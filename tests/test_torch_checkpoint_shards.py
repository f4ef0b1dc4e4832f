"""Per-shard checkpoints of the JAX package read by the port on the CPU.

A multi-process JAX run writes ``arrays.p{rank}.npz`` and
``index.p{rank}.json`` per rank and ``meta.json`` last.  Here the slabs are
written by JAX itself (``local_checkpoint_chunks`` and ``write_shard_slab``
over the 8-device CPU mesh of ``tests/conftest.py``, 4 x 2 data x model,
or ``CheckpointManager.save_sharded``), on one rank or split over two
ranks with entry names numbered per rank as
``tests/test_multichip.py::test_sharded_checkpoint_cross_rank_entry_names``
does.  The port's ``load_checkpoint`` must give JAX's load leaf for leaf,
optimizer state included, with ``resume_filter``, ``weight_map`` and
``load_optimizer``; ``Trainer.load``, ``cli.train --evaluate`` and
``cli.predict`` from a per-shard directory must give what they give from
the single-file checkpoint it was cut from."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax

from open_knowledge_graph_embeddings_tpu.cli.predict import main as jax_predict_main
from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.parallel import make_mesh, opt_state_shardings, variables_shardings
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu_torch.cli import predict as port_predict
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    flatten_arrays,
    load_checkpoint,
    open_checkpoint_reader,
    unflatten_arrays,
    variables_from_jax_arrays,
)

torch.set_num_threads(1)

MODEL = "LSTMComplexRelationModel"
MODEL_CONFIG = {"entity_slot_size": 8, "init_std": 0.1, "sparse": True, "dropout": 0.0, "normalize": "batchnorm"}
OPT = {"optimizer": "Adagrad", "lr": 0.3}


def _jax_tree(meta, seed):
    """JAX variables and Adagrad state; with ``seed`` > 0 every array
    (accumulators and steps too) drawn from that numpy seed."""
    model = jax_build_model(MODEL, meta, **MODEL_CONFIG)
    v = model.init(jax.random.key(3))
    reg = JaxRegimes(OPT)
    reg.update(1, 0)
    opt = reg.init_state(v["params"])
    if seed:
        rng = np.random.default_rng(seed)
        draw = lambda x: jax.numpy.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))  # noqa: E731
        v = {**v, "params": jax.tree_util.tree_map(draw, v["params"]), "state": jax.tree_util.tree_map(draw, v["state"])}
        opt = jax.tree_util.tree_map(draw, opt)
    return v, opt


def _on_mesh(variables, opt_state):
    mesh = make_mesh(data=4, model=2)
    var_sh = variables_shardings(variables, mesh)
    return jax.device_put(variables, var_sh), jax.device_put(opt_state, opt_state_shardings(opt_state, var_sh, mesh))


def write_jax_slabs(path, variables, opt_state, meta, ranks):
    """JAX's per-shard checkpoint of the trees, sharded over the 4 x 2 mesh,
    as ``ranks`` slabs: with two, every multi-chunk key's chunks are split
    between the ranks and numbered per rank, so both slabs hold ``key::0``."""
    vs, os_ = _on_mesh(variables, opt_state)
    chunks, index = jax_ckpt.local_checkpoint_chunks(jax_ckpt.gather_local_shard_tree(vs, os_))
    assert any(len(v["chunks"]) > 1 for v in index.values())  # really sharded
    os.makedirs(path, exist_ok=True)
    slabs = [({}, {}) for _ in range(ranks)]
    for key, info in index.items():
        parts = info["chunks"]
        cut = (len(parts) + 1) // 2 if ranks == 2 and len(parts) > 1 else len(parts)
        for rank, sub in enumerate((parts[:cut], parts[cut:])[:ranks]):
            if not sub:
                continue
            rchunks, ridx = slabs[rank]
            entries = []
            for i, c in enumerate(sub):
                entry = f"{key}::{i}"
                rchunks[entry] = chunks[c["entry"]]
                entries.append({"entry": entry, "start": c["start"], "stop": c["stop"]})
            ridx[key] = {"shape": info["shape"], "dtype": info["dtype"], "chunks": entries}
    for rank, (rchunks, ridx) in enumerate(slabs):
        jax_ckpt.write_shard_slab(str(path), rank, rchunks, ridx)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return str(path)


@pytest.fixture(scope="module")
def shard_checkpoints(toy_dataset_dir, tmp_path_factory):
    meta = jax_load_meta(toy_dataset_dir, (10, 10), cache_dir=toy_dataset_dir + "/shard_cache")
    v, opt = _jax_tree(meta, seed=11)
    d = tmp_path_factory.mktemp("shard_ckpt")
    paths = {r: write_jax_slabs(d / f"ranks{r}", v, opt, {"training_steps": 7}, r) for r in (1, 2)}
    full = jax_ckpt.save_checkpoint(str(d), "full", v, opt, {"training_steps": 7})
    return meta, paths, full


CASES = {
    "all": dict(),
    "filter": dict(resume_filter=["lstm", "bn"]),
    "weight-map": dict(weight_map={
        "params/entity_lstm/w_ih": "params/relation_lstm/w_ih",  # onto a key the checkpoint holds: the rename wins
        "params/entity_token_embedding": "params/relation_token_embedding",  # another shape: skipped
        "opt/entity_lstm/b_ih/sum": "opt/relation_lstm/b_ih/sum"}),
    "filter-map-no-optimizer": dict(resume_filter=["relation"], weight_map={
        "params/entity_lstm/w_hh": "params/relation_lstm/w_hh"}, load_optimizer=False),
}


def _both_loads(path, meta, **kw):
    """(port's load, JAX's load) of ``path`` into the same fresh targets,
    each flattened to {key: numpy array}, and the two metas."""
    jv, jopt = _jax_tree(meta, seed=0)
    want_v, want_opt, want_meta = jax_ckpt.load_checkpoint(path, jv, jopt, **kw)
    pv = variables_from_jax_arrays({**jax_ckpt.flatten_arrays(jv["params"], "params"),
                                    **jax_ckpt.flatten_arrays(jv["state"], "state")})
    popt = unflatten_arrays(jax_ckpt.flatten_arrays(jopt, "opt"), "opt")
    got_v, got_opt, got_meta = load_checkpoint(path, pv, popt, **kw)
    want = {**jax_ckpt.flatten_arrays(want_v["params"], "params"), **jax_ckpt.flatten_arrays(want_v["state"], "state"),
            **jax_ckpt.flatten_arrays(want_opt, "opt")}
    got = {**flatten_arrays(got_v["params"], "params"), **flatten_arrays(got_v["state"], "state"),
           **flatten_arrays(got_opt, "opt")}
    return got, want, got_meta, want_meta


@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_shard_slabs_load_like_jax(shard_checkpoints, case, ranks):
    """Every params, state and opt leaf exactly JAX's load of the same slabs,
    and with every option also the port's load of the single-file
    checkpoint of the same trees."""
    meta, paths, full = shard_checkpoints
    got, want, got_meta, want_meta = _both_loads(paths[ranks], meta, **CASES[case])
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got_meta == want_meta == {"training_steps": 7}
    from_full, _, _, _ = _both_loads(full, meta, **CASES[case])
    for k, w in from_full.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    with np.load(f"{full}/arrays.npz") as z:
        loaded = {k for k in got if k in z.files and np.array_equal(got[k], z[k])}
    if case == "all":
        assert loaded == set(got)
    if case == "filter":
        assert "params/entity_token_embedding" not in loaded and "opt/entity_token_embedding/sum" in loaded
    if case == "filter-map-no-optimizer":
        assert not any(k.startswith("opt/") for k in loaded)


def test_cross_rank_entry_names_read_from_their_own_slab(shard_checkpoints):
    """Entry names recur across the two slabs; each chunk is read from the
    slab that listed it (a global entry -> slab map restores [A; B] as
    [B; B])."""
    meta, paths, full = shard_checkpoints
    reader = open_checkpoint_reader(paths[2])
    with np.load(os.path.join(paths[2], "arrays.p0.npz")) as a, np.load(os.path.join(paths[2], "arrays.p1.npz")) as b:
        shared = set(a.files) & set(b.files)
    assert shared  # the same names in both slabs
    split = [k for k in reader.keys() if len({c["slab"] for c in reader.index[k]["chunks"]}) == 2]
    assert "params/entity_token_embedding" in split
    with np.load(f"{full}/arrays.npz") as z:
        for k in split:
            np.testing.assert_array_equal(reader.read_full(k), z[k], err_msg=k)
    reader.close()


def test_incomplete_or_missing_slabs_raise(shard_checkpoints, tmp_path):
    meta, paths, _ = shard_checkpoints
    part = tmp_path / "part"
    shutil.copytree(paths[2], part)
    os.remove(part / "index.p1.json")  # rank 1's chunks lost: its leaves are not covered
    v, opt = _jax_tree(meta, seed=0)
    pv = variables_from_jax_arrays(jax_ckpt.flatten_arrays(v["params"], "params"))
    with pytest.raises(ValueError, match="cover"):
        load_checkpoint(str(part), pv, {})
    with pytest.raises(AssertionError, match="cover"):  # JAX's reader refuses it too
        jax_ckpt.load_checkpoint(str(part), v, opt)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="neither arrays.npz nor per-shard"):
        load_checkpoint(str(tmp_path / "empty"), {"params": {}}, {})


@pytest.mark.parametrize("options", [dict(), dict(resume_filter=["relation_embedding"], load_optimizer=False),
                                     dict(weight_map={"params/relation_embedding": "params/renamed_away"})],
                         ids=["all", "filter", "weight-map-away"])
def test_save_sharded_single_rank_loads_like_jax(toy_dataset_dir, tmp_path, options):
    """``CheckpointManager.save_sharded`` on rank 0 of the mesh (the cases of
    ``tests/test_multichip.py`` :443 and :511, lookup ComplEx): the port's
    load equals JAX's, optimizer state included."""
    meta = jax_load_meta(toy_dataset_dir, (10, 10), cache_dir=toy_dataset_dir + "/shard_cache")
    model = jax_build_model("LookupComplexRelationModel", meta, entity_slot_size=8)
    reg = JaxRegimes({"optimizer": "Adagrad", "lr": 0.1})
    reg.update(1, 0)
    rng = np.random.default_rng(5)
    draw = lambda x: jax.numpy.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))  # noqa: E731
    v = jax.tree_util.tree_map(draw, model.init(jax.random.key(1)))
    opt = jax.tree_util.tree_map(draw, reg.init_state(v["params"]))
    vs, os_ = _on_mesh(v, opt)
    mgr = jax_ckpt.CheckpointManager(str(tmp_path / "exp"), keep_checkpoints=2)
    path = mgr.save_sharded(vs, os_, {"training_steps": 3}, rank=0, barrier=lambda tag: None)
    mgr.wait_finalized()
    assert not os.path.exists(os.path.join(path, "arrays.npz"))
    fresh = model.init(jax.random.key(9))
    fresh_opt = reg.init_state(fresh["params"])
    want_v, want_opt, want_meta = jax_ckpt.load_checkpoint(path, fresh, fresh_opt, **options)
    pv = variables_from_jax_arrays(jax_ckpt.flatten_arrays(fresh["params"], "params"))
    popt = unflatten_arrays(jax_ckpt.flatten_arrays(fresh_opt, "opt"), "opt")
    got_v, got_opt, got_meta = load_checkpoint(path, pv, popt, **options)
    want = {**jax_ckpt.flatten_arrays(want_v["params"], "params"), **jax_ckpt.flatten_arrays(want_opt, "opt")}
    got = {**flatten_arrays(got_v["params"], "params"), **flatten_arrays(got_opt, "opt")}
    assert set(got) == set(want) and got_meta == want_meta
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    saved = jax_ckpt.flatten_arrays(jax.tree_util.tree_map(np.asarray, vs["params"]), "params")
    same = {k for k in saved if np.array_equal(got[k], saved[k])}
    assert same == ({"params/relation_embedding"} if "resume_filter" in options
                    else set(saved) - {"params/relation_embedding"} if "weight_map" in options else set(saved))


# ------------------------------------------------- the CLIs from a shard dir


def _config(toy_dataset_dir, exp_dir, **over):
    cfg = dict(dataset_dir=toy_dataset_dir, experiment_dir=str(exp_dir), model=MODEL, model_config=MODEL_CONFIG,
               optimization_config=OPT, batch_size=4, epochs=3, eval_epoch_freq=0, eval_freq=-1, print_freq=1,
               sparse_min_ratio=0.0, workers=2, seed=1,
               train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": True,
                                  "min_size_batch_labels": 6},
               val_data_config={"input_file": "valid.txt", "batch_size": 4, "use_batch_shared_entities": False},
               test_data_config={"input_file": "test.txt", "batch_size": 4, "use_batch_shared_entities": False})
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def trained(toy_dataset_dir, tmp_path_factory):
    """A JAX cli.train run's last checkpoint and the same trees as two rank
    slabs (the meta.json copied: config, optimizer host state, steps)."""
    d = tmp_path_factory.mktemp("shard_cli")
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, d / "jax_exp"))
    jax_main(args)
    full = str(d / "jax_exp" / "checkpoint0")
    meta = jax_load_meta(toy_dataset_dir, (10, 10), cache_dir=toy_dataset_dir + "/shard_cache")
    v, opt = _jax_tree(meta, seed=0)
    v, opt, ck_meta = jax_ckpt.load_checkpoint(full, v, opt)
    shards = write_jax_slabs(d / "shards", v, opt, ck_meta, ranks=2)
    return d, full, shards


def test_trainer_load_from_shards(trained, toy_dataset_dir):
    """``cli.train --resume`` (``train: false``) into ``Trainer.load``:
    params, batch-norm state, Adagrad state, step count and results from
    the slabs bit-equal to those from the single file."""
    d, full, shards = trained
    trainers = []
    for name, ck in (("full", full), ("shards", shards)):
        path = d / f"resume_{name}.yaml"
        path.write_text(yaml.safe_dump(_config(toy_dataset_dir, d / f"port_{name}", resume=ck, train=False)))
        trainers.append(port_train.cli_main([str(path), "--device", "cpu"]))
    a, b = trainers
    got = {**flatten_arrays(b.variables["params"], "params"), **flatten_arrays(b.variables["state"], "state"),
           **flatten_arrays(b.opt_state, "opt")}
    want = {**flatten_arrays(a.variables["params"], "params"), **flatten_arrays(a.variables["state"], "state"),
            **flatten_arrays(a.opt_state, "opt")}
    with np.load(f"{full}/arrays.npz") as z:
        assert set(got) == set(want) == set(z.files)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], z[k], err_msg=k)
    assert b.training_steps == a.training_steps == 6
    assert b.results.to_dicts() == a.results.to_dicts()
    b.args["epochs"] = 4
    b.run()  # and trains on
    assert b.training_steps > 6 and float(b.opt_state["entity_lstm"]["w_ih"]["step"]) == b.training_steps


@pytest.mark.parametrize("on_validation", [True, False], ids=["validation", "test"])
def test_evaluate_from_shards(trained, toy_dataset_dir, on_validation):
    """``cli.train --evaluate`` from the slabs and from the single file:
    exactly the same MRR, MR, hits and loss."""
    d, full, shards = trained
    results = []
    for name, ck in (("full", full), ("shards", shards)):
        path = d / f"eval_{name}_{on_validation}.yaml"
        path.write_text(yaml.safe_dump(_config(toy_dataset_dir, d / f"eval_{name}_{on_validation}", resume=ck)))
        trainer = port_train.cli_main([str(path), "--device", "cpu", "--evaluate", "true",
                                       "--evaluate_on_validation", str(on_validation).lower()])
        results.append(trainer.evaluate().averages_dict)
    assert results[0] == results[1]
    assert 0 < results[0]["mrr"] <= 1


def _lines(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def test_predict_from_shards(trained, toy_dataset_dir, capsys):
    """``cli.predict`` from the slabs prints what it prints from the single
    file, and the names JAX's cli.predict ranks first."""
    d, full, shards = trained
    cfg = d / "predict.yaml"
    cfg.write_text(yaml.safe_dump(_config(toy_dataset_dir, d / "predict")))
    for query in ("Barack Obama|works in|?", "?|capital of|France"):
        want = _lines(port_predict.main, [str(cfg), "--resume", full, "--query", query, "-k", "5", "--device", "cpu"],
                      capsys)
        got = _lines(port_predict.main, [str(cfg), "--resume", shards, "--query", query, "-k", "5", "--device", "cpu"],
                     capsys)
        assert got == want and len(got) == 5
        jax_names = [ln.split(None, 2)[2] for ln in _lines(jax_predict_main, [str(cfg), "--resume", full, "--query",
                                                                             query, "-k", "5"], capsys)]
        assert [ln.split(None, 2)[2] for ln in got] == jax_names
