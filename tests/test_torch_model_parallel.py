"""The port's model axis (``model_parallel`` > 1) on ``gloo`` CPU processes
against the JAX package on its ``make_mesh(data=D, model=M)`` mesh (of the
8 virtual CPU devices of tests/conftest.py) and against the port's world
of one, for D = 1, M = 2 (2 processes) and D = 2, M = 2 (4 processes; only
there does a collective taken over the wrong group show).

The ranks of both worlds run every case in one launch
(tests/torch_model_parallel_worker.py); the JAX package and the world of
one run here on the same numpy-seeded inputs, the weights crossing through
``variables_from_jax_arrays``.  The cases mirror tests/test_shard_map.py
and tests/test_multichip.py:

* the boundary gather equals a plain gather, forward and gradient;
* ``shard_map_score``'s loss and three steps: loss rel 1e-5, table and
  accumulator atol 1e-6;
* the trainer's dense step on lookup ComplEx (batch-shared, and full
  vocabulary on an odd entity count, with KL and a gradient clip);
* the row-sparse LSTM-ComplEx step with the gather-sum plan, and with
  query dedup;
* full-vocabulary filtered ranking on exact scores: ranks equal to the
  world of one's and JAX's, loss and metric sums within rtol 1e-5, the
  filtered top-k equal;
* checkpoints: the port's slabs, a single-file checkpoint and JAX's data =
  4 x model = 2 slabs each load into slabs leaf for leaf, and JAX's reader
  reads the port's slabs;
* ``cli.train`` with ``model_parallel: 2`` trains, evaluates, writes slabs
  that are the tables' halves, and matches the world of one;
* a planted fault: a world-wide ``all_reduce`` where the model group's
  belongs must fail the comparison.

Tolerances are those of the JAX package's mesh tests (rtol 1e-5, atol
1e-6; the LSTM sparse step's rtol 2e-5 / atol 1e-4 of
test_sparse_grad_plan_on_mesh).  Adagrad's first step is +-lr wherever
|g| >> eps, so a parameter whose Adagrad sum is below 1e-12 (|g| < 1e-6)
is held by its sum alone, as in tests/test_torch_parallel.py.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.parallel import make_mesh as jax_make_mesh
from open_knowledge_graph_embeddings_tpu.parallel import opt_state_shardings as jax_opt_shardings
from open_knowledge_graph_embeddings_tpu.parallel import variables_shardings as jax_var_shardings
from open_knowledge_graph_embeddings_tpu.parallel import train_batch_shardings as jax_batch_shardings
from open_knowledge_graph_embeddings_tpu.parallel.shard_map_score import (
    make_sharded_lookup_train_step as jax_sharded_step,
)
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.evaluate import ranks_from_scores as jax_ranks_from_scores
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu.train.step import make_train_step as jax_train_step
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset, load_meta
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_bounds
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    flatten_arrays,
    open_checkpoint_reader,
    variables_from_jax_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import filtered_topk, ranks_from_scores
from open_knowledge_graph_embeddings_tpu_torch.train.loss import one_vs_n_loss
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device, make_train_step, train_batch_to_arrays
from test_torch_checkpoint_shards import MODEL as CKPT_MODEL, MODEL_CONFIG as CKPT_CONFIG, OPT as CKPT_OPT
from test_torch_checkpoint_shards import _jax_tree, write_jax_slabs
from test_torch_eval import _case as eval_case

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_model_parallel_worker.py")
WORKER_TIMEOUT_S = 300
WORLDS = {"1x2": (1, 2), "2x2": (2, 2)}
RTOL, ATOL = 1e-5, 1e-6
NOISE_SUM = 1e-12
LOOKUP_CFG = dict(entity_slot_size=8, init_std=0.1)
LSTM_CFG = dict(entity_slot_size=32, init_std=0.1, sparse=True, dropout=0.0, normalize="batchnorm")
ADAGRAD = {"optimizer": "Adagrad", "lr": 0.2}
SGD = {"optimizer": "SGD", "lr": 0.5}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _synth(d, mentions):
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synth_olpbench.py"), str(d),
         "--mentions", str(mentions), "--relations", "30", "--triples", "400",
         "--eval-size", "20", "--ent-tokens", "101", "--rel-tokens", "25", "--seed", "2"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """Two synthetic OLPBench-shaped sets as tests/test_torch_parallel.py's:
    one with an odd number of entities (303 = 301 mentions + PAD and UNK)
    for the port's uneven slabs, one with 302 for the LSTM cases that JAX
    runs too (its device_put refuses a row-sharded [303, L] token-id
    buffer)."""
    return (_synth(tmp_path_factory.mktemp("synth_odd"), 301), _synth(tmp_path_factory.mktemp("synth_even"), 300))


def _datasets(path, **cfg):
    cfg = dict(input_file="train.txt", is_training_data=True, **cfg)
    return (JaxDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **cfg),
            OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/port_cache", **cfg))


def _start(jmodel, seed=0):
    jv = jmodel.init(jax.random.key(seed))
    return jv, {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}


def _jax_hp(reg):
    return [{k: jnp.float32(v) for k, v in h.items()} for h in reg.hparams()]


def _jax_steps(jmodel, jv, batches, mesh, opt, planner=None, model_mesh=False):
    """JAX's dense (``planner`` None) or row-sparse step on ``mesh`` -> flat
    params, state and optimizer state, and the losses."""
    if model_mesh:
        jmodel.set_mesh(mesh)
    try:
        reg = JaxRegimes(opt)
        reg.update(1, 0)
        var_sh = jax_var_shardings(jv, mesh)
        vs = jax.device_put(jv, var_sh)
        o = jax.device_put(reg.init_state(vs["params"]), None)
        o = jax.device_put(o, jax_opt_shardings(o, var_sh, mesh))
        if planner is None:
            from open_knowledge_graph_embeddings_tpu.train.step import train_batch_to_arrays as jax_arrays

            step, planner = jax_train_step(jmodel, reg, jv["params"]), jax_arrays
        else:
            step = jax_sparse_step(jmodel, reg, jv["params"], entity_sparse=True)
        losses = []
        for i, b in enumerate(batches):
            arrs = planner(b)
            sh = jax_batch_shardings(arrs, mesh)
            arrs = {k: jax.device_put(np.asarray(v), sh[k]) for k, v in arrs.items()}
            vs, o, st = step(vs, o, _jax_hp(reg), arrs, jax.random.key(100 + i))
            losses.append(float(st["loss_sum"]))
    finally:
        jmodel.set_mesh(None)
    flat = {**jax_flatten(vs["params"], "params"), **jax_flatten(vs["state"], "state"), **jax_flatten(o, "opt")}
    return {k: np.asarray(v) for k, v in flat.items()}, np.asarray(losses)


def _port_one(path, name, cfg, start, batches, opt, **kw):
    """The port's dense step in one process -> flat arrays and losses."""
    model = build_model(name, load_meta(path, cache_dir=path + "/port_cache"), **cfg)
    v = model.init(torch.Generator().manual_seed(0))
    v.update(variables_from_jax_arrays(start))
    reg = OptimizerRegimes(opt)
    reg.update(1, 0)
    o = reg.init_state(v["params"])
    step = make_train_step(model, reg, v["params"], **kw)
    losses = []
    for i, b in enumerate(batches):
        v, o, st = step(v, o, reg.hparams(), arrays_to_device(train_batch_to_arrays(b), "cpu"),
                        torch.Generator().manual_seed(i))
        losses.append(float(st["loss_sum"]))
    flat = {**flatten_arrays(v["params"], "params"), **flatten_arrays(v["state"], "state"), **flatten_arrays(o, "opt")}
    return flat, np.asarray(losses)


def _whole(ranks, key, D, M):
    """A leaf from the ranks' outputs: a slab key's rows assembled from the
    ranks of data index 0 (in model order), else rank 0's."""
    name = key.split("/")[1] if "/" in key else None
    if f"slab/{name}" in ranks[0] and ranks[0][key].ndim > 0:
        return np.concatenate([ranks[m][key] for m in range(M)])
    return ranks[0][key]


def _close(got, want, rtol=RTOL, atol=ATOL, keys=None):
    """Every leaf of ``want`` in ``got``; Adagrad-noise parameters held by
    their sums (module docstring)."""
    for k in keys or want:
        g, w = got[k], want[k]
        acc = want.get(f"opt/{k.removeprefix('params/')}/sum") if k.startswith("params/") else None
        if acc is not None:
            noisy = (acc > 0) & (acc < NOISE_SUM)
            assert noisy.sum() < 0.01 * max((acc > 0).sum(), 1), (k, noisy.sum())
            g, w = g[~noisy], w[~noisy]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------ the runs


def _cases(tmp, toy, synth_pair):
    """Every case both worlds run, and what the tests need to check them."""
    synth, synth_even = synth_pair
    cases, refs = {}, {}
    rng = np.random.default_rng(0)
    # the boundary gather: 13 rows (uneven slabs), repeated ids
    cases["gather"] = {"kind": "gather", "table": rng.standard_normal((13, 4)).astype(np.float32),
                       "ids": np.asarray([0, 5, 12, 7, 5, 3, 11, 6], np.int64)}
    # shard_map_score on the toy meta (10 entities, 8 candidates)
    jds, pds = _datasets(toy, batch_size=4)
    jmodel = jax_build_model("LookupComplexRelationModel", jds.meta, **LOOKUP_CFG)
    jv, start = _start(jmodel)
    meta = pds.meta
    B, N = 8, meta.entities_size - meta.min_entities_size
    pos_rows, pos_cols = np.full(16, -1, np.int32), np.full(16, -1, np.int32)
    pos_rows[:B], pos_cols[:B] = np.arange(B), rng.integers(0, N, B)
    batch = {"ent_ids": rng.integers(2, meta.entities_size, B).astype(np.int32),
             "rel_ids": rng.integers(2, meta.relations_size, B).astype(np.int32),
             "is_sp": np.arange(B) % 2 == 0, "row_valid": np.ones(B, bool), "pos_rows": pos_rows,
             "pos_cols": pos_cols, "normalizer_loss": np.float32(B * N), "n_real_cols": np.float32(N)}
    hp = dict(lr=0.3, weight_decay=0.0, lr_decay=0.0, eps=1e-10)
    cases["shard_map"] = {"kind": "shard_map", "dataset_dir": toy, "cache_dir": toy + "/port_cache",
                          "model": "LookupComplexRelationModel", "model_config": LOOKUP_CFG, "variables": start,
                          "batch": batch, "hp": hp, "steps": 3}
    refs["shard_map"] = (jmodel, jv, batch, hp, start)
    # the dense step: lookup ComplEx, batch-shared on the toy set (JAX's
    # test_sharded_matches_single_device)
    jds, pds = _datasets(toy, batch_size=4, use_batch_shared_entities=True, min_size_batch_labels=8)
    jmodel = jax_build_model("LookupComplexRelationModel", jds.meta, **LOOKUP_CFG)
    jv, start = _start(jmodel, 1)
    batches = list(BatchBuilder(pds, seed=3).batches(shuffle=True))[:3]
    dense = {"kind": "dense", "dataset_dir": toy, "cache_dir": toy + "/port_cache",
             "model": "LookupComplexRelationModel", "model_config": LOOKUP_CFG, "variables": start, "opt": ADAGRAD,
             "batches": batches}
    cases["dense"] = dense
    cases["dense_planted"] = {**dense, "plant": True}
    refs["dense"] = (jmodel, jv, batches, start)
    # the dense step on the full vocabulary of 303 entities (odd), with KL
    # and a gradient clip, against the world of one
    _, pds = _datasets(synth, batch_size=8)
    full = list(BatchBuilder(pds, seed=5).batches(shuffle=True))[:2]
    full_cfg = {**LOOKUP_CFG, "batch_norm": True, "l2_reg": 1e-3}
    jmodel_f = jax_build_model("LookupComplexRelationModel", _datasets(synth, batch_size=8)[0].meta, **full_cfg)
    _, start_f = _start(jmodel_f, 2)
    cases["full_kl"] = {"kind": "dense", "dataset_dir": synth, "cache_dir": synth + "/port_cache",
                        "model": "LookupComplexRelationModel", "model_config": full_cfg, "variables": start_f,
                        "opt": SGD, "batches": full, "loss_type": "kl", "grad_clip": 0.05}
    refs["full_kl"] = (synth, full, start_f)
    # the row-sparse LSTM step: the gather-sum plan, and query dedup
    jds, pds = _datasets(synth_even, batch_size=128, use_batch_shared_entities=True, min_size_batch_labels=128,
                         max_size_prefix_label=4)
    jmodel = jax_build_model("LSTMComplexRelationModel", jds.meta, **LSTM_CFG)
    jv, start = _start(jmodel)
    sbatches = list(BatchBuilder(pds, seed=4).batches(shuffle=True))[:1]
    for tag, plan_kw in (("plan", dict(min_rows_ratio=0.0)), ("dedup", dict(min_rows_ratio=0.0, dedup_bucket=8))):
        cases[f"sparse_{tag}"] = {"kind": "sparse", "dataset_dir": synth_even, "cache_dir": synth_even + "/port_cache",
                                  "model": "LSTMComplexRelationModel", "model_config": LSTM_CFG, "variables": start,
                                  "opt": ADAGRAD, "batches": sbatches, "plan_kw": plan_kw}
        refs[f"sparse_{tag}"] = (jmodel, jv, sbatches, plan_kw)
    # a token model's candidate cache and a full-vocabulary eval batch
    vcfg = dict(input_file="valid.txt", is_training_data=False, batch_size=8)
    vds = OneToNMentionRelationDataset(dataset_dir=synth_even, cache_dir=synth_even + "/port_cache", **vcfg)
    vds.attach_filter_index("train.txt", "valid.txt", "test.txt")
    vbatch = next(iter(BatchBuilder(vds).batches(shuffle=False)))
    sds = OneToNMentionRelationDataset(dataset_dir=synth_even, cache_dir=synth_even + "/port_cache",
                                       use_batch_shared_entities=True, min_size_batch_labels=64, **vcfg)
    sds.attach_filter_index("train.txt", "valid.txt", "test.txt")
    sbatch = next(iter(BatchBuilder(sds, seed=1).batches(shuffle=False)))
    cases["cache"] = {"kind": "cache", "dataset_dir": synth_even, "cache_dir": synth_even + "/port_cache",
                      "model": "LSTMComplexRelationModel", "model_config": {**LSTM_CFG, "sparse": False},
                      "variables": start, "batch": vbatch, "shared_batch": sbatch}
    refs["cache"] = (vbatch, sbatch)
    # full-vocabulary ranking on exact scores (tests/test_torch_eval.py)
    cases["eval"] = {"kind": "eval", "case": eval_case(3, B=6, N=101, N_real=95), "chunk": 16, "k": 5}
    # checkpoints: JAX's 4 x 2 slabs and a single-file checkpoint of the
    # LSTM model of tests/test_torch_checkpoint_shards.py
    jmeta = jax_build_model(CKPT_MODEL, _datasets(toy, batch_size=4)[0].meta, **CKPT_CONFIG).meta
    cv, copt = _jax_tree(jmeta, seed=11)
    jax_slabs = write_jax_slabs(tmp / "jax_slabs", cv, copt, {"training_steps": 7}, 2)
    single = jax_ckpt.save_checkpoint(str(tmp), "single", cv, copt, {"training_steps": 7})
    flat_c = {**jax_flatten(cv["params"], "params"), **jax_flatten(cv["state"], "state")}
    refs["ckpt"] = {**flat_c, **jax_flatten(copt, "opt")}
    return cases, refs, {"ckpt": dict(kind="ckpt", dataset_dir=toy, cache_dir=toy + "/port_cache", model=CKPT_MODEL,
                                      model_config=CKPT_CONFIG, variables=flat_c, opt=CKPT_OPT, single=single,
                                      jax_slabs=jax_slabs)}


def _cli_args(toy, exp_dir, model_parallel, shared=False):
    """JAX's test_cli_trains_on_mesh run (full vocabulary), or with
    ``shared`` batch-shared training and validation."""
    if shared:
        args = _cli_args(toy, exp_dir, model_parallel)
        args["train_data_config"].update(use_batch_shared_entities=True, min_size_batch_labels=6)
        args["val_data_config"].update(use_batch_shared_entities=True, min_size_batch_labels=6)
        return args
    return dict(dataset_dir=toy, experiment_dir=exp_dir, seed=7, epochs=3, batch_size=4, eval_epoch_freq=2,
                eval_freq=-1, save_epoch_freq=-1, print_freq=1, eval_block_rows=0, workers=2,
                model_parallel=model_parallel, model="LookupComplexRelationModel",
                model_config={"entity_slot_size": 8, "init_std": 0.1},
                optimization_config={"optimizer": "Adagrad", "epoch": 0, "lr": 0.3, "weight_decay": 1e-10},
                train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": False},
                val_data_config={"input_file": "valid.txt", "batch_size": 2, "use_batch_shared_entities": False},
                test_data_config={"input_file": "test.txt", "batch_size": 2, "use_batch_shared_entities": False})


@pytest.fixture(scope="module")
def runs(tmp_path_factory, toy_dataset_dir, synth_dir):
    """Both worlds' outputs (each a list of per-rank dicts), started
    together, and the references' inputs."""
    tmp = tmp_path_factory.mktemp("model_parallel")
    cases, refs, extra = _cases(tmp, toy_dataset_dir, synth_dir)
    procs, prefixes = [], {}
    for tag, (D, M) in WORLDS.items():
        world_cases = {**cases, "ckpt": {**extra["ckpt"], "dir": str(tmp / f"ckpt_{tag}")},
                       "cli": {"kind": "cli", "args": _cli_args(toy_dataset_dir, str(tmp / f"cli_{tag}"), M)},
                       "cli_shared": {"kind": "cli", "args": _cli_args(toy_dataset_dir, str(tmp / f"clis_{tag}"), M,
                                                                       shared=True)}}
        os.makedirs(tmp / f"ckpt_{tag}", exist_ok=True)
        case_path = tmp / f"cases_{tag}.pkl"
        with open(case_path, "wb") as f:
            pickle.dump(world_cases, f)
        port, prefixes[tag] = _free_port(), str(tmp / f"out_{tag}")
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        for r in range(D * M):
            log = open(tmp / f"{tag}_rank{r}.log", "w")
            procs.append((subprocess.Popen([sys.executable, WORKER, str(case_path), prefixes[tag], str(r), str(D),
                                            str(M), str(port)], stdout=log, stderr=subprocess.STDOUT, env=env,
                                           text=True), log))
    # the references run here while the ranks work
    one_dir = str(tmp / "cli_one")
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import main as port_main
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    for key, shared in (("cli", False), ("cli_shared", True)):
        args = load_config()
        args.update(_cli_args(toy_dataset_dir, f"{one_dir}_{key}", 1, shared))
        refs[f"{key}_one"] = port_main(args, device="cpu")
    for p, log in procs:
        try:
            p.wait(timeout=WORKER_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
            log.close()
    for p, log in procs:
        text = open(log.name).read()
        assert p.returncode == 0 and "WORKER_OK" in text, text[-4000:]
    out = {tag: [dict(np.load(f"{prefixes[tag]}.r{r}.npz")) for r in range(D * M)]
           for tag, (D, M) in WORLDS.items()}
    return out, cases, refs


def _case_out(ranks, name):
    return [{k[len(name) + 1:]: v for k, v in r.items() if k.startswith(name + "/")} for r in ranks]


# ------------------------------------------------------------ the tests


@pytest.mark.parametrize("world", list(WORLDS))
def test_boundary_gather_equals_a_plain_gather(runs, world):
    out, cases, _ = runs
    D, M = WORLDS[world]
    table, ids = cases["gather"]["table"], cases["gather"]["ids"]
    ranks = _case_out(out[world], "gather")
    for r, o in enumerate(ranks):
        np.testing.assert_array_equal(o["rows"], table[ids])
        np.testing.assert_array_equal(o["rows_eq"], table[ids])
        # the gradient: the model group's cotangents summed, this slab's rows
        group = range((r // M) * M, (r // M + 1) * M)
        full = np.zeros_like(table)
        np.add.at(full, ids, sum(ranks[s]["ct"] for s in group))
        lo = int(o["lo"])
        np.testing.assert_allclose(o["grad"], full[lo : lo + len(o["grad"])], rtol=1e-6, atol=1e-7)
        rows_per = -(-len(table) // M)
        padded = np.concatenate([full, np.zeros((rows_per * M - len(table), table.shape[1]), np.float32)])
        m = r % M
        np.testing.assert_allclose(o["grad_eq"], padded[m * rows_per : (m + 1) * rows_per], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", list(WORLDS))
def test_shard_map_step_matches_jax_and_one_process(runs, world):
    out, cases, refs = runs
    D, M = WORLDS[world]
    jmodel, jv, batch, hp, start = refs["shard_map"]
    step, prepare, prepare_batch = jax_sharded_step(jmodel, jax_make_mesh(data=D, model=M))
    params, opt = prepare(jax.tree_util.tree_map(jnp.copy, jv))
    sb = prepare_batch(batch)
    want_losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, {k: jnp.float32(v) for k, v in hp.items()}, sb)
        want_losses.append(float(loss))
    ranks = _case_out(out[world], "shard_map")
    for o in ranks:
        np.testing.assert_allclose(o["losses"], want_losses, rtol=1e-5)
    ent = np.concatenate([ranks[m]["ent"] for m in range(M)])
    acc = np.concatenate([ranks[m]["acc_ent"] for m in range(M)])
    np.testing.assert_allclose(ent, np.asarray(params["entity_embedding"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc, np.asarray(opt["ent"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["rel"], np.asarray(params["relation_embedding"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["acc_rel"], np.asarray(opt["rel"]), rtol=1e-5, atol=1e-6)
    # the world of one's dense step on the same batch
    meta = jmodel.meta
    one, one_losses = _port_one_batch(cases["shard_map"], batch, hp)
    np.testing.assert_allclose(ranks[0]["losses"], one_losses, rtol=1e-5)
    np.testing.assert_allclose(ent[: meta.entities_size], one["params/entity_embedding"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["fn_loss"], one_losses[0], rtol=1e-5)


def _port_one_batch(case, batch, hp):
    model = build_model(case["model"], load_meta(case["dataset_dir"], cache_dir=case["cache_dir"]),
                        **case["model_config"])
    v = model.init(torch.Generator().manual_seed(0))
    v.update(variables_from_jax_arrays(case["variables"]))
    reg = OptimizerRegimes({"optimizer": "Adagrad", **hp})
    reg.update(1, 0)
    o = reg.init_state(v["params"])
    step = make_train_step(model, reg, v["params"])
    losses = []
    for _ in range(3):
        v, o, st = step(v, o, reg.hparams(), arrays_to_device(batch, "cpu"))
        losses.append(float(st["loss_sum"]))
    return flatten_arrays(v["params"], "params"), np.asarray(losses)


def _assembled(ranks, D, M):
    return {k: _whole(ranks, k, D, M) for k in ranks[0] if not k.startswith("slab/")}


@pytest.mark.parametrize("world", list(WORLDS))
def test_dense_step_matches_jax_mesh(runs, world):
    out, _, refs = runs
    D, M = WORLDS[world]
    jmodel, jv, batches, start = refs["dense"]
    want, want_loss = _jax_steps(jmodel, jax.tree_util.tree_map(jnp.copy, jv), batches,
                                 jax_make_mesh(data=D, model=M), ADAGRAD)
    ranks = _case_out(out[world], "dense")
    for r in ranks[1:]:  # replicated leaves bit-equal on every rank
        for k in r:
            if k.startswith(("params/relation", "opt/relation", "loss")):
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = _assembled(ranks, D, M)
    np.testing.assert_allclose(got["loss_sum"], want_loss, rtol=RTOL)
    _close(got, want)
    assert ranks[0]["slab/entity_embedding"].tolist() == [0, 5, 10]


@pytest.mark.parametrize("world", list(WORLDS))
def test_full_vocabulary_kl_clip_step_matches_one_process(runs, world):
    """Lookup ComplEx with batchnorm and the cubic regularizer over the full
    vocabulary of an odd 303 entities (slabs 152 / 151), KL loss and a
    gradient clip that binds: each rank's block of the columns, the KL
    softmax over the model group, the clip's norm over the slabs.  SGD, whose
    update is linear in the gradient, so the parameters show it."""
    out, cases, refs = runs
    D, M = WORLDS[world]
    synth, batches, start = refs["full_kl"]
    case = cases["full_kl"]
    one, one_loss = _port_one(synth, "LookupComplexRelationModel", case["model_config"], start, batches, SGD,
                              loss_type="kl", grad_clip=0.05)
    ranks = _case_out(out[world], "full_kl")
    assert ranks[0]["slab/entity_embedding"].tolist() == [0, 152, 303]
    assert ranks[M - 1]["slab/entity_embedding"].tolist() == [152, 303, 303] if M == 2 else True
    got = _assembled(ranks, D, M)
    np.testing.assert_allclose(got["loss_sum"], one_loss, rtol=RTOL)
    _close(got, one)
    unclipped, _ = _port_one(synth, "LookupComplexRelationModel", case["model_config"], start, batches, SGD,
                             loss_type="kl")
    assert not np.allclose(unclipped["params/entity_embedding"], one["params/entity_embedding"])  # the clip binds


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("tag", ["plan", "dedup"])
def test_sparse_lstm_step_matches_jax_mesh(runs, world, tag):
    """The row-sparse LSTM-ComplEx step: the candidates' gather-sum plans
    stacked over ``model``, the entity token table's [U, d] rows read from
    the slabs and each rank's row update on the uids its slab owns."""
    out, _, refs = runs
    D, M = WORLDS[world]
    jmodel, jv, batches, plan_kw = refs[f"sparse_{tag}"]
    mesh = jax_make_mesh(data=D, model=M)
    planner = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", mesh=mesh, **plan_kw)
    want, want_loss = _jax_steps(jmodel, jax.tree_util.tree_map(jnp.copy, jv), batches, mesh, ADAGRAD, planner,
                                 model_mesh=True)
    ranks = _case_out(out[world], f"sparse_{tag}")
    got = _assembled(ranks, D, M)
    np.testing.assert_allclose(got["loss_sum"], want_loss, rtol=RTOL)
    _close(got, want, rtol=2e-5, atol=1e-4)
    if tag == "dedup":
        assert got["params/entity_token_embedding"].shape == want["params/entity_token_embedding"].shape


def test_planted_world_wide_model_reduce_fails(runs):
    """The dense case on the 2 x 2 world with the model group's collectives
    taken over the world (the boundary gather, the candidates' batchnorm):
    it must fail the comparison the real run passes."""
    out, _, refs = runs
    jmodel, jv, batches, _ = refs["dense"]
    want, want_loss = _jax_steps(jmodel, jax.tree_util.tree_map(jnp.copy, jv), batches, jax_make_mesh(2, 2), ADAGRAD)
    got = _assembled(_case_out(out["2x2"], "dense_planted"), 2, 2)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got["loss_sum"], want_loss, rtol=RTOL)
        _close(got, want)


@pytest.mark.parametrize("world", list(WORLDS))
def test_block_ranking_equals_one_process_and_jax(runs, world):
    """Full-vocabulary filtered ranking over the model group's blocks of 101
    candidates (51 / 50, chunks of 16) on exact scores with ties across
    blocks: ranks equal to the world of one's and JAX's, the BCE and KL
    losses within rtol 1e-5, the filtered top-k equal."""
    out, cases, _ = runs
    c = cases["eval"]["case"]
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items() if isinstance(v, np.ndarray)}
    scores = t["q"] @ t["cand"].t()
    golds = [t[k] for k in ("filter_rows", "filter_cols", "gold_rows", "gold_mention_cols")]
    want, gv = ranks_from_scores(scores, *golds, t["col_valid"])
    jranks, _ = jax_ranks_from_scores(jnp.asarray(scores.numpy()), *[jnp.asarray(g.numpy()) for g in golds],
                                      jnp.asarray(c["col_valid"]))
    np.testing.assert_array_equal(want.numpy(), np.asarray(jranks))
    n_real = torch.tensor(c["n_real"])
    for r in _case_out(out[world], "eval"):
        np.testing.assert_array_equal(r["gold_valid"], gv.numpy())
        valid = gv.numpy()
        for loss_type in ("bce", "kl"):  # a gold that is not ranked has no rank to compare
            np.testing.assert_array_equal(r[f"{loss_type}_ranks"][valid], want.numpy()[valid], err_msg=loss_type)
            loss, _ = one_vs_n_loss(loss_type, scores, t["pos_rows"], t["pos_cols"], t["row_valid"], t["col_valid"],
                                    n_real)
            np.testing.assert_allclose(r[f"{loss_type}_loss"], loss.numpy(), rtol=1e-5, err_msg=loss_type)
        ts, tc = filtered_topk(scores, golds[0], golds[1], t["col_valid"], 5)
        np.testing.assert_array_equal(r["top_scores"], ts.numpy())
        np.testing.assert_array_equal(r["top_cols"], tc.numpy())


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("source", ["port", "single", "jax"])
def test_checkpoints_load_into_slabs(runs, world, source):
    """The port's per-shard save (slabs written by the ranks of data index
    0, replicated leaves by rank 0), a single-file checkpoint and JAX's data
    = 4 x model = 2 slabs each load into an M = 2 run's slabs leaf for leaf;
    JAX's reader reads the port's slabs as the assembled leaves."""
    out, _, refs = runs
    D, M = WORLDS[world]
    ranks = _case_out(out[world], "ckpt")
    own_ranks = [{**{k[4:]: v for k, v in r.items() if k.startswith("own/")},
                  **{k: v for k, v in r.items() if k.startswith("slab/")}} for r in ranks]
    own = {k: _whole(own_ranks, k, D, M) for k in own_ranks[0] if not k.startswith("slab/")}
    want = own if source == "port" else refs["ckpt"]
    assert set(want) == {k.split("/", 1)[1] for k in ranks[0] if k.startswith(source + "/")}
    for r, o in enumerate(ranks):
        lo, hi, n = (int(x) for x in o["slab/entity_token_embedding"])
        for k, w in want.items():
            g = o[f"{source}/{k}"]
            if g.shape != w.shape:  # a slab: this rank's rows
                assert w.shape[0] == n, k
                w = w[lo:hi]
            np.testing.assert_array_equal(g, w, err_msg=f"{source} {k} rank {r}")
    if source == "port":
        path = str(ranks[0]["path"])
        names = sorted(os.listdir(path))
        assert names == sorted([f"arrays.p{r}.npz" for r in range(D * M)] + [f"index.p{r}.json" for r in range(D * M)]
                               + ["meta.json"]), names
        reader = jax_ckpt.open_checkpoint_reader(path)
        for k, w in own.items():
            np.testing.assert_array_equal(np.asarray(reader.read_full(k)), w, err_msg=k)


@pytest.mark.parametrize("world", list(WORLDS))
def test_candidate_cache_blocks_match_one_process(runs, world):
    """A token model's full-vocabulary cache on a model axis: each rank
    encodes its slab's entities (the token table gathered from the slabs)
    and the eval step ranks one batch over the group's blocks; and a
    batch-shared validation batch, each rank encoding its block of the
    batch's candidates: the rows and the stats of the world of one."""
    from open_knowledge_graph_embeddings_tpu_torch.train.step import eval_batch_to_arrays, make_eval_step

    out, cases, refs = runs
    case = cases["cache"]
    model = build_model(case["model"], load_meta(case["dataset_dir"], cache_dir=case["cache_dir"]),
                        **case["model_config"])
    v = model.init(torch.Generator().manual_seed(0))
    v.update(variables_from_jax_arrays(case["variables"]))
    cache = model.candidate_cache(v)
    vbatch, sbatch = refs["cache"]
    step = make_eval_step(model)
    want = step(v, arrays_to_device(eval_batch_to_arrays(vbatch), "cpu"), cache).numpy()
    want_shared = step(v, arrays_to_device(eval_batch_to_arrays(sbatch), "cpu")).numpy()
    assert sbatch.candidate_ids is not None and want_shared[0] > 0
    for r in _case_out(out[world], "cache"):
        lo, hi = r["block"]
        np.testing.assert_allclose(r["cache"], cache.numpy()[lo:hi], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["packed"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["shared"], want_shared, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("key", ["cli", "cli_shared"])
def test_cli_train_on_the_model_axis_matches_one_process(runs, world, key):
    """``cli.train`` with ``model_parallel: 2`` (lookup ComplEx, the full
    vocabulary of the toy set, JAX's test_cli_trains_on_mesh): it trains,
    evaluates by data group, writes a per-shard checkpoint whose entity
    table chunks are the table's halves, and gives the world of one's
    parameters, training losses and validation metrics; with batch-shared
    training and validation (``cli_shared``) each rank encodes and ranks its
    block of a batch's candidates (with several data groups the validation
    batches, and so their negatives, are each group's own, as in the JAX
    package's host-sharded eval: its metrics are not the world of one's)."""
    out, _, refs = runs
    D, M = WORLDS[world]
    one = refs[f"{key}_one"]
    ranks = _case_out(out[world], key)
    E = one.variables["params"]["entity_embedding"].shape[0]
    for r, o in enumerate(ranks):
        assert int(o["steps"]) == one.training_steps > 0
        assert o["slab/entity_embedding"].tolist() == list(slab_bounds(E, M, r % M)) + [E]
        assert tuple(o["host_shard"]) == ((r // M, D) if D > 1 else (-1, -1))
        np.testing.assert_allclose(o["training_loss"], ranks[0]["training_loss"], rtol=0, atol=0)
    want = {**flatten_arrays(one.variables["params"], "params"), **flatten_arrays(one.opt_state, "opt")}
    got = {k: _whole(ranks, k, D, M) for k in want}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    rows = [r for r in one.results.to_dicts() if "validation_mrr" in r]
    assert len(rows) == len(ranks[0]["validation_mrr"]) > 0
    if key == "cli" or D == 1:
        np.testing.assert_allclose(ranks[0]["validation_mrr"], [r["validation_mrr"] for r in rows], rtol=1e-5)
        np.testing.assert_allclose(ranks[0]["validation_loss"], [r["validation_loss"] for r in rows], rtol=1e-5)
    else:  # each data group builds its slice's batches and draws their negatives: other candidate sets
        assert all(0 < x <= 1 for x in ranks[0]["validation_mrr"]), ranks[0]["validation_mrr"]
    for o in ranks[1:]:  # a model group's ranks report the group's metrics, the data groups' sums
        np.testing.assert_array_equal(o["validation_mrr"], ranks[0]["validation_mrr"])
    np.testing.assert_allclose(ranks[0]["training_loss"],
                               [r["training_loss"] for r in one.results.to_dicts() if "training_loss" in r], rtol=1e-5)
    ck = str(ranks[0]["checkpoint"])
    reader = open_checkpoint_reader(ck)
    chunks = reader.index["params/entity_embedding"]["chunks"]
    assert sorted((c["start"][0], c["stop"][0]) for c in chunks) == [slab_bounds(E, M, m) for m in range(M)]
    np.testing.assert_array_equal(reader.read_full("params/entity_embedding"), got["params/entity_embedding"])


def test_variables_and_opt_state_shardings_match_jax(toy_dataset_dir):
    """Which leaves a model axis shards: the port's ``variables_shardings``
    and ``opt_state_shardings`` name JAX's row-sharded parameters and their
    accumulators (``model``) and leave the rest, the step scalars included,
    whole, on a 1 x 2 mesh; on a 1 x 1 mesh nothing is sharded."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import make_mesh
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import opt_state_shardings, variables_shardings

    jds, pds = _datasets(toy_dataset_dir, batch_size=4)
    for name, cfg in (("LSTMComplexRelationModel", CKPT_CONFIG), ("LookupComplexRelationModel", LOOKUP_CFG)):
        jmodel = jax_build_model(name, jds.meta, **cfg)
        jv = jmodel.init(jax.random.key(0))
        reg = JaxRegimes(ADAGRAD)
        reg.update(1, 0)
        jopt = reg.init_state(jv["params"])
        jmesh = jax_make_mesh(data=1, model=2)
        jvs = jax_var_shardings(jv, jmesh)
        flat = {}
        for top in ("params", "state"):
            for path, sh in jax.tree_util.tree_flatten_with_path(jvs[top], is_leaf=lambda x: hasattr(x, "spec"))[0]:
                key = "/".join(str(getattr(p, "key", p)) for p in path)
                flat[f"{top}/{key}"] = tuple(sh.spec)[0] if tuple(sh.spec) else None
        for path, sh in jax.tree_util.tree_flatten_with_path(jax_opt_shardings(jopt, jvs, jmesh),
                                                             is_leaf=lambda x: hasattr(x, "spec"))[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            flat[f"opt/{key}"] = tuple(sh.spec)[0] if tuple(sh.spec) else None
        model = build_model(name, pds.meta, **cfg)
        v = model.init(torch.Generator().manual_seed(0))
        ropt = OptimizerRegimes(ADAGRAD)
        ropt.update(1, 0)
        opt = ropt.init_state(v["params"])
        got = variables_shardings(v, make_mesh(1, 2, 0))
        got.update(opt_state_shardings(opt, got))
        assert got == flat, name
        assert "model" in got.values()
        none = variables_shardings(v, make_mesh(1, 1, 0))
        assert set(opt_state_shardings(opt, none).values()) | set(none.values()) == {None}


def test_model_axis_without_a_world_raises(toy_dataset_dir, tmp_path):
    """``model_parallel: 2`` in one process has no model group to split the
    tables over: ``cli.train`` raises, with no quiet return to one rank."""
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import main as port_main
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    args = load_config()
    args.update(_cli_args(toy_dataset_dir, str(tmp_path / "exp"), 2))
    with pytest.raises(ValueError, match="model groups of 2"):
        port_main(args, device="cpu")
