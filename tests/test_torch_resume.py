"""Resuming in the torch port against the JAX package on the CPU:
``load_checkpoint`` of a JAX-written checkpoint with ``resume_filter``,
``weight_map`` (a rename, a collision the renamed key wins, a shape
mismatch skipped) and ``load_optimizer``; ``cli.train --resume`` with
``resume_filter`` and ``resume_freeze`` (``Trainer.load``: newly frozen
leaves take the empty optimizer state, the others keep what was loaded);
and a config with a ``weight_map`` key, which the JAX CLI never reads and
the port's CLI refused until it read it the same way.

The checkpoint holds JAX's weights and Adagrad state drawn from a numpy
seed; both packages load it into the same targets (JAX's init carried
across by ``variables_from_jax_arrays``), so every array must be exactly
equal."""

import numpy as np
import pytest
import torch
import yaml

import jax

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    flatten_arrays,
    load_checkpoint,
    unflatten_arrays,
    variables_from_jax_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.train.trainer import _state_nodes

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


@pytest.fixture(scope="module")
def jax_checkpoint(toy_dataset_dir, tmp_path_factory):
    meta = jax_load_meta(toy_dataset_dir, (10, 10), cache_dir=toy_dataset_dir + "/resume_cache")
    v, opt = _jax_tree(meta, seed=11)
    d = tmp_path_factory.mktemp("resume_ckpt")
    path = jax_ckpt.save_checkpoint(str(d), "ck", v, opt, {"training_steps": 7})
    return meta, path


CASES = {
    "all": dict(),
    "filter": dict(resume_filter=["lstm", "bn"]),
    "weight-map": dict(weight_map={
        # a rename onto a key the checkpoint also holds: the renamed one wins
        "params/entity_lstm/w_ih": "params/relation_lstm/w_ih",
        # a rename onto a leaf of another shape: skipped, the identity entry loads
        "params/entity_token_embedding": "params/relation_token_embedding",
        # a rename of an optimizer leaf
        "opt/entity_lstm/b_ih/sum": "opt/relation_lstm/b_ih/sum"}),
    "filter-map-no-optimizer": dict(resume_filter=["relation"], weight_map={
        "params/entity_lstm/w_hh": "params/relation_lstm/w_hh"}, load_optimizer=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_checkpoint_matches_jax(jax_checkpoint, case):
    """``load_checkpoint`` of both packages on a JAX-written checkpoint
    into the same targets: every params, state and opt array exactly equal
    to JAX's, and the meta the same."""
    meta, path = jax_checkpoint
    jv, jopt = _jax_tree(meta, seed=0)
    want_v, want_opt, want_meta = jax_ckpt.load_checkpoint(path, jv, jopt, **CASES[case])
    targets = {**jax_ckpt.flatten_arrays(jv["params"], "params"), **jax_ckpt.flatten_arrays(jv["state"], "state")}
    pv = variables_from_jax_arrays(targets)
    popt = unflatten_arrays(jax_ckpt.flatten_arrays(jopt, "opt"), "opt")
    got_v, got_opt, got_meta = load_checkpoint(path, pv, popt, **CASES[case])
    want = {**jax_ckpt.flatten_arrays(want_v["params"], "params"), **jax_ckpt.flatten_arrays(want_v["state"], "state"),
            **jax_ckpt.flatten_arrays(want_opt, "opt")}
    got = {**flatten_arrays(got_v["params"], "params"), **flatten_arrays(got_v["state"], "state"),
           **flatten_arrays(got_opt, "opt")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got_meta == want_meta
    with np.load(f"{path}/arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    loaded = {k for k in want if k in saved and np.array_equal(want[k], saved[k])}
    renamed = {k for k in want if any(np.array_equal(want[k], saved[c]) for c in saved if c != k)}
    if case == "filter":
        assert all(("lstm" in k or "bn" in k) for k in loaded if k.startswith("params/"))
        assert "params/entity_token_embedding" not in loaded and "opt/entity_token_embedding/sum" in loaded
    if case == "weight-map":
        assert {"params/relation_lstm/w_ih", "opt/relation_lstm/b_ih/sum"} <= renamed
        assert "params/relation_token_embedding" in loaded  # the mismatched rename was skipped
    if case == "filter-map-no-optimizer":
        assert not any(k.startswith("opt/") for k in loaded | renamed)
        assert "params/relation_lstm/w_hh" in renamed and "params/entity_lstm/w_ih" not in loaded


def _config(toy_dataset_dir, exp_dir, **over):
    cfg = dict(dataset_dir=toy_dataset_dir, experiment_dir=str(exp_dir), model=MODEL, model_config=MODEL_CONFIG,
               optimization_config=OPT, batch_size=4, epochs=2, eval_epoch_freq=0, eval_freq=-1, print_freq=1,
               sparse_min_ratio=0.0, workers=2, seed=1,
               train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": True,
                                  "min_size_batch_labels": 6})
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("over", [
    dict(resume_filter=["lstm"], resume_freeze=["entity_lstm"]),
    dict(resume_freeze="token_embedding", weight_map={"params/entity_lstm/w_ih": "params/relation_lstm/w_ih"}),
], ids=["filter-freeze", "freeze-weight-map-key"])
def test_cli_resume_matches_jax(jax_checkpoint, toy_dataset_dir, tmp_path, monkeypatch, over):
    """``cli.train --resume`` (``train: false``) of both packages from the
    same init: the filtered-in leaves equal the checkpoint's and the rest
    the init, the optimizer state equal to JAX's leaf by leaf (``{}`` for
    the newly frozen leaves, the loaded state for the others), the frozen
    patterns and step count JAX's; a ``weight_map`` key in the config is
    read by neither CLI (the JAX CLI passes only ``resume_filter`` and
    ``resume_freeze`` to ``Trainer.load``).  Then ``Trainer.load`` again
    with a ``freeze_param`` pattern the trainers did not freeze yet, and a
    ``weight_map``: the same comparison."""
    _, path = jax_checkpoint
    from open_knowledge_graph_embeddings_tpu.models.model import KGEModel as JaxKGEModel

    inits = []
    orig = JaxKGEModel.init

    def record_init(self, rng):
        v = orig(self, rng)
        inits.append({n: np.array(a) for k in ("params", "state") for n, a in jax_ckpt.flatten_arrays(v[k], k).items()})
        return v

    monkeypatch.setattr(JaxKGEModel, "init", record_init)
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, tmp_path / "jax", resume=path, train=False, **over))
    jtrainer = jax_main(args)
    port_init = KGEModel.init
    monkeypatch.setattr(KGEModel, "init", lambda self, gen: {**port_init(self, gen),
                                                             **variables_from_jax_arrays(inits[0])})
    cfg = tmp_path / "port.yaml"
    cfg.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / "port", resume=path, train=False, **over)))
    trainer = port_train.cli_main([str(cfg), "--device", "cpu"])

    got = _assert_trainers_equal(jtrainer, trainer)
    frozen = [p for p, s in _state_nodes(trainer.opt_state) if not s]
    assert frozen and all(("entity_lstm" in p) if "resume_filter" in over else ("token_embedding" in p)
                          for p in frozen)
    for t in (jtrainer, trainer):
        t.load(path, freeze_param=["relation_lstm/w_hh"], weight_map={"params/entity_bn/mean": "params/entity_bn/var"})
    _assert_trainers_equal(jtrainer, trainer)
    assert "relation_lstm/w_hh" in trainer.regimes.frozen_patterns and not trainer.opt_state["relation_lstm"]["w_hh"]
    assert trainer.opt_state["relation_lstm"]["w_ih"] or "resume_filter" not in over
    with np.load(f"{path}/arrays.npz") as z:
        for k in got:
            if k.startswith("params/"):
                from_ckpt = ("resume_filter" not in over) or "lstm" in k
                assert np.array_equal(got[k], z[k]) == from_ckpt, k
                assert np.array_equal(got[k], inits[0][k]) != from_ckpt, k


def _assert_trainers_equal(jtrainer, trainer):
    """Every params, state and optimizer array, the frozen patterns and the
    step count of the two trainers equal; returns the port's arrays."""
    want = {**jax_ckpt.flatten_arrays(jtrainer.variables["params"], "params"),
            **jax_ckpt.flatten_arrays(jtrainer.variables["state"], "state"),
            **jax_ckpt.flatten_arrays(jtrainer.opt_state, "opt")}
    got = {**flatten_arrays(trainer.variables["params"], "params"),
           **flatten_arrays(trainer.variables["state"], "state"), **flatten_arrays(trainer.opt_state, "opt")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert trainer.regimes.frozen_patterns == jtrainer.regimes.frozen_patterns
    assert trainer.training_steps == jtrainer.training_steps == 7
    return got
