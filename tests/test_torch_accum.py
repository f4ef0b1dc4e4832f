"""Gradient accumulation in the torch port against the JAX package on the
CPU: the window plans of the row-sparse path (one union row space per
window), the dense and the row-sparse accumulate-then-apply steps after two
windows of two micro-batches, and ``cli.train`` with
``batch_size_for_backward = 2 x batch_size`` over three epochs (the
training loss row by row, and what carries across the epoch boundaries).

Inputs are made from numpy seeds (the data sets, the batch order); JAX
weights cross over through ``variables_from_jax_arrays``; dropout is 0 and
everything is f32.  SGD keeps the parameter comparison exact up to f32
summation order (Adagrad's first step turns f32 noise on a near-zero
gradient entry into ±lr).  Tolerances (``TOL``): the lookup model's
gradients sum a few products and are held to rtol 1e-5, atol 1e-6; the
LSTM's sum over every row and step in another order than XLA's, and are
held to rtol 1e-4 (tests/test_torch_train_ops.py's rule for such
gradients) with an atol of 1e-4 of the leaf's largest |value|, as are the
parameters, statistics and losses they move (measured: the summed
gradients up to 4.6e-5 of their largest, parameters 2.6e-5, the first
window's losses 5e-7 off JAX's, the second's 2e-5)."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.models.model import KGEModel as JaxKGEModel
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_accum_steps as jax_sparse_accum
from open_knowledge_graph_embeddings_tpu.train.step import make_accum_steps as jax_accum
from open_knowledge_graph_embeddings_tpu.train.step import train_batch_to_arrays as jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel, build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_accum_steps
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    make_accum_steps,
    make_train_step,
    train_batch_to_arrays,
)
from test_torch_train_step import ROOT, _slot_sets, synth_dir  # noqa: F401  (synth_dir is a fixture)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

SGD = {"optimizer": "SGD", "lr": 0.1}
TOL = {"lookup": dict(rtol=1e-5, atol=1e-6), "lstm": dict(rtol=1e-4, atol=1e-4)}
MODELS = {"lookup": ("LookupComplexRelationModel", dict(entity_slot_size=8, init_std=0.1, sparse=True)),
          "lstm": ("LSTMComplexRelationModel", dict(entity_slot_size=16, init_std=0.1, sparse=True, dropout=0.0,
                                                    normalize="batchnorm"))}


def _setup(path, kind, tag):
    """Both packages' dataset, model and weights (JAX's init) on ``path``:
    the toy set (10 prefixes) in batches of 2 with 6 batch-shared
    candidates, the synthetic one in batches of 8 with 12."""
    batch_size, n_cands = (2, 6) if "toy" in path else (8, 12)
    cfg = dict(input_file="train.txt", is_training_data=True, batch_size=batch_size, use_batch_shared_entities=True,
               min_size_batch_labels=n_cands, max_size_prefix_label=4)
    j = JaxDataset(dataset_dir=path, cache_dir=f"{path}/jax_{tag}", **cfg)
    p = OneToNMentionRelationDataset(dataset_dir=path, cache_dir=f"{path}/port_{tag}", **cfg)
    name, mcfg = MODELS[kind]
    jmodel, model = jax_build_model(name, j.meta, **mcfg), build_model(name, p.meta, **mcfg)
    jv = jmodel.init(jax.random.key(0))
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays({**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}))
    return p, jmodel, jv, model, pv


def _windows(p, n=2, k=2, seed=4):
    batches = list(BatchBuilder(p, seed=seed).batches(shuffle=True))
    assert len(batches) >= n * k
    return [batches[i * k: (i + 1) * k] for i in range(n)]


def _assert_plans_equal(jds, pds):
    for jd, pd in zip(jds, pds, strict=True):
        assert set(pd) == set(jd)
        for k in jd:
            if not k.startswith("sparse/plan/"):
                np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
        for kind in ("entity", "relation"):
            if f"sparse/plan/{kind}_token/pos" in jd:
                assert _slot_sets(pd, kind) == _slot_sets(jd, kind)


@pytest.mark.parametrize("kind,ratio", [("lookup", 0.0), ("lstm", 0.0), ("lstm", 12.0)],
                         ids=["lookup", "lstm", "lstm-dense-fallback"])
def test_plan_window_matches_jax(toy_dataset_dir, synth_dir, kind, ratio):  # noqa: F811
    """Every array of both windows' plans equals JAX's (the gather-sum
    slots as sets per uid): the shared union uids and valid masks, the
    remapped ids and token matrices, no query dedup; at ratio 12 the small
    tables fall back to dense and no plan key is emitted."""
    path = toy_dataset_dir if kind == "lookup" else synth_dir
    p, jmodel, _, model, _ = _setup(path, kind, f"plan_{kind}")
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", min_rows_ratio=ratio)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=ratio)
    for window in _windows(p):
        jds, pds = jplan.plan_window(window), plan.plan_window(window)
        _assert_plans_equal(jds, pds)
        uid_keys = [k for k in pds[0] if k.endswith("/uids")]
        assert bool(uid_keys) == (ratio == 0.0)
        for k in uid_keys:  # one union plan for the whole window
            assert all(np.array_equal(d[k], pds[0][k]) for d in pds)
        assert not any(k.startswith("dedup/") for d in pds for k in d)


def _flagship_window(tmp_path):
    """A window of four 4096-prefix micro-batches with 4096 batch-shared
    candidates over the flagship's token vocabularies (200,000 and 50,000
    tokens, lengths 10) and its 50,000 relations."""
    d = tmp_path / "flagship_shaped"
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d), "--mentions", "100000",
                    "--relations", "50000", "--triples", "40000", "--ent-tokens", "200000", "--rel-tokens", "50000",
                    "--eval-size", "20", "--seed", "3"], check=True, capture_output=True, timeout=120)
    cfg = dict(input_file="train.txt", is_training_data=True, batch_size=4096, use_batch_shared_entities=True,
               min_size_batch_labels=4096)
    p = OneToNMentionRelationDataset(dataset_dir=str(d), **cfg)
    cfgm = dict(entity_slot_size=512, sparse=True, dtype="bfloat16")
    jmodel = jax_build_model("LSTMComplexRelationModel", JaxDataset(dataset_dir=str(d), **cfg).meta, **cfgm)
    model = build_model("LSTMComplexRelationModel", p.meta, **cfgm)
    return list(BatchBuilder(p, seed=0).batches(shuffle=True))[:4], jmodel, model


def test_plan_window_flagship_shaped_matches_jax(tmp_path):
    """One synthetic flagship-shaped window: the plan arrays equal JAX's,
    and the sparsify rule (height >= 12 x next_bucket(union)) decides each
    token table: the relation token table goes dense (its union over 4 x
    4096 relations exceeds 4,096 rows, a twelfth of its height), the entity
    token table stays row-sparse (a union below 16,384)."""
    window, jmodel, model = _flagship_window(tmp_path)
    jds = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact").plan_window(window)
    pds = SparsePlanBuilder(model.embedder, entity_sparse=True).plan_window(window)
    _assert_plans_equal(jds, pds)
    meta = model.meta
    ent_union = np.union1d(0, np.concatenate([meta.entity_token_ids[np.concatenate([b.ent_ids, b.candidate_ids])]
                                              .ravel() for b in window]))
    rel_union = np.union1d(0, np.concatenate([meta.relation_token_ids[b.rel_ids].ravel() for b in window]))
    for table, union, height in (("entity_token_embedding", ent_union, meta.entity_tokens_size),
                                 ("relation_token_embedding", rel_union, meta.relation_tokens_size)):
        bucket = 1 << max(8, int(len(union) - 1).bit_length())
        assert (f"sparse/{table}/uids" in pds[0]) == (height >= 12 * bucket), (table, len(union), height)
    assert len(rel_union) > 4096 and "sparse/relation_token_embedding/uids" not in pds[0]
    assert len(ent_union) <= 16384 and "sparse/entity_token_embedding/uids" in pds[0]
    assert pds[0]["ent_ids"].shape == (4096,) and "dedup/ent_inv" not in pds[0]


def _close(got, want, kind, err_msg):
    """``TOL[kind]``: the lookup's atol absolute, the LSTM's a share of the
    leaf's largest |want|."""
    rtol, atol = TOL[kind]["rtol"], TOL[kind]["atol"]
    if kind == "lstm":
        atol *= float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=err_msg)


def _compare(jv, pv, kind, jopt=None, popt=None):
    """Every parameter, BN statistic (and optimizer leaf) of both packages."""
    want = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}
    got = {**flatten_arrays(pv["params"], "params"), **flatten_arrays(pv["state"], "state")}
    if jopt is not None:
        want.update(jax_flatten(jopt, "opt"))
        got.update(flatten_arrays(popt, "opt"))
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, kind, k)


@pytest.mark.parametrize("kind", ["lookup", "lstm"])
def test_dense_accumulation_matches_jax(toy_dataset_dir, synth_dir, kind):  # noqa: F811
    """The dense accumulation (every gradient summed over the window, one
    SGD update), two windows of two micro-batches: every parameter, BN
    statistic and optimizer leaf, and each micro-batch's loss, by ``TOL``
    (the LSTM's second-window losses read 2e-5 off JAX's: they see
    parameters moved by its gradients)."""
    path = toy_dataset_dir if kind == "lookup" else synth_dir
    p, jmodel, jv, model, pv = _setup(path, kind, f"dense_{kind}")
    jreg, preg = JaxRegimes(SGD), OptimizerRegimes(SGD)
    jreg.update(1, 0)
    preg.update(1, 0)
    jz, jg, ja = jax_accum(jmodel, jreg, jv["params"])
    pz, pg, pa = make_accum_steps(model, preg, pv["params"])
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    for window in _windows(p):
        jacc, pacc = jz(), pz()
        for b in window:
            jv, jacc, js = jg(jv, jacc, {k: jnp.asarray(v) for k, v in jax_arrays(b).items()}, jax.random.key(1))
            pv, pacc, ps = pg(pv, pacc, arrays_to_device(train_batch_to_arrays(b), "cpu"))
            assert float(ps["loss_sum"]) == pytest.approx(float(js["loss_sum"]), rel=TOL[kind]["rtol"])
        jv, jopt = ja(jv, jopt, jacc, jhp)
        pv, popt = pa(pv, popt, pacc, preg.hparams())
    _compare(jv, pv, kind, jopt, popt)


@pytest.mark.parametrize("kind", ["lookup", "lstm"])
def test_sparse_accumulation_matches_jax(toy_dataset_dir, synth_dir, kind):  # noqa: F811
    """The row-sparse accumulation on the window plans (the [U, d] row
    gradients summed in f32 on the union rows, one row update), two windows
    of two micro-batches: the summed row gradients, every leaf and each
    micro-batch's loss by ``TOL``."""
    path = toy_dataset_dir if kind == "lookup" else synth_dir
    p, jmodel, jv, model, pv = _setup(path, kind, f"sparse_{kind}")
    jreg, preg = JaxRegimes(SGD), OptimizerRegimes(SGD)
    jreg.update(1, 0)
    preg.update(1, 0)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", min_rows_ratio=0.0)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0)
    jz, jg, ja = jax_sparse_accum(jmodel, jreg, jv["params"], entity_sparse=True)
    pz, pg, pa = make_sparse_accum_steps(model, preg, pv["params"], entity_sparse=True)
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    for window in _windows(p):
        jarrs = [{k: jnp.asarray(v) for k, v in d.items()} for d in jplan.plan_window(window)]
        parrs = [arrays_to_device(d, "cpu") for d in plan.plan_window(window)]
        jacc, pacc = jz(jarrs[0]), pz(parrs[0])
        assert set(pacc["rows"]) == set(jacc["rows"]) and pacc["rows"]
        for jarr, parr in zip(jarrs, parrs):
            jv, jacc, js = jg(jv, jacc, jarr, jax.random.key(1))
            pv, pacc, ps = pg(pv, pacc, parr)
            assert float(ps["loss_sum"]) == pytest.approx(float(js["loss_sum"]), rel=TOL[kind]["rtol"])
        for t, acc in pacc["rows"].items():
            _close(acc.numpy(), np.asarray(jacc["rows"][t]), kind, t)
        jv, jopt = ja(jv, jopt, jacc, jarrs[-1], jhp)
        pv, popt = pa(pv, popt, pacc, parrs[-1], preg.hparams())
    _compare(jv, pv, kind, jopt, popt)


def test_accumulation_equals_one_update_of_the_summed_gradients(toy_dataset_dir):
    """In the port alone: two micro-batches accumulated and applied once
    equal one SGD update by the sum of each micro-batch's gradient at the
    same parameters (the params do not move between micro-batches)."""
    p, _, _, model, pv = _setup(toy_dataset_dir, "lookup", "sum")
    reg = OptimizerRegimes(SGD)
    reg.update(1, 0)
    b1, b2 = _windows(p, n=1)[0]
    grads = []
    for b in (b1, b2):  # each micro-batch's gradient alone: lr 1 SGD on a copy, read back
        v = {"params": {k: t.clone() for k, t in pv["params"].items()}, "state": pv["state"], "buffers": pv["buffers"]}
        one = OptimizerRegimes({"optimizer": "SGD", "lr": 1.0})
        one.update(1, 0)
        v2, _, _ = make_train_step(model, one, v["params"])(v, one.init_state(v["params"]), one.hparams(),
                                                            arrays_to_device(train_batch_to_arrays(b), "cpu"))
        grads.append({k: pv["params"][k] - v2["params"][k] for k in pv["params"]})
    want = {k: pv["params"][k] - SGD["lr"] * (grads[0][k] + grads[1][k]) for k in pv["params"]}
    z, g, a = make_accum_steps(model, reg, pv["params"])
    acc = z()
    for b in (b1, b2):
        pv, acc, _ = g(pv, acc, arrays_to_device(train_batch_to_arrays(b), "cpu"))
    pv, _ = a(pv, reg.init_state(pv["params"]), acc, reg.hparams())
    for k, w in want.items():
        np.testing.assert_allclose(pv["params"][k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


CLI_CASES = {
    # full vocabulary, dense lookup tables: 5 batches of 2 a pass (odd), the accumulator carries
    "dense-lookup": dict(model="LookupComplexRelationModel",
                         model_config={"entity_slot_size": 8, "init_std": 0.1, "dropout": 0.0},
                         train_data_config={"input_file": "train.txt", "batch_size": 2,
                                            "use_batch_shared_entities": False}, batch_size=2),
    # batch-shared LSTM with row-sparse token tables: the batches of an unfinished window carry
    "sparse-lstm": dict(model="LSTMComplexRelationModel",
                        model_config={"entity_slot_size": 8, "init_std": 0.1, "sparse": True, "dropout": 0.0},
                        train_data_config={"input_file": "train.txt", "batch_size": 2,
                                           "use_batch_shared_entities": True, "min_size_batch_labels": 6},
                        batch_size=2, sparse_min_ratio=0.0),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_accumulation_matches_jax(toy_dataset_dir, tmp_path, monkeypatch, case):
    """``cli.train`` of both packages with ``batch_size_for_backward`` = 2 x
    ``batch_size`` over three epochs from the same weights (JAX's init,
    carried across by ``variables_from_jax_arrays``): the training loss row
    by row to rtol 1e-5, ``training_steps`` (micro-batches) and the state
    that carries across the epoch boundaries (the accumulator's count on
    the dense path, the unfinished window on the sparse path) equal to
    JAX's, and the final parameters to rtol 1e-5."""
    common = dict(dataset_dir=toy_dataset_dir, epochs=3, batch_size_for_backward=4, eval_epoch_freq=0,
                  eval_freq=-1, save_epoch_freq=100, print_freq=1, workers=2, seed=1,
                  optimization_config={"optimizer": "SGD", "lr": 0.5}, **CLI_CASES[case])
    inits = []
    orig = JaxKGEModel.init

    def record_init(self, rng):  # copies: the JAX step donates the variables' buffers
        v = orig(self, rng)
        inits.append({n: np.array(a) for k in ("params", "state") for n, a in jax_flatten(v[k], k).items()})
        return v

    monkeypatch.setattr(JaxKGEModel, "init", record_init)
    args = jax_load_config()
    args.update(common, experiment_dir=str(tmp_path / "jax"))
    jtrainer = jax_main(args)
    port_init = KGEModel.init
    monkeypatch.setattr(KGEModel, "init", lambda self, gen: {**port_init(self, gen),
                                                             **variables_from_jax_arrays(inits[0])})
    path = tmp_path / "port.yaml"
    path.write_text(yaml.safe_dump({**common, "experiment_dir": str(tmp_path / "port")}))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])

    def losses(t):
        return [r["training_loss"] for r in t.results.to_dicts() if "training_loss" in r]

    assert trainer.accum_steps == jtrainer.accum_steps == 2
    np.testing.assert_allclose(losses(trainer), losses(jtrainer), rtol=1e-5)
    assert len(losses(trainer)) == 3
    assert trainer.training_steps == jtrainer.training_steps
    assert trainer._accum_i == jtrainer._accum_i
    assert len(trainer._window_buf) == len(jtrainer._window_buf)
    if case == "dense-lookup":  # 5 batches a pass: 15 micro-batches, 7 updates, one carried
        assert trainer.training_steps == 15 and trainer._accum_i == 1
    else:  # the sparse path trains whole windows only; the rest waits for the next pass
        assert trainer._accum_i == 0 and trainer.training_steps % 2 == 0
        assert sum(s["applied"] for s in trainer.step_log) == trainer.training_steps // 2
    _compare(jtrainer.variables, trainer.variables, "lookup")
