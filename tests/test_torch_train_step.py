"""The torch port's training path against the JAX package on the CPU: the
host batches and sparse plans, the train-mode encodes, and one and three
whole sparse steps (query dedup and the gather-sum grad plan engaged:
``min_rows_ratio`` 0 so the small tables go sparse, ``dedup_bucket`` 8 so
the queries dedup), plus the port's sparse step against its own dense step.

Data: a small synthetic OLPBench-shaped set (tools/make_synth_olpbench.py)
and the toy set of tests/conftest.py.  JAX weights cross over through
``variables_from_jax_arrays``; dropout is 0.  Tolerances, stated where
used, are derived from f32 rounding (same products, other summation
order) or from utils/numerics.py's bf16 rule."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import open_knowledge_graph_embeddings_tpu.models.embedders as jax_embedders
from open_knowledge_graph_embeddings_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    make_train_step,
    train_batch_to_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE, assert_bf16_close

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

ROOT = pathlib.Path(__file__).resolve().parents[1]
D = 32
BATCH = 64
DATA_CFG = dict(input_file="train.txt", is_training_data=True, batch_size=BATCH,
                use_batch_shared_entities=True, min_size_batch_labels=64, max_size_prefix_label=4)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_train")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d),
         "--mentions", "300", "--relations", "30", "--triples", "400",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "2"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


def _datasets(path):
    j = JaxDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **DATA_CFG)
    p = OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/port_cache", **DATA_CFG)
    return j, p


def _assert_batches_equal(jb, pb):
    for name in ("ent_ids", "rel_ids", "is_sp", "row_valid", "candidate_ids", "col_valid", "pos_rows", "pos_cols"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name), err_msg=name)
    assert (pb.num_rows, pb.num_cols, pb.cand_offset, pb.normalizer_loss) == (
        jb.num_rows, jb.num_cols, jb.cand_offset, jb.normalizer_loss)


# ------------------------------------------------------------- host plans


def _assert_records_equal(got, want):
    for name in ("p1", "p2", "slot", "group_offsets", "mention_offsets", "mentions", "row_has_dup"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("which,max_prefix", [("synth", 4), ("toy", 1)], ids=["synth-split-4", "toy-split-1"])
def test_records_match_jax(synth_dir, toy_dataset_dir, which, max_prefix):
    """Prefix records of both directions, large prefixes split, dup flags;
    and each package reads the other's records cache (same npz, same key)."""
    path = synth_dir if which == "synth" else toy_dataset_dir
    cfg = dict(DATA_CFG, max_size_prefix_label=max_prefix)
    j = JaxDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **cfg)
    p = OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/port_cache", **cfg)
    _assert_records_equal(p.records, j.records)
    _assert_records_equal(OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **cfg).records,
                          j.records)
    _assert_records_equal(JaxDataset(dataset_dir=path, cache_dir=path + "/port_cache", **cfg).records, j.records)


@pytest.mark.parametrize("workers", [0, 3], ids=["one-stream", "workers"])
def test_train_batches_match_jax(synth_dir, workers):
    """Shuffled batch-shared batches with negative top-up, two epochs, from
    the one sequential stream and from per-batch streams on worker threads."""
    j, p = _datasets(synth_dir)
    jbb, pbb = JaxBatchBuilder(j, seed=5), BatchBuilder(p, seed=5)
    assert len(jbb) == len(pbb) >= 5
    for _ in range(2):
        jl = list(jbb.batches(shuffle=True, prefetch=2 if workers else 0, workers=max(workers, 1)))
        pl = list(pbb.batches(shuffle=True, prefetch=2 if workers else 0, workers=max(workers, 1)))
        assert len(jl) == len(pl)
        for jb, pb in zip(jl, pl):
            _assert_batches_equal(jb, pb)


def test_full_vocab_batches_match_jax(toy_dataset_dir):
    cfg = dict(DATA_CFG, use_batch_shared_entities=False, batch_size=4)
    j = JaxDataset(dataset_dir=toy_dataset_dir, cache_dir=toy_dataset_dir + "/jax_cache", **cfg)
    p = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, cache_dir=toy_dataset_dir + "/port_cache", **cfg)
    for jb, pb in zip(JaxBatchBuilder(j, seed=1).batches(shuffle=True), BatchBuilder(p, seed=1).batches(shuffle=True)):
        assert pb.candidate_ids is None
        np.testing.assert_array_equal(pb.pos_cols, jb.pos_cols)
        np.testing.assert_array_equal(pb.ent_ids, jb.ent_ids)
        assert pb.normalizer_loss == jb.normalizer_loss


def _plans(synth_dir, **kw):
    j, p = _datasets(synth_dir)
    jmodel = jax_build_model("LSTMComplexRelationModel", j.meta, entity_slot_size=D, sparse=True)
    model = build_model("LSTMComplexRelationModel", p.meta, entity_slot_size=D, sparse=True)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", **kw)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, **kw)
    batches = list(BatchBuilder(p, seed=3).batches(shuffle=True))
    return [(jplan(b), plan(b)) for b in batches]


def _slot_sets(d, kind):
    """{uid: sorted positions} of a gather-sum plan (slot order is free)."""
    pos, valid, uid = (d[f"sparse/plan/{kind}_token/{k}"] for k in ("pos", "valid", "uid"))
    out = {}
    for s in range(len(uid)):
        out.setdefault(int(uid[s]), []).extend(pos[s][valid[s]].tolist())
    return {u: sorted(v) for u, v in out.items() if v}


@pytest.mark.parametrize("ratio,dedup_bucket", [(0.0, 8), (12.0, 512)], ids=["sparse-dedup", "flagship-gates"])
def test_sparse_plans_match_jax(synth_dir, ratio, dedup_bucket):
    """Every array of the plan equals JAX's; the grad-plan slots as sets of
    positions per uid (the JAX package may assign slots natively)."""
    pairs = _plans(synth_dir, min_rows_ratio=ratio, dedup_bucket=dedup_bucket)
    engaged = set()
    for jd, pd in pairs:
        assert set(pd) == set(jd)
        for k in jd:
            if k.startswith("sparse/plan/"):
                continue
            np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
            engaged |= {k.split("/")[0]}
        for kind in ("entity", "relation"):
            if f"sparse/plan/{kind}_token/pos" in jd:
                assert _slot_sets(pd, kind) == _slot_sets(jd, kind)
                assert pd[f"sparse/plan/{kind}_token/pos"].shape == jd[f"sparse/plan/{kind}_token/pos"].shape
    if ratio == 0.0:
        assert {"sparse", "dedup"} <= engaged


# --------------------------------------------------------- train encodes


def _models(path, dtype, opt=None):
    j, p = _datasets(path)
    cfg = dict(entity_slot_size=D, normalize="batchnorm", dtype=dtype, sparse=True, init_std=0.1, dropout=0.0)
    jmodel = jax_build_model("LSTMComplexRelationModel", j.meta, **cfg)
    jv = jmodel.init(jax.random.key(0))
    model = build_model("LSTMComplexRelationModel", p.meta, **cfg)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays({**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}))
    return j, p, jmodel, jv, model, pv


def _run_jax(fn, fused, monkeypatch):
    if not fused:
        return fn()
    monkeypatch.setattr(jax_embedders, "lstm_fused_supported", lambda *a: True)
    with pltpu.force_tpu_interpret_mode():
        return fn()


@pytest.mark.parametrize("with_inv", [False, True], ids=["no-dedup", "dedup-inv"])
def test_encode_entity_pair_train_matches_jax(synth_dir, with_inv):
    """Train-mode pair encode (BN batch statistics per group, state threaded
    a then b): values and new running statistics."""
    _, _, jmodel, jv, model, pv = _models(synth_dir, "float32")
    rng = np.random.default_rng(9)
    a = rng.integers(2, model.meta.entities_size, 48).astype(np.int32)
    b = rng.integers(2, model.meta.entities_size, 24).astype(np.int32)
    inv = rng.integers(0, 24, 40).astype(np.int32) if with_inv else None
    kw = {} if inv is None else {"inv_b": jnp.asarray(inv)}
    wa, wb, wst, _ = jmodel.embedder.encode_entity_pair(jv, jnp.asarray(a), jnp.asarray(b), train=True, **kw)
    ga, gb, gst, _ = model.embedder.encode_entity_pair(
        pv, torch.from_numpy(a).long(), torch.from_numpy(b).long(), train=True,
        inv_b=None if inv is None else torch.from_numpy(inv).long())
    for got, want in ((ga, wa), (gb, wb)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(gst["entity_bn"][k].numpy(), np.asarray(wst["entity_bn"][k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ------------------------------------------------------------ whole step


def _jax_to_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _steps(synth_dir, dtype, opt, n_steps, monkeypatch, fused):
    j, p, jmodel, jv, model, pv = _models(synth_dir, dtype)
    jreg, preg = JaxRegimes(opt), OptimizerRegimes(opt)
    jreg.update(1, 0)
    preg.update(1, 0)
    kw = dict(min_rows_ratio=0.0, dedup_bucket=8)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", **kw)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, **kw)
    jstep = jax_sparse_step(jmodel, jreg, jv["params"], entity_sparse=True)
    pstep = make_sparse_train_step(model, preg, pv["params"], entity_sparse=True)
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    batches = list(BatchBuilder(p, seed=4).batches(shuffle=True))[:n_steps]
    jl, pl, flats = [], [], []
    for b in batches:
        jarr = {k: jnp.asarray(v) for k, v in jplan(b).items()}
        jv, jopt, jstats = _run_jax(lambda: jstep(jv, jopt, jhp, jarr, jax.random.key(0)), fused, monkeypatch)
        pv, popt, pstats = pstep(pv, popt, preg.hparams(), arrays_to_device(plan(b), "cpu"))
        jl.append(float(jstats["loss_sum"]) / b.normalizer_loss)
        pl.append(float(pstats["loss_sum"]) / b.normalizer_loss)
        jflat = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state"),
                 **jax_flatten(jopt, "opt")}
        pflat = {k: v.copy() for k, v in {**flatten_arrays(pv["params"], "params"),
                                            **flatten_arrays(pv["state"], "state"),
                                            **flatten_arrays(popt, "opt")}.items()}  # CPU views: copy
        assert set(pflat) == set(jflat)
        flats.append((jflat, pflat))
    return np.array(jl), np.array(pl), flats


@pytest.mark.parametrize("n_steps", [1, 3])
def test_sparse_sgd_steps_match_jax(synth_dir, monkeypatch, n_steps):
    """f32, SGD (exact parameter parity: no ±lr flips): every parameter,
    BN statistic and optimizer leaf to 2e-5 after one and three steps."""
    jl, pl, flats = _steps(synth_dir, "float32", {"optimizer": "SGD", "lr": 0.5}, n_steps, monkeypatch,
                           fused=False)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jflat, pflat = flats[-1]
    for k, want in jflat.items():
        np.testing.assert_allclose(pflat[k], want, rtol=2e-5, atol=2e-5, err_msg=k)


def test_sparse_adagrad_steps_match_jax(synth_dir, monkeypatch):
    """f32, Adagrad lr 0.2 with weight decay (lazy on the token rows): the
    loss trajectory over three steps and the accumulators.  Parameters are
    compared only where |g| is well above f32 noise: Adagrad's first step
    turns any nonzero gradient entry into ±lr."""
    opt = {"optimizer": "Adagrad", "lr": 0.2, "weight_decay": 1e-4}
    jl, pl, flats = _steps(synth_dir, "float32", opt, 3, monkeypatch, fused=False)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jflat, pflat = flats[-1]
    for k, want in jflat.items():
        if k.startswith("opt/") and k.endswith("/sum"):
            # sums of squared gradients: relative to each leaf's largest accumulator
            np.testing.assert_allclose(pflat[k], want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), err_msg=k)
        elif k.endswith("/step"):
            np.testing.assert_array_equal(pflat[k], want, err_msg=k)


def test_sparse_steps_bf16_fused_match_jax(synth_dir, monkeypatch):
    """bf16 with JAX's fused Pallas path forced (interpret mode), SGD lr 0.5:
    each parameter's first update (new - old) rounded to bf16 against JAX's
    under the bf16 rule with the 2 % share of another summation order (one
    element of a 128-element bias is 0.8 %; measured at most 0.8 %), and the
    loss of two steps to rtol 1e-3 (measured 2.3e-5).  Later steps are
    chaotic at bf16: noise at f32 rounding level on JAX's own initial
    weights moves its later losses by more than the port differs from it
    (checked once against a perturbed JAX run), so they are no test of the
    port."""
    before = {k: v.copy() for k, v in jax_flatten(_models(synth_dir, "bfloat16")[3]["params"], "params").items()}
    jl, pl, flats = _steps(synth_dir, "bfloat16", {"optimizer": "SGD", "lr": 0.5}, 2, monkeypatch, fused=True)
    np.testing.assert_allclose(pl, jl, rtol=1e-3)
    jflat, pflat = flats[0]
    for k, old in before.items():
        bf = lambda a: torch.from_numpy(np.ascontiguousarray(a - old)).to(torch.bfloat16)  # noqa: E731
        assert_bf16_close(bf(pflat[k]), bf(jflat[k]), MAX_UNEQUAL_SHARE)


@pytest.mark.parametrize("opt", [{"optimizer": "SGD", "lr": 0.5}, {"optimizer": "Adagrad", "lr": 0.2}],
                         ids=["sgd", "adagrad"])
def test_sparse_matches_dense_in_port(synth_dir, opt):
    """The port's sparse step (row plans and the gather-sum backward, no
    query dedup) against its own dense step (weight decay 0, where the two
    agree up to f32 summation order), three steps.  The gather-sum plan sums
    slots in another order than the dense scatter, so the losses agree to
    rtol 1e-5 and, with SGD, the parameters to 2e-5 (a missing or extra plan
    position moves a row by ~lr).  With Adagrad the parameters are not
    compared: its first step turns that f32 noise on near-zero gradient
    entries into visible moves (measured 7.9e-5 on 2 of 4096 LSTM weights);
    its accumulators are, to rtol 1e-4 of each leaf's largest."""
    _, p, _, _, model, pv = _models(synth_dir, "float32")
    batches = list(BatchBuilder(p, seed=4).batches(shuffle=True))[:3]
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0, dedup_queries=False)
    out = []
    for sparse in (False, True):
        v = {"params": _clone(pv["params"]), "state": _clone(pv["state"]), "buffers": pv["buffers"]}
        reg = OptimizerRegimes(opt)
        reg.update(1, 0)
        step = (make_sparse_train_step(model, reg, v["params"], entity_sparse=True) if sparse
                else make_train_step(model, reg, v["params"]))
        o = reg.init_state(v["params"])
        losses = []
        for b in batches:
            arrays = plan(b) if sparse else train_batch_to_arrays(b)
            v, o, stats = step(v, o, reg.hparams(), arrays_to_device(arrays, "cpu"))
            losses.append(float(stats["loss_sum"]))
        out.append((losses, flatten_arrays(v["params"], "params"), flatten_arrays(o, "opt")))
    (ld, pd, od), (ls, ps, os_) = out
    np.testing.assert_allclose(ls, ld, rtol=1e-5)
    if opt["optimizer"] == "SGD":
        for k in pd:
            np.testing.assert_allclose(ps[k], pd[k], rtol=2e-5, atol=2e-5, err_msg=k)
    else:
        for k in od:
            if k.endswith("/sum"):
                np.testing.assert_allclose(os_[k], od[k], rtol=1e-4, atol=1e-4 * np.abs(od[k]).max(), err_msg=k)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}
