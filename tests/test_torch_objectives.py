"""The KL loss of the torch port against the JAX package on the CPU: dense
labels, the loss and its score gradient, the eval's chunked online
logsumexp, the eval step, and whole sparse training steps with KL (query
dedup engaged).

Inputs are made from numpy seeds; JAX weights cross over through
``variables_from_jax_arrays``; dropout is 0.  KL takes no label smoothing in
either package (JAX's ``one_vs_n_loss`` passes its dense labels to
``kl_div_sum`` unsmoothed)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from open_knowledge_graph_embeddings_tpu.train import evaluate as jev
from open_knowledge_graph_embeddings_tpu.train import loss as jloss
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu.train.step import eval_batch_to_arrays as jax_eval_arrays
from open_knowledge_graph_embeddings_tpu.train.step import make_eval_step as jax_make_eval_step
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.train import evaluate as pev
from open_knowledge_graph_embeddings_tpu_torch.train import loss as ploss
from open_knowledge_graph_embeddings_tpu_torch.train import step as pstep
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
from test_torch_eval import GOLD, POS, _case, _eval_models, _eval_sets, _j, _t
from test_torch_train_step import _models, synth_dir  # noqa: F401  (synth_dir is a fixture)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)


def _labels_case(seed, B=5, N=11):
    """Positive pairs with a duplicate and -1 padding (which points at cell
    (0, 0)), and a real label at (0, 0)."""
    rng = np.random.default_rng(seed)
    rows = np.array([0, 1, 1, 3, 1, 0, -1, -1], np.int32)
    cols = np.array([0, 4, 7, 2, 4, 9, -1, -1], np.int32)
    return rng, rows, cols, B, N


def test_dense_labels_and_smoothing_match_jax():
    """Dense labels (duplicates collapse, padding does not erase the real
    label at (0, 0)) and the reference's smoothing arithmetic equal JAX's;
    JAX's dense BCE sum on those smoothed labels equals the port's BCE on
    the unique positive pairs."""
    rng, rows, cols, B, N = _labels_case(0)
    want = np.asarray(jloss.dense_labels(jnp.asarray(rows), jnp.asarray(cols), B, N))
    got = ploss.dense_labels(torch.from_numpy(rows), torch.from_numpy(cols), B, N)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 1 and got.sum() == 5
    sm = np.asarray(jloss.apply_label_smoothing(jnp.asarray(want), jnp.float32(N), 0.1))
    np.testing.assert_array_equal(ploss.apply_label_smoothing(got, torch.tensor(np.float32(N)), 0.1).numpy(), sm)
    assert ploss.apply_label_smoothing(got, N, 0.0) is got
    scores = (rng.standard_normal((B, N)) * 3).astype(np.float32)
    mask = rng.random((B, N)) < 0.8
    mask[want > 0] = True  # a positive pair is a real cell
    jb = float(jloss.bce_with_logits_sum(jnp.asarray(scores), jnp.asarray(sm), jnp.asarray(mask)))
    ur, uc = (torch.from_numpy(x.astype(np.int32)) for x in np.nonzero(want))
    pb = float(ploss.bce_with_logits_sum_indexed(torch.from_numpy(scores), ur, uc, torch.from_numpy(mask),
                                                 np.float32(N), 0.1))
    assert pb == pytest.approx(jb, rel=1e-6)


@pytest.mark.parametrize("with_col_valid", [False, True], ids=["all-cols", "padded-cols"])
def test_kl_loss_and_score_grad_match_jax(with_col_valid):
    """``one_vs_n_loss("kl")`` over [B, N] scores with padded rows (and
    columns): the loss and d(loss)/d(scores) to relative 1e-5 of JAX's
    (the grad to 1e-5 of its largest magnitude); label smoothing changes
    neither package's KL; the normalizer is the positive count."""
    rng, rows, cols, B, N = _labels_case(1)
    scores = (rng.standard_normal((B, N)) * 2).astype(np.float32)
    row_valid = np.arange(B) < B - 1
    col_valid = (np.arange(N) < N - 1) if with_col_valid else None
    n_real = np.float32(N - 1 if with_col_valid else N)

    def jfn(s, smoothing):
        return jloss.one_vs_n_loss("kl", s, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(row_valid),
                                   None if col_valid is None else jnp.asarray(col_valid), jnp.float32(n_real),
                                   smoothing)

    jl, jn = jfn(jnp.asarray(scores), 0.0)
    jg = jax.grad(lambda s: jfn(s, 0.0)[0])(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    pl, pn = ploss.one_vs_n_loss("kl", s, torch.from_numpy(rows), torch.from_numpy(cols),
                                 torch.from_numpy(row_valid), None if col_valid is None else torch.from_numpy(col_valid),
                                 torch.tensor(n_real), 0.0)
    pl.backward()
    assert float(pl) == pytest.approx(float(jl), rel=1e-5)
    assert float(pn) == float(jn) == 6.0
    g, want = s.grad.numpy(), np.asarray(jg)
    np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert not g[B - 1].any()  # the padding row takes no gradient
    smoothed, _ = ploss.one_vs_n_loss("kl", torch.from_numpy(scores), torch.from_numpy(rows), torch.from_numpy(cols),
                                      torch.from_numpy(row_valid),
                                      None if col_valid is None else torch.from_numpy(col_valid),
                                      torch.tensor(n_real), 0.1)
    assert float(smoothed) == float(pl) and float(jfn(jnp.asarray(scores), 0.1)[0]) == float(jl)


def test_kl_matches_torch_kldivloss():
    """The port's KL over unpadded scores is torch's ``KLDivLoss(sum)`` of
    ``log_softmax`` against the 0/1 labels (the reference's loss)."""
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.standard_normal((3, 7)).astype(np.float32))
    labels = torch.from_numpy((rng.random((3, 7)) < 0.4).astype(np.float32))
    got = ploss.kl_div_sum(scores, labels, torch.ones(3, 7, dtype=torch.bool))
    want = torch.nn.KLDivLoss(reduction="sum")(torch.log_softmax(scores, dim=1), labels)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def _chunked_kl(mod, c, chunk, lib):
    conv = _t if lib == "torch" else _j
    q, cand = conv(c, "q", "cand")
    n_real = torch.tensor(c["n_real"]) if lib == "torch" else jnp.float32(c["n_real"])
    loss, ranks, valid = mod.eval_stats_chunked(q, cand, *conv(c, *POS), n_real, *conv(c, *GOLD), 0.0, chunk=chunk,
                                                loss_type="kl")
    return float(loss), np.asarray(ranks), np.asarray(valid)


@pytest.mark.parametrize("chunk", [16, 33, 100])
def test_eval_stats_chunked_kl_matches_jax_and_dense(chunk):
    """The chunked eval with KL (per row an online logsumexp over chunks of
    C < N candidates, the last chunk overlapping): the loss within relative
    1e-5 of JAX's and of the dense KL, the ranks equal JAX's and the same
    as with BCE (the loss type does not touch the ranking)."""
    c = _case(5)
    scores = torch.from_numpy(c["q"] @ c["cand"].T)
    dense, _ = ploss.one_vs_n_loss("kl", scores, *_t(c, *POS), torch.tensor(c["n_real"]))
    p_loss, p_ranks, p_valid = _chunked_kl(pev, c, chunk, "torch")
    j_loss, j_ranks, j_valid = _chunked_kl(jev, c, chunk, "jax")
    np.testing.assert_array_equal(p_valid, j_valid)
    np.testing.assert_array_equal(p_ranks[p_valid], j_ranks[p_valid])
    assert p_loss == pytest.approx(j_loss, rel=1e-5)
    assert p_loss == pytest.approx(float(dense), rel=1e-5)
    _, bce_ranks, _ = pev.eval_stats_chunked(*_t(c, "q", "cand"), *_t(c, *POS), torch.tensor(c["n_real"]),
                                             *_t(c, *GOLD), 0.0, chunk=chunk)
    np.testing.assert_array_equal(p_ranks, bce_ranks.numpy())


@pytest.mark.parametrize("mode", ["batch-shared", "full-vocab-chunked"])
def test_kl_eval_step_matches_jax(synth_dir, monkeypatch, mode):  # noqa: F811
    """make_eval_step with KL on the same weights (LSTM-ComplEx, d=32, f32)
    over every test batch: the rank sums equal, the loss to rtol 1e-5; the
    chunked branch of the port (forced below its 100,000 candidates)
    against JAX's dense one."""
    jmodel, jv, model, pv = _eval_models(synth_dir)
    shared = mode == "batch-shared"
    cfg = dict(batch_size=16, use_batch_shared_entities=shared, min_size_batch_labels=64 if shared else -1)
    j, p = _eval_sets(synth_dir, f"kl_{shared}", split="test.txt", **cfg)
    jcache = pcache = None
    if not shared:
        off = p.meta.min_entities_size
        jcache, pcache = jmodel.encode_all_entities(jv)[off:], model.encode_all_entities(pv)[off:]
        monkeypatch.setattr(pstep, "CHUNKED_ABOVE", 0)
    jstep, pstep_fn = jax_make_eval_step(jmodel, "kl"), pstep.make_eval_step(model, "kl")
    n = 0
    for jb, pb in zip(JaxBatchBuilder(j, seed=2).batches(), BatchBuilder(p, seed=2).batches()):
        ja = {k: jnp.asarray(v) for k, v in jax_eval_arrays(jb).items()}
        want = pstep.unpack_eval_stats(np.asarray(jstep(jv, ja) if shared else jstep(jv, ja, jcache)))
        got = pstep.unpack_eval_stats(pstep_fn(pv, pstep.arrays_to_device(pstep.eval_batch_to_arrays(pb), "cpu"),
                                               pcache))
        for k in ("count", "mr", "h50", "h10", "h3", "h1", "normalizer_metric"):
            assert got[k] == want[k], (k, got, want)
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
        n += got["count"]
    assert n > 20


def test_kl_sparse_steps_match_jax(synth_dir):  # noqa: F811
    """Three whole sparse steps with KL (LSTM-ComplEx d=32 f32, batchnorm,
    batch-shared candidates, query dedup and the gather-sum plan engaged),
    SGD lr 0.5: the loss per step to rtol 1e-5 and every parameter, BN
    statistic and optimizer leaf to 2e-5."""
    j, p, jmodel, jv, model, pv = _models(synth_dir, "float32")
    opt = {"optimizer": "SGD", "lr": 0.5}
    jreg, preg = JaxRegimes(opt), OptimizerRegimes(opt)
    jreg.update(1, 0)
    preg.update(1, 0)
    kw = dict(min_rows_ratio=0.0, dedup_bucket=8)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", **kw)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, **kw)
    jstep = jax_sparse_step(jmodel, jreg, jv["params"], entity_sparse=True, loss_type="kl")
    ps = make_sparse_train_step(model, preg, pv["params"], entity_sparse=True, loss_type="kl")
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    dedup = 0
    for b in list(BatchBuilder(p, seed=4).batches(shuffle=True))[:3]:
        arrays = plan(b)
        dedup += "dedup/ent_inv" in arrays
        jv, jopt, jstats = jstep(jv, jopt, jhp, {k: jnp.asarray(v) for k, v in jplan(b).items()}, jax.random.key(0))
        pv, popt, pstats = ps(pv, popt, preg.hparams(), pstep.arrays_to_device(arrays, "cpu"))
        assert float(pstats["loss_sum"]) == pytest.approx(float(jstats["loss_sum"]), rel=1e-5)
        assert float(pstats["normalizer_metric"]) == float(jstats["normalizer_metric"])
    assert dedup > 0
    want = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state"), **jax_flatten(jopt, "opt")}
    got = {**flatten_arrays(pv["params"], "params"), **flatten_arrays(pv["state"], "state"),
           **flatten_arrays(popt, "opt")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-5, atol=2e-5, err_msg=k)
