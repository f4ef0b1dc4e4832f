"""The training ops of the torch port against the JAX package, on the CPU:
the last-state LSTM's value and gradients (the port's plain forward and
backward under its autograd Function), both Adagrad updates, the fused
score + BCE loss and its gradients, train-mode batchnorm, the token gather
with both backward forms, and the host helpers.

Seeded numpy inputs go through both packages; the JAX Pallas kernels run in
interpret mode.  Tolerances: f32 results that sum the same products in
another order are held to rtol 1e-5 (values) and 1e-4 (gradients, which
sum over every row and step); bf16 results to utils/numerics.py's rule (at
most 4 bf16 ulps of max|want|, at most 0.5 % of elements not bit-equal)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from open_knowledge_graph_embeddings_tpu.models import embedders as jax_embedders
from open_knowledge_graph_embeddings_tpu.ops import lstm as jax_lstm
from open_knowledge_graph_embeddings_tpu.ops import norm as jax_norm
from open_knowledge_graph_embeddings_tpu.ops.pallas.adagrad_kernel import adagrad_update_pallas
from open_knowledge_graph_embeddings_tpu.ops.pallas.scatter_adagrad_kernel import scatter_adagrad_xla
from open_knowledge_graph_embeddings_tpu.train import loss as jax_loss
from open_knowledge_graph_embeddings_tpu.utils import misc as jax_misc
from open_knowledge_graph_embeddings_tpu_torch.models import embedders
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel, norm
from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update
from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad
from open_knowledge_graph_embeddings_tpu_torch.train import loss as port_loss
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import build_token_grad_plan, host_length_sort_perm
from open_knowledge_graph_embeddings_tpu_torch.utils import misc
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE_CPU, assert_bf16_close

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.detach().float().numpy()


# ------------------------------------------------------------------ LSTM


def _lstm_case(B, L=10, D=128, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy()  # lengths 0..L
    lens[0], lens[-1] = L, 0
    emb = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    k = 1.0 / np.sqrt(D)
    params = {n: rng.uniform(-k, k, s).astype(np.float32) for n, s in
              (("w_ih", (4 * D, D)), ("w_hh", (4 * D, D)), ("b_ih", 4 * D), ("b_hh", 4 * D))}
    dlast = rng.standard_normal((B, D)).astype(np.float32)
    return lens, emb, params, dlast


def _port_grads(params, emb, lens, dlast, tdtype):
    p = {k: _t(v).requires_grad_() for k, v in params.items()}
    x = _t(emb).requires_grad_()
    last = port_lstm.lstm_last_fused(p, x.to(tdtype), _t(lens))
    (last.float() * _t(dlast)).sum().backward()
    return _np(last), {k: _np(v.grad) for k, v in p.items()}, _np(x.grad)


def _jax_grads(params, emb, lens, dlast, jdtype, fused=True):
    def f(p, x):
        x = x.astype(jdtype)
        if fused:
            last = jax_lstm.lstm_last_fused(p, x, jnp.asarray(lens))
        else:
            out = jax_lstm.lstm_forward_tm(p, x)
            idx = jnp.clip(jnp.asarray(lens) - 1, 0, x.shape[0] - 1)
            last = jnp.take_along_axis(out, idx[None, :, None], axis=0)[0]
        return jnp.sum(last.astype(jnp.float32) * dlast), last

    p = {k: jnp.asarray(v) for k, v in params.items()}
    grad = jax.grad(f, argnums=(0, 1), has_aux=True)
    if fused:
        with pltpu.force_tpu_interpret_mode():
            (gp, gx), last = grad(p, jnp.asarray(emb))
    else:
        (gp, gx), last = grad(p, jnp.asarray(emb))
    return _np(last), {k: _np(v) for k, v in gp.items()}, _np(gx)


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_lstm_value_and_grads_match_pallas_interpret(tdtype, jdtype):
    """Value, dW_ih, dW_hh, db (both biases) and demb at the active
    positions against JAX's custom VJP over the interpret-mode Pallas
    kernels, lengths 0..L.  At bf16 every gradient is a bf16 product
    accumulated in f32, so it is held to the bf16 rule after rounding both
    sides to bf16 (a dgates rounding point misplaced, or c_t read in f32
    instead of from the bf16 residual, changes 2-30 % of the elements)."""
    lens, emb, params, dlast = _lstm_case(B=40)
    got_last, got_p, got_x = _port_grads(params, emb, lens, dlast, tdtype)
    want_last, want_p, want_x = _jax_grads(params, emb, lens, dlast, jdtype)
    active = np.arange(emb.shape[0])[:, None] < np.maximum(lens, 1)[None, :]
    pairs = [(got_last, want_last), (got_x[active], want_x[active])] + [(got_p[k], want_p[k]) for k in want_p]
    for got, want in pairs:
        if tdtype == torch.bfloat16:
            bf = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)  # noqa: E731
            assert_bf16_close(bf(got), bf(want), MAX_UNEQUAL_SHARE_CPU)
        else:
            np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("B", [37, 64])
def test_lstm_grads_match_scan_f32(B):
    """Ragged B against JAX's scan path + last-state select (any B)."""
    lens, emb, params, dlast = _lstm_case(B=B, seed=B)
    got_last, got_p, got_x = _port_grads(params, emb, lens, dlast, torch.float32)
    want_last, want_p, want_x = _jax_grads(params, emb, lens, dlast, jnp.float32, fused=False)
    active = np.arange(emb.shape[0])[:, None] < np.maximum(lens, 1)[None, :]
    np.testing.assert_allclose(got_last, want_last, **VAL_TOL)
    np.testing.assert_allclose(got_x[active], want_x[active], **GRAD_TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], err_msg=k, **GRAD_TOL)


def test_lstm_backward_takes_residuals_and_cotangent_in_the_compute_dtype():
    """Rounding points at the backward's boundary: hs, cs and dlast must
    arrive in the compute dtype (c_t is read from the bf16 residual, dlast is
    rounded before its injection), so an f32 one is refused rather than used
    unrounded.  Reading c_t in f32 instead moves 34 % of the bf16 gradients
    off JAX's in the test above; leaving dgates unrounded before the
    products 44 %, summing db over rounded dgates 39 % (mutation checks in a
    scratch copy)."""
    lens, emb, params, dlast = _lstm_case(B=16, D=32, seed=4)
    bf = torch.bfloat16
    e, wi, wh = (_t(x).to(bf) for x in (emb, params["w_ih"], params["w_hh"]))
    b = _t(params["b_ih"] + params["b_hh"])
    ln = _t(lens)
    _, hs, cs = lstm_kernel.lstm_encode_last_plain(e, wi, wh, b, ln, residuals=True)
    assert hs.dtype == cs.dtype == bf
    dl = _t(dlast).to(bf)
    for args in ((hs, cs, dl.float()), (hs, cs.float(), dl), (hs.float(), cs, dl)):
        with pytest.raises(ValueError, match="bfloat16"):
            lstm_kernel.lstm_last_backward(e, wi, wh, b, ln, *args)
    demb, dwi, dwh, db = lstm_kernel.lstm_last_backward(e, wi, wh, b, ln, hs, cs, dl)
    assert demb.dtype == dwi.dtype == dwh.dtype == bf and db.dtype == torch.float32


def test_length_sort_matches_host_replica():
    """The gather-sum plan's positions follow host_length_sort_perm, which
    must equal the device sort (trap: a torch argsort that is not stable)."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        R, L = int(rng.integers(5, 80)), int(rng.integers(2, 11))
        toks = np.zeros((R, L), np.int32)
        for r, n in enumerate(rng.integers(0, L + 1, R)):
            toks[r, :n] = rng.integers(1, 99, n)
        order, _ = port_lstm.length_sort_perm(_t((toks > 0).sum(1)), L)
        np.testing.assert_array_equal(order.numpy(), host_length_sort_perm(toks))


# --------------------------------------------------------------- Adagrad


def _jax_adagrad_rule(g, p, acc, clr, wd, eps):
    """JAX train/optim.py's Adagrad rule off the TPU (its XLA branch, :153-155)."""
    from open_knowledge_graph_embeddings_tpu.train.optim import _adagrad_update

    hp = {"lr": jnp.float32(clr), "lr_decay": jnp.float32(0.0), "weight_decay": jnp.float32(wd),
          "eps": jnp.float32(eps)}
    new_p, s = _adagrad_update(g, {"sum": acc, "step": jnp.float32(0)}, p, hp)
    return new_p, s["sum"]


def _jax_adagrad_pallas(g, p, acc, clr, wd, eps):
    with pltpu.force_tpu_interpret_mode():
        return adagrad_update_pallas(g, p, acc, jnp.float32(clr), jnp.float32(wd), jnp.float32(eps))


# The Pallas interpreter cannot run a ragged final block (it pads the
# output shapes; see tests/test_pallas_lstm.py::TestPallasAdagrad), so the
# ragged 1234-row height is held against JAX's XLA Adagrad rule, which is
# what the JAX package runs for such a leaf off the TPU.
@pytest.mark.parametrize("V,ref", [(1024, _jax_adagrad_pallas), (1234, _jax_adagrad_rule), (2048, _jax_adagrad_rule)],
                         ids=["pallas-interpret", "ragged-1234-xla", "xla"])
def test_dense_adagrad_matches_jax(V, ref):
    rng = np.random.default_rng(V)
    d = 128
    g, p = (rng.standard_normal((V, d)).astype(np.float32) for _ in range(2))
    acc = np.abs(rng.standard_normal((V, d))).astype(np.float32)
    clr, wd, eps = 0.3, 1e-3, 1e-10
    want_p, want_acc = ref(jnp.asarray(g), jnp.asarray(p), jnp.asarray(acc), clr, wd, eps)
    tp, tacc = _t(p.copy()), _t(acc.copy())
    adagrad_update(_t(g), tp, tacc, torch.tensor(clr), wd, eps)
    # the same f32 rule elementwise: only the last bit of the quotient may differ
    np.testing.assert_allclose(tacc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_row_adagrad_matches_xla_with_padding_on_row_zero(wd):
    """Padding uids duplicate row 0, which is also a real entry (the PAD
    token row); with wd > 0 row 0's update is not a no-op and the padding
    entries must not disturb it."""
    rng = np.random.default_rng(7)
    V, d, U, n = 300, 16, 64, 41
    uids = np.zeros(U, np.int32)
    uids[:n] = np.sort(np.concatenate([[0], rng.choice(np.arange(1, V), n - 1, replace=False)]))
    valid = np.arange(U) < n
    g = rng.standard_normal((U, d)).astype(np.float32)
    p = rng.standard_normal((V, d)).astype(np.float32)
    acc = np.abs(rng.standard_normal((V, d))).astype(np.float32)
    want_p, want_acc = scatter_adagrad_xla(jnp.asarray(g), jnp.asarray(uids), jnp.asarray(valid), jnp.asarray(p),
                                           jnp.asarray(acc), jnp.float32(0.2), jnp.float32(wd), jnp.float32(1e-10))
    tp, tacc = _t(p.copy()), _t(acc.copy())
    scatter_adagrad(_t(g), _t(uids), _t(valid), tp, tacc, torch.tensor(0.2), wd, 1e-10)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(want_acc), rtol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-7)
    untouched = np.setdiff1d(np.arange(V), uids)
    np.testing.assert_array_equal(tp.numpy()[untouched], p[untouched])
    assert not np.array_equal(tp.numpy()[0], p[0]) or wd == 0.0


def test_wrappers_validate_and_count():
    p, acc = torch.zeros(4, 8), torch.ones(4, 8)
    with pytest.raises(ValueError, match="shape"):
        adagrad_update(torch.zeros(4, 7), p, acc, torch.tensor(0.1), 0.0, 1e-10)
    with pytest.raises(ValueError, match="float32"):
        adagrad_update(p.double(), p, acc, torch.tensor(0.1), 0.0, 1e-10)
    with pytest.raises(ValueError, match="valid"):
        scatter_adagrad(torch.zeros(2, 8), torch.zeros(2, dtype=torch.long), torch.ones(2), p, acc,
                        torch.tensor(0.1), 0.0, 1e-10)
    before = (adagrad_update.launches, scatter_adagrad.launches)
    adagrad_update(p.clone(), p, acc, torch.tensor(0.1), 0.0, 1e-10)  # CPU: plain version, no launch
    assert (adagrad_update.launches, scatter_adagrad.launches) == before
    with pytest.raises(ValueError, match="no Adagrad kernel"):
        adagrad_update(*(x.to("meta") for x in (p, p, acc, torch.tensor(0.1))), 0.0, 1e-10)


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("with_col_valid", [False, True])
def test_bce_over_scores_value_and_grads(smoothing, with_col_valid):
    rng = np.random.default_rng(3)
    B, N, d, P = 12, 19, 16, 32
    q = rng.standard_normal((B, d)).astype(np.float32)
    cand = rng.standard_normal((N, d)).astype(np.float32)
    pairs = sorted(set(zip(rng.integers(0, B, 20), rng.integers(0, N - 3, 20))))
    pos_rows = np.full(P, -1, np.int32)
    pos_cols = np.full(P, -1, np.int32)
    pos_rows[: len(pairs)], pos_cols[: len(pairs)] = zip(*pairs)
    row_valid = np.arange(B) < B - 2
    col_valid = (np.arange(N) < N - 3) if with_col_valid else None
    n_real = np.float32(N - 3 if with_col_valid else N)

    def jfn(q, c):
        return jax_loss.bce_over_scores(q, c, jnp.asarray(pos_rows), jnp.asarray(pos_cols), jnp.asarray(row_valid),
                                        None if col_valid is None else jnp.asarray(col_valid), jnp.float32(n_real),
                                        smoothing)

    want, (wq, wc) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(cand))
    tq, tc = _t(q).requires_grad_(), _t(cand).requires_grad_()
    got = port_loss.bce_over_scores(tq, tc, _t(pos_rows), _t(pos_cols), _t(row_valid),
                                    None if col_valid is None else _t(col_valid), torch.tensor(n_real), smoothing)
    (got * 0.7).backward()  # a cotangent other than 1
    np.testing.assert_allclose(float(got), float(want), **VAL_TOL)
    np.testing.assert_allclose(tq.grad.numpy(), 0.7 * np.asarray(wq), **GRAD_TOL)
    np.testing.assert_allclose(tc.grad.numpy(), 0.7 * np.asarray(wc), **GRAD_TOL)


def test_bce_over_scores_bf16_operands():
    """bf16 q and cand: f32 scores and f32 gradient products, rounded to
    bf16 at the end on both sides."""
    rng = np.random.default_rng(4)
    B, N, d = 16, 24, 32
    q = (rng.standard_normal((B, d)) * 0.5).astype(np.float32)
    cand = (rng.standard_normal((N, d)) * 0.5).astype(np.float32)
    pos_rows = np.array([0, 3, 5, 9, -1, -1], np.int32)
    pos_cols = np.array([1, 3, 20, 7, -1, -1], np.int32)
    rv = np.ones(B, bool)
    jq, jc = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(cand).astype(jnp.bfloat16)
    want, (wq, wc) = jax.value_and_grad(
        lambda a, b: jax_loss.bce_over_scores(a, b, jnp.asarray(pos_rows), jnp.asarray(pos_cols), jnp.asarray(rv),
                                              None, jnp.float32(N), 0.0), argnums=(0, 1))(jq, jc)
    tq, tc = _t(q).to(torch.bfloat16).requires_grad_(), _t(cand).to(torch.bfloat16).requires_grad_()
    got = port_loss.bce_over_scores(tq, tc, _t(pos_rows), _t(pos_cols), _t(rv), None, torch.tensor(np.float32(N)))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **VAL_TOL)
    assert tq.grad.dtype == torch.bfloat16
    assert_bf16_close(tq.grad, _np(wq), MAX_UNEQUAL_SHARE_CPU)
    assert_bf16_close(tc.grad, _np(wc), MAX_UNEQUAL_SHARE_CPU)


# -------------------------------------------------------------- batchnorm


@pytest.mark.parametrize("momentum", [0.1, None], ids=["momentum", "cumulative"])
def test_train_batchnorm_matches_jax(momentum):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((33, 24)) * 2 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0, 1, 24).astype(np.float32), "bias": rng.standard_normal(24).astype(np.float32)}
    state = {"mean": rng.standard_normal(24).astype(np.float32), "var": rng.uniform(0.5, 2, 24).astype(np.float32),
             "count": np.float32(3)}
    ct = rng.standard_normal((33, 24)).astype(np.float32)

    def jfn(p, x):
        y, st = jax_norm.apply_batchnorm(p, {k: jnp.asarray(v) for k, v in state.items()}, x, True, momentum)
        return jnp.sum(y * ct), (y, st)

    (gp, gx), (wy, wst) = jax.grad(jfn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in params.items()}
    tx = _t(x).requires_grad_()
    y, st = norm.apply_batchnorm(tp, {k: torch.tensor(v) for k, v in state.items()}, tx, True, momentum)
    (y * _t(ct)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), **VAL_TOL)
    for k in ("mean", "var", "count"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]), err_msg=k, **VAL_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]), err_msg=k, **GRAD_TOL)


# ---------------------------------------------------------- token gather


@pytest.mark.parametrize("with_plan", [False, True], ids=["scatter", "gather-sum-plan"])
@pytest.mark.parametrize("cdtype", ["float32", "bfloat16"])
def test_token_gather_backward_matches_jax(with_plan, cdtype):
    """Both backward forms against JAX's: PAD positions dropped, duplicate
    tokens summed (the plan's slots of K=4 split heavy tokens)."""
    rng = np.random.default_rng(7)
    R, L, V, d = 30, 6, 23, 16
    toks = np.zeros((R, L), np.int32)
    for r, n in enumerate(rng.integers(0, L + 1, R)):
        toks[r, :n] = rng.zipf(1.4, n) % (V - 1) + 1
    toks_sorted = toks[host_length_sort_perm(toks)].T.copy()  # [L, R]
    table = rng.standard_normal((V, d)).astype(np.float32)
    ct = rng.standard_normal((L, R, d)).astype(np.float32)
    plan = build_token_grad_plan(toks, V, K=4, bucket_min=8) if with_plan else None
    jdt, tdt = getattr(jnp, cdtype), getattr(torch, cdtype)

    def jfn(tbl):
        jp = None if plan is None else {k: jnp.asarray(v) for k, v in plan.items()}
        e = jax_embedders.token_gather_tm(tbl, jnp.asarray(toks_sorted), jdt, time_major=True, grad_plan=jp)
        return jnp.sum(e.astype(jnp.float32) * ct), e

    want_g, want_e = jax.grad(jfn, has_aux=True)(jnp.asarray(table))
    tt = _t(table).requires_grad_()
    e = embedders.token_gather_tm(tt, _t(toks_sorted).long(), tdt,
                                  grad_plan=None if plan is None else {k: _t(v).long() if v.dtype == np.int32
                                                                       else _t(v) for k, v in plan.items()})
    (e.float() * _t(ct)).sum().backward()
    assert e.dtype == tdt
    np.testing.assert_array_equal(_np(e), _np(want_e))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_g), **GRAD_TOL)
    assert not tt.grad[0].any()  # PAD row


def test_pad_stop_gradient_matches_jax():
    rng = np.random.default_rng(2)
    toks = np.array([[3, 0, 2], [0, 0, 1]], np.int32)
    emb = rng.standard_normal((2, 3, 4)).astype(np.float32)
    want = jax.grad(lambda e: jnp.sum(jax_embedders._pad_stop_gradient(e, jnp.asarray(toks)) ** 2))(jnp.asarray(emb))
    te = _t(emb).requires_grad_()
    (embedders._pad_stop_gradient(te, _t(toks)) ** 2).sum().backward()
    np.testing.assert_array_equal(te.grad.numpy(), np.asarray(want))


# ------------------------------------------------------------ host helpers


def test_misc_helpers_match_jax():
    for n, m in ((0, 128), (1, 1), (129, 128), (4096, 256), (5000, 1024)):
        assert misc.next_bucket(n, m) == jax_misc.next_bucket(n, m)
    lists = [[3, 1], [], [7, 7, 9], [2]]
    for a, b in zip(misc.pack_ragged(lists), jax_misc.pack_ragged(lists)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# -------------------------------------------------------------- regimes


def test_optimizer_regimes_match_jax():
    """Two regex-matched regimes with phases (SGD then Adagrad on the LSTM
    leaves from epoch 2, Adagrad with weight decay on the rest), a frozen
    pattern, hparams through the phase switch, and one update with grad
    clipping: labels, hyperparameters, states and parameters equal JAX's."""
    from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
    from open_knowledge_graph_embeddings_tpu.train.optim import assign_regimes as jax_assign
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes, assign_regimes, leaves

    rng = np.random.default_rng(8)
    shapes = {"entity_lstm": {"w_ih": (8, 4), "b_ih": (8,)}, "relation_bn": {"scale": (4,)}, "table": (6, 4)}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    config = [[{"optimizer": "SGD", "lr": 0.5, "match": "lstm"}, {"epoch": 2, "optimizer": "Adagrad", "lr": 0.1}],
              {"optimizer": "Adagrad", "lr": 0.2, "weight_decay": 0.01}]
    frozen = ["relation_bn"]
    jr, pr = JaxRegimes(config, frozen_patterns=frozen), OptimizerRegimes(config, frozen_patterns=frozen)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), params)
    want_labels = dict(leaves(jax.tree_util.tree_map(int, jax_assign(jp, jr.matches, frozen))))
    assert dict(leaves(assign_regimes(tp, pr.matches, frozen))) == want_labels
    for epoch, step in ((1, 0), (2, 5)):
        assert jr.update(epoch, step) == pr.update(epoch, step)
        assert pr.hparams() == [{k: float(v) for k, v in h.items()} for h in jr.hparams()]
        assert pr.opt_names() == jr.opt_names() and pr.host_state() == jr.host_state()
    jopt, popt = jr.init_state(jp), pr.init_state(tp)
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jr.hparams()]
    jnew, jopt = jr.make_apply(jp, grad_clip=1.0)(jax.tree_util.tree_map(jnp.asarray, grads), jopt, jp, jhp)
    pnew, popt = pr.make_apply(tp, grad_clip=1.0)(jax.tree_util.tree_map(torch.from_numpy, grads), popt, tp,
                                                  pr.hparams())
    for (k, want), (k2, got) in zip(leaves(jax.tree_util.tree_map(np.asarray, jnew)), leaves(pnew)):
        assert k == k2
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=k)
    want_state = dict(leaves(jax.tree_util.tree_map(np.asarray, jopt)))
    got_state = dict(leaves(popt))
    assert set(got_state) == set(want_state)
    for k, want in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), want, rtol=1e-6, atol=1e-7, err_msg=k)
