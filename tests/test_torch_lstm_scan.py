"""Plain versions of the port's kernels 5-8 against the JAX package's Pallas
kernels in interpret mode, on the CPU.

* Kernels 7/8 (``ops/lstm_scan_kernel.py``): the recurrence over a
  precomputed input projection against ``lstm_scan_pallas``, value and VJP,
  f32 and bf16; at a ragged B, where the JAX package takes ``lax.scan``, the
  whole unfused LSTM (projection included) against ``lstm_forward_tm``.
* Kernels 5/6 (the every-state modes of ``ops/lstm_kernel.py``) against
  ``lstm_encode_fused``: hs and every gradient at the positions a row
  reaches (the others hold unread garbage on both devices).

Tolerances: f32, the same f32 products summed in another order (rtol 1e-4,
atol 1e-5 for gradients that pass through ten steps of carries; 1e-5 for
values).  bf16: utils/numerics.py's rule, at most 4 bf16 ulps of max|want|
and a bounded share of elements not bit-equal: 0.5 % for values (the CPU
share; measured <= 0.22 %), 2 % for the input gradients dx_proj and demb
(measured <= 0.43 %: a flipped dgate feeds the f32 dh carry of every
earlier step) and the backward's 10 % for the weight gradients (measured
0.46-3.4 %: a dW sums every (row, step), so one flipped dgate moves a whole
row of it).  A misplaced bf16 rounding point moves 17-39 % and a dropped
carry tens of ulps (utils/numerics.py).

At a ragged B the JAX package's bf16 backward is XLA's autodiff of the
``lax.scan``, which rounds the dh cotangent of every step to bf16 where the
Pallas kernel (and kernel 8) carry it in f32: it reads 34-38 % of elements
unequal (at most one ulp) against the port, a difference of the JAX
package's two paths, not of the port.  So the bf16 gradients at a ragged B
are held against the Pallas kernels on the batch padded to a multiple of 8
with zero rows and a zero cotangent (rows are independent in the scan, and
a zero row adds nothing to dW), and only the f32 gradients against the
``lax.scan``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from open_knowledge_graph_embeddings_tpu.ops import lstm as jax_lstm
from open_knowledge_graph_embeddings_tpu.ops.pallas import lstm_kernel as jax_kernels
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel, lstm_scan_kernel
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_UNEQUAL_SHARE,
    MAX_UNEQUAL_SHARE_BWD,
    MAX_UNEQUAL_SHARE_CPU,
    assert_bf16_close,
)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

F32_VALUE = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]


def _np(x):
    if isinstance(x, jax.Array):
        return np.asarray(x.astype(jnp.float32))
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tdtype, tol=F32_GRAD, share=MAX_UNEQUAL_SHARE):
    if tdtype == torch.bfloat16:
        assert_bf16_close(_np(got), _np(want), share)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **tol)


def _scan_case(L, B, H, seed):
    rng = np.random.default_rng(seed)
    x_proj = (rng.standard_normal((L, B, 4 * H)) * 0.5).astype(np.float32)
    w_hh = rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), (4 * H, H)).astype(np.float32)
    dhs = (rng.standard_normal((L, B, H)) * 0.5).astype(np.float32)
    return x_proj, w_hh, dhs


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_scan_matches_pallas_interpret(tdtype, jdtype):
    """Kernel 7's and 8's plain versions against ``lstm_scan_pallas``:
    hs, and the VJP (dx_proj from the backward kernel, dW_hh from the einsum
    outside it) for a random cotangent of every state."""
    L, B, H = 10, 16, 128
    x_proj, w_hh, dhs = _scan_case(L, B, H, seed=0)
    jx, jw = jnp.asarray(x_proj).astype(jdtype), jnp.asarray(w_hh.T).astype(jdtype)
    with pltpu.force_tpu_interpret_mode():
        want_hs, vjp = jax.vjp(jax_kernels.lstm_scan_pallas, jx, jw)
        want_dxp, want_dw_t = vjp(jnp.asarray(dhs).astype(jdtype))

    xp = torch.from_numpy(x_proj).to(tdtype).requires_grad_()
    w = torch.from_numpy(w_hh).to(tdtype).requires_grad_()
    hs = lstm_scan_kernel.lstm_scan(xp, w)
    hs.backward(torch.from_numpy(dhs).to(tdtype))
    assert hs.dtype == xp.grad.dtype == w.grad.dtype == tdtype
    _close(hs, want_hs, tdtype, F32_VALUE, MAX_UNEQUAL_SHARE_CPU)
    _close(xp.grad, want_dxp, tdtype)
    _close(w.grad.t(), want_dw_t, tdtype, share=MAX_UNEQUAL_SHARE_BWD)


def test_scan_plain_forward_residuals():
    """The forward's cs residual is the f32 cell state rounded to the
    compute dtype; hs[t] feeds step t+1 as it was rounded."""
    L, B, H = 4, 8, 16
    x_proj, w_hh, _ = _scan_case(L, B, H, seed=1)
    xp = torch.from_numpy(x_proj).to(torch.bfloat16)
    w = torch.from_numpy(w_hh).to(torch.bfloat16)
    hs, cs = lstm_scan_kernel.lstm_scan_forward(xp, w)
    h = torch.zeros(B, H)
    c = torch.zeros(B, H)
    for t in range(L):
        i, f, g, o = (xp[t].float() + h.to(torch.bfloat16).float() @ w.float().t()).chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        assert torch.equal(hs[t], h.to(torch.bfloat16)) and torch.equal(cs[t], c.to(torch.bfloat16))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("B", [1, 37])
def test_unfused_lstm_matches_jax_at_ragged_b(monkeypatch, tdtype, jdtype, B):
    """B % 8 != 0: the JAX package runs ``lstm_forward_tm`` through
    ``lax.scan`` (the same function as kernel 7 in the forward); the port
    runs its projection and kernels 7/8 for every B.  The value and, at f32,
    every gradient against the ``lax.scan``; at bf16 the gradients against
    the Pallas kernels on the zero-padded batch (module docstring)."""
    L, D = 10, 128
    rng = np.random.default_rng(B)
    k = 1 / np.sqrt(D)
    params = {n: rng.uniform(-k, k, s).astype(np.float32)
              for n, s in (("w_ih", (4 * D, D)), ("w_hh", (4 * D, D)), ("b_ih", (4 * D,)), ("b_hh", (4 * D,)))}
    x = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    dhs = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)

    def jax_vjp(x_, dhs_):
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        out, vjp = jax.vjp(jax_lstm.lstm_forward_tm, jp, jnp.asarray(x_).astype(jdtype))
        return out, vjp(jnp.asarray(dhs_).astype(jdtype))

    want, (want_gp, want_gx) = jax_vjp(x, dhs)
    if tdtype == torch.bfloat16:
        pad = -B % 8 or 8
        monkeypatch.setattr(jax_kernels, "pallas_supported", lambda *a: True)
        with pltpu.force_tpu_interpret_mode():
            _, (want_gp, want_gx) = jax_vjp(np.pad(x, ((0, 0), (0, pad), (0, 0))),
                                            np.pad(dhs, ((0, 0), (0, pad), (0, 0))))
        want_gx = want_gx[:, :B]

    pp = {n: torch.from_numpy(v).requires_grad_() for n, v in params.items()}
    px = torch.from_numpy(x).to(tdtype).requires_grad_()
    got = port_lstm.lstm_forward_tm(pp, px)
    got.backward(torch.from_numpy(dhs).to(tdtype))
    _close(got, want, tdtype, F32_VALUE, MAX_UNEQUAL_SHARE_CPU)
    _close(px.grad, want_gx, tdtype)
    for n in params:
        if tdtype == torch.bfloat16 and n.startswith("b_"):
            # f32 sums of bf16 dgates in another order: 1e-4 of max|db| (a
            # skipped or misplaced cotangent moves db by tens of percent)
            want_b = _np(want_gp[n])
            assert np.abs(_np(pp[n].grad) - want_b).max() <= 1e-4 * np.abs(want_b).max(), n
        else:
            _close(pp[n].grad.to(tdtype), want_gp[n], tdtype, share=MAX_UNEQUAL_SHARE_BWD)


def _fused_case(L, B, D, seed):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy()
    k = 1 / np.sqrt(D)
    w_ih = rng.uniform(-k, k, (4 * D, D)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (4 * D, D)).astype(np.float32)
    bias = rng.uniform(-2 * k, 2 * k, 4 * D).astype(np.float32)
    emb = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    active = np.arange(L)[:, None] < np.maximum(lens, 1)[None, :]
    # the loss reads only the positions a row reaches
    r = (rng.standard_normal((L, B, D)) * active[..., None]).astype(np.float32)
    return lens, emb, w_ih, w_hh, bias, r, active


@pytest.mark.parametrize("tdtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_every_state_fused_matches_pallas_interpret(tdtype, jdtype):
    """Kernels 5 and 6 (plain versions) against ``lstm_encode_fused``:
    hs, demb at the positions a row reaches, dW_ih, dW_hh and db for the
    loss ``sum(hs * r)`` with r zero at the other positions."""
    L, B, D = 10, 32, 128
    lens, emb, w_ih, w_hh, bias, r, active = _fused_case(L, B, D, seed=3)

    def jloss(e, wi, wh, b):
        hs = jax_kernels.lstm_encode_fused(e, wi, wh, b, jnp.asarray(lens))
        return jnp.sum(hs.astype(jnp.float32) * r), hs

    with pltpu.force_tpu_interpret_mode():
        (_, want_hs), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(emb).astype(jdtype), jnp.asarray(w_ih.T).astype(jdtype),
            jnp.asarray(w_hh.T).astype(jdtype), jnp.asarray(bias))
    want_demb, want_dwih_t, want_dwhh_t, want_db = grads

    e = torch.from_numpy(emb).to(tdtype).requires_grad_()
    wi = torch.from_numpy(w_ih).to(tdtype).requires_grad_()
    wh = torch.from_numpy(w_hh).to(tdtype).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    hs = lstm_kernel.lstm_encode_fused(e, wi, wh, b, torch.from_numpy(lens))
    (hs.float() * torch.from_numpy(r)).sum().backward()
    act = torch.from_numpy(active)
    _close(hs[act], _np(want_hs)[active], tdtype, F32_VALUE, MAX_UNEQUAL_SHARE_CPU)
    _close(e.grad[act], _np(want_demb)[active], tdtype)
    _close(wi.grad.t(), want_dwih_t, tdtype, share=MAX_UNEQUAL_SHARE_BWD)
    _close(wh.grad.t(), want_dwhh_t, tdtype, share=MAX_UNEQUAL_SHARE_BWD)
    want_db = _np(want_db).reshape(-1)
    assert np.abs(b.grad.numpy() - want_db).max() <= 1e-4 * np.abs(want_db).max()


def test_every_state_backward_adds_each_step():
    """Kernel 6's plain version with the cotangent on the last positions
    only equals kernel 2's with that cotangent as dlast (the two modes
    differ only in where the cotangent enters)."""
    L, B, D = 6, 24, 32
    lens, emb, w_ih, w_hh, bias, r, active = _fused_case(L, B, D, seed=4)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (emb, w_ih, w_hh)]
    args += [torch.from_numpy(bias), torch.from_numpy(lens)]
    hs, cs = lstm_kernel.lstm_all_forward(*args)
    dlast = torch.from_numpy(r[0]).to(torch.bfloat16)
    last_step = np.maximum(lens, 1) - 1
    dhs = torch.zeros(L, B, D, dtype=torch.bfloat16)
    dhs[torch.from_numpy(last_step).long(), torch.arange(B)] = dlast
    got = lstm_kernel.lstm_all_backward(*args, hs, cs, dhs)
    want = lstm_kernel.lstm_last_backward(*args, hs, cs, dlast)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_every_state_wrappers_validate_inputs():
    lens, emb, w_ih, w_hh, bias, _, _ = _fused_case(4, 8, 16, seed=5)
    args = [torch.from_numpy(x) for x in (emb, w_ih, w_hh, bias, lens)]
    hs, cs = lstm_kernel.lstm_all_forward(*args)
    with pytest.raises(ValueError, match="dhs"):
        lstm_kernel.lstm_all_backward(*args, hs, cs, hs[0])
    before = (lstm_kernel.lstm_all_forward.launches, lstm_scan_kernel.lstm_scan_forward.launches)
    lstm_scan_kernel.lstm_scan_forward(torch.zeros(4, 8, 64), args[2])  # CPU: plain, no launch
    assert (lstm_kernel.lstm_all_forward.launches, lstm_scan_kernel.lstm_scan_forward.launches) == before
    with pytest.raises(ValueError, match="w_hh"):
        lstm_scan_kernel.lstm_scan_forward(torch.zeros(4, 8, 64), args[1][:, :8])
    with pytest.raises(ValueError, match="no LSTM kernel"):
        lstm_scan_kernel.lstm_scan_forward(torch.zeros(4, 8, 64, device="meta"), args[2].to("meta"))
