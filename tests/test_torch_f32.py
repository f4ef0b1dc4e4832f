"""The f32 LSTM path of the port on the CPU: the f32 rule that holds the f32
kernels to their plain versions on the card, the any-H route of the
recurrence kernels, and the port's unfused LSTM at an H the TPU kernels do
not tile against the JAX package.

* The f32 rule (``utils/numerics.py``): the largest difference relative to
  max|want|.  It must pass the plain version and fail its planted TF32
  yardstick (the same plain version with its operands rounded to 10 mantissa
  bits: 1.5-3.8e-4 here) and a dropped bias or recurrent product, for each
  f32 mode (kernels 1, 2, 5, 6, 7, 8) at d=128.
* The numerics of the f32 3xTF32 kernels (kernels 1, 2, 5 and 6 on the
  card): the plain f32 forward and backward with every product emulated as
  3xTF32 (``utils/numerics.py::matmul_3xtf32``) meet the f32 rule against
  the plain versions at D = H = 512, and with one TF32 product (1xTF32) fail
  it.
* The any-H route (``ops/lstm_scan_kernel.py::padded_forward`` /
  ``padded_backward``): H padded per gate block with zeros is exact, so the
  padded plain version equals the unpadded one (f32 rule; bf16 rule).
* ``ops/lstm.py::lstm_forward_tm`` at H = 100 against the JAX package's
  ``lstm_forward_tm`` (its ``lax.scan`` branch, H % 128 != 0), with the
  tolerances of ``tests/test_torch_lstm_scan.py``: at bf16 the value against
  the ``lax.scan`` and the gradients against the Pallas kernels run on the
  same H in interpret mode on the batch padded to a multiple of 8 (that
  file's docstring: the ``lax.scan`` autodiff rounds the dh cotangent to
  bf16 where the kernels carry it in f32).
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
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_REL_ERR_F32,
    MAX_UNEQUAL_SHARE,
    MAX_UNEQUAL_SHARE_BWD,
    MAX_UNEQUAL_SHARE_CPU,
    agreement,
    assert_bf16_close,
    assert_f32_close,
    f32_agreement,
    matmul_3xtf32,
    round_to_tf32,
)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

F32_VALUE = dict(rtol=1e-5, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-5)


def test_round_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10, -(1 + 2**-11 + 2**-20), 3.0e-3, 0.0])
    got = round_to_tf32(x)
    want = torch.tensor([1.0, 1.0, 1 + 2**-9, 1 + 2**-10, -(1 + 2**-10), float(got[5]), 0.0])
    assert torch.equal(got, want)  # ties to even, then nearest, sign kept
    bits = got.view(torch.int32)
    assert torch.equal(bits & 0x1FFF, torch.zeros_like(bits))
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2**-11


def _fused_case(B=96, D=128, L=10, seed=0):
    rng = np.random.default_rng(seed)
    lens = torch.from_numpy(np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy())
    k = 1 / np.sqrt(D)
    f = lambda *s, sc=0.5: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    u = lambda *s: torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32))  # noqa: E731
    emb, w_ih, w_hh, bias = f(L, B, D), u(4 * D, D), u(4 * D, D), u(4 * D) * 2
    act = torch.arange(L)[:, None] < lens.clamp(min=1)[None, :]
    return (emb, w_ih, w_hh, bias, lens), act, f(B, D), f(L, B, D) * act[..., None]


def _fused_outputs(mode, args, act, dlast, dhs):
    """(name, output) pairs of one f32 mode's plain version, at the
    positions the rows reach."""
    if mode == "kernel 1":
        last, hs, cs = lk.lstm_encode_last_plain(*args, residuals=True)
        return [("last", last), ("hs", hs[act]), ("cs", cs[act])]
    if mode == "kernel 5":
        hs, cs = lk.lstm_all_forward_plain(*args)
        return [("hs", hs[act]), ("cs", cs[act])]
    # the backward modes on the unperturbed forward's residuals
    _, hs, cs = lk.lstm_encode_last_plain(*args, residuals=True)
    fn, cot = (lk.lstm_last_backward_plain, dlast) if mode == "kernel 2" else (lk.lstm_all_backward_plain, dhs)
    demb, dw_ih, dw_hh, db = fn(*args, hs, cs, cot)
    return [("demb", demb[act]), ("dW_ih", dw_ih), ("dW_hh", dw_hh), ("db", db)]


@pytest.mark.parametrize("mode", ["kernel 1", "kernel 2", "kernel 5", "kernel 6"])
def test_f32_rule_fails_tf32_yardstick_and_dropped_bias_fused(mode):
    """Kernels 1, 2, 5 and 6 (plain versions, d=128): the rule passes the
    plain version against itself and fails, on some output, the same plain
    version with TF32 operands and with the bias dropped."""
    args, act, dlast, dhs = _fused_case()
    want = _fused_outputs(mode, args, act, dlast, dhs)
    for (name, got), (_, w) in zip(_fused_outputs(mode, args, act, dlast, dhs), want):
        assert f32_agreement(got, w).rel_err == 0.0, name
    tf32 = (*(round_to_tf32(x) for x in args[:3]), *args[3:])
    planted = {"TF32 operands": _fused_outputs(mode, tf32, act, round_to_tf32(dlast), round_to_tf32(dhs)),
               "bias dropped": _fused_outputs(mode, (*args[:3], torch.zeros_like(args[3]), args[4]), act, dlast, dhs)}
    for fault, outs in planted.items():
        readings = {name: f32_agreement(g, w).rel_err for (name, g), (_, w) in zip(outs, want)}
        assert not all(f32_agreement(g, w).ok() for (_, g), (_, w) in zip(outs, want)), (fault, readings)
    # the yardstick is far from the limit on every output, not on one alone
    yard = {name: f32_agreement(g, w).rel_err for (name, g), (_, w) in zip(planted["TF32 operands"], want)}
    assert min(yard.values()) > 2 * MAX_REL_ERR_F32, yard


def test_matmul_3xtf32_splits_and_orders_its_products():
    """hi + lo keeps an f32 value to ~2^-22 of it, hi·hi' alone is one TF32
    product, and 3xTF32 is as close to the f32 product as f32 itself."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    hi = round_to_tf32(a)
    assert (((a - hi) - round_to_tf32(a - hi)).abs() <= a.abs() * 2.0**-21).all()
    exact = (a.double() @ b.double()).float()
    assert torch.equal(matmul_3xtf32(a, b, passes=1), round_to_tf32(a) @ round_to_tf32(b))
    err3 = f32_agreement(matmul_3xtf32(a, b), exact).rel_err
    err1 = f32_agreement(matmul_3xtf32(a, b, passes=1), exact).rel_err
    err32 = f32_agreement(a @ b, exact).rel_err
    assert err3 <= 4 * err32 + 1e-7 and err1 > 30 * err3, (err3, err1, err32)
    with pytest.raises(ValueError, match="passes"):
        matmul_3xtf32(a, b, passes=2)


@pytest.fixture(scope="module")
def flagship_width_case():
    """One ragged pass at the flagship's width (D = H = 512, L = 10, 64
    rows), f32, with the plain forward's residuals and both cotangents."""
    (emb, w_ih, w_hh, bias, lens), act, dlast, dhs = _fused_case(B=64, D=512, seed=7)
    args = (emb, w_ih, w_hh, bias, lens)
    _, hs, cs = lk.lstm_encode_last_plain(*args, residuals=True)
    return args, act, hs, cs, dlast, dhs


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("mode", ["kernel 2", "kernel 6"])
def test_3xtf32_backward_meets_the_f32_rule_and_1xtf32_fails_it(monkeypatch, flagship_width_case, mode, passes):
    """Kernels 2 and 6 in f32 take every product (gate recompute, demb,
    dh, dW) as 3xTF32 on the card: the plain f32 backward with every
    product emulated so meets the f32 rule against the plain version on
    every output; with one TF32 product per product (1xTF32, the variant
    chip_smoke.py plants) it fails the rule."""
    args, act, hs, cs, dlast, dhs = flagship_width_case
    fn, cot = (lk.lstm_last_backward_plain, dlast) if mode == "kernel 2" else (lk.lstm_all_backward_plain, dhs)
    want = fn(*args, hs, cs, cot)
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul_3xtf32(a, b, passes=passes))
    got = fn(*args, hs, cs, cot)
    monkeypatch.undo()
    readings = {name: f32_agreement(g[act] if name == "demb" else g, w[act] if name == "demb" else w)
                for name, g, w in zip(("demb", "dW_ih", "dW_hh", "db"), got, want)}
    if passes == 3:
        assert all(r.ok() for r in readings.values()), readings
        assert max(r.rel_err for r in readings.values()) < MAX_REL_ERR_F32 / 4, readings
    else:
        assert not all(r.ok() for r in readings.values()), readings


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("mode", ["kernel 1", "kernel 5"])
def test_3xtf32_forward_meets_the_f32_rule_and_1xtf32_fails_it(monkeypatch, flagship_width_case, mode, passes):
    """Kernels 1 and 5 in f32 take the gate products (x.W_ih^T and
    h.W_hh^T) as 3xTF32 on the card, through the gate loop the backward
    recomputes them with: the plain f32 forward with both products emulated
    so meets the f32 rule against the plain version on last, hs and cs (the
    outputs the mode writes, at the positions the rows reach), the error
    carried through h for ten steps; with one TF32 product per product
    (1xTF32, the variant chip_smoke.py plants) it fails the rule."""
    args, act, _, _, dlast, dhs = flagship_width_case
    want = _fused_outputs(mode, args, act, dlast, dhs)
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul_3xtf32(a, b, passes=passes))
    got = _fused_outputs(mode, args, act, dlast, dhs)
    monkeypatch.undo()
    readings = {name: f32_agreement(g, w) for (name, g), (_, w) in zip(got, want)}
    if passes == 3:
        assert all(r.ok() for r in readings.values()), readings
        assert max(r.rel_err for r in readings.values()) < MAX_REL_ERR_F32 / 4, readings
    else:
        assert not all(r.ok() for r in readings.values()), readings


@pytest.mark.parametrize("mode", ["kernel 7", "kernel 8"])
def test_f32_rule_fails_tf32_yardstick_and_dropped_recurrence_scan(mode):
    """Kernels 7 and 8 (plain versions, H=128): x_proj holds the bias, so the
    planted faults are the TF32 operands and a dropped recurrent product."""
    rng = np.random.default_rng(1)
    H = 128
    x_proj = torch.from_numpy((rng.standard_normal((10, 96, 4 * H)) * 0.5).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), (4 * H, H)).astype(np.float32))
    dhs = torch.from_numpy((rng.standard_normal((10, 96, H)) * 0.5).astype(np.float32))
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)

    def run(xp, w, d=dhs):
        if mode == "kernel 7":
            return sk.lstm_scan_forward_plain(xp, w)
        return (sk.lstm_scan_backward_plain(xp, w, hs, cs, d),)

    want = run(x_proj, w_hh)
    assert all(f32_agreement(g, w).rel_err == 0.0 for g, w in zip(run(x_proj, w_hh), want))
    tf32 = [f32_agreement(g, w) for g, w in zip(run(round_to_tf32(x_proj), round_to_tf32(w_hh),
                                                    round_to_tf32(dhs)), want)]
    assert all(a.rel_err > 2 * MAX_REL_ERR_F32 for a in tf32), tf32
    assert not all(f32_agreement(g, w).ok() for g, w in zip(run(x_proj, torch.zeros_like(w_hh)), want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hp", [(100, 104), (36, 40), (37, 40)])
def test_padded_scan_route_equals_unpadded(dtype, H, Hp):
    """The any-H route of kernels 7 and 8: padding H per gate block with
    zeros (to Hp, as the wrappers do on the card for the kernels' multiple)
    changes nothing, forward or backward."""
    rng = np.random.default_rng(H)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32)).to(dtype)  # noqa: E731
    x_proj, dhs = f(10, 37, 4 * H), f(10, 37, H)
    w_hh = torch.from_numpy(rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), (4 * H, H)).astype(np.float32)).to(dtype)
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    phs, pcs = sk.padded_forward(sk.lstm_scan_forward_plain, x_proj, w_hh, Hp)
    dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    pdxp = sk.padded_backward(sk.lstm_scan_backward_plain, x_proj, w_hh, hs, cs, dhs, Hp)
    assert phs.shape == hs.shape and pdxp.shape == dxp.shape and pdxp.dtype == dtype
    for got, want in ((phs, hs), (pcs, cs), (pdxp, dxp)):
        if dtype == torch.bfloat16:
            assert_bf16_close(got, want, MAX_UNEQUAL_SHARE_CPU)
        else:
            assert_f32_close(got, want)
    # the padded units stay zero: h = c = 0 at every step
    p_hs, _ = sk.lstm_scan_forward_plain(sk._pad_units(x_proj, Hp, gates=True),
                                         sk._pad_units(sk._pad_units(w_hh, Hp).t(), Hp, gates=True).t())
    assert torch.equal(p_hs[..., H:], torch.zeros_like(p_hs[..., H:]))


def test_kernel_multiple_and_refusals():
    """The kernels' multiple of D and H is 16 bytes of the dtype; the fused
    wrappers' refusal names it, and no refusal sends a dtype to the CPU."""
    assert lk.kernel_multiple(torch.bfloat16) == 8 and lk.kernel_multiple(torch.float32) == 4
    with pytest.raises(TypeError, match="bfloat16 or float32") as e:
        lk._check_kernel_inputs(torch.float16, 8, 8)
    assert "cpu" not in str(e.value).lower()
    with pytest.raises(ValueError, match="divisible by 4"):
        lk._check_kernel_inputs(torch.float32, 128, 102)
    lk._check_kernel_inputs(torch.float32, 128, 100)  # 100 % 4 == 0


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_unfused_lstm_at_h100_matches_jax(monkeypatch, tdtype, jdtype):
    """H = 100, D = 64, B = 37: the JAX package takes ``lax.scan`` (H % 128
    != 0), the port its projection and kernels 7/8 (their plain versions
    here; on the card the padded route).  Value and, at f32, every gradient
    against the ``lax.scan``; at bf16 the gradients against the Pallas
    kernels at the same H on the zero-padded batch (module docstring)."""
    L, B, D, H = 10, 37, 64, 100
    rng = np.random.default_rng(H)
    init = {"w_ih": (4 * H, D), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
    params = {n: rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), s).astype(np.float32) for n, s in init.items()}
    x = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    dhs = (rng.standard_normal((L, B, H)) * 0.5).astype(np.float32)

    def jax_vjp(x_, dhs_):
        jp = {n: jnp.asarray(v) for n, v in params.items()}
        out, vjp = jax.vjp(jax_lstm.lstm_forward_tm, jp, jnp.asarray(x_).astype(jdtype))
        return out, vjp(jnp.asarray(dhs_).astype(jdtype))

    want, (want_gp, want_gx) = jax_vjp(x, dhs)
    if tdtype == torch.bfloat16:
        pad = -B % 8
        monkeypatch.setattr(jax_kernels, "pallas_supported", lambda *a: True)
        with pltpu.force_tpu_interpret_mode():
            _, (want_gp, want_gx) = jax_vjp(np.pad(x, ((0, 0), (0, pad), (0, 0))),
                                            np.pad(dhs, ((0, 0), (0, pad), (0, 0))))
        want_gx = want_gx[:, :B]

    pp = {n: torch.from_numpy(v).requires_grad_() for n, v in params.items()}
    px = torch.from_numpy(x).to(tdtype).requires_grad_()
    got = port_lstm.lstm_forward_tm(pp, px)
    got.backward(torch.from_numpy(dhs).to(tdtype))
    assert got.shape == (L, B, H) and got.dtype == tdtype

    def np32(a):
        return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) else a.detach().float().numpy()

    if tdtype == torch.float32:
        np.testing.assert_allclose(np32(got), np32(want), **F32_VALUE)
        np.testing.assert_allclose(np32(px.grad), np32(want_gx), **F32_GRAD)
        for n in params:
            np.testing.assert_allclose(np32(pp[n].grad), np32(want_gp[n]), **F32_GRAD)
        return
    assert_bf16_close(np32(got), np32(want), MAX_UNEQUAL_SHARE_CPU)
    assert_bf16_close(np32(px.grad), np32(want_gx), MAX_UNEQUAL_SHARE)
    # the weight and bias gradients by the bf16 rule at the backward's share:
    # db is an f32 sum of bf16 dgates, and one dgate flipped by an ulp moves
    # it by that ulp (here 2^-9 at max|db| = 12.3: 1.6e-4 of it, 0.03 bf16 ulps)
    for n in params:
        assert_bf16_close(np32(pp[n].grad.to(tdtype)), np32(want_gp[n].astype(jdtype)), MAX_UNEQUAL_SHARE_BWD)


def test_agreement_picks_the_rule_of_the_dtype():
    a = torch.randn(64)
    assert type(agreement(a, a)).__name__ == "F32Agreement"
    assert type(agreement(a.to(torch.bfloat16), a.to(torch.bfloat16))).__name__ == "Bf16Agreement"
    bumped = a * (1 + 4 * MAX_REL_ERR_F32)
    assert not agreement(bumped, a).ok() and agreement(a * (1 + MAX_REL_ERR_F32 / 4), a).ok()
