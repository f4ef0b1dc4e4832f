"""The port's last-state LSTM and length sort against the JAX package.

The port's CPU path is the plain PyTorch version of the CUDA kernel
(``ops/lstm_kernel.py``), which keeps the input projection in f32 like the
TPU kernel.  So it is held against JAX's ``lstm_last_fused`` run in Pallas
interpret mode at f32 and bf16, and against the scan path
(``lstm_forward_tm`` + last-state select) at f32 only: at bf16 the scan
path rounds the hoisted projection to bf16 (``ops/lstm.py:67-69``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from open_knowledge_graph_embeddings_tpu.ops import lstm as jax_lstm
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_UNEQUAL_SHARE_CPU,
    assert_bf16_close,
)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

# f32: both sides accumulate the same f32 products in another order.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: utils/numerics.py's rule, at most 4 bf16 ulps of max|want| (|h| up
# to ~0.32 here, so 4 * 2^-9) and at most 0.5 % of elements not bit-equal;
# measured 0.01 ulps and 0.02 %.  h not rounded before the recurrent product
# gives 9 % unequal, a bf16-rounded input projection 4-7 %.


def _case(B, L=10, D=128, seed=0, sort=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, B).astype(np.int32)  # zero-length rows included
    if sort:
        lens = np.sort(lens)[::-1].copy()
    emb = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    k = 1.0 / np.sqrt(D)
    params = {
        "w_ih": rng.uniform(-k, k, (4 * D, D)).astype(np.float32),
        "w_hh": rng.uniform(-k, k, (4 * D, D)).astype(np.float32),
        "b_ih": rng.uniform(-k, k, 4 * D).astype(np.float32),
        "b_hh": rng.uniform(-k, k, 4 * D).astype(np.float32),
    }
    return lens, emb, params


def _port_last(params, emb, lens, tdtype):
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    out = port_lstm.lstm_last_fused(p, torch.from_numpy(emb).to(tdtype), torch.from_numpy(lens))
    assert out.dtype == tdtype
    return out.float().numpy()


def _jax_fused_last(params, emb, lens, jdtype):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    with pltpu.force_tpu_interpret_mode():
        out = jax_lstm.lstm_last_fused(p, jnp.asarray(emb).astype(jdtype), jnp.asarray(lens))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize(
    "tdtype,jdtype", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)], ids=["f32", "bf16"]
)
def test_last_state_matches_pallas_interpret(tdtype, jdtype):
    lens, emb, params = _case(B=64)
    assert lens.min() == 0 and lens.max() == 10
    got = _port_last(params, emb, lens, tdtype)
    want = _jax_fused_last(params, emb, lens, jdtype)
    if tdtype == torch.bfloat16:
        assert_bf16_close(got, want, MAX_UNEQUAL_SHARE_CPU)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("B", [37, 96])
def test_last_state_matches_scan_f32(B):
    """Ragged B included: the port has no gate on B % 8."""
    lens, emb, params = _case(B=B, seed=B)
    got = _port_last(params, emb, lens, torch.float32)
    out_tm = jax_lstm.lstm_forward_tm({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(emb))
    idx = np.clip(lens.astype(np.int64) - 1, 0, emb.shape[0] - 1)
    want = np.take_along_axis(np.asarray(out_tm), idx[None, :, None], axis=0)[0]
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_version_is_row_independent():
    """A row's last state does not depend on the other rows of the batch:
    one row alone equals the same row inside a ragged batch."""
    lens, emb, params = _case(B=37, seed=5)
    full = _port_last(params, emb, lens, torch.bfloat16)
    for r in (0, 17, 36):
        one = _port_last(params, emb[:, r : r + 1].copy(), lens[r : r + 1].copy(), torch.bfloat16)
        np.testing.assert_array_equal(one[0], full[r])


@pytest.mark.parametrize("B,L", [(1, 10), (50, 10), (257, 7)])
def test_length_sort_perm_matches_jax(B, L):
    rng = np.random.default_rng(B)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    order_j, pos_j = jax_lstm.length_sort_perm(jnp.asarray(lengths), L)
    order, inv = port_lstm.length_sort_perm(torch.from_numpy(lengths), L)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(pos_j))


def test_init_lstm_params_shapes_and_range():
    p = port_lstm.init_lstm_params(torch.Generator().manual_seed(0), 96, 64)
    assert tuple(p["w_ih"].shape) == (256, 96) and tuple(p["w_hh"].shape) == (256, 64)
    assert tuple(p["b_ih"].shape) == (256,) and tuple(p["b_hh"].shape) == (256,)
    k = 1.0 / np.sqrt(64)
    assert all(float(v.abs().max()) <= k for v in p.values())


def test_wrapper_validates_inputs():
    lens, emb, params = _case(B=8, L=4, D=16)
    e = torch.from_numpy(emb)
    wih = torch.from_numpy(params["w_ih"])
    whh = torch.from_numpy(params["w_hh"])
    bias = torch.from_numpy(params["b_ih"] + params["b_hh"])
    ln = torch.from_numpy(lens)
    with pytest.raises(ValueError, match="weights"):
        lstm_kernel.lstm_encode_last_fused(e, wih.t(), whh, bias, ln)
    with pytest.raises(ValueError, match="bias"):
        lstm_kernel.lstm_encode_last_fused(e, wih, whh, bias.double(), ln)
    with pytest.raises(ValueError, match="lengths"):
        lstm_kernel.lstm_encode_last_fused(e, wih, whh, bias, ln[:3])
    before = lstm_kernel.lstm_encode_last_fused.launches
    lstm_kernel.lstm_encode_last_fused(e, wih, whh, bias, ln)  # CPU: plain version, no launch
    assert lstm_kernel.lstm_encode_last_fused.launches == before
    # only CPU tensors take the plain version: another device has no kernel
    meta = [x.to("meta") for x in (e, wih, whh, bias, ln)]
    with pytest.raises(ValueError, match="no LSTM kernel"):
        lstm_kernel.lstm_encode_last_fused(*meta)

