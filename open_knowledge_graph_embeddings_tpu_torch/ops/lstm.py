"""Single-layer LSTM in torch gate order (i, f, g, o) with two bias vectors,
the stable length sort, and the two LSTM paths the embedders choose between.

Counterpart of ``open_knowledge_graph_embeddings_tpu/ops/lstm.py``:

* fused (:func:`lstm_last_fused`): the length-aware last-state LSTM of
  :mod:`.lstm_kernel`, which fuses the input projection into its kernels;
* unfused (:func:`lstm_forward_tm`): the input projection as one large
  product, rounded to the compute dtype once, then the recurrence over every
  row and step (:mod:`.lstm_scan_kernel`), every state out.

:func:`lstm_fused_supported` is JAX's choice between them on a TPU.  On the
CPU every kernel runs as its plain PyTorch version.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import lstm_encode_fused, lstm_encode_last_fused
from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_scan_kernel import lstm_scan, matmul_f32


def init_lstm_params(
    generator: torch.Generator, input_size: int, hidden_size: int, device=None
) -> Dict[str, torch.Tensor]:
    """Torch-default initialization: U(-1/sqrt(H), 1/sqrt(H)) for all weights."""
    k = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        return torch.empty(*shape, device=device).uniform_(-k, k, generator=generator)

    return {
        "w_ih": u(4 * hidden_size, input_size),
        "w_hh": u(4 * hidden_size, hidden_size),
        "b_ih": u(4 * hidden_size),
        "b_hh": u(4 * hidden_size),
    }


def length_sort_perm(lengths: torch.Tensor, max_len: int):
    """Stable descending-length permutation: a stable sort on ``max_len -
    len`` (the JAX package's counting sort gives the same order).  Returns
    ``(order, inv)`` with ``sorted_x = x[order]`` and ``x == sorted_x[inv]``."""
    order = torch.argsort(max_len - lengths, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return order, inv


def lstm_last_fused(
    params: Dict[str, torch.Tensor], emb_tm: torch.Tensor, lengths_sorted: torch.Tensor
) -> torch.Tensor:
    """``emb_tm`` [L, B, D] with rows sorted by descending length -> each
    row's last non-pad state [B, H] in ``emb_tm``'s dtype.  The weights are
    cast to the compute dtype here, once per encode, in the gate-major
    layout the kernel reads."""
    w_ih, w_hh, bias = _compute_weights(params, emb_tm.dtype)
    return lstm_encode_last_fused(emb_tm, w_ih, w_hh, bias, lengths_sorted)


def lstm_fused_supported(B: int, L: int, D: int, H: int) -> bool:
    """Whether the JAX package runs the fused encoder for a [L, B] token
    block on a TPU (``ops/lstm.py:99-109`` with ``pallas_supported``,
    ``ops/pallas/lstm_kernel.py:234-246``): neither ``OKET_DISABLE_LSTM_FUSED``
    nor ``OKET_DISABLE_PALLAS`` set, ``D`` and ``H`` multiples of 128 and ``B``
    a multiple of 8 (its smallest batch tile).  The rule does not look at the
    device, so the port computes on every device the function the JAX package
    computes on a TPU.  The switches are read at call time, as JAX reads them
    at trace time; here ``OKET_DISABLE_PALLAS`` only picks the unfused path,
    whose recurrence is still a kernel on the card."""
    if os.environ.get("OKET_DISABLE_LSTM_FUSED") or os.environ.get("OKET_DISABLE_PALLAS"):
        return False
    return D % 128 == 0 and H % 128 == 0 and B % 8 == 0


def _compute_weights(params: Dict[str, torch.Tensor], dtype):
    """Gate-major weights cast to the compute dtype and the f32 bias; autograd
    carries their gradients back through the cast to the f32 parameters, as
    JAX's ``astype`` VJP does."""
    w_ih = params["w_ih"].to(dtype).contiguous()
    w_hh = params["w_hh"].to(dtype).contiguous()
    return w_ih, w_hh, (params["b_ih"] + params["b_hh"]).float()


class _InputProjection(torch.autograd.Function):
    """``x_proj = dtype(x·W_ihᵀ + b)`` for ``x`` [N, D]: the product
    accumulated in f32, the f32 bias added, one rounding to the compute dtype
    (JAX ``ops/lstm.py:67-69``).  The backward is XLA's autodiff of that
    expression: ``dx = dtype(dx_proj·W_ih)`` and ``dW_ih = dtype(dx_projᵀ·x)``
    with f32 accumulation, ``db = Σ dx_proj`` in f32.  A plain large product,
    computed outside any kernel as the JAX package leaves it to XLA: on the
    card cuBLAS's bf16 product with f32 output (``matmul_f32``)."""

    @staticmethod
    def forward(ctx, x, w_ih, bias):
        ctx.save_for_backward(x, w_ih)
        return (matmul_f32(x, w_ih.t()) + bias).to(x.dtype)

    @staticmethod
    def backward(ctx, dxp):
        x, w_ih = ctx.saved_tensors
        dxp = dxp.to(x.dtype)
        dx = matmul_f32(dxp, w_ih).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = matmul_f32(dxp.t(), x).to(w_ih.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, dxp.float().sum(0)


def lstm_forward_tm(params: Dict[str, torch.Tensor], x_tm: torch.Tensor) -> torch.Tensor:
    """The unfused LSTM over time-major ``x_tm`` [L, B, D] -> every state
    [L, B, H] in ``x_tm``'s dtype, zero initial state: the input projection
    hoisted out of the recurrence (one [L·B, D] x [D, 4H] product, rounded
    to the compute dtype after the bias), then the recurrence over every row
    and step (kernels 7 and 8 on the card)."""
    L, B, D = x_tm.shape
    dtype = x_tm.dtype
    w_ih, w_hh, bias = _compute_weights(params, dtype)
    x_proj = _InputProjection.apply(x_tm.reshape(L * B, D), w_ih, bias)
    return lstm_scan(x_proj.reshape(L, B, -1), w_hh)


def lstm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Batch-major wrapper: ``x`` [B, L, D] -> outputs [B, L, H]."""
    return lstm_forward_tm(params, x.transpose(0, 1)).transpose(0, 1)


def lstm_forward_tm_sorted(
    params: Dict[str, torch.Tensor], emb_tm: torch.Tensor, lengths_sorted: torch.Tensor
) -> torch.Tensor:
    """Length-aware fused LSTM returning every state: ``emb_tm`` [L, B, D]
    with rows sorted by descending length -> [L, B, H]; the positions at or
    past a row's length hold unread garbage on the card (kernels 5 and 6)."""
    w_ih, w_hh, bias = _compute_weights(params, emb_tm.dtype)
    return lstm_encode_fused(emb_tm, w_ih, w_hh, bias, lengths_sorted)


def last_states(out_tm: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's state at its last non-pad position, ``clip(len - 1, 0,
    L - 1)``, from time-major ``out_tm`` [L, B, H] -> [B, H] (JAX's
    ``take_along_axis``)."""
    idx = (lengths.long() - 1).clamp(0, out_tm.shape[0] - 1)
    return torch.take_along_dim(out_tm, idx[None, :, None], dim=0)[0]


def lstm_last_state(params: Dict[str, torch.Tensor], x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Output at the last non-pad position of batch-major ``x`` [B, L, D]
    (reference semantics: ``(input > 0).sum(1) - 1``)."""
    return last_states(lstm_forward_tm(params, x.transpose(0, 1)), lengths)
