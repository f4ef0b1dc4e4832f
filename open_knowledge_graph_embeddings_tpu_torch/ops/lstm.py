"""Single-layer LSTM in torch gate order (i, f, g, o) with two bias vectors,
the stable length sort, and the last-state encoder the embedders call.

Counterpart of ``open_knowledge_graph_embeddings_tpu/ops/lstm.py``.  The
port has one LSTM: the fused length-aware last-state LSTM and its backward
(:mod:`.lstm_kernel`), whose CPU path is their plain PyTorch versions.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import lstm_encode_last_fused


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
    layout the kernel reads; autograd carries their gradients back through
    the cast to the f32 parameters, as JAX's ``astype`` VJP does."""
    dtype = emb_tm.dtype
    w_ih = params["w_ih"].to(dtype).contiguous()
    w_hh = params["w_hh"].to(dtype).contiguous()
    bias = (params["b_ih"] + params["b_hh"]).float()
    return lstm_encode_last_fused(emb_tm, w_ih, w_hh, bias, lengths_sorted)
