"""Batch normalization with torch.nn.BatchNorm1d semantics, functional
style: parameters ``{scale, bias}``, state ``{mean, var, count}``.

Counterpart of ``open_knowledge_graph_embeddings_tpu/ops/norm.py``:

* train: normalize by the biased batch variance and update the running
  statistics with the unbiased one, ``running = (1 - m) * running + m *
  batch``; ``momentum=None`` is torch's cumulative average over the batches
  seen (``count``);
* eval: normalize by the running statistics.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def init_batchnorm(
    num_features: int,
    uniform_weight: bool = False,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Returns (params {scale, bias}, state {mean, var, count}).
    ``uniform_weight`` draws the scale from U(0, 1), as token embedders do."""
    if uniform_weight:
        scale = torch.empty(num_features, device=device).uniform_(0.0, 1.0, generator=generator)
    else:
        scale = torch.ones(num_features, device=device)
    params = {"scale": scale, "bias": torch.zeros(num_features, device=device)}
    state = {
        "mean": torch.zeros(num_features, device=device),
        "var": torch.ones(num_features, device=device),
        "count": torch.zeros((), device=device),
    }
    return params, state


def apply_batchnorm(
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    x: torch.Tensor,
    train: bool = False,
    momentum: Optional[float] = 0.1,
    eps: float = 1e-5,
    group=None,
    n_total: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize ``x`` [B, F] -> ``(y, new_state)``.  The new running
    statistics are computed from detached batch statistics: they are state,
    not part of the gradient.  With ``n_total`` the batch is split over the
    ranks of ``group`` (``x`` is this rank's part of its ``n_total`` rows):
    the mean and the biased variance are sums over the group
    (differentiable all-reduces), so every rank normalizes by the whole
    batch's statistics."""
    if train and n_total is not None:
        from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import all_reduce_sum

        mean = all_reduce_sum(x.sum(0), group) / n_total
        var = all_reduce_sum(((x - mean) ** 2).sum(0), group) / n_total
        n = n_total
    elif train:
        mean = x.mean(0)
        var = x.var(0, unbiased=False)  # biased: used for the normalization
        n = x.shape[0]
    if train:
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            cnt = state["count"]
            if momentum is None:
                new_state = {
                    "mean": (state["mean"] * cnt + mean) / (cnt + 1.0),
                    "var": (state["var"] * cnt + unbiased) / (cnt + 1.0),
                    "count": cnt + 1.0,
                }
            else:
                new_state = {
                    "mean": (1 - momentum) * state["mean"] + momentum * mean,
                    "var": (1 - momentum) * state["var"] + momentum * unbiased,
                    "count": cnt + 1.0,
                }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y, new_state
