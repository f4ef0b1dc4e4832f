"""Batch normalization with torch.nn.BatchNorm1d semantics, functional
style: parameters ``{scale, bias}``, state ``{mean, var, count}``.

Counterpart of ``open_knowledge_graph_embeddings_tpu/ops/norm.py``; only
eval mode (running statistics), which serving uses, is ported so far.
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
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize ``x`` [B, F] by the running statistics -> (y, state)."""
    if train:
        raise NotImplementedError(
            "batchnorm in train mode comes with the training step (ROADMAP Queue 1)"
        )
    y = (x - state["mean"]) * torch.rsqrt(state["var"] + eps) * params["scale"] + params["bias"]
    return y, state
