"""1-vs-N BCE over the batch-shared (or full) candidate space, without a
dense label matrix.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/loss.py`` for the
train step's BCE (KL and the explicit dense-label path come with ROADMAP
Queue 1 item 4).  With unique (row, col) positive pairs (the batch builder
guarantees them), the label of a cell is ``multi_hot * a + b`` with
``a = 1 - smoothing`` and ``b = (1 - smoothing) / N`` (``a = 1, b = 0``
without smoothing), so

    loss = sum_mask[ max(s, 0) + log1p(e^-|s|) - b*s ] - a * sum_pos s.
"""

from __future__ import annotations

from typing import Optional

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates


def cell_mask(row_valid: torch.Tensor, col_valid: Optional[torch.Tensor], num_cols: int) -> torch.Tensor:
    """[B, N] mask of real (non-padding) label cells."""
    rm = row_valid[:, None]
    if col_valid is None:
        return rm.expand(row_valid.shape[0], num_cols)
    return rm & col_valid[None, :]


def _smoothing_ab(smoothing: float, n_real_cols):
    if smoothing > 0:
        return 1.0 - smoothing, (1.0 - smoothing) / n_real_cols
    return 1.0, 0.0


def _positives(pos_rows, pos_cols):
    """Padding pairs (-1) point at cell (0, 0) with weight 0."""
    valid = pos_rows >= 0
    return valid, torch.where(valid, pos_rows, 0).long(), torch.where(valid, pos_cols, 0).long()


def bce_with_logits_sum_indexed(scores, pos_rows, pos_cols, mask, n_real_cols, smoothing: float):
    """Sum over the real cells of BCE-with-logits (torch ``reduction='sum'``)
    with the labels given as unique (row, col) pairs (-1 padded)."""
    a, b = _smoothing_ab(smoothing, n_real_cols)
    per_cell = torch.clamp(scores, min=0.0) + torch.log1p(torch.exp(-scores.abs()))
    if smoothing > 0:
        per_cell = per_cell - scores * b
    base = torch.where(mask, per_cell, 0.0).sum()
    valid, r, c = _positives(pos_rows, pos_cols)
    s_pos = torch.where(valid, scores[r, c], 0.0)
    return base - a * s_pos.sum()


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product with TF32 off (it would round the f32 operands)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _BceOverScores(torch.autograd.Function):
    """``BCE_sum(q @ candᵀ)`` with JAX's hand-written VJP
    (``_bce_over_scores_bwd``): the elementwise part ``ct·(σ(s) − b)·mask``
    feeds the two f32 gradient products directly, and the positive-label
    term lands on dq/dcand as a [P, d] f32 gather/scatter-add — no dense
    [B, N] label or gradient scatter."""

    @staticmethod
    def forward(ctx, q, cand, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, smoothing):
        scores = score_against_candidates(q, cand)
        mask = cell_mask(row_valid, col_valid, scores.shape[1])
        loss = bce_with_logits_sum_indexed(scores, pos_rows, pos_cols, mask, n_real_cols, smoothing)
        ctx.save_for_backward(q, cand, scores, pos_rows, pos_cols, mask, n_real_cols)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, ct):
        q, cand, scores, pos_rows, pos_cols, mask, n_real_cols = ctx.saved_tensors
        a, b = _smoothing_ab(ctx.smoothing, n_real_cols)
        base = torch.where(mask, ct * (torch.sigmoid(scores) - b), 0.0)
        q32, cand32 = q.float(), cand.float()
        dq = _f32_product(base, cand32)
        dcand = _f32_product(base.t(), q32)
        valid, r, c = _positives(pos_rows, pos_cols)
        w = torch.where(valid, -a * ct, 0.0)[:, None]
        dq.index_add_(0, r, w * cand32[c])
        dcand.index_add_(0, c, w * q32[r])
        return dq.to(q.dtype), dcand.to(cand.dtype), None, None, None, None, None, None


def bce_over_scores(q, cand, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, smoothing: float = 0.0):
    """Fused ``loss = BCE_sum(q [B, d] @ cand [N, d]ᵀ)`` over the real cells
    (``row_valid`` [B], ``col_valid`` [N] or None), positives as -1-padded
    (row, col) pairs, ``n_real_cols`` an f32 scalar tensor; differentiable
    in ``q`` and ``cand``."""
    return _BceOverScores.apply(q, cand, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, smoothing)
