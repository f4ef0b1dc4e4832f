"""1-vs-N losses over the batch-shared (or full) candidate space.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/loss.py``: the
train step's fused BCE score + loss, and the eval step's loss over a score
matrix, BCE without a dense label matrix and KL over dense 0/1 labels
scattered from the positive pairs.  With unique (row, col) positive pairs
(the batch builder guarantees them), the BCE label of a cell is
``multi_hot * a + b`` with ``a = 1 - smoothing`` and ``b = (1 - smoothing)
/ N`` (``a = 1, b = 0`` without smoothing), so

    loss = sum_mask[ max(s, 0) + log1p(e^-|s|) - b*s ] - a * sum_pos s.

KL takes no label smoothing, as in the JAX package (its ``one_vs_n_loss``
passes the unsmoothed dense labels to ``kl_div_sum``).
"""

from __future__ import annotations

from typing import Optional

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates


def dense_labels(pos_rows: torch.Tensor, pos_cols: torch.Tensor, num_rows: int, num_cols: int) -> torch.Tensor:
    """A [B, N] f32 multi-hot label matrix scattered from -1-padded (row,
    col) pairs: duplicates collapse to 1, and padding pairs point at cell
    (0, 0) with 0, which a real label there outweighs."""
    valid = pos_rows >= 0
    flat = torch.where(valid, pos_rows.long() * num_cols + pos_cols.long(), 0)
    labels = torch.zeros(num_rows * num_cols, dtype=torch.float32, device=pos_rows.device)
    return labels.scatter_reduce_(0, flat, valid.float(), reduce="amax").view(num_rows, num_cols)


def cell_mask(row_valid: torch.Tensor, col_valid: Optional[torch.Tensor], num_cols: int) -> torch.Tensor:
    """[B, N] mask of real (non-padding) label cells."""
    rm = row_valid[:, None]
    if col_valid is None:
        return rm.expand(row_valid.shape[0], num_cols)
    return rm & col_valid[None, :]


def apply_label_smoothing(labels: torch.Tensor, n_real_cols, smoothing: float) -> torch.Tensor:
    """``(labels + 1/N) * (1 - smoothing)`` on every cell (the reference's
    arithmetic); kept for parity with the JAX package, which calls it on no
    path either."""
    if smoothing <= 0:
        return labels
    return (labels + 1.0 / n_real_cols) * (1.0 - smoothing)


def kl_div_sum(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """torch ``KLDivLoss(reduction='sum')(log_softmax(scores), labels)``:
    ``sum labels * (log labels - log_softmax(scores))`` with 0·log 0 = 0,
    the softmax over the real cells only (padding masked to ``finfo.min``).
    With ``group``, ``scores`` is this rank's block of the columns and the
    softmax runs over every rank's block: the row max (a shift, no
    gradient) and the sum of exponentials are reduced over the group."""
    masked = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    if group is None:
        logp = torch.log_softmax(masked, dim=-1)
    else:
        from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import _all_reduce, all_reduce_sum

        m = _all_reduce(masked.detach().amax(dim=-1, keepdim=True).contiguous(), group, op="max")
        se = all_reduce_sum(torch.exp(masked - m).sum(dim=-1, keepdim=True), group)
        logp = masked - m - torch.log(se)
    safe = torch.where(labels > 0, labels, 1.0)
    per_cell = labels * (torch.log(safe) - logp)
    return torch.where(mask & (labels > 0), per_cell, 0.0).sum()


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


def one_vs_n_loss(loss_type: str, scores, pos_rows, pos_cols, row_valid, col_valid, n_real_cols,
                  label_smoothing: float = 0.0, group=None):
    """``(loss_sum, normalizer_metric = number of positive cells)`` over a
    [B, N] score matrix: the eval step's loss, and the train step's for KL.
    BCE takes the indexed form; KL the dense labels, unsmoothed.  With
    ``group`` the columns are this rank's block of a model axis
    (:func:`kl_div_sum`); the sums are this rank's part."""
    B, N = scores.shape
    mask = cell_mask(row_valid, col_valid, N)
    if loss_type == "bce":
        loss = bce_with_logits_sum_indexed(scores, pos_rows, pos_cols, mask, n_real_cols, label_smoothing)
    elif loss_type == "kl":
        loss = kl_div_sum(scores, dense_labels(pos_rows, pos_cols, B, N), mask, group)
    else:
        raise ValueError(f"loss {loss_type!r} not supported; choose 'bce' or 'kl' (reference parity)")
    return loss, (pos_rows >= 0).sum().float()
