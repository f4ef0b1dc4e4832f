"""1-vs-N scoring: the prefix direction folds into a per-row query vector,
after which every row scores against the shared candidate matrix in one
product.  Counterpart of ``open_knowledge_graph_embeddings_tpu/ops/scoring.py``:
ComplEx, DistMult, RESCAL/Tucker3 and the two data-bias diagnostics.
"""

from __future__ import annotations

import torch


def score_against_candidates(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``[B, d] x [N, d] -> [B, N]`` float32 scores.

    bf16 operands are widened to f32 (exact) and multiplied in full f32, the
    f32-output product of the JAX package: a bf16 output would round the
    scores and make false ties.  TF32 is switched off for the call, since it
    would round the widened operands again."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(q.float(), cand.float().t())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def triple_scores(q: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Per-row scores ``sum(q * o, -1)`` -> [B]."""
    return (q * o).sum(-1)


def complex_query(e: torch.Tensor, r: torch.Tensor, is_sp: torch.Tensor) -> torch.Tensor:
    """ComplEx query vectors for a mixed batch: ``e ⊛ r`` for sp rows and
    ``e ⊛ conj(r)`` for po rows (``is_sp`` [B] bool)."""
    e1, e2 = e.chunk(2, dim=-1)
    r1, r2 = r.chunk(2, dim=-1)
    sign = torch.where(is_sp, 1.0, -1.0)[:, None].to(r2.dtype)
    r2s = r2 * sign
    return torch.cat([e1 * r1 - e2 * r2s, e2 * r1 + e1 * r2s], dim=-1)


def distmult_query(e: torch.Tensor, r: torch.Tensor, is_sp: torch.Tensor) -> torch.Tensor:
    """DistMult is direction-symmetric: q = e ⊙ r."""
    del is_sp
    return e * r


def rescal_query(e: torch.Tensor, r_mat: torch.Tensor, is_sp: torch.Tensor) -> torch.Tensor:
    """RESCAL/Tucker3 query vectors for a mixed batch: ``q_sp[j] = sum_i
    s_i R_ij`` and ``q_po[i] = sum_j R_ij o_j`` for ``r_mat`` [B, d, d], two
    batched mat-vecs accumulated in f32 (bf16 operands widened exactly),
    selected per row by ``is_sp`` and rounded once to ``e``'s dtype."""
    e32, r32 = e.float(), r_mat.float()
    q_sp = torch.bmm(e32[:, None, :], r32)[:, 0]
    q_po = torch.bmm(r32, e32[:, :, None])[:, :, 0]
    return torch.where(is_sp[:, None], q_sp, q_po).to(e.dtype)


def bias_relation_query(e: torch.Tensor, r: torch.Tensor, is_sp: torch.Tensor) -> torch.Tensor:
    """Relation-frequency diagnostic: the score depends on the relation only."""
    del e, is_sp
    return r


def bias_entity_query(e: torch.Tensor, r: torch.Tensor, is_sp: torch.Tensor) -> torch.Tensor:
    """Entity-similarity diagnostic: score = e · candidate."""
    del r, is_sp
    return e
