"""Filtered top-k over the candidate cache, without the [B, N] score matrix.

Counterpart of ``filtered_topk_chunked`` in
``open_knowledge_graph_embeddings_tpu/train/evaluate.py``, with the same tie
order as ``lax.top_k``: equal scores keep the lower index first, and the
merge prefers the running top-k, so overall the lowest column wins a tie.
The synthetic and the real OLPBench vocabularies hold many mentions with
identical token sequences, so exact ties are common.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates

FILTER_VALUE = -1e8  # reference filter mask value


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` on float32 ``x`` [B, M]: the k largest values per row in
    descending order, equal values lowest position first.

    ``torch.topk`` leaves the order of ties open, so each value is mapped to
    an int32 that orders like the float's total order and joined with the
    reversed position into one unique int64 key."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    pos = torch.arange(x.shape[-1], device=x.device)
    key = ordered * (1 << 32) + (0xFFFFFFFF - pos)
    _, idx = torch.topk(key, k, dim=-1)
    return torch.gather(x, -1, idx), idx


def filtered_topk_chunked(
    q: torch.Tensor,  # [B, d] query vectors
    cand_emb: torch.Tensor,  # [N, d] candidate matrix (the eval cache)
    filter_rows: torch.Tensor,
    filter_cols: torch.Tensor,
    col_valid: Optional[torch.Tensor],
    k: int,
    chunk: int = 131072,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidate columns per prefix with known-true cells (the -1
    padded ``filter_rows`` / ``filter_cols`` pairs) set to ``FILTER_VALUE``:
    a per-chunk top-k merged with the running top-k.  Returns
    (top_scores [B, k] f32, top_cols [B, k] int32)."""
    B = q.shape[0]
    N = cand_emb.shape[0]
    C = min(chunk, N)
    n_chunks = -(-N // C)
    kk = min(k, N)
    dev = q.device

    f_valid = (filter_rows >= 0) & (filter_cols >= 0)
    fr = torch.where(f_valid, filter_rows, 0).long()
    fc = torch.where(f_valid, filter_cols, 0).long()
    col_arange = torch.arange(C, device=dev)

    ts = torch.full((B, kk), float("-inf"), device=dev)
    tc = torch.zeros((B, kk), dtype=torch.int32, device=dev)
    for i in range(n_chunks):
        c0 = i * C
        s0 = min(c0, N - C)  # the last chunk overlaps the one before it
        col_ids = s0 + col_arange
        okc = col_ids >= c0
        if col_valid is not None:
            okc &= col_valid[s0 : s0 + C]
        s = score_against_candidates(q, cand_emb[s0 : s0 + C])
        in_f = f_valid & (fc >= c0) & (fc < c0 + C) & (fc < N)
        s[fr[in_f], fc[in_f] - s0] = FILTER_VALUE
        s = torch.where(okc[None, :], s, float("-inf"))
        cs, cc = stable_topk(s, kk)
        merged_s, pos = stable_topk(torch.cat([ts, cs], dim=1), kk)
        cols = torch.cat([tc, col_ids[cc].to(torch.int32)], dim=1)
        ts, tc = merged_s, torch.gather(cols, 1, pos)
    return ts, tc
