"""Filtered ranking and filtered top-k, the eval half of the step library.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/evaluate.py``.
A gold answer's rank is computed as in the reference:

* ``true[g]`` = max over the gold's mention-alternative columns of the raw
  scores (the best alternative takes the credit),
* filtered scores = scores with every known-true cell set to ``-1e8`` and
  padding columns left out,
* ``rank[g]`` = #(filtered > true) + #(filtered == true) // 2.

The filter is applied as sparse corrections of the raw counts (the per-row
filter sets are unique), so no [B, N] mask is built.  The synthetic and the
real OLPBench vocabularies hold many mentions with identical token
sequences, so exact ties are the normal case, not an edge case: the value a
gold is compared with and the values it is compared against must come out
of one product (see :func:`eval_stats_chunked`).

:func:`filtered_topk_chunked` and :func:`stable_topk` keep ``lax.top_k``'s
tie order: equal scores keep the lower index first, and the merge prefers
the running top-k, so overall the lowest column wins a tie.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates

FILTER_VALUE = -1e8  # reference filter mask value
#: above this many candidates a cache is scored chunk by chunk
CHUNKED_ABOVE = 100_000


def scatter_mask(rows: torch.Tensor, cols: torch.Tensor, num_rows: int, num_cols: int) -> torch.Tensor:
    """[B, N] boolean mask from (row, col) pairs (-1 padded)."""
    valid = rows >= 0
    mask = torch.zeros((num_rows, num_cols), dtype=torch.bool, device=rows.device)
    mask[rows[valid].long(), cols[valid].long()] = True
    return mask


def _golds(gold_rows, gold_mention_cols):
    """(mention-column mask [G, A], gold_valid [G], the golds' rows [G]
    with 0 for padding).  A gold with no valid mention column is not
    ranked."""
    m_valid = gold_mention_cols >= 0
    gold_valid = (gold_rows >= 0) & m_valid.any(dim=1)
    return m_valid, gold_valid, torch.where(gold_valid, gold_rows, 0).long()


def _filters(filter_rows, filter_cols, col_valid):
    """(filter pairs that count [F], their rows [F], their columns [F]),
    padding pairs pointing at cell (0, 0)."""
    f_valid = (filter_rows >= 0) & (filter_cols >= 0)
    fr = torch.where(f_valid, filter_rows, 0).long()
    fc = torch.where(f_valid, filter_cols, 0).long()
    f_ok = f_valid if col_valid is None else f_valid & col_valid[fc]
    return f_ok, fr, fc


def _count(cond: torch.Tensor) -> torch.Tensor:
    return cond.sum(dim=-1, dtype=torch.int64)


def ranks_from_scores(
    scores: torch.Tensor,  # [B, N] raw prediction scores
    filter_rows: torch.Tensor,  # [F] (-1 pad)
    filter_cols: torch.Tensor,  # [F]
    gold_rows: torch.Tensor,  # [G] (-1 pad)
    gold_mention_cols: torch.Tensor,  # [G, A] (-1 pad)
    col_valid: Optional[torch.Tensor],  # [N] bool or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ranks [G] int32, gold_valid [G] bool)`` from one [B, N] score
    matrix: the counts over each gold's raw row, then for each filter pair
    in the gold's row its raw contribution swapped for ``FILTER_VALUE``'s
    (exact: the builder's filter pairs are unique)."""
    m_valid, gold_valid, g_rows = _golds(gold_rows, gold_mention_cols)
    m_cols = torch.where(m_valid, gold_mention_cols, 0).long()
    true = torch.where(m_valid, scores[g_rows[:, None], m_cols], float("-inf")).amax(dim=1)  # [G]
    t = true[:, None]
    srow = scores[g_rows]  # [G, N]
    ok = True if col_valid is None else col_valid[None, :]
    false_pos = _count((srow > t) & ok)
    equals = _count((srow == t) & ok)

    f_ok, fr, fc = _filters(filter_rows, filter_cols, col_valid)
    fs = scores[fr, fc][None, :]  # [1, F]
    match = (fr[None, :] == g_rows[:, None]) & f_ok[None, :] & gold_valid[:, None]
    false_pos = false_pos - _count(match & (fs > t)) + _count(match & (FILTER_VALUE > t))
    equals = equals - _count(match & (fs == t)) + _count(match & (FILTER_VALUE == t))
    return (false_pos + equals // 2).to(torch.int32), gold_valid


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


def eval_stats_chunked(
    q: torch.Tensor,  # [B, d] query vectors
    cand_emb: torch.Tensor,  # [N, d] candidate matrix (the eval cache)
    pos_rows: torch.Tensor,
    pos_cols: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: Optional[torch.Tensor],
    n_real_cols: torch.Tensor,
    filter_rows: torch.Tensor,
    filter_cols: torch.Tensor,
    gold_rows: torch.Tensor,
    gold_mention_cols: torch.Tensor,
    label_smoothing: float = 0.0,
    chunk: int = 131072,
    loss_type: str = "bce",
    block=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The loss (BCE, or KL by an online logsumexp) and filtered ranks
    without the [B, N] score matrix, in two passes over chunks of C
    candidates -> ``(loss_sum, ranks [G] int32, gold_valid [G])``.  Pass A
    sums the loss terms (KL: per row a running max and sum-exp over the
    real cells, and the positives' scores; the loss is the sum over
    positives of ``logsumexp(row) - s_pos``) and takes each gold's
    ``true`` and the values of the filter cells in its row; pass B counts
    ``>`` and ``==`` against the final ``true``.

    Where the port differs from the JAX package, and why: JAX's pass A takes
    ``true`` and the filter values from the [B, C] chunk product, while its
    pass B compares in a [G, C] product over the gold rows, and it relies on
    the two products giving bitwise equal values for equal rows.  cuBLAS may
    pick another kernel, with another summation order, for each number of
    rows, and so may the CPU's GEMM, so that equality cannot be assumed
    here; with exact ties the normal case, one ulp between the two turns a
    tie into a ``>`` or a ``<``.  So every value a rank compares comes from
    one product shape, the [Gv, C] product of the valid golds' query rows:
    ``true``, each gold row's filter-cell values and the counts.  Both
    passes run that product on the same chunk, and the last chunk overlaps
    the one before it, so every chunk has the same shape.  The [B, C]
    product feeds only the loss.  The ranks are the same function as JAX's.

    On a model axis (``block``, a ``parallel.sharding.RowBlock``)
    ``cand_emb`` is this rank's block of the N candidates (columns
    ``[block.lo, block.hi)``; the other arguments keep global columns).
    Every rank of the block's group chunks at the width of the largest
    block (a shorter block is padded, its padding columns invalid), so
    every rank runs the same product shape.  Each gold's mention rows are
    gathered from their owners (the boundary gather, exact) and ``true``
    taken from a [Gv, C] product of them, the same on every rank; each rank
    counts its block's columns and applies the filter corrections of the
    pairs in its block, and the counts and the loss are summed over the
    group (KL: the row max and the sum of exponentials first).
    """
    if loss_type not in ("bce", "kl"):
        raise ValueError(f"loss {loss_type!r} not supported; choose 'bce' or 'kl' (reference parity)")
    if block is not None:
        return _eval_stats_block(q, cand_emb, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, filter_rows,
                                 filter_cols, gold_rows, gold_mention_cols, label_smoothing, chunk, loss_type, block)
    B = q.shape[0]
    N = cand_emb.shape[0]
    C = min(chunk, N)
    n_chunks = -(-N // C)
    dev = q.device
    a, b = (1.0 - label_smoothing, (1.0 - label_smoothing) / n_real_cols) if label_smoothing > 0 else (1.0, 0.0)
    p_valid = pos_rows >= 0
    pr = torch.where(p_valid, pos_rows, 0).long()
    pc = torch.where(p_valid, pos_cols, 0).long()

    m_valid, gold_valid, g_rows = _golds(gold_rows, gold_mention_cols)
    gi = torch.nonzero(gold_valid).squeeze(1)  # the valid golds, Gv of them
    q_g = q[g_rows[gi]]  # [Gv, d]: a gold's query row, once per gold
    gm = gold_mention_cols[gi].long()
    gm_valid = m_valid[gi]
    f_ok, fr, fc = _filters(filter_rows, filter_cols, col_valid)
    # (gold, filter pair) for every filter pair in a valid gold's row
    pg, pf = ((fr[None, :] == g_rows[gi][:, None]) & f_ok[None, :]).nonzero(as_tuple=True)
    p_col = fc[pf]
    Gv = gi.shape[0]
    col_arange = torch.arange(C, device=dev)

    def chunk_cols(i):
        c0 = i * C
        s0 = min(c0, N - C)  # the last chunk overlaps the one before it
        okc = (s0 + col_arange) >= c0
        if col_valid is not None:
            okc &= col_valid[s0 : s0 + C]
        return c0, s0, okc

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    m_run = torch.full((B,), float("-inf"), device=dev)  # KL: running row max
    se_run = torch.zeros(B, device=dev)  # KL: running sum of exp(s - m_run)
    true = torch.full((Gv,), float("-inf"), device=dev)
    fs = torch.zeros(pg.shape[0], device=dev)
    for i in range(n_chunks):
        c0, s0, okc = chunk_cols(i)
        blk = cand_emb[s0 : s0 + C]
        s = score_against_candidates(q, blk)  # [B, C]: the loss only
        ok_cell = row_valid[:, None] & okc[None, :]
        in_p = p_valid & (pc >= c0) & (pc < c0 + C)
        s_pos = torch.where(in_p, s[pr, (pc - s0).clamp(0, C - 1)], 0.0).sum()
        if loss_type == "kl":
            m_new = torch.maximum(m_run, torch.where(ok_cell, s, float("-inf")).amax(dim=1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            scale = torch.exp(torch.where(torch.isfinite(m_run), m_run - m_safe, float("-inf")))
            se_run = se_run * scale + torch.where(ok_cell, torch.exp(s - m_safe[:, None]), 0.0).sum(dim=1)
            m_run = m_new
            loss = loss + s_pos  # the positives' scores, subtracted below
        else:
            per_cell = torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs())) - s * b
            loss = loss + torch.where(ok_cell, per_cell, 0.0).sum() - a * s_pos
        if Gv:
            sg = score_against_candidates(q_g, blk)  # [Gv, C]
            in_m = gm_valid & (gm >= c0) & (gm < c0 + C)
            vm = sg.gather(1, (gm - s0).clamp(0, C - 1))
            true = torch.maximum(true, torch.where(in_m, vm, float("-inf")).amax(dim=1))
            in_f = (p_col >= c0) & (p_col < c0 + C)
            fs = torch.where(in_f, sg[pg, (p_col - s0).clamp(0, C - 1)], fs)

    if loss_type == "kl":
        lse = torch.where(torch.isfinite(m_run), m_run + torch.log(torch.clamp(se_run, min=1e-38)), 0.0)
        loss = torch.where(p_valid, lse[pr], 0.0).sum() - loss

    false_pos = torch.zeros(Gv, dtype=torch.int64, device=dev)
    equals = torch.zeros(Gv, dtype=torch.int64, device=dev)
    t = true[:, None]
    for i in range(n_chunks if Gv else 0):
        c0, s0, okc = chunk_cols(i)
        sg = score_against_candidates(q_g, cand_emb[s0 : s0 + C])
        false_pos += _count((sg > t) & okc[None, :])
        equals += _count((sg == t) & okc[None, :])

    # the sparse filter corrections of ranks_from_scores, per (gold, pair)
    tp = true[pg]

    def per_gold(cond):
        return torch.zeros(Gv, dtype=torch.int64, device=dev).index_add_(0, pg, cond.long())

    false_pos = false_pos - per_gold(fs > tp) + per_gold(FILTER_VALUE > tp)
    equals = equals - per_gold(fs == tp) + per_gold(FILTER_VALUE == tp)
    ranks = torch.zeros(gold_rows.shape[0], dtype=torch.int32, device=dev)
    ranks[gi] = (false_pos + equals // 2).to(torch.int32)
    return loss, ranks, gold_valid


def _eval_stats_block(q, cand, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, filter_rows, filter_cols,
                      gold_rows, gold_mention_cols, label_smoothing, chunk, loss_type, block):
    """:func:`eval_stats_chunked` over this rank's block of the candidates
    (see its docstring)."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import _all_reduce, boundary_gather

    group, lo, nb = block.group, block.lo, block.hi - block.lo
    B, dev = q.shape[0], q.device
    C = min(chunk, block.width)
    if nb < C:  # the same product shape as the ranks with the widest block
        cand = torch.cat([cand, cand.new_zeros((C - nb, cand.shape[1]))])
    N = cand.shape[0]
    n_chunks = -(-N // C)
    local_valid = torch.zeros(N, dtype=torch.bool, device=dev)
    local_valid[:nb] = True if col_valid is None else col_valid[lo : lo + nb]
    a, b = (1.0 - label_smoothing, (1.0 - label_smoothing) / n_real_cols) if label_smoothing > 0 else (1.0, 0.0)
    p_valid = (pos_rows >= 0) & (pos_cols >= lo) & (pos_cols < lo + nb)
    pr = torch.where(p_valid, pos_rows, 0).long()
    pc = torch.where(p_valid, pos_cols - lo, 0).long()

    m_valid, gold_valid, g_rows = _golds(gold_rows, gold_mention_cols)
    gi = torch.nonzero(gold_valid).squeeze(1)
    q_g = q[g_rows[gi]]  # [Gv, d]
    Gv = gi.shape[0]
    # true: every mention row of the valid golds gathered from its owner,
    # then scored in [Gv, C] products of packed chunks of those rows
    g_of, a_of = m_valid[gi].nonzero(as_tuple=True)
    m_cols = gold_mention_cols[gi][g_of, a_of].long()
    true = torch.full((Gv,), float("-inf"), device=dev)
    if Gv:
        rows = boundary_gather(cand[:nb], m_cols, lo, group)
        for j in range(0, rows.shape[0], C):
            part = rows[j : j + C]
            pack = torch.cat([part, part.new_zeros((C - part.shape[0], part.shape[1]))])
            sg = score_against_candidates(q_g, pack)  # [Gv, C]
            k = torch.arange(part.shape[0], device=dev)
            true = true.scatter_reduce(0, g_of[j : j + C], sg[g_of[j : j + C], k], reduce="amax")
    # the filter pairs in a valid gold's row and in this rank's block
    f_ok, fr, fc = _filters(filter_rows, filter_cols, col_valid)
    f_ok = f_ok & (fc >= lo) & (fc < lo + nb)
    pg, pf = ((fr[None, :] == g_rows[gi][:, None]) & f_ok[None, :]).nonzero(as_tuple=True)
    p_col = fc[pf] - lo
    col_arange = torch.arange(C, device=dev)

    loss = torch.zeros((), dtype=torch.float32, device=dev)
    m_run = torch.full((B,), float("-inf"), device=dev)
    se_run = torch.zeros(B, device=dev)
    fs = torch.zeros(pg.shape[0], device=dev)
    false_pos = torch.zeros(Gv, dtype=torch.int64, device=dev)
    equals = torch.zeros(Gv, dtype=torch.int64, device=dev)
    t = true[:, None]
    for i in range(n_chunks):
        c0 = i * C
        s0 = min(c0, N - C)  # the last chunk overlaps the one before it
        okc = ((s0 + col_arange) >= c0) & local_valid[s0 : s0 + C]
        blk = cand[s0 : s0 + C]
        s = score_against_candidates(q, blk)  # [B, C]: the loss only
        ok_cell = row_valid[:, None] & okc[None, :]
        in_p = p_valid & (pc >= c0) & (pc < c0 + C)
        s_pos = torch.where(in_p, s[pr, (pc - s0).clamp(0, C - 1)], 0.0).sum()
        if loss_type == "kl":
            m_new = torch.maximum(m_run, torch.where(ok_cell, s, float("-inf")).amax(dim=1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            scale = torch.exp(torch.where(torch.isfinite(m_run), m_run - m_safe, float("-inf")))
            se_run = se_run * scale + torch.where(ok_cell, torch.exp(s - m_safe[:, None]), 0.0).sum(dim=1)
            m_run = m_new
            loss = loss + s_pos
        else:
            per_cell = torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs())) - s * b
            loss = loss + torch.where(ok_cell, per_cell, 0.0).sum() - a * s_pos
        if Gv:
            sg = score_against_candidates(q_g, blk)  # [Gv, C]: every value a gold is compared with
            in_f = (p_col >= c0) & (p_col < c0 + C)
            fs = torch.where(in_f, sg[pg, (p_col - s0).clamp(0, C - 1)], fs)
            false_pos += _count((sg > t) & okc[None, :])
            equals += _count((sg == t) & okc[None, :])
    if loss_type == "kl":
        m_all = _all_reduce(m_run.clone(), group, op="max")
        m_safe = torch.where(torch.isfinite(m_all), m_all, 0.0)
        part = torch.where(torch.isfinite(m_run), se_run * torch.exp(m_run - m_safe), 0.0)
        se = _all_reduce(part, group)
        lse = torch.where(torch.isfinite(m_all), m_all + torch.log(torch.clamp(se, min=1e-38)), 0.0)
        loss = torch.where(p_valid, lse[pr], 0.0).sum() - loss
    tp = true[pg]

    def per_gold(cond):
        return torch.zeros(Gv, dtype=torch.int64, device=dev).index_add_(0, pg, cond.long())

    false_pos = false_pos - per_gold(fs > tp) + per_gold(FILTER_VALUE > tp)
    equals = equals - per_gold(fs == tp) + per_gold(FILTER_VALUE == tp)
    counts = _all_reduce(torch.stack([false_pos, equals]).double(), group).long()  # exact below 2^53
    loss = _all_reduce(loss.reshape(1), group)[0]
    ranks = torch.zeros(gold_rows.shape[0], dtype=torch.int32, device=dev)
    ranks[gi] = (counts[0] + counts[1] // 2).to(torch.int32)
    return loss, ranks, gold_valid


def filtered_topk_block(q, cand, filter_rows, filter_cols, col_valid, k, block, chunk: int = 131072):
    """:func:`filtered_topk_chunked` on a model axis: each rank's top-k of its
    block (global columns), gathered over the block's group and merged;
    ties keep the lowest column (the ranks' blocks are in column order)."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import gather_rows

    lo, nb = block.lo, block.hi - block.lo
    if nb < k:  # every rank gives k columns: pad with invalid ones
        cand = torch.cat([cand, cand.new_zeros((k - nb, cand.shape[1]))])
    local_valid = torch.zeros(cand.shape[0], dtype=torch.bool, device=q.device)
    local_valid[:nb] = True if col_valid is None else col_valid[lo : lo + nb]
    f_in = (filter_cols >= lo) & (filter_cols < lo + nb) & (filter_rows >= 0)
    ts, tc = filtered_topk_chunked(q, cand, torch.where(f_in, filter_rows, -1), torch.where(f_in, filter_cols - lo, -1),
                                   local_valid, k, chunk)
    all_s = gather_rows(ts.t().contiguous(), block.index, block.parts, block.group).t()  # [B, parts * k]
    all_c = gather_rows((tc + lo).t().float().contiguous(), block.index, block.parts, block.group).t()
    top_s, pos = stable_topk(all_s.contiguous(), min(k, block.n))
    return top_s, torch.gather(all_c, 1, pos).to(torch.int32)


def filtered_topk(
    scores: torch.Tensor,  # [B, N]
    filter_rows: torch.Tensor,
    filter_cols: torch.Tensor,
    col_valid: Optional[torch.Tensor],
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidate columns per prefix with the known-true cells
    suppressed, the ``log_predictions`` payload -> (top_scores [B, k],
    top_cols [B, k] int32), ties lowest column first."""
    B, N = scores.shape
    filtered = torch.where(scatter_mask(filter_rows, filter_cols, B, N), FILTER_VALUE, scores)
    if col_valid is not None:
        filtered = torch.where(col_valid[None, :], filtered, float("-inf"))
    top_scores, top_cols = stable_topk(filtered, min(k, N))
    return top_scores, top_cols.to(torch.int32)


def metric_sums_from_ranks(ranks: torch.Tensor, gold_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Summed metric contributions over the valid golds (the host divides by
    ``count``)."""
    r = ranks.float()

    def z(x):
        return torch.where(gold_valid, x, 0.0).sum()

    return {
        "count": gold_valid.sum(),
        "mrr": z(1.0 / (r + 1.0)),
        "mr": z(r),
        "h50": z((ranks < 50).float()),
        "h10": z((ranks < 10).float()),
        "h3": z((ranks < 3).float()),
        "h1": z((ranks < 1).float()),
    }
