"""Row-sparse embedding-table training (``sparse: true``).

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/sparse.py`` with
the 'compact' plan layout on one device:

1. the host (:class:`SparsePlanBuilder`) finds, per batch, the unique rows
   of each table the batch touches: the entity and relation ids themselves
   for lookup tables (the batch's ids are remapped into that compact row
   space), the union of token ids for token tables, PAD included (the
   batch's token matrices are remapped); for the LSTM it plans the
   gather-sum token-table backward, and for the LSTM and unigram families
   it dedups the query mentions and relations;
2. the step gathers those rows, differentiates the loss with respect to
   the gathered [U, d] rows instead of the [V, d] table,
3. and the row-sparse Adagrad (:func:`..ops.scatter_adagrad_kernel.scatter_adagrad_tables`,
   one CUDA launch for every sparse table of a regime group on the card)
   updates only the touched rows.

Weight decay applies lazily to the touched rows (torch raises on sparse +
weight_decay; the JAX package documents the same extension).  Sparse tables
take Adagrad or SGD(momentum=0), the set torch supports for sparse grads.
A table is sparsified for a batch only when its height exceeds
``min_rows_ratio`` x its touched rows; otherwise it takes the dense update.

Gradient accumulation composes with the row-sparse path
(:func:`make_sparse_accum_steps`): the window's micro-batches share one
union row space (:meth:`SparsePlanBuilder.plan_window`), their [U, d] row
gradients add up in f32, and the row update runs once on the sum.

The token plans' unique-and-remap and gather-sum grouping run in C++
(``native/``: counting passes with the GIL released, per prefetch thread)
where the library is built, and in numpy otherwise; both give the same
arrays.  On a data-parallel mesh of ranks the plans are per rank: each
rank's LSTM block gets its own gather-sum plan, the queries dedup per rank
block, and the union of rows stays the batch's, so the ranks' [U, d] row
gradients add up (``train/step.py::reduce_over_ranks``) before the one row
update every rank makes.

Not carried over: the TPU-tile layouts 'block' and 'hybrid' (8-row HBM
tiles), and the plans of the model axis (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import (
    BigramPoolingEmbedder,
    LookupEmbedder,
    LSTMEmbedder,
    TokenEmbedderBase,
)
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.native import grad_plan_native, native_available, unique_remap_native
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS
from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad_tables
from open_knowledge_graph_embeddings_tpu_torch.train.optim import (
    OptimizerRegimes,
    assign_regimes,
    clip_by_global_norm,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    add_tree,
    grad_tree,
    leaf_tree,
    map_tree,
    prefix_loss,
    reduce_over_ranks,
    train_batch_to_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.misc import next_bucket

SPARSE_CAPABLE_OPTIMIZERS = ("Adagrad", "SGD")


def host_length_sort_perm(toks: np.ndarray) -> np.ndarray:
    """Host replica of the device's stable descending-length sort
    (ops/lstm.py ``length_sort_perm``): ``toks[order]`` is the row order the
    fused LSTM sees.  Both sort stably on ``max_len - length``."""
    L = toks.shape[1]
    lengths = (toks > 0).sum(axis=1)
    return np.argsort(L - lengths, kind="stable").astype(np.int32)


def build_token_grad_plan(toks: np.ndarray, layout_height: int, K: int = 8,
                          bucket_min: int = 256) -> Dict[str, np.ndarray]:
    """Slot plan for the gather-sum token-table backward
    (models/embedders.py ``token_gather_tm`` ``grad_plan``).

    ``toks`` [R, L] are the remapped token ids as the row encoder sees them;
    positions are flat time-major indices into the length-sorted layout
    (p = t * R + sorted_row).  Non-pad positions are grouped by token id into
    slots of ``K`` (ids ascending, each id's positions ascending); padding
    slots point ``uid`` at ``layout_height`` (out of range, dropped).

    The C++ kernel (``native/oket_native.cpp`` ``oket_grad_plan``: counting
    passes, the GIL released) builds it where the library is built; the
    numpy branch below gives the same arrays."""
    R, L = toks.shape
    res = grad_plan_native(toks, layout_height, K, layout_height)
    if res is not None:
        pos, valid, uid, s_real = res
        S = next_bucket(max(s_real, 1), minimum=bucket_min)
        if S <= pos.shape[0]:
            return {"pos": pos[:S], "valid": valid[:S], "uid": uid[:S]}
        out = {"pos": np.zeros((S, K), np.int32), "valid": np.zeros((S, K), bool),
               "uid": np.full(S, layout_height, np.int32)}
        out["pos"][: len(pos)], out["valid"][: len(pos)], out["uid"][: len(pos)] = pos, valid, uid
        return out
    order = host_length_sort_perm(toks)
    ids_flat = toks[order].T.reshape(-1)  # time-major [L*R]
    keep = np.flatnonzero(ids_flat != 0)
    o = np.argsort(ids_flat[keep], kind="stable")  # each id's positions ascending, as the C++ kernel
    ids_s = ids_flat[keep][o]
    pos_s = keep[o].astype(np.int32)
    n = len(ids_s)
    S = next_bucket(1, minimum=bucket_min)
    if n:
        change = np.empty(n, bool)
        change[0] = True
        change[1:] = ids_s[1:] != ids_s[:-1]
        run_id = np.cumsum(change) - 1
        run_start = np.flatnonzero(change)
        off = np.arange(n) - run_start[run_id]
        slots_per_run = -(-np.diff(np.append(run_start, n)) // K)
        slot_base = np.concatenate(([0], np.cumsum(slots_per_run)[:-1]))
        slot_of = (slot_base[run_id] + off // K).astype(np.int64)
        S = next_bucket(int(slots_per_run.sum()), minimum=bucket_min)
    pos_m = np.zeros((S, K), np.int32)
    valid = np.zeros((S, K), bool)
    uid = np.full(S, layout_height, np.int32)
    if n:
        pos_m[slot_of, off % K] = pos_s
        valid[slot_of, off % K] = True
        uid[slot_of] = ids_s
    return {"pos": pos_m, "valid": valid, "uid": uid}


def sparse_table_names(embedder, entity_sparse: bool) -> Tuple[str, ...]:
    """Tables eligible for row-sparse updates.  Entity-side tables are sparse
    only under batch-shared candidates (full-vocabulary training touches
    every entity row anyway)."""
    if isinstance(embedder, LookupEmbedder):
        names = ("entity_embedding", "relation_embedding")
    elif isinstance(embedder, TokenEmbedderBase):
        names = ("entity_token_embedding", "relation_token_embedding")
    else:
        return ()
    return names if entity_sparse else names[1:]


class SparsePlanBuilder:
    """Host side: batch -> array dict with unique-row plans.

    The dict is ``train_batch_to_arrays(batch)`` plus, per sparse table T,
    ``sparse/T/uids`` ([U] int32, bucket-padded with row 0) and
    ``sparse/T/valid`` ([U] bool).  For a lookup embedder the batch's
    entity, candidate and relation ids are remapped into the compact row
    space; for a token embedder the token matrices of the batch, remapped,
    replace the token-id buffers under ``sparse/buffers/*``, the gather-sum
    plans (LSTM) ride under ``sparse/plan/*`` and the query dedup inverses
    (LSTM, unigram) under ``dedup/*``."""

    def __init__(self, embedder, entity_sparse: bool, uid_bucket_min: int = 256,
                 min_rows_ratio: float = 12.0, grad_plan: bool = True,
                 dedup_queries: bool = True, dedup_bucket: int = 512, mesh=None):
        """``min_rows_ratio``: a table is sparsified for a batch only when
        its height exceeds ``ratio x touched rows`` (the JAX package's
        default, 12, is its measured crossover on the TPU; the port keeps
        the same default so both take the same path).

        ``mesh``: the mesh of ranks (``parallel/mesh.py``) or None.  With a
        mesh the model encodes candidates and queries in separate regions
        whose rows split over ``data`` (models/model.py), so the gather-sum
        plans are built per rank over each region's row blocks and stacked
        [A, S, K] (the candidates' under ``sparse/plan/cand_token``), and
        the queries dedup per rank block to a common bucket S with the
        inverse indices global (``rank * S + local``)."""
        self.embedder = embedder
        self.entity_sparse = entity_sparse
        self.uid_bucket_min = uid_bucket_min
        self.min_rows_ratio = min_rows_ratio
        self.tables = sparse_table_names(embedder, entity_sparse)
        if entity_sparse and not self.tables:
            raise ValueError(f"no sparse tables for embedder {type(embedder).__name__}")
        self.is_token = isinstance(embedder, TokenEmbedderBase)
        # the gather-sum plan indexes the LSTM's sorted time-major layout
        self.grad_plan = bool(grad_plan) and isinstance(embedder, LSTMEmbedder)
        # the bigram's batchnorm sees the positions of the encode batch, so
        # deduped queries would change its statistics
        self.dedup_queries = bool(dedup_queries) and self.is_token and not isinstance(
            embedder, BigramPoolingEmbedder)
        self.dedup_bucket = int(dedup_bucket)
        self.mesh = mesh
        self._tl = threading.local()  # per prefetch thread: the native remap's scratch

    @property
    def plan_path(self) -> str:
        """Which branch builds the token plans: ``native`` (the C++ kernels)
        or ``numpy``."""
        return "native" if native_available() else "numpy"

    def _unique_remap(self, toks: np.ndarray, vocab: int):
        """``(uids, remapped or None)``: the sorted unique token ids with PAD
        (0) among them, from the C++ kernel with the matrix remapped, or from
        numpy's ``union1d`` (the caller remaps)."""
        buf = getattr(self._tl, "buf", None)
        if buf is None or buf.size < vocab:
            buf = self._tl.buf = np.empty(vocab, np.int32)
        res = unique_remap_native(toks, vocab, buf)
        return res if res is not None else (np.union1d(np.int32(0), toks), None)

    def _pack_rows(self, d: Dict[str, Any], table: str, uids: np.ndarray, height: int):
        """Emit the plan of one table and return the id -> compact-row
        remapper, or None when the table is too small to pay off (then no
        plan keys are emitted and the batch keeps its ids)."""
        U = next_bucket(len(uids), minimum=self.uid_bucket_min)
        if height < self.min_rows_ratio * U:
            return None
        padded = np.zeros(U, np.int32)
        padded[: len(uids)] = uids
        valid = np.zeros(U, bool)
        valid[: len(uids)] = True
        d[f"sparse/{table}/uids"] = padded
        d[f"sparse/{table}/valid"] = valid
        return lambda x: np.searchsorted(uids, x).astype(np.int32)

    def __call__(self, batch: Batch) -> Dict[str, Any]:
        d = train_batch_to_arrays(batch)
        if self.is_token:
            self._plan_token(d, batch)
        else:
            self._plan_lookup(d, batch)
        return d

    # ------------------------------------------------ accumulation windows

    def plan_window(self, batches) -> list:
        """Plan a gradient-accumulation window: one union row space over
        all its micro-batches.  Every returned array dict carries the same
        ``sparse/T/uids`` and ``valid`` (so one [U, d] accumulator serves
        the whole window), and each micro-batch's ids are remapped into it.
        Queries are not deduped here, as in the JAX package's window plan:
        the entity pass runs over B + |candidates| rows."""
        ds = [train_batch_to_arrays(b) for b in batches]
        if self.is_token:
            self._window_token(ds, batches)
        else:
            self._window_lookup(ds, batches)
        return ds

    def _window_lookup(self, ds, batches) -> None:
        meta = self.embedder.meta
        if self.entity_sparse:
            if any(b.candidate_ids is None for b in batches):
                raise ValueError("entity-table sparsity needs batch-shared candidates")
            used = np.concatenate([x for b in batches for x in (b.ent_ids, b.candidate_ids)])
            plan: Dict[str, Any] = {}
            remap = self._pack_rows(plan, "entity_embedding", np.unique(used), meta.entities_size)
            for d, b in zip(ds, batches):
                d.update(plan)
                if remap is not None:
                    d["ent_ids"] = remap(b.ent_ids)
                    d["candidate_ids"] = remap(b.candidate_ids)
        plan = {}
        remap = self._pack_rows(plan, "relation_embedding", np.unique(np.concatenate([b.rel_ids for b in batches])),
                                meta.relations_size)
        for d, b in zip(ds, batches):
            d.update(plan)
            if remap is not None:
                d["rel_ids"] = remap(b.rel_ids)

    def _window_token(self, ds, batches) -> None:
        meta = self.embedder.meta
        if self.entity_sparse:
            if any(b.candidate_ids is None for b in batches):
                raise ValueError("entity-token-table sparsity needs batch-shared candidates")
            toks_list = [meta.entity_token_ids[np.concatenate([b.ent_ids, b.candidate_ids])] for b in batches]
            ut = np.union1d(np.int32(0), np.concatenate([t.ravel() for t in toks_list]))
            plan: Dict[str, Any] = {}
            remap = self._pack_rows(plan, "entity_token_embedding", ut, meta.entity_tokens_size)
            for d, b, toks in zip(ds, batches, toks_list):
                d.update(plan)
                if remap is not None:
                    B = len(b.ent_ids)
                    d["ent_ids"] = np.arange(B, dtype=np.int32)
                    d["candidate_ids"] = np.arange(B, B + len(b.candidate_ids), dtype=np.int32)
                    d["sparse/buffers/entity_token_ids"] = remap(toks)
                    self._emit_grad_plan(d, "entity", "entity_token_embedding")
        rtoks_list = [meta.relation_token_ids[b.rel_ids] for b in batches]
        plan = {}
        remap = self._pack_rows(plan, "relation_token_embedding",
                                np.union1d(np.int32(0), np.concatenate([t.ravel() for t in rtoks_list])),
                                meta.relation_tokens_size)
        for d, b, rtoks in zip(ds, batches, rtoks_list):
            d.update(plan)
            if remap is not None:
                d["rel_ids"] = np.arange(len(b.rel_ids), dtype=np.int32)
                d["sparse/buffers/relation_token_ids"] = remap(rtoks)
                self._emit_grad_plan(d, "relation", "relation_token_embedding")

    def _plan_lookup(self, d: Dict[str, Any], batch: Batch) -> None:
        meta = self.embedder.meta
        if self.entity_sparse:
            if batch.candidate_ids is None:
                raise ValueError("entity-table sparsity needs batch-shared candidates")
            used = np.concatenate([batch.ent_ids, batch.candidate_ids])
            remap = self._pack_rows(d, "entity_embedding", np.unique(used), meta.entities_size)
            if remap is not None:
                d["ent_ids"] = remap(batch.ent_ids)
                d["candidate_ids"] = remap(batch.candidate_ids)
        remap = self._pack_rows(d, "relation_embedding", np.unique(batch.rel_ids), meta.relations_size)
        if remap is not None:
            d["rel_ids"] = remap(batch.rel_ids)

    def _emit_grad_plan(self, d: Dict[str, Any], kind: str, table: str) -> None:
        if not self.grad_plan:
            return
        toks = d[f"sparse/buffers/{kind}_token_ids"]
        height = len(d[f"sparse/{table}/uids"])
        if self.mesh is not None:
            # the mesh branch encodes the candidate rows and the query rows
            # in separate regions, each split over `data`
            A = self.mesh.shape[DATA_AXIS]
            if kind == "entity":
                B = len(d["ent_ids"])
                self._emit_sharded_plan(d, "cand", toks[B:], A, height)
                self._emit_sharded_plan(d, "entity", toks[:B], A, height)
            else:
                self._emit_sharded_plan(d, kind, toks, A, height)
            return
        if kind == "entity":
            # candidates and query entities share ONE LSTM pass, candidates
            # first (model.prefix_queries_and_candidates), so the plan's
            # rows follow that concatenation, not the buffer order
            B = len(d["ent_ids"])
            toks = np.concatenate([toks[B:], toks[:B]])
        for k, v in build_token_grad_plan(toks, height).items():
            d[f"sparse/plan/{kind}_token/{k}"] = v

    def _emit_sharded_plan(self, d: Dict[str, Any], key: str, toks: np.ndarray, A: int, height: int) -> None:
        """Per-rank plans of a region's rows: rank i's over its block [i R / A,
        (i + 1) R / A), stacked [A, S, K] with a common S (padding slots point
        ``uid`` out of range).  A row count that does not divide takes one
        global [S, K] plan, and the region then runs whole on every rank."""
        R = len(toks)
        if A <= 1 or R % A:
            for k, v in build_token_grad_plan(toks, height).items():
                d[f"sparse/plan/{key}_token/{k}"] = v
            return
        blk = R // A
        plans = [build_token_grad_plan(toks[i * blk : (i + 1) * blk], height) for i in range(A)]
        S = max(p["pos"].shape[0] for p in plans)
        K = plans[0]["pos"].shape[1]
        pos = np.zeros((A, S, K), np.int32)
        valid = np.zeros((A, S, K), bool)
        uid = np.full((A, S), height, np.int32)
        for i, p in enumerate(plans):
            n = p["pos"].shape[0]
            pos[i, :n], valid[i, :n], uid[i, :n] = p["pos"], p["valid"], p["uid"]
        d[f"sparse/plan/{key}_token/pos"] = pos
        d[f"sparse/plan/{key}_token/valid"] = valid
        d[f"sparse/plan/{key}_token/uid"] = uid

    def _dedup_ids(self, ids: np.ndarray):
        """(encode_ids, inv or None): the unique ids padded to a multiple of
        ``dedup_bucket`` with the first unique id (those rows are encoded but
        never gathered), or the ids unchanged when dedup would not shrink.

        On a mesh each rank's block of rows dedups alone to a common bucket
        S; the encode ids are the blocks' [A * S] and the inverse indices
        global (``rank * S + local``), so each rank's encode region holds
        its own block's unique rows."""
        if not self.dedup_queries:
            return ids, None
        A = self.mesh.shape[DATA_AXIS] if self.mesh is not None else 1
        if len(ids) % A:
            return ids, None
        blk = len(ids) // A
        parts = [np.unique(ids[i * blk : (i + 1) * blk], return_inverse=True) for i in range(A)]
        S = max(self.dedup_bucket, -(-max(len(u) for u, _ in parts) // self.dedup_bucket) * self.dedup_bucket)
        if A * S >= len(ids):
            return ids, None
        enc = np.concatenate([np.concatenate([u, np.full(S - len(u), u[0], u.dtype)]) for u, _ in parts])
        inv = np.concatenate([i * S + iv for i, (_, iv) in enumerate(parts)])
        return enc.astype(np.int32), inv.astype(np.int32)

    def _plan_token(self, d: Dict[str, Any], batch: Batch) -> None:
        meta = self.embedder.meta
        if self.entity_sparse:
            if batch.candidate_ids is None:
                raise ValueError("entity-token-table sparsity needs batch-shared candidates")
            ents_enc, ent_inv = self._dedup_ids(batch.ent_ids)
            toks = meta.entity_token_ids[np.concatenate([ents_enc, batch.candidate_ids])]
            # PAD (token 0) maps to compact row 0 even when no pad token occurs
            ut, remapped = self._unique_remap(toks, meta.entity_tokens_size)
            remap = self._pack_rows(d, "entity_token_embedding", ut, meta.entity_tokens_size)
            if remap is not None:
                B = len(ents_enc)
                d["ent_ids"] = np.arange(B, dtype=np.int32)
                d["candidate_ids"] = np.arange(B, B + len(batch.candidate_ids), dtype=np.int32)
                if ent_inv is not None:
                    d["dedup/ent_inv"] = ent_inv
                d["sparse/buffers/entity_token_ids"] = remapped if remapped is not None else remap(toks)
                self._emit_grad_plan(d, "entity", "entity_token_embedding")
        rels_enc, rel_inv = self._dedup_ids(batch.rel_ids)
        rtoks = meta.relation_token_ids[rels_enc]
        rut, rremapped = self._unique_remap(rtoks, meta.relation_tokens_size)
        remap = self._pack_rows(d, "relation_token_embedding", rut, meta.relation_tokens_size)
        if remap is not None:
            d["rel_ids"] = np.arange(len(rels_enc), dtype=np.int32)
            if rel_inv is not None:
                d["dedup/rel_inv"] = rel_inv
            d["sparse/buffers/relation_token_ids"] = rremapped if rremapped is not None else remap(rtoks)
            self._emit_grad_plan(d, "relation", "relation_token_embedding")


# ------------------------------------------------------------- row updates


def _sparse_adagrad_rows(g_rows, uids, valid, ps, states, hp):
    """The row Adagrad step of a regime group's sparse tables; their new
    states."""
    steps = scatter_adagrad_tables([g.contiguous() for g in g_rows], uids, valid, ps, [s["sum"] for s in states],
                                   [s["step"] for s in states], hp)
    return [{"sum": s["sum"], "step": step} for s, step in zip(states, steps)]


def _sparse_sgd_rows(g_rows, uids, valid, ps, states, hp):
    out = []
    for g_rows, uids, valid, p, s in zip(g_rows, uids, valid, ps, states):
        uids = uids.long()
        g = (g_rows.float() + hp["weight_decay"] * p[uids]) * valid[:, None].float()
        p.index_add_(0, uids, -hp["lr"] * g)
        out.append({"momentum": s["momentum"], "step": s["step"] + 1.0})
    return out


# each takes a regime group's tables at once:
# (g_rows, uids, valid, params, states, hparams) -> states
_SPARSE_RULES = {"Adagrad": _sparse_adagrad_rows, "SGD": _sparse_sgd_rows}


def batch_buffers(variables, batch) -> Dict[str, Any]:
    """Model buffers for a sparse batch: the batch-local token matrices
    replace the resident ones, and the gather-sum plans ride along as
    ``{kind}_token_grad_plan``."""
    buffers = dict(variables["buffers"])
    for bk in ("entity_token_ids", "relation_token_ids"):
        if f"sparse/buffers/{bk}" in batch:
            buffers[bk] = batch[f"sparse/buffers/{bk}"]
    for kind in ("entity", "relation", "cand"):
        if f"sparse/plan/{kind}_token/pos" in batch:
            buffers[f"{kind}_token_grad_plan"] = {
                k: batch[f"sparse/plan/{kind}_token/{k}"] for k in ("pos", "valid", "uid")
            }
    return buffers


def _resolve_sparse_tables(model, regimes, params_example, entity_sparse) -> Dict[str, int]:
    """{table name -> regime label} of the sparse-eligible tables, with the
    torch-parity optimizer restrictions enforced."""
    labels = assign_regimes(params_example, regimes.matches, regimes.frozen_patterns)
    opt_names = regimes.opt_names()
    table_label = {
        t: labels[t] for t in sparse_table_names(model.embedder, entity_sparse)
        if t in params_example and labels[t] >= 0
    }
    for t, lbl in table_label.items():
        name = opt_names[lbl]
        if name not in _SPARSE_RULES:
            raise ValueError(f"sparse updates for table {t!r} need one of {SPARSE_CAPABLE_OPTIMIZERS}, "
                             f"got {name} (torch has the same restriction for sparse gradients)")
        if name == "SGD":
            merged: Dict = {}
            for ph in regimes.regimes[lbl]:
                merged.update(ph)
            if float(merged.get("momentum", 0.0)) != 0.0:
                raise ValueError("sparse SGD requires momentum == 0")
    return table_label


def _sparse_grads(model, variables, batch, sparse_tables, loss_type, label_smoothing, generator):
    """The backward of a sparse batch -> ``(g_dense, g_rows, loss_sum,
    norm_metric, new_state)``: gradients of the dense leaves and of the
    gathered [U, d] rows of ``sparse_tables``."""
    params = variables["params"]
    dense_leaves = leaf_tree({k: v for k, v in params.items() if k not in sparse_tables})
    rows = {t: leaf_tree(params[t][batch[f"sparse/{t}/uids"]]) for t in sparse_tables}
    v = {"params": {**dense_leaves, **rows}, "state": variables["state"], "buffers": batch_buffers(variables, batch)}
    loss_sum, norm_metric, new_state, reg = prefix_loss(model, v, batch, loss_type, label_smoothing, generator)
    ((loss_sum + reg) / batch["normalizer_loss"]).backward()
    g_dense, g_rows = grad_tree(dense_leaves), grad_tree(rows)
    # on a mesh: every rank's union of rows is the batch's, so its [U, d]
    # row gradients add up position by position
    loss_sum, norm_metric = reduce_over_ranks(model, [g_dense, g_rows], loss_sum, norm_metric)
    return g_dense, g_rows, loss_sum.detach(), norm_metric, new_state


def _sparse_apply(regimes, table_label, opt_names, params, opt_state, g_dense, g_rows, batch, sparse_tables,
                  hparams, grad_clip):
    """The update of a sparse batch (or window) from its gradients -> ``(new
    params, new opt_state)``: the global-norm clip over both, the dense
    leaves through ``make_apply`` (kernel 3 for Adagrad), then one row
    update per regime group (kernel 4 for Adagrad)."""
    if grad_clip is not None and grad_clip > 0:
        clipped = clip_by_global_norm({**g_dense, **g_rows}, grad_clip)
        g_dense = {k: clipped[k] for k in g_dense}
        g_rows = {t: clipped[t] for t in g_rows}
    dense = {k: v for k, v in params.items() if k not in sparse_tables}
    dense_apply = regimes.make_apply(dense, grad_clip=None)
    new_params, new_opt = dense_apply(
        g_dense, {k: s for k, s in opt_state.items() if k not in sparse_tables}, dense, hparams)
    new_params, new_opt = dict(new_params), dict(new_opt)
    groups: Dict[int, list] = {}
    for t in sparse_tables:
        groups.setdefault(table_label[t], []).append(t)
    for lbl, ts in groups.items():  # one row update per regime group
        states = _SPARSE_RULES[opt_names[lbl]](
            [g_rows[t] for t in ts], [batch[f"sparse/{t}/uids"] for t in ts],
            [batch[f"sparse/{t}/valid"] for t in ts], [params[t] for t in ts], [opt_state[t] for t in ts],
            hparams[lbl])
        for t, s in zip(ts, states):
            new_params[t], new_opt[t] = params[t], s
    return new_params, new_opt


def make_sparse_train_step(model: KGEModel, regimes: OptimizerRegimes, params_example,
                           entity_sparse: bool, loss_type: str = "bce", label_smoothing: float = 0.0,
                           grad_clip: Optional[float] = None):
    """Sparse analog of :func:`..train.step.make_train_step`:
    ``step(variables, opt_state, hparams, batch, generator) -> (variables,
    opt_state, stats)`` for a batch of :class:`SparsePlanBuilder` arrays on
    the device.  Parameters and optimizer state are updated in place.

    Adagrad's launches on the card, per step and regime group: one dense
    launch for the group's dense leaves with a gradient (a table that falls
    back to dense for the batch joins them; ceil(leaves / 32) beyond 32
    leaves) and one row launch for the group's row-sparse tables (none when
    no table of the group carries a plan; ceil(tables / 8) beyond 8)."""
    table_label = _resolve_sparse_tables(model, regimes, params_example, entity_sparse)
    opt_names = regimes.opt_names()

    def step(variables, opt_state, hparams, batch, generator=None):
        # which tables carry a plan is decided per batch (small tables fall back to dense)
        sparse_tables = tuple(t for t in table_label if f"sparse/{t}/uids" in batch)
        g_dense, g_rows, loss_sum, norm_metric, new_state = _sparse_grads(
            model, variables, batch, sparse_tables, loss_type, label_smoothing, generator)
        new_params, new_opt = _sparse_apply(regimes, table_label, opt_names, variables["params"], opt_state,
                                            g_dense, g_rows, batch, sparse_tables, hparams, grad_clip)
        new_variables = {"params": new_params, "state": new_state, "buffers": variables["buffers"]}
        return new_variables, new_opt, {"loss_sum": loss_sum, "normalizer_metric": norm_metric}

    return step


def make_sparse_accum_steps(model: KGEModel, regimes: OptimizerRegimes, params_example, entity_sparse: bool,
                            loss_type: str = "bce", label_smoothing: float = 0.0,
                            grad_clip: Optional[float] = None):
    """Gradient accumulation composed with row-sparse updates, on the
    window plans of :meth:`SparsePlanBuilder.plan_window` -> ``(zero_acc,
    grad_step, apply_step)``:

    * ``zero_acc(arrays)``: a fresh accumulator ``{"rows", "dense"}`` shaped
      by a micro-batch of the window (its union plan): [U, d] f32 per
      sparse table, zeros like the params for the rest;
    * ``grad_step(variables, acc, arrays, generator) -> (variables, acc,
      stats)`` adds a micro-batch's row gradients (in f32) and dense ones;
    * ``apply_step(variables, opt_state, acc, arrays, hparams) ->
      (variables, opt_state)``: clip the summed window gradient, then the
      dense update (kernel 3) and the row update on the union rows (kernel
      4); ``arrays`` is any micro-batch of the window."""
    table_label = _resolve_sparse_tables(model, regimes, params_example, entity_sparse)
    opt_names = regimes.opt_names()

    def window_tables(arrays):
        return tuple(t for t in table_label if f"sparse/{t}/uids" in arrays)

    def zero_acc(arrays):
        sparse_tables = window_tables(arrays)
        rows = {t: torch.zeros(arrays[f"sparse/{t}/uids"].shape[0], params_example[t].shape[1], dtype=torch.float32,
                               device=params_example[t].device) for t in sparse_tables}
        dense = {k: map_tree(torch.zeros_like, v) for k, v in params_example.items() if k not in sparse_tables}
        return {"rows": rows, "dense": dense}

    def grad_step(variables, acc, batch, generator=None):
        g_dense, g_rows, loss_sum, norm_metric, new_state = _sparse_grads(
            model, variables, batch, window_tables(batch), loss_type, label_smoothing, generator)
        for t, g in g_rows.items():
            acc["rows"][t].add_(g.float())
        add_tree(acc["dense"], g_dense)
        new_variables = {**variables, "state": new_state}
        return new_variables, acc, {"loss_sum": loss_sum, "normalizer_metric": norm_metric}

    def apply_step(variables, opt_state, acc, batch, hparams):
        new_params, new_opt = _sparse_apply(regimes, table_label, opt_names, variables["params"], opt_state,
                                            acc["dense"], acc["rows"], batch, window_tables(batch), hparams,
                                            grad_clip)
        return {**variables, "params": new_params}, new_opt

    return zero_acc, grad_step, apply_step
