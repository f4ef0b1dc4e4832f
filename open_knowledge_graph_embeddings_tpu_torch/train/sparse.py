"""Row-sparse embedding-table training (``sparse: true``).

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/sparse.py`` with
the 'compact' plan layout on one device:

1. the host (:class:`SparsePlanBuilder`) finds, per batch, the unique rows
   of each table the batch touches (the union of token ids for token
   tables, PAD included), remaps the batch's token matrices into that
   compact row space, plans the gather-sum token-table backward, and
   dedups the query mentions and relations;
2. the step gathers those rows, differentiates the loss with respect to
   the gathered [U, d] rows instead of the [V, d] table,
3. and the row-sparse Adagrad (:func:`..ops.scatter_adagrad_kernel.scatter_adagrad`,
   the Triton kernel on the card) updates only the touched rows.

Weight decay applies lazily to the touched rows (torch raises on sparse +
weight_decay; the JAX package documents the same extension).  Sparse tables
take Adagrad or SGD(momentum=0), the set torch supports for sparse grads.
A table is sparsified for a batch only when its height exceeds
``min_rows_ratio`` x its touched rows; otherwise it takes the dense update.

Not carried over: the TPU-tile layouts 'block' and 'hybrid' (8-row HBM
tiles), the mesh plans, and the native (C++) plan helpers, whose numpy
branches the JAX package pins to them (ROADMAP Queue 1 items 1, 6, 14);
gradient accumulation windows (Queue 1 item 12).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder, TokenEmbedderBase
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad
from open_knowledge_graph_embeddings_tpu_torch.train.optim import (
    OptimizerRegimes,
    adagrad_clr,
    assign_regimes,
    clip_by_global_norm,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    grad_tree,
    leaf_tree,
    prefix_loss,
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
    slots of ``K``; padding slots point ``uid`` at ``layout_height`` (out of
    range, dropped)."""
    R, L = toks.shape
    order = host_length_sort_perm(toks)
    ids_flat = toks[order].T.reshape(-1)  # time-major [L*R]
    keep = np.flatnonzero(ids_flat != 0)
    o = np.argsort(ids_flat[keep])  # any order within an id run: slot sums are order-free
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
    if isinstance(embedder, TokenEmbedderBase):
        return ("entity_token_embedding", "relation_token_embedding") if entity_sparse else (
            "relation_token_embedding",)
    return ()


class SparsePlanBuilder:
    """Host side: batch -> array dict with unique-row plans.

    The dict is ``train_batch_to_arrays(batch)`` plus, per sparse table T,
    ``sparse/T/uids`` ([U] int32, bucket-padded with row 0) and
    ``sparse/T/valid`` ([U] bool); the token matrices of the batch, remapped
    into the compact row space, replace the token-id buffers under
    ``sparse/buffers/*``; the gather-sum plans ride under ``sparse/plan/*``
    and the query dedup inverses under ``dedup/*``."""

    def __init__(self, embedder, entity_sparse: bool, uid_bucket_min: int = 256,
                 min_rows_ratio: float = 12.0, grad_plan: bool = True,
                 dedup_queries: bool = True, dedup_bucket: int = 512):
        """``min_rows_ratio``: a table is sparsified for a batch only when
        its height exceeds ``ratio x touched rows`` (the JAX package's
        default, 12, is its measured crossover on the TPU; the port keeps
        the same default so both take the same path)."""
        self.embedder = embedder
        self.entity_sparse = entity_sparse
        self.uid_bucket_min = uid_bucket_min
        self.min_rows_ratio = min_rows_ratio
        self.tables = sparse_table_names(embedder, entity_sparse)
        if not isinstance(embedder, TokenEmbedderBase):
            raise NotImplementedError(
                f"sparse plans for {type(embedder).__name__} are not ported: ROADMAP Queue 1 item 11"
            )
        if entity_sparse and not self.tables:
            raise ValueError(f"no sparse tables for embedder {type(embedder).__name__}")
        self.grad_plan = bool(grad_plan) and isinstance(embedder, LSTMEmbedder)
        self.dedup_queries = bool(dedup_queries)
        self.dedup_bucket = int(dedup_bucket)

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
        self._plan_token(d, batch)
        return d

    def _emit_grad_plan(self, d: Dict[str, Any], kind: str, table: str) -> None:
        if not self.grad_plan:
            return
        toks = d[f"sparse/buffers/{kind}_token_ids"]
        if kind == "entity":
            # candidates and query entities share ONE LSTM pass, candidates
            # first (model.prefix_queries_and_candidates), so the plan's
            # rows follow that concatenation, not the buffer order
            B = len(d["ent_ids"])
            toks = np.concatenate([toks[B:], toks[:B]])
        for k, v in build_token_grad_plan(toks, len(d[f"sparse/{table}/uids"])).items():
            d[f"sparse/plan/{kind}_token/{k}"] = v

    def _dedup_ids(self, ids: np.ndarray):
        """(encode_ids, inv or None): the unique ids padded to a multiple of
        ``dedup_bucket`` with the first unique id (those rows are encoded but
        never gathered), or the ids unchanged when dedup would not shrink."""
        if not self.dedup_queries:
            return ids, None
        uniq, inv = np.unique(ids, return_inverse=True)
        S = max(self.dedup_bucket, -(-len(uniq) // self.dedup_bucket) * self.dedup_bucket)
        if S >= len(ids):
            return ids, None
        enc = np.concatenate([uniq, np.full(S - len(uniq), uniq[0], uniq.dtype)])
        return enc.astype(np.int32), inv.astype(np.int32)

    def _plan_token(self, d: Dict[str, Any], batch: Batch) -> None:
        meta = self.embedder.meta
        if self.entity_sparse:
            if batch.candidate_ids is None:
                raise ValueError("entity-token-table sparsity needs batch-shared candidates")
            ents_enc, ent_inv = self._dedup_ids(batch.ent_ids)
            toks = meta.entity_token_ids[np.concatenate([ents_enc, batch.candidate_ids])]
            # PAD (token 0) maps to compact row 0 even when no pad token occurs
            ut = np.union1d(np.int32(0), toks)
            remap = self._pack_rows(d, "entity_token_embedding", ut, meta.entity_tokens_size)
            if remap is not None:
                B = len(ents_enc)
                d["ent_ids"] = np.arange(B, dtype=np.int32)
                d["candidate_ids"] = np.arange(B, B + len(batch.candidate_ids), dtype=np.int32)
                if ent_inv is not None:
                    d["dedup/ent_inv"] = ent_inv
                d["sparse/buffers/entity_token_ids"] = remap(toks)
                self._emit_grad_plan(d, "entity", "entity_token_embedding")
        rels_enc, rel_inv = self._dedup_ids(batch.rel_ids)
        rtoks = meta.relation_token_ids[rels_enc]
        remap = self._pack_rows(
            d, "relation_token_embedding", np.union1d(np.int32(0), rtoks), meta.relation_tokens_size
        )
        if remap is not None:
            d["rel_ids"] = np.arange(len(rels_enc), dtype=np.int32)
            if rel_inv is not None:
                d["dedup/rel_inv"] = rel_inv
            d["sparse/buffers/relation_token_ids"] = remap(rtoks)
            self._emit_grad_plan(d, "relation", "relation_token_embedding")


# ------------------------------------------------------------- row updates


def _sparse_adagrad_rows(g_rows, uids, valid, p, s, hp):
    step = s["step"] + 1.0
    scatter_adagrad(g_rows.contiguous(), uids, valid, p, s["sum"], adagrad_clr(step, hp),
                    hp["weight_decay"], hp["eps"])
    return p, {"sum": s["sum"], "step": step}


def _sparse_sgd_rows(g_rows, uids, valid, p, s, hp):
    uids = uids.long()
    g = (g_rows.float() + hp["weight_decay"] * p[uids]) * valid[:, None].float()
    p.index_add_(0, uids, -hp["lr"] * g)
    return p, {"momentum": s["momentum"], "step": s["step"] + 1.0}


_SPARSE_RULES = {"Adagrad": _sparse_adagrad_rows, "SGD": _sparse_sgd_rows}


def batch_buffers(variables, batch) -> Dict[str, Any]:
    """Model buffers for a sparse batch: the batch-local token matrices
    replace the resident ones, and the gather-sum plans ride along as
    ``{kind}_token_grad_plan``."""
    buffers = dict(variables["buffers"])
    for bk in ("entity_token_ids", "relation_token_ids"):
        if f"sparse/buffers/{bk}" in batch:
            buffers[bk] = batch[f"sparse/buffers/{bk}"]
    for kind in ("entity", "relation"):
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


def make_sparse_train_step(model: KGEModel, regimes: OptimizerRegimes, params_example,
                           entity_sparse: bool, loss_type: str = "bce", label_smoothing: float = 0.0,
                           grad_clip: Optional[float] = None):
    """Sparse analog of :func:`..train.step.make_train_step`:
    ``step(variables, opt_state, hparams, batch, generator) -> (variables,
    opt_state, stats)`` for a batch of :class:`SparsePlanBuilder` arrays on
    the device.  Parameters and optimizer state are updated in place."""
    table_label = _resolve_sparse_tables(model, regimes, params_example, entity_sparse)
    opt_names = regimes.opt_names()

    def step(variables, opt_state, hparams, batch, generator=None):
        params = variables["params"]
        # which tables carry a plan is decided per batch (small tables fall back to dense)
        sparse_tables = tuple(t for t in table_label if f"sparse/{t}/uids" in batch)
        dense = {k: v for k, v in params.items() if k not in sparse_tables}
        dense_leaves = leaf_tree(dense)
        uids = {t: batch[f"sparse/{t}/uids"] for t in sparse_tables}
        rows = {t: leaf_tree(params[t][uids[t]]) for t in sparse_tables}
        v = {"params": {**dense_leaves, **rows}, "state": variables["state"],
             "buffers": batch_buffers(variables, batch)}
        loss_sum, norm_metric, new_state, reg = prefix_loss(model, v, batch, loss_type, label_smoothing,
                                                             generator)
        ((loss_sum + reg) / batch["normalizer_loss"]).backward()
        g_dense = grad_tree(dense_leaves)
        g_rows = {t: rows[t].grad for t in sparse_tables}
        if grad_clip is not None and grad_clip > 0:
            clipped = clip_by_global_norm({**g_dense, **g_rows}, grad_clip)
            g_dense = {k: clipped[k] for k in g_dense}
            g_rows = {t: clipped[t] for t in g_rows}

        dense_apply = regimes.make_apply(dense, grad_clip=None)
        new_params, new_opt = dense_apply(
            g_dense, {k: s for k, s in opt_state.items() if k not in sparse_tables}, dense, hparams)
        new_params, new_opt = dict(new_params), dict(new_opt)
        for t in sparse_tables:
            lbl = table_label[t]
            new_params[t], new_opt[t] = _SPARSE_RULES[opt_names[lbl]](
                g_rows[t], uids[t], batch[f"sparse/{t}/valid"], params[t], opt_state[t], hparams[lbl])
        new_variables = {"params": new_params, "state": new_state, "buffers": variables["buffers"]}
        return new_variables, new_opt, {"loss_sum": loss_sum.detach(), "normalizer_metric": norm_metric}

    return step
