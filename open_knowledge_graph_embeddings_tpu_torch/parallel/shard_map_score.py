"""The explicit-collective lookup step over a [data, model] mesh of ranks
(lookup embedder x {ComplEx, DistMult} x BCE over the full vocabulary).

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/shard_map_score.py``,
function for function.  In the JAX package it is the hand-written
``shard_map`` twin of the GSPMD program; in the port every collective is
explicit anyway, and this module is the smallest whole instance of the
model axis that the trainer's step (``train/step.py``) is held against:

* the entity table is padded to a multiple of ``model`` rows and
  row-sharded in equal slabs: model rank m owns rows ``[m V/M, (m+1) V/M)``;
* the boundary gather (:func:`sharded_embedding_lookup`): each rank writes
  the requested rows it owns into a zero buffer and an ``all_reduce`` over
  the model group assembles them; its backward hands each rank its slab's
  rows of the summed cotangent, the transpose of JAX's ``psum``;
* batch rows split over ``data``: each rank scores its ``[B/D, d] x
  [d, V/M]`` block against its own slab, the labels taken in the slab's
  column range, and the loss is its masked sum, summed over the world;
* :func:`make_sharded_lookup_train_step` completes it into a step: the
  slab's gradient is summed over the data group, the replicated relation
  table's over the world, and Adagrad runs shard-locally on the slab and
  its accumulator through kernel 3 (``ops/adagrad_kernel.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.models.model import QUERY_FNS, KGEModel
from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update_leaves
from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates
from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import (
    _all_reduce,
    all_reduce_tensors,
    boundary_gather,
)
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def sharded_embedding_lookup(table_local: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS):
    """Rows ``ids`` (global, the same on every rank of the ``axis`` group)
    of a table row-sharded over ``axis`` in equal slabs, this rank's being
    ``table_local`` -> the [K, d] rows on every rank; differentiable in
    ``table_local``."""
    rows = table_local.shape[0]
    return boundary_gather(table_local, ids, mesh.index(axis) * rows, mesh.group(axis))


def _row_block(n: int, mesh: Mesh) -> slice:
    if n % mesh.data:
        raise ValueError(f"{n} batch rows do not split over {mesh.data} data ranks")
    b = n // mesh.data
    return slice(mesh.index(DATA_AXIS) * b, (mesh.index(DATA_AXIS) + 1) * b)


def make_sharded_lookup_score_fn(model: KGEModel, mesh: Mesh, loss_type: str = "bce"):
    """Explicit-collective loss of a lookup model -> ``fn(variables, batch)
    -> loss_sum``, the BCE sum over the whole batch on every rank.
    ``variables`` hold the whole tables (the same on every rank); the
    entity table is padded to a multiple of ``model`` rows and each rank
    takes its slab.  ``fn.local_fn(ent_slab, rel_table, local_batch)`` is
    this rank's part of the sum (differentiable), on a
    :func:`prepare_local_batch` dict."""
    if loss_type != "bce":
        raise ValueError("the explicit-collective path computes BCE only")
    M = mesh.model
    E = model.meta.entities_size
    E_pad = -(-E // M) * M
    off = model.meta.min_entities_size
    query_fn = QUERY_FNS[model.scorer]

    def local_fn(ent_table, rel_table, b):
        # the boundary gather over the model group; the relation table is
        # small and replicated, so its gather is local
        e = sharded_embedding_lookup(ent_table, b["ent_ids"], mesh)
        q = query_fn(e, rel_table[b["rel_ids"]], b["is_sp"])
        # this rank's table rows ARE its candidates
        rows = ent_table.shape[0]
        lo = mesh.index(MODEL_AXIS) * rows
        x = score_against_candidates(q, ent_table)  # [B/D, V/M]
        # labels in the slab's column range, in entity-id space
        pos_rows, col_global = b["pos_rows"], b["pos_cols"] + off
        in_range = (col_global >= lo) & (col_global < lo + rows) & (pos_rows >= 0)
        flat = torch.where(in_range, pos_rows * rows + col_global - lo, 0).long()
        labels = torch.zeros(x.numel(), dtype=torch.float32, device=x.device).scatter_reduce_(
            0, flat, in_range.float(), reduce="amax").view_as(x)
        # mask: valid rows x real entity columns (ids >= off, < E)
        col_ids = lo + torch.arange(rows, device=x.device)
        mask = b["row_valid"][:, None] & ((col_ids >= off) & (col_ids < E))[None, :]
        per_cell = torch.clamp(x, min=0.0) - x * labels + torch.log1p(torch.exp(-x.abs()))
        return torch.where(mask, per_cell, 0.0).sum()

    def fn(variables, batch: Dict) -> torch.Tensor:
        ent = _pad_rows(variables["params"]["entity_embedding"], E_pad)
        rows = E_pad // M
        m = mesh.index(MODEL_AXIS)
        local = local_fn(ent[m * rows : (m + 1) * rows], variables["params"]["relation_embedding"],
                         prepare_local_batch(batch, mesh, ent.device))
        return _all_reduce(local.detach().clone())

    fn.local_fn = local_fn
    return fn


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t if t.shape[0] == n else torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])


def prepare_local_batch(batch: Dict, mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """Host side, once per batch: this rank's block of the rows and of the
    re-bucketed positives (:func:`_shard_positives_by_row`), on ``device``."""
    rows = _row_block(len(batch["ent_ids"]), mesh)
    pos_r, pos_c = _shard_positives_by_row(batch, mesh)
    cap = len(pos_r) // mesh.data
    d = mesh.index(DATA_AXIS)
    out = {k: np.asarray(batch[k])[rows] for k in ("ent_ids", "rel_ids", "is_sp", "row_valid")}
    out.update(pos_rows=pos_r[d * cap : (d + 1) * cap], pos_cols=pos_c[d * cap : (d + 1) * cap])
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()}
    for k in ("ent_ids", "rel_ids", "pos_rows", "pos_cols"):
        t[k] = t[k].long()
    t["normalizer_loss"] = float(batch["normalizer_loss"])
    return t


def make_sharded_lookup_train_step(model: KGEModel, mesh: Mesh, loss_type: str = "bce"):
    """A full explicit-collective training step of a full-vocabulary lookup
    model -> ``(step, prepare, prepare_batch)``.

    ``step(params, opt_state, hp, batch) -> (params, opt_state, loss_sum)``:
    the backward of this rank's loss part (the boundary gather's backward
    sums the query rows' cotangents over the model group), the slab's
    gradient summed over the data group and the relation table's over the
    world, then Adagrad on the slab and its accumulator and on the
    replicated table (kernel 3, one launch), in place.  ``params`` =
    ``{"entity_embedding": [E_pad / M, d] slab, "relation_embedding": [R,
    d]}``, ``opt_state`` = ``{"ent", "rel"}`` accumulators and ``"step"``;
    ``hp`` = ``{lr, lr_decay, weight_decay, eps}``.  :func:`prepare` builds
    them from a model's (whole) variables, ``prepare_batch`` a batch."""
    M = mesh.model
    E = model.meta.entities_size
    E_pad = -(-E // M) * M
    local_fn = make_sharded_lookup_score_fn(model, mesh, loss_type).local_fn

    def prepare_batch(batch: Dict) -> Dict:
        """Host side: this rank's rows and re-bucketed positives."""
        return prepare_local_batch(batch, mesh, device)

    def step(params, opt_state, hp, batch):
        ent = params["entity_embedding"].detach().requires_grad_()
        rel = params["relation_embedding"].detach().requires_grad_()
        local = local_fn(ent, rel, batch)
        (local / batch["normalizer_loss"]).backward()
        g_ent, g_rel = ent.grad, rel.grad
        all_reduce_tensors([g_ent], mesh.group(DATA_AXIS))  # the slab's gradient: its data group
        loss_sum = local.detach().clone()
        all_reduce_tensors([g_rel, loss_sum])  # the replicated table's and the loss: the world
        steps = adagrad_update_leaves([g_ent, g_rel], [params["entity_embedding"], params["relation_embedding"]],
                                      [opt_state["ent"], opt_state["rel"]], [opt_state["step"]] * 2, hp)
        return params, {**opt_state, "step": steps[0]}, loss_sum

    device = None

    def prepare(variables):
        nonlocal device
        ent = _pad_rows(variables["params"]["entity_embedding"], E_pad)
        device = ent.device
        rows = E_pad // M
        m = mesh.index(MODEL_AXIS)
        params = {"entity_embedding": ent[m * rows : (m + 1) * rows].clone(),
                  "relation_embedding": variables["params"]["relation_embedding"].clone()}
        opt_state = {"ent": torch.zeros_like(params["entity_embedding"]),
                     "rel": torch.zeros_like(params["relation_embedding"]),
                     "step": torch.zeros((), dtype=torch.float32, device=device)}
        return params, opt_state

    return step, prepare, prepare_batch


def _shard_positives_by_row(batch: Dict, mesh: Mesh):
    """Re-bucket (pos_rows, pos_cols) so each data rank receives the
    positives of its own row block, padded to a common per-rank size ->
    ``(pos_rows, pos_cols)`` [D * cap] with local row indices, -1 padded."""
    D = mesh.data
    B = len(batch["ent_ids"])
    rows_per = B // D
    pos_rows = np.asarray(batch["pos_rows"])
    pos_cols = np.asarray(batch["pos_cols"])
    valid = pos_rows >= 0
    owner = np.where(valid, pos_rows // rows_per, -1)
    cap = max([int((owner == d).sum()) for d in range(D)] + [1])
    out_r = np.full((D, cap), -1, np.int32)
    out_c = np.full((D, cap), -1, np.int32)
    for d in range(D):
        sel = owner == d
        n = int(sel.sum())
        out_r[d, :n] = pos_rows[sel] - d * rows_per  # local row index
        out_c[d, :n] = pos_cols[sel]
    return out_r.reshape(D * cap), out_c.reshape(D * cap)
