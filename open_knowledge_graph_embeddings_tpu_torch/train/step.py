"""The train step (encode, fused score + BCE or scores + KL, backward,
optimizer update), its gradient-accumulation form and the eval step
(encode, loss, filtered ranks).

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/step.py``:
:func:`prefix_loss`, :func:`train_batch_to_arrays`, the dense step
:func:`make_train_step`, which differentiates with respect to every
parameter and is the reference the sparse step (train/sparse.py) is held
against, :func:`make_accum_steps` and :func:`make_eval_step`.  PyTorch runs
eagerly, so a step is a plain function; the parameters and optimizer state
are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.ops import scoring
from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import (
    CHUNKED_ABOVE,
    eval_stats_chunked,
    filtered_topk,
    filtered_topk_block,
    filtered_topk_chunked,
    metric_sums_from_ranks,
    ranks_from_scores,
)
from open_knowledge_graph_embeddings_tpu_torch.train.loss import bce_over_scores, one_vs_n_loss
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes


def prefix_loss(model: KGEModel, variables, batch, loss_type: str, label_smoothing: float,
                generator: Optional[torch.Generator]):
    """``(loss_sum, normalizer_metric, new_state, reg)`` of a train batch (a
    dict of device tensors).  BCE goes through the fused score + loss
    ``bce_over_scores``; KL through the explicit [B, N] scores and dense
    labels (``one_vs_n_loss``).  With query dedup, ``dedup/ent_inv`` and
    ``dedup/rel_inv`` gather the unique encodes back to per-row.

    On a mesh of ranks (``model.mesh``) every rank encodes the whole batch
    (its LSTM rows split and gathered, models/model.py) and scores only its
    block of the rows, on a model axis against its block of the candidates
    (the positives outside the block's columns dropped, ``col_valid`` cut
    to it, KL's softmax over every rank's block): the loss sum and the
    count of positives are this rank's part, the regularizer counts once
    (models/model.py), so that the sums over the ranks
    (:func:`reduce_over_ranks`) are the batch's."""
    cand_ids = batch.get("candidate_ids")
    q, cand_emb, new_state, reg = model.prefix_queries_and_candidates(
        variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"], cand_ids, train=True,
        generator=generator, ent_inv=batch.get("dedup/ent_inv"), rel_inv=batch.get("dedup/rel_inv"))
    pos_rows, pos_cols, row_valid = batch["pos_rows"], batch["pos_cols"], batch["row_valid"]
    col_valid, group = batch.get("col_valid"), None
    if model.mesh is not None:
        from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import block

        lo, hi = block(q.shape[0], model.mesh)
        keep = (pos_rows >= lo) & (pos_rows < hi)
        q, row_valid = q[lo:hi], row_valid[lo:hi]
        pos_rows, pos_cols = torch.where(keep, pos_rows - lo, -1), torch.where(keep, pos_cols, -1)
    cb = model.cand_block(None if cand_ids is None else cand_ids.shape[0])
    if cb is not None:
        keep = (pos_cols >= cb.lo) & (pos_cols < cb.hi)
        pos_rows, pos_cols = torch.where(keep, pos_rows, -1), torch.where(keep, pos_cols - cb.lo, -1)
        col_valid = None if col_valid is None else col_valid[cb.lo : cb.hi]
        group = cb.group
    if loss_type == "bce":
        loss_sum = bce_over_scores(q, cand_emb, pos_rows, pos_cols, row_valid, col_valid, batch["n_real_cols"],
                                   label_smoothing)
        return loss_sum, (pos_rows >= 0).sum().float(), new_state, reg
    loss_sum, norm_metric = one_vs_n_loss(loss_type, scoring.score_against_candidates(q, cand_emb), pos_rows,
                                          pos_cols, row_valid, col_valid, batch["n_real_cols"], label_smoothing,
                                          group=group)
    return loss_sum, norm_metric, new_state, reg


def reduce_over_ranks(model: KGEModel, grads, loss_sum, norm_metric, slabs=()):
    """On a mesh: sum the gradients (a list of trees, in place) and the loss
    sum and count of positives over the ranks, so every rank applies the
    same update -> ``(loss_sum, norm_metric)``: the gradient of a slab (a
    top-level key in ``slabs``) over its data group (its model group's
    ranks summed theirs in the boundary gather's backward), everything else
    over the world in one ``all_reduce``.  Without a mesh: the two as they
    are."""
    if model.mesh is None:
        return loss_sum, norm_metric
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import all_reduce_tensors, tensors_of
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS

    whole, sharded = [], []
    for tree in grads:
        for k, g in tree.items():
            (sharded if k in slabs else whole).extend(tensors_of([g]))
    all_reduce_tensors(sharded, model.mesh.group(DATA_AXIS))
    stats = torch.stack([loss_sum.detach().float(), norm_metric.float()])
    all_reduce_tensors(whole + [stats])
    return stats[0], stats[1]


def train_batch_to_arrays(batch: Batch) -> Dict[str, Any]:
    """A host :class:`Batch` -> the step's array dict (numpy)."""
    d = {
        "ent_ids": batch.ent_ids,
        "rel_ids": batch.rel_ids,
        "is_sp": batch.is_sp,
        "row_valid": batch.row_valid,
        "pos_rows": batch.pos_rows,
        "pos_cols": batch.pos_cols,
        "normalizer_loss": np.float32(batch.normalizer_loss),
        "n_real_cols": np.float32(batch.num_cols),
    }
    if batch.candidate_ids is not None:
        d["candidate_ids"] = batch.candidate_ids
        d["col_valid"] = batch.col_valid
    return d


def eval_batch_to_arrays(batch: Batch) -> Dict[str, Any]:
    """An eval :class:`Batch` -> the eval step's array dict (numpy)."""
    d = train_batch_to_arrays(batch)
    d.update(filter_rows=batch.filter_rows, filter_cols=batch.filter_cols, gold_rows=batch.gold_rows,
             gold_mention_cols=batch.gold_mention_cols)
    return d


def arrays_to_device(arrays: Dict[str, Any], device) -> Dict[str, Any]:
    """Numpy array dict -> tensors on ``device``: index arrays as int64,
    scalars as 0-d f32 tensors."""

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device, non_blocking=True)

    return {k: put(v) for k, v in arrays.items()}


def make_train_step(model: KGEModel, regimes: OptimizerRegimes, params_example, loss_type: str = "bce",
                    label_smoothing: float = 0.0, grad_clip: Optional[float] = None):
    """``step(variables, opt_state, hparams, batch, generator) -> (variables,
    opt_state, stats)`` with dense gradients of every parameter."""
    apply_updates = regimes.make_apply(params_example, grad_clip, **sharded_norm(model, params_example))

    def step(variables, opt_state, hparams, batch, generator=None):
        params = variables["params"]
        leaves = leaf_tree(params)
        v = {**variables, "params": leaves}
        loss_sum, norm_metric, new_state, reg = prefix_loss(model, v, batch, loss_type, label_smoothing,
                                                             generator)
        ((loss_sum + reg) / batch["normalizer_loss"]).backward()
        grads = grad_tree(leaves)
        loss_sum, norm_metric = reduce_over_ranks(model, [grads], loss_sum, norm_metric, variables.get("slabs", ()))
        new_params, new_opt = apply_updates(grads, opt_state, params, hparams)
        new_variables = {**variables, "params": new_params, "state": new_state}
        return new_variables, new_opt, {"loss_sum": loss_sum.detach(), "normalizer_metric": norm_metric}

    return step


def make_accum_steps(model: KGEModel, regimes: OptimizerRegimes, params_example, loss_type: str = "bce",
                     label_smoothing: float = 0.0, grad_clip: Optional[float] = None):
    """Gradient accumulation (the reference's ``batch_size_for_backward``):
    ``(zero_grads, grad_step, apply_step)``.  ``zero_grads()`` is a fresh
    accumulator shaped like the params; ``grad_step(variables, acc, batch,
    generator) -> (variables, acc, stats)`` adds a micro-batch's
    normalizer-scaled gradients to it (the params are not updated, the
    batchnorm state is); ``apply_step(variables, opt_state, acc, hparams)
    -> (variables, opt_state)`` is one optimizer update from the sum, with
    the regime's clip."""
    apply_updates = regimes.make_apply(params_example, grad_clip, **sharded_norm(model, params_example))

    def zero_grads():
        return map_tree(torch.zeros_like, params_example)

    def grad_step(variables, acc, batch, generator=None):
        leaves = leaf_tree(variables["params"])
        v = {**variables, "params": leaves}
        loss_sum, norm_metric, new_state, reg = prefix_loss(model, v, batch, loss_type, label_smoothing,
                                                             generator)
        ((loss_sum + reg) / batch["normalizer_loss"]).backward()
        grads = grad_tree(leaves)
        loss_sum, norm_metric = reduce_over_ranks(model, [grads], loss_sum, norm_metric, variables.get("slabs", ()))
        add_tree(acc, grads)
        new_variables = {**variables, "state": new_state}
        return new_variables, acc, {"loss_sum": loss_sum.detach(), "normalizer_metric": norm_metric}

    def apply_step(variables, opt_state, acc, hparams):
        new_params, new_opt = apply_updates(acc, opt_state, variables["params"], hparams)
        return {**variables, "params": new_params}, new_opt

    return zero_grads, grad_step, apply_step


def sharded_norm(model: KGEModel, params) -> Dict[str, Any]:
    """The keywords of ``make_apply`` / ``clip_by_global_norm`` that count a
    slab's squares over its model group: the sharded top-level ``params``
    (every entity table on a model axis) and the group."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import MODEL_AXIS
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import ROW_SHARDED_TABLES

    if not model.model_axis:
        return {}
    return {"sharded": tuple(k for k in params if k in ROW_SHARDED_TABLES), "group": model.mesh.group(MODEL_AXIS)}


def map_tree(fn, tree):
    return {k: map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def add_tree(acc, grads):
    """``acc += grads`` leaf by leaf, in place."""
    for k, g in grads.items():
        if isinstance(g, dict):
            add_tree(acc[k], g)
        else:
            acc[k].add_(g)


def leaf_tree(tree):
    """Autograd leaves sharing storage with ``tree``'s tensors (the in-place
    updates after the backward write through to the parameters)."""
    return {k: leaf_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.detach().requires_grad_()


def grad_tree(tree):
    """The gradients of :func:`leaf_tree`'s leaves; a leaf the loss does not
    reach (the relation encoder of the entity-bias model, the unused
    batchnorm of the bigram's token encode) gets zeros, as JAX's gradient
    gives it, and takes its optimizer update (weight decay) like the rest."""
    if isinstance(tree, dict):
        return {k: grad_tree(v) for k, v in tree.items()}
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


def make_eval_step(model: KGEModel, loss_type: str = "bce", label_smoothing: float = 0.0, topk: int = 0):
    """``eval_step(variables, batch, cand_emb=None)`` -> the stats of
    :data:`EVAL_STAT_KEYS` packed in one f32 device vector (the rank metrics
    summed over the batch's golds), and with ``topk > 0`` also the filtered
    top-k ``(scores, columns)`` per prefix.

    ``cand_emb`` is the precomputed [N, d] candidate cache of a
    full-vocabulary eval.  Above ``CHUNKED_ABOVE`` candidates the step scores
    chunk by chunk (:func:`..train.evaluate.eval_stats_chunked`, no [B, N]
    score matrix); otherwise it takes the [B, N] scores (candidates encoded
    from the batch's ids when there is no cache, the batch-shared
    validation) with :func:`..train.loss.one_vs_n_loss` and
    :func:`..train.evaluate.ranks_from_scores`.

    On a model axis every rank of a model group takes the same batch:
    ``cand_emb`` is this rank's block of the cache (or the step encodes its
    block of the candidates, ``KGEModel.cand_block``), and the chunked
    ranking runs over the blocks of the group (``eval_stats_chunked(...,
    block=)``), so its stats are the group's, the same on every rank."""

    def pack(stats, loss_sum, norm_metric):
        stats.update(loss_sum=loss_sum, normalizer_metric=norm_metric)
        return torch.stack([stats[k].float() for k in EVAL_STAT_KEYS])

    @torch.no_grad()
    def eval_step(variables, batch, cand_emb=None):
        cand_ids, col_valid = batch.get("candidate_ids"), batch.get("col_valid")
        golds = (batch["filter_rows"], batch["filter_cols"], batch["gold_rows"], batch["gold_mention_cols"])
        cb = model.cand_block(None if cand_ids is None else cand_ids.shape[0])
        if cb is not None:
            if cand_emb is None:
                q, cand_emb, _, _ = model.prefix_queries_and_candidates(
                    variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"], cand_ids)
            else:
                q, _, _ = model.queries(variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"])
            loss_sum, ranks, gold_valid = eval_stats_chunked(
                q, cand_emb, batch["pos_rows"], batch["pos_cols"], batch["row_valid"], col_valid,
                batch["n_real_cols"], *golds, label_smoothing, loss_type=loss_type, block=cb)
            packed = pack(metric_sums_from_ranks(ranks, gold_valid), loss_sum,
                          (batch["pos_rows"] >= 0).sum().float())
            if topk > 0:
                return (packed, *filtered_topk_block(q, cand_emb, golds[0], golds[1], col_valid, topk, cb))
            return packed
        if cand_emb is not None and cand_ids is None and cand_emb.shape[0] > CHUNKED_ABOVE:
            q, _, _ = model.queries(variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"])
            loss_sum, ranks, gold_valid = eval_stats_chunked(
                q, cand_emb, batch["pos_rows"], batch["pos_cols"], batch["row_valid"], col_valid,
                batch["n_real_cols"], *golds, label_smoothing, loss_type=loss_type)
            packed = pack(metric_sums_from_ranks(ranks, gold_valid), loss_sum,
                          (batch["pos_rows"] >= 0).sum().float())
            if topk > 0:
                return (packed, *filtered_topk_chunked(q, cand_emb, golds[0], golds[1], col_valid, topk))
            return packed
        scores, _, _ = model.prefix_scores(variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"],
                                           cand_ids=cand_ids, cand_emb=cand_emb)
        loss_sum, norm_metric = one_vs_n_loss(loss_type, scores, batch["pos_rows"], batch["pos_cols"],
                                              batch["row_valid"], col_valid, batch["n_real_cols"], label_smoothing)
        ranks, gold_valid = ranks_from_scores(scores, *golds, col_valid)
        packed = pack(metric_sums_from_ranks(ranks, gold_valid), loss_sum, norm_metric)
        if topk > 0:
            return (packed, *filtered_topk(scores, golds[0], golds[1], col_valid, topk))
        return packed

    return eval_step


EVAL_STAT_KEYS = ("count", "mrr", "mr", "h50", "h10", "h3", "h1", "loss_sum", "normalizer_metric")


def unpack_eval_stats(packed: Sequence[float]) -> Dict[str, float]:
    vals = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    return {k: float(v) for k, v in zip(EVAL_STAT_KEYS, vals)}
