"""The train step: encode, fused score + BCE, backward, optimizer update.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/step.py``:
:func:`prefix_loss`, :func:`train_batch_to_arrays` and the dense step
:func:`make_train_step`, which differentiates with respect to every
parameter and is the reference the sparse step (train/sparse.py) is held
against.  PyTorch runs eagerly, so a step is a plain function; the
parameters and optimizer state are updated in place.  The eval step comes
with ROADMAP Queue 1 item 8, gradient accumulation with item 12.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.train.loss import bce_over_scores
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes


def prefix_loss(model: KGEModel, variables, batch, loss_type: str, label_smoothing: float,
                generator: Optional[torch.Generator]):
    """``(loss_sum, normalizer_metric, new_state, reg)`` of a train batch (a
    dict of device tensors).  BCE goes through the fused score + loss
    ``bce_over_scores``; with query dedup, ``dedup/ent_inv`` and
    ``dedup/rel_inv`` gather the unique encodes back to per-row."""
    if loss_type != "bce":
        raise NotImplementedError(f"loss {loss_type!r} is not ported yet: ROADMAP Queue 1 item 4")
    q, cand_emb, new_state, reg = model.prefix_queries_and_candidates(
        variables, batch["ent_ids"], batch["rel_ids"], batch["is_sp"], batch.get("candidate_ids"),
        train=True, generator=generator, ent_inv=batch.get("dedup/ent_inv"),
        rel_inv=batch.get("dedup/rel_inv"),
    )
    loss_sum = bce_over_scores(
        q, cand_emb, batch["pos_rows"], batch["pos_cols"], batch["row_valid"], batch.get("col_valid"),
        batch["n_real_cols"], label_smoothing,
    )
    return loss_sum, (batch["pos_rows"] >= 0).sum().float(), new_state, reg


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
    apply_updates = regimes.make_apply(params_example, grad_clip)

    def step(variables, opt_state, hparams, batch, generator=None):
        params = variables["params"]
        leaves = leaf_tree(params)
        v = {"params": leaves, "state": variables["state"], "buffers": variables["buffers"]}
        loss_sum, norm_metric, new_state, reg = prefix_loss(model, v, batch, loss_type, label_smoothing,
                                                             generator)
        ((loss_sum + reg) / batch["normalizer_loss"]).backward()
        new_params, new_opt = apply_updates(grad_tree(leaves), opt_state, params, hparams)
        new_variables = {"params": new_params, "state": new_state, "buffers": variables["buffers"]}
        return new_variables, new_opt, {"loss_sum": loss_sum.detach(), "normalizer_metric": norm_metric}

    return step


def leaf_tree(tree):
    """Autograd leaves sharing storage with ``tree``'s tensors (the in-place
    updates after the backward write through to the parameters)."""
    return {k: leaf_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.detach().requires_grad_()


def grad_tree(tree):
    return {k: grad_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.grad
