"""Host-side training engine on one device: the epoch loop, optimizer phase
switching, throughput logging and checkpoints.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/trainer.py`` for
a single device.  Semantics carried over:

* ``epoch`` derived from training steps: ``floor(steps / (len + 1)) + 1``
  (so ``epochs: 2`` trains one epoch);
* the host builds batches (and the sparse plans) on ``workers`` prefetch
  threads while the device runs the previous step;
* items/sec = positives per second;
* checkpoints ``checkpoint{0..k-1}`` with the optimizer state and the
  optimizer's host state, always one at the end of a run.

``train_scan_steps`` (K steps per device program on the TPU) runs its K
steps one after another here: the same math (``tests/test_scan_steps.py``);
capturing them in a CUDA graph is ROADMAP Queue 1 item 10.  Evaluation,
early stopping and model selection come with Queue 1 item 8; gradient
accumulation with item 12; meshes with item 14.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    load_checkpoint,
    load_opt_state,
    save_checkpoint,
)
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import (
    SparsePlanBuilder,
    make_sparse_train_step,
    sparse_table_names,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    make_train_step,
    train_batch_to_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import ResultsLog

logger = logging.getLogger(__name__)


def _eval_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with eval: ROADMAP Queue 1 item 8")


class Trainer:
    def __init__(
        self,
        args: Dict[str, Any],
        model: KGEModel,
        train_dataset: OneToNMentionRelationDataset,
        save_path: str = ".",
        device="cuda",
        keep_checkpoints: int = 5,
        variables=None,
        has_validation: bool = False,
    ):
        """``has_validation``: the config names a validation set, so the
        eval cadence (``eval_epoch_freq``, ``eval_freq``) asks for eval,
        which raises until eval is ported."""
        self.args = args
        self.model = model
        self.train_dataset = train_dataset
        self.device = torch.device(device)
        seed = int(args.get("seed") or 0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.variables = variables if variables is not None else model.init(self.generator)

        self.loss_type = args.get("experiment_settings", {}).get("loss", "bce")
        self.label_smoothing = float(args.get("bce_label_smoothing") or 0.0)
        self.grad_clip = float(args["grad_clip"]) if args.get("grad_clip") else None
        bsz = train_dataset.batch_size
        bsfb = args.get("batch_size_for_backward") or train_dataset.batch_size_for_backward
        if int(round((bsfb or bsz) / bsz)) > 1:
            raise NotImplementedError("gradient accumulation is not ported yet: ROADMAP Queue 1 item 12")
        if int(args.get("model_parallel") or 1) > 1:
            raise NotImplementedError("model parallelism is not ported yet: ROADMAP Queue 1 item 14")
        self.has_validation = has_validation

        frozen = args.get("resume_freeze") or []
        self.regimes = OptimizerRegimes(
            args["optimization_config"], args.get("lr_scheduler_config"),
            frozen_patterns=[frozen] if isinstance(frozen, str) else frozen,
        )
        self.regimes.update(1, 0)

        # row-sparse table updates (embedder config `sparse: true`)
        entity_sparse = bool(train_dataset.use_batch_shared_entities)
        self.sparse = bool(getattr(model.embedder, "sparse", False)) and bool(
            sparse_table_names(model.embedder, entity_sparse))
        self._sparse_plan = None
        if self.sparse:
            self._sparse_plan = SparsePlanBuilder(
                model.embedder, entity_sparse,
                min_rows_ratio=float(args.get("sparse_min_ratio", 12.0)),
                grad_plan=bool(args.get("sparse_grad_plan", True)),
            )
            logger.info("row-sparse updates for tables %s (entity_sparse=%s)",
                        self._sparse_plan.tables, entity_sparse)
        self.opt_state = self.regimes.init_state(self.variables["params"])
        self._rebuild_steps()
        self.train_builder = BatchBuilder(train_dataset, seed=seed)
        if int(args.get("train_scan_steps") or 1) > 1:
            logger.info("train_scan_steps=%s: the steps of a window run one after another",
                        args["train_scan_steps"])

        self.save_path = save_path
        self.keep_checkpoints = keep_checkpoints
        self._ckpt_counter = 0
        self.results = ResultsLog(os.path.join(save_path, "results.csv"))
        self.training_steps = 0
        self.len_train_batches = max(len(self.train_builder), 1)
        #: per step: host ms waiting for the next planned batch, the loss per
        #: real cell (a device scalar) and the tables that took the row-sparse
        #: update
        self.step_log: List[Dict[str, Any]] = []
        self.last_epoch: Optional[Dict[str, float]] = None

    def _rebuild_steps(self):
        kw = dict(loss_type=self.loss_type, label_smoothing=self.label_smoothing, grad_clip=self.grad_clip)
        if self.sparse:
            self.train_step = make_sparse_train_step(
                self.model, self.regimes, self.variables["params"],
                entity_sparse=self._sparse_plan.entity_sparse, **kw)
        else:
            self.train_step = make_train_step(self.model, self.regimes, self.variables["params"], **kw)

    @property
    def epoch(self) -> int:
        return math.floor(self.training_steps / (self.len_train_batches + 1)) + 1

    def _to_device(self, batch):
        """Runs on the prefetch threads: the host plan, then the copy."""
        arrays = self._sparse_plan(batch) if self.sparse else train_batch_to_arrays(batch)
        return batch, arrays_to_device(arrays, self.device)

    def train_epoch(self):
        """One pass over the training data -> ``{"loss": mean loss per
        real cell, "items_per_s": positives per second}``."""
        n_batches = len(self.train_builder)
        if n_batches == 0:
            raise ValueError("training builder produced 0 batches: check train_data_config "
                             "(input_file, batch_size) against the dataset")
        self.len_train_batches = n_batches
        print_freq = self.args.get("print_freq") or 100
        save_freq = self.args.get("save_freq") or -1
        eval_freq = (self.args.get("eval_freq") or 0) if self.has_validation else 0
        workers = int(self.args.get("workers", 8))
        # stats stay on the device until a print boundary: no sync per step
        pending: List = []
        loss_sum_total = norm_total = items = 0.0
        epoch_start = batch_start = time.time()
        items_t = 1e-9

        def drain():
            nonlocal loss_sum_total, norm_total, items
            for stats, norm_loss in pending:
                loss_sum_total += float(stats["loss_sum"])
                norm_total += norm_loss
                items += float(stats["normalizer_metric"])
            pending.clear()

        it = self.train_builder.batches(shuffle=True, prefetch=max(2, workers), transform=self._to_device,
                                        workers=workers)
        step_i = -1
        while True:
            t_wait = time.perf_counter()
            try:
                batch, arrays = next(it)
            except StopIteration:
                break
            wait_ms = (time.perf_counter() - t_wait) * 1e3
            step_i += 1
            self.training_steps += 1
            if self.regimes.update(self.epoch, self.training_steps):
                # optimizer type changed: fresh state and a rebuilt step
                self.opt_state = self.regimes.init_state(self.variables["params"])
                self._rebuild_steps()
            self.variables, self.opt_state, stats = self.train_step(
                self.variables, self.opt_state, self.regimes.hparams(), arrays, self.generator)
            self.step_log.append({
                "wait_ms": wait_ms,
                "loss": stats["loss_sum"] / batch.normalizer_loss,  # stays on the device
                "sparse_tables": tuple(t for t in ("entity_token_embedding", "relation_token_embedding")
                                       if f"sparse/{t}/uids" in arrays),
            })
            pending.append((stats, batch.normalizer_loss))
            now = time.time()
            items_t += now - batch_start
            batch_start = now
            if step_i % print_freq == 0 or step_i == n_batches - 1:
                drain()
                logger.info(
                    "TRAINING - EPOCH [%3d][%6d/%d]  time: %7.3f  items/sec: (%.0f)  loss: %.7f",
                    self.epoch, step_i, n_batches, time.time() - epoch_start, items / items_t,
                    loss_sum_total / max(norm_total, 1e-30),
                )
            if save_freq > 0 and step_i > 0 and step_i % save_freq == 0:
                self.save()
            if eval_freq > 0 and step_i > 0 and step_i % eval_freq == 0:
                raise _eval_not_ported(f"eval_freq (step {step_i})")
        drain()
        return {"loss": loss_sum_total / max(norm_total, 1e-30), "items_per_s": items / items_t}

    def run(self):
        """Train until the epochs are exhausted; leave a checkpoint."""
        epochs = self.args.get("epochs", 100)
        if self.has_validation and (self.args.get("eval_epoch_freq") or 0) > 0:
            raise _eval_not_ported("eval_epoch_freq > 0 with a validation set")
        while self.epoch < epochs:
            result = self.last_epoch = self.train_epoch()
            self.results.add(epoch=self.epoch, training_steps=self.training_steps,
                             training_loss=result["loss"])
            self.results.save()
        if self.training_steps > 0:
            self.save()

    def save(self) -> str:
        meta = {
            "epoch": self.epoch,
            "training_steps": self.training_steps,
            "config": _jsonable(self.args),
            "optimizer_host_state": self.regimes.host_state(),
            "results": self.results.to_dicts(),
        }
        name = f"checkpoint{self._ckpt_counter}"
        self._ckpt_counter = (self._ckpt_counter + 1) % self.keep_checkpoints
        return save_checkpoint(self.save_path, name, self.variables, meta, self.opt_state)

    def load(self, path: str, reset_optimizer: bool = False):
        """Resume from a checkpoint of either package: variables, optimizer
        state and host state (unless ``reset_optimizer``), step count and
        results."""
        self.variables, meta = load_checkpoint(path, self.variables)
        host = meta.get("optimizer_host_state")
        if host:
            old_names = self.regimes.opt_names()
            self.regimes.load_host_state(host, reset=reset_optimizer)
            if self.regimes.opt_names() != old_names:
                self.opt_state = self.regimes.init_state(self.variables["params"])
                self._rebuild_steps()
        if not reset_optimizer:
            self.opt_state = load_opt_state(path, self.opt_state)
        self.training_steps = int(meta.get("training_steps", 0))
        if meta.get("results"):
            self.results.rows = list(meta["results"])
        return meta


def _jsonable(obj):
    import json

    try:
        json.dumps(obj)
        return obj
    except TypeError:
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return str(obj)
