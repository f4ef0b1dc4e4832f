"""Host-side training engine: the epoch loop, optimizer phase switching,
the eval cadence, model selection, early stopping, throughput logging and
checkpoints, on one device or on several processes.

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/trainer.py``.
Semantics carried over:

* ``epoch`` derived from training steps: ``floor(steps / (len + 1)) + 1``
  (so ``epochs: 2`` runs two passes, the second stopping the loop);
* the host builds batches (and the sparse plans) on ``workers`` prefetch
  threads while the device runs the previous step;
* eval every ``eval_freq`` steps and/or every ``eval_epoch_freq`` epochs
  on the validation split (batch-shared, or full vocabulary against the
  candidate cache in device batches of ``eval_block_rows`` prefixes);
* model selection on ``model_select_metric`` (``model_best-{metric}``
  copies) with patience early stopping and its three extra triggers (the
  metric above the max threshold, below the min threshold, its moving
  average relative change below ``patience_metric_change``);
* items/sec = positives per second;
* checkpoints ``checkpoint{0..k-1}`` with the optimizer state and the
  optimizer's host state, ``checkpoint_epoch_{n}`` at ``save_epoch_freq``,
  always one at the end of a run;
* with ``profile_steps`` > 0, a torch.profiler trace (host and device
  activity) of that many steps from training step 1 on, written as a
  Chrome trace to ``<save_path>/profile/trace.json``.

Gradient accumulation (``batch_size_for_backward`` = k x ``batch_size``):
each micro-batch adds its gradients to an accumulator and every k-th runs
one optimizer update from the sum; on the row-sparse path k batches form a
window planned over one union row space.  The accumulator (and on the
sparse path the batches of an unfinished window) carries across epoch
boundaries, and ``training_steps`` counts micro-batches, as in the JAX
package.

``train_scan_steps`` (K steps per device program on the TPU) runs its K
steps one after another here: the same math (``tests/test_scan_steps.py``);
capturing them in a CUDA graph is ROADMAP Queue 1 item 10.

Several processes (``parallel/``, a world set up by ``cli.train``): the
ranks form a data-parallel mesh; every rank builds each global batch and
its plans identically and scores its block of the rows, and the gradients
are summed over the ranks, so the replicas stay equal
(``train/step.py``).  Each rank evaluates a strided slice of the eval set
(``BatchBuilder(host_shard=...)``) and the metric sums are added over the
ranks; rank 0 writes ``results.csv``, decides early stopping for every
rank, and every rank writes its slab of a per-shard checkpoint
(``train/checkpoint.py::save_checkpoint_sharded``).  ``train_scan_steps``
is off on a mesh, as in the JAX package.  ``model_parallel > 1`` (the model
axis) is ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch, BatchBuilder, pad_batches_to_common_shape
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import TokenEmbedderBase
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import default_mesh
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    copy_checkpoint,
    load_checkpoint,
    load_checkpoint_meta,
    save_checkpoint,
    save_checkpoint_sharded,
)
from open_knowledge_graph_embeddings_tpu_torch.train.metrics import MetricResult
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import (
    SparsePlanBuilder,
    make_sparse_accum_steps,
    make_sparse_train_step,
    sparse_table_names,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    eval_batch_to_arrays,
    make_accum_steps,
    make_eval_step,
    make_train_step,
    train_batch_to_arrays,
    unpack_eval_stats,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import ResultsLog

logger = logging.getLogger(__name__)


def running_mean(new, old=None, momentum=0.9):
    return new if old is None else momentum * old + (1 - momentum) * new


class Trainer:
    def __init__(
        self,
        args: Dict[str, Any],
        model: KGEModel,
        train_dataset: OneToNMentionRelationDataset,
        validation_dataset: Optional[OneToNMentionRelationDataset] = None,
        save_path: str = ".",
        device="cuda",
        keep_checkpoints: int = 5,
        variables=None,
    ):
        """``validation_dataset``: the split :meth:`evaluate` ranks (with its
        filter index attached), or None: no eval."""
        self.args = args
        self.model = model
        self.train_dataset = train_dataset
        self.validation_dataset = validation_dataset
        self.device = torch.device(device)
        seed = int(args.get("seed") or 0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.variables = variables if variables is not None else model.init(self.generator)

        self.loss_type = args.get("experiment_settings", {}).get("loss", "bce")
        self.label_smoothing = float(args.get("bce_label_smoothing") or 0.0)
        self.grad_clip = float(args["grad_clip"]) if args.get("grad_clip") else None
        if int(args.get("model_parallel") or 1) > 1:
            raise NotImplementedError(
                "model parallelism (model_parallel > 1: row-sharded entity tables, the candidate axis over the "
                "model axis) is not ported yet: ROADMAP Queue 1 item 16")
        # several processes: the ranks of the world form a data-parallel mesh
        self.rank, self.world = dist.process_index(), dist.process_count()
        self.mesh = default_mesh() if dist.is_initialized() else None
        model.set_mesh(self.mesh)
        if self.mesh is not None:
            logger.info("data-parallel mesh: rank %d of %d (backend %s)", self.rank, self.world, dist.backend())

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
        self._sparse_tables = sparse_table_names(model.embedder, entity_sparse) if self.sparse else ()
        if self.sparse:
            self._sparse_plan = SparsePlanBuilder(
                model.embedder, entity_sparse,
                min_rows_ratio=float(args.get("sparse_min_ratio", 12.0)),
                grad_plan=bool(args.get("sparse_grad_plan", True)),
                mesh=self.mesh,
            )
            logger.info("row-sparse updates for tables %s (entity_sparse=%s); token plans on the %s branch",
                        self._sparse_plan.tables, entity_sparse, self._sparse_plan.plan_path)
        self.opt_state = self.regimes.init_state(self.variables["params"])
        self._rebuild_steps()
        self.train_builder = BatchBuilder(train_dataset, seed=seed)

        bsz = train_dataset.batch_size
        bsfb = args.get("batch_size_for_backward") or train_dataset.batch_size_for_backward
        self.accum_steps = max(1, int(round((bsfb or bsz) / bsz)))
        # the accumulation state carries across epoch boundaries
        self._acc_grads = None
        self._accum_i = 0
        self._window_buf: List[Batch] = []  # sparse path: the batches of an unfinished window
        if self.accum_steps > 1:
            logger.info("gradient accumulation over %d micro-batches%s", self.accum_steps,
                        " (row-sparse union-row windows)" if self.sparse else "")
        if int(args.get("train_scan_steps") or 1) > 1:
            if self.accum_steps > 1 or self.mesh is not None:
                logger.info("train_scan_steps=%s disabled (%s)", args["train_scan_steps"],
                            "gradient accumulation" if self.accum_steps > 1 else "device mesh")
            else:
                logger.info("train_scan_steps=%s: the steps of a window run one after another",
                            args["train_scan_steps"])

        # full-vocab eval scores eval_block_rows prefixes per device batch
        # (the metric sums do not depend on it); batch-shared eval keeps the
        # protocol batch, since its candidates depend on the batch
        eval_bs = None
        eval_block = int(args.get("eval_block_rows") or 0)
        if (validation_dataset is not None and eval_block > validation_dataset.batch_size
                and not validation_dataset.use_batch_shared_entities):
            eval_bs = eval_block
            logger.info("full-vocab eval device batch: %d rows (protocol batch %d)", eval_block,
                        validation_dataset.batch_size)
        # host-sharded eval: every rank holds whole parameters, so it ranks a
        # strided slice of the eval set alone; the metric sums are added
        val_shard = None
        if self.world > 1 and dist.local_eval_mesh(self.mesh) is not None:
            val_shard = (self.rank, self.world)
            logger.info("host-sharded eval: shard %s", val_shard)
        self.val_builder = (BatchBuilder(validation_dataset, batch_size=eval_bs, host_shard=val_shard)
                            if validation_dataset is not None else None)
        self._eval_batches_cache = None

        self.save_path = save_path
        self.keep_checkpoints = keep_checkpoints
        self._ckpt_counter = 0
        self.last_checkpoint: Optional[str] = None
        self.results = ResultsLog(os.path.join(save_path, "results.csv"))
        self.training_steps = 0
        self.len_train_batches = max(len(self.train_builder), 1)
        if "mr" in (args.get("model_select_metric") or []):
            logger.warning("model_select_metric includes 'mr', which is greater-is-better as in the reference "
                           "(utils/metrics.py:58): model selection will prefer the HIGHEST mean rank. Use 'mrr'.")
        self.terminate = False
        self.terminate_epochs = args.get("patience_epochs", 50)
        self.best_validation_results = MetricResult()
        self.last_validation_metric = None
        self.moving_average_metric_change = None
        #: the last evaluate(): host seconds of the candidate cache encode and
        #: of the batches, and the number of batches
        self.last_eval: Optional[Dict[str, float]] = None
        #: per step (micro-batch): host ms waiting for the next planned batch,
        #: the loss per real cell (a device scalar), the tables that took the
        #: row-sparse update, and whether an optimizer update ran after it
        #: (every step without accumulation)
        self.step_log: List[Dict[str, Any]] = []
        self.last_epoch: Optional[Dict[str, float]] = None
        self.profile_steps = int(args.get("profile_steps") or 0)
        self._profiler = None
        self._profiling_until = 0
        #: the trace file ``profile_steps`` wrote, once written
        self.profile_trace: Optional[str] = None

    def _rebuild_steps(self):
        kw = dict(loss_type=self.loss_type, label_smoothing=self.label_smoothing, grad_clip=self.grad_clip)
        params = self.variables["params"]
        if self.sparse:
            entity_sparse = self._sparse_plan.entity_sparse
            self.train_step = make_sparse_train_step(self.model, self.regimes, params, entity_sparse, **kw)
            self.zero_grads, self.grad_step, self.apply_step = make_sparse_accum_steps(
                self.model, self.regimes, params, entity_sparse, **kw)
        else:
            self.train_step = make_train_step(self.model, self.regimes, params, **kw)
            self.zero_grads, self.grad_step, self.apply_step = make_accum_steps(self.model, self.regimes, params,
                                                                                **kw)
        self.eval_step = make_eval_step(self.model, self.loss_type, self.label_smoothing)
        self._eval_step_topk = None  # built when log_predictions is set

    @property
    def epoch(self) -> int:
        return math.floor(self.training_steps / (self.len_train_batches + 1)) + 1

    def _to_device(self, batch):
        """Runs on the prefetch threads: the host plan, then the copy."""
        arrays = self._sparse_plan(batch) if self.sparse else train_batch_to_arrays(batch)
        return batch, arrays_to_device(arrays, self.device)

    def train_epoch(self, val_hook=None):
        """One pass over the training data -> ``{"loss": mean loss per
        real cell, "items_per_s": positives per second}``; calls
        ``val_hook(last_step_of_epoch=False)`` every ``eval_freq`` steps."""
        n_batches = len(self.train_builder)
        if n_batches == 0:
            raise ValueError("training builder produced 0 batches: check train_data_config "
                             "(input_file, batch_size) against the dataset")
        self.len_train_batches = n_batches
        print_freq = self.args.get("print_freq") or 100
        save_freq = self.args.get("save_freq") or -1
        eval_freq = self.args.get("eval_freq") or 0
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

        it = self._iter_train_arrays(workers)
        step_i = -1
        while True:
            t_wait = time.perf_counter()
            try:
                batch, arrays = next(it)
            except StopIteration:
                break
            wait_ms = (time.perf_counter() - t_wait) * 1e3
            step_i += 1
            if self.profile_steps:
                self._profile_before_step()
            self.training_steps += 1
            if self.regimes.update(self.epoch, self.training_steps):
                # optimizer type changed: fresh state and a rebuilt step
                self.opt_state = self.regimes.init_state(self.variables["params"])
                self._rebuild_steps()
            applied = True
            if self.accum_steps <= 1:
                self.variables, self.opt_state, stats = self.train_step(
                    self.variables, self.opt_state, self.regimes.hparams(), arrays, self.generator)
            else:
                stats, applied = self._accumulate(arrays)
            self.step_log.append({
                "wait_ms": wait_ms,
                "loss": stats["loss_sum"] / batch.normalizer_loss,  # stays on the device
                "sparse_tables": tuple(t for t in self._sparse_tables if f"sparse/{t}/uids" in arrays),
                "applied": applied,
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
            if val_hook is not None and eval_freq > 0 and step_i > 0 and step_i % eval_freq == 0:
                drain()
                val_hook(last_step_of_epoch=False)
        drain()
        return {"loss": loss_sum_total / max(norm_total, 1e-30), "items_per_s": items / items_t}

    def _profile_before_step(self) -> None:
        """Start the trace before the step after training step 1 and write it
        ``profile_steps`` steps later, as the JAX package's trainer does."""
        if self._profiler is None and self.training_steps == 1:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self._profiling_until = self.training_steps + self.profile_steps
        elif self._profiler is not None and self._profiling_until <= self.training_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out_dir = os.path.join(self.save_path, "profile")
        os.makedirs(out_dir, exist_ok=True)
        self.profile_trace = os.path.join(out_dir, "trace.json")
        self._profiler.export_chrome_trace(self.profile_trace)
        logger.info("wrote profiler trace to %s", self.profile_trace)
        self._profiler = None
        self.profile_steps = 0

    def _accumulate(self, arrays):
        """One micro-batch into the accumulator, and the optimizer update
        when it completes the window -> ``(stats, applied)``."""
        if self._acc_grads is None:
            # the sparse accumulator is shaped by the window's union plan
            self._acc_grads = self.zero_grads(arrays) if self.sparse else self.zero_grads()
        self.variables, self._acc_grads, stats = self.grad_step(self.variables, self._acc_grads, arrays,
                                                                self.generator)
        self._accum_i += 1
        if self._accum_i < self.accum_steps:
            return stats, False
        if self.sparse:  # any micro-batch of the window carries its union plan
            self.variables, self.opt_state = self.apply_step(self.variables, self.opt_state, self._acc_grads,
                                                             arrays, self.regimes.hparams())
        else:
            self.variables, self.opt_state = self.apply_step(self.variables, self.opt_state, self._acc_grads,
                                                             self.regimes.hparams())
        self._acc_grads = None
        self._accum_i = 0
        return stats, True

    def _iter_train_arrays(self, workers: int):
        """``(batch, device arrays)`` of one training pass.  The batches are
        built, planned and copied on the prefetch threads; with row-sparse
        accumulation ``accum_steps`` batches form a window planned over one
        union row space on this thread (``SparsePlanBuilder.plan_window``),
        and the batches of an unfinished window at the end of a pass wait
        in ``_window_buf`` for the next pass."""
        prefetch = max(2, workers)
        if not (self.sparse and self.accum_steps > 1):
            yield from self.train_builder.batches(shuffle=True, prefetch=prefetch, transform=self._to_device,
                                                  workers=workers)
            return
        for batch in self.train_builder.batches(shuffle=True, prefetch=prefetch, workers=workers):
            self._window_buf.append(batch)
            if len(self._window_buf) == self.accum_steps:
                window, self._window_buf = self._window_buf, []
                for b, d in zip(window, self._sparse_plan.plan_window(window)):
                    yield b, arrays_to_device(d, self.device)

    # ------------------------------------------------------------------- eval

    #: lookup models above this many entities evaluate against a cache (the
    #: encoded table slice), which takes the chunked ranking above
    #: ``CHUNKED_ABOVE`` candidates
    LOOKUP_CACHE_ABOVE = 200_000

    def _candidate_cache(self) -> Optional[torch.Tensor]:
        """The [N, d] candidate cache of a full-vocabulary eval
        (``KGEModel.candidate_cache``) for token models and for lookup models
        above ``LOOKUP_CACHE_ABOVE`` entities.  None for batch-shared eval,
        which encodes its candidates per batch, and for smaller lookup
        models, whose eval step encodes the slice itself and ranks the dense
        [B, N] scores."""
        ds = self.validation_dataset
        if ds is None or ds.use_batch_shared_entities:
            return None
        if (not isinstance(self.model.embedder, TokenEmbedderBase)
                and self.model.meta.entities_size <= self.LOOKUP_CACHE_ABOVE):
            return None
        return self.model.candidate_cache(self.variables)

    def _eval_batches(self, builder: BatchBuilder):
        """Full-vocabulary eval batches are deterministic: built once, padded
        to one shape and reused by every eval; batch-shared eval draws new
        negatives every pass."""
        if builder is not self.val_builder or builder.ds.use_batch_shared_entities:
            return builder.batches(shuffle=False, prefetch=2)
        if self._eval_batches_cache is None:
            self._eval_batches_cache = pad_batches_to_common_shape(list(builder.batches(shuffle=False)))
        return self._eval_batches_cache

    #: the host-side sums: the packed device stats but the metric normalizer,
    #: then the loss normalizer
    _EVAL_SUM_KEYS = ("count", "mrr", "mr", "h50", "h10", "h3", "h1", "loss_sum")

    def evaluate(self, builder: Optional[BatchBuilder] = None) -> MetricResult:
        """Filtered ranking over the validation split (or ``builder``'s) ->
        the mean loss per cell and the rank metrics over every gold."""
        builder = builder or self.val_builder
        if builder is None:
            raise ValueError("no validation dataset")
        t0 = time.perf_counter()
        cand_emb = self._candidate_cache()
        if cand_emb is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # host clock of the cache encode alone
        t1 = time.perf_counter()
        log_preds = bool(self.args.get("log_predictions"))
        if log_preds and self._eval_step_topk is None:
            self._eval_step_topk = make_eval_step(self.model, self.loss_type, self.label_smoothing,
                                                  topk=int(self.args.get("log_predictions_topk") or 10))
        step_fn = self._eval_step_topk if log_preds else self.eval_step
        pred_file = None
        if log_preds:
            suffix = f".p{self.rank}" if self.world > 1 else ""
            pred_file = open(os.path.join(self.save_path, f"predictions_step{self.training_steps}{suffix}.tsv"), "w")
            pred_file.write("direction\tent_id\trel_id\ttop_entity_ids\ttop_scores\n")
        sums = np.zeros(len(self._EVAL_SUM_KEYS) + 1, dtype=np.float64)
        n_batches = 0
        pending = []  # (device stats, normalizer_loss, prediction payload or None)

        def drain():
            for packed, normalizer_loss, preds in pending:
                stats = unpack_eval_stats(packed)
                for j, k in enumerate(self._EVAL_SUM_KEYS):
                    sums[j] += stats[k]
                sums[-1] += normalizer_loss
                if preds is not None:
                    self._write_predictions(pred_file, *preds)
            pending.clear()

        for batch in self._eval_batches(builder):
            arrays = arrays_to_device(eval_batch_to_arrays(batch), self.device)
            n_batches += 1
            out = step_fn(self.variables, arrays, cand_emb)
            packed, preds = (out[0], (batch, out[1], out[2])) if log_preds else (out, None)
            pending.append((packed, batch.normalizer_loss, preds))
            if len(pending) >= 512:  # a bounded number of live device results
                drain()
        drain()
        if pred_file is not None:
            pred_file.close()
            logger.info("wrote predictions to %s", pred_file.name)
        sums = dist.all_processes_sum(sums)  # host-sharded eval: every rank's slice
        totals = dict(zip(self._EVAL_SUM_KEYS, sums))
        result = MetricResult()
        cnt = totals["count"]
        if cnt > 0:
            for m in ("mrr", "mr", "h1", "h3", "h10", "h50"):
                result[m].update(totals[m] / cnt, cnt)
        if sums[-1] > 0:
            result["loss"].update(totals["loss_sum"] / sums[-1], sums[-1])
        t2 = time.perf_counter()
        self.last_eval = {"cache_s": t1 - t0, "batches_s": t2 - t1, "batches": n_batches}
        logger.info("EVALUATING - EPOCH [%3d]  time: %7.3f  local batches: %d  METRICS  %s",
                    self.epoch, t2 - t0, n_batches, result.averages)
        return result

    def _write_predictions(self, f, batch: Batch, top_scores, top_cols) -> None:
        """One TSV row per real prefix: the filtered top-k entity ids and
        their scores."""
        top_scores = top_scores.cpu().numpy()
        top_cols = top_cols.cpu().numpy()
        if batch.candidate_ids is not None:
            ent_of_col = np.asarray(batch.candidate_ids)
            top_ents = ent_of_col[np.clip(top_cols, 0, len(ent_of_col) - 1)]
        else:
            top_ents = top_cols + batch.cand_offset
        for i in range(batch.num_rows):
            direction = "sp" if batch.is_sp[i] else "po"
            ids = " ".join(str(e) for e in top_ents[i])
            scs = " ".join(f"{s:.4f}" for s in top_scores[i])
            f.write(f"{direction}\t{batch.ent_ids[i]}\t{batch.rel_ids[i]}\t{ids}\t{scs}\n")

    # ------------------------------------------------------- model selection

    def _check_early_stopping(self, validation_results: MetricResult, results_row: Dict):
        """Model selection and patience after one eval -> ``(improved,
        the improved selection metrics)``; sets ``terminate``."""
        args = self.args
        one_improved = False
        metric_improved = {}
        best_tags: List[str] = []
        for name, meter in validation_results.items():
            metric_improved[name] = False
            if meter.avg_better_than(self.best_validation_results[name]):
                if name in args["model_select_metric"]:
                    best_tags.append(name)
                    one_improved = True
                self.best_validation_results[name] = meter
                metric_improved[name] = True
            results_row[f"validation_{name}"] = meter.avg

        select = args["model_select_metric"][0]
        if self.last_validation_metric is None:
            self.last_validation_metric = validation_results[select]
        elif validation_results[select].avg > 0:
            self.moving_average_metric_change = running_mean(
                math.fabs((self.last_validation_metric.avg - validation_results[select].avg)
                          / validation_results[select].avg),
                self.moving_average_metric_change,
            )

        exceeds_max = bool(args.get("patience_metric_max_treshold")) and validation_results[
            select].avg_better_than_float(args["patience_metric_max_treshold"])
        below_min = bool(args.get("patience_metric_min_treshold")) and not validation_results[
            select].avg_better_than_float(args["patience_metric_min_treshold"])
        minimal_change = (bool(args.get("patience_metric_change")) and self.moving_average_metric_change is not None
                          and self.moving_average_metric_change < args["patience_metric_change"])
        if exceeds_max or below_min or minimal_change or not metric_improved[select]:
            reasons = [r for r, f in [("metric_exceeds_critical_treshold", exceeds_max),
                                      ("metric_not_achieving_critical_treshold", below_min),
                                      ("metric_has_minimal_change", minimal_change),
                                      ("metric has not improved", not metric_improved[select])] if f]
            logger.info("Loosing patience with %s in epoch %d because %s", select, self.epoch, " and ".join(reasons))
            if self.epoch >= self.terminate_epochs:
                self.terminate = True
        else:
            self.terminate_epochs = self.epoch + args["patience_epochs"]
        self.regimes.lr_scheduler_step(validation_results[select].avg,
                                       greater_is_better=validation_results[select].greater_is_better,
                                       epoch=self.epoch)
        return one_improved, best_tags

    # -------------------------------------------------------------- run loop

    def run(self):
        """Train until the epochs are exhausted or early stopping fires;
        leave a checkpoint."""
        epochs = self.args.get("epochs", 100)
        eval_epoch_freq = self.args.get("eval_epoch_freq") or 0
        save_epoch_freq = self.args.get("save_epoch_freq") or 0

        def val_hook(last_step_of_epoch: bool):
            if self.val_builder is None:
                return
            validation_results = self.evaluate()
            row = {"epoch": self.epoch, "training_steps": self.training_steps}
            improved, tags = self._check_early_stopping(validation_results, row)
            # every rank computed the same sums; rank 0's decision binds all,
            # so none waits alone in a collective
            self.terminate = dist.broadcast_flag(self.terminate)
            if last_step_of_epoch and save_epoch_freq and self.epoch % save_epoch_freq == 0:
                self.save(save_all=True, is_best=improved, tags=tags if improved else None)
            self.results.add(**row)
            self.save_results()

        while self.epoch < epochs and not self.terminate:
            result = self.last_epoch = self.train_epoch(val_hook=val_hook)
            self.results.add(epoch=self.epoch, training_steps=self.training_steps,
                             training_loss=result["loss"])
            if self.val_builder is not None and eval_epoch_freq and self.epoch % eval_epoch_freq == 0:
                val_hook(last_step_of_epoch=True)
            self.save_results()
        if self._profiler is not None:  # the run ended inside the traced steps
            self._stop_profile()
        if self.training_steps > 0:
            self.save()

    def save_results(self) -> None:
        """Write results.csv: rank 0's, since the ranks share a directory."""
        if self.rank == 0:
            self.results.save()

    def save(self, is_best: bool = False, tags=None, save_all: bool = False) -> str:
        """Write the next ``checkpoint{i}`` (and its best-model and
        per-epoch copies); returns its path.  Several ranks write one
        per-shard checkpoint together, rank 0 makes the copies."""
        meta = {
            "epoch": self.epoch,
            "training_steps": self.training_steps,
            "config": _jsonable(self.args),
            "optimizer_host_state": self.regimes.host_state(),
            "results": self.results.to_dicts(),
        }
        name = f"checkpoint{self._ckpt_counter}"
        self._ckpt_counter = (self._ckpt_counter + 1) % self.keep_checkpoints
        def copies(path):
            copy_checkpoint(self.save_path, path, name, meta["epoch"], is_best=is_best, tags=tags,
                            save_all=save_all)

        if self.world > 1:
            path = save_checkpoint_sharded(self.save_path, name, self.variables, meta, self.opt_state, self.rank,
                                           self.world, dist.barrier, on_written=copies)
        else:
            path = save_checkpoint(self.save_path, name, self.variables, meta, self.opt_state)
            copies(path)
        self.last_checkpoint = path
        return path

    def load(self, path: str, reset_optimizer: bool = False, resume_filter=None, freeze_param=None,
             weight_map=None, dont_load_optimizer: bool = False):
        """Resume from a checkpoint of either package, as the JAX package's
        ``Trainer.load``: the optimizer's host state first (unless
        ``reset_optimizer``; a restored phase may take another optimizer
        type, and so another state), then the variables through
        ``resume_filter`` and ``weight_map`` (``load_checkpoint``), the
        optimizer state (unless ``reset_optimizer`` or
        ``dont_load_optimizer``), the step count and results; then
        ``freeze_param`` patterns join the frozen ones: newly frozen leaves
        get the empty state, the others keep what was loaded."""
        host = load_checkpoint_meta(path).get("optimizer_host_state")
        if host:
            old_names = self.regimes.opt_names()
            self.regimes.load_host_state(host, reset=reset_optimizer)
            if self.regimes.opt_names() != old_names:
                self.opt_state = self.regimes.init_state(self.variables["params"])
                self._rebuild_steps()
        self.variables, self.opt_state, meta = load_checkpoint(
            path, self.variables, self.opt_state, resume_filter=resume_filter, weight_map=weight_map,
            load_optimizer=not (reset_optimizer or dont_load_optimizer))
        self.training_steps = int(meta.get("training_steps", 0))
        if meta.get("results"):
            self.results.rows = list(meta["results"])
            self.save_results()
        if freeze_param:
            patterns = [freeze_param] if isinstance(freeze_param, str) else list(freeze_param)
            new = [p for p in patterns if p not in self.regimes.frozen_patterns]
            if new:
                self.regimes.frozen_patterns.extend(new)
                fresh = self.regimes.init_state(self.variables["params"])
                loaded = dict(_state_nodes(self.opt_state))
                self.opt_state = _map_state_nodes(
                    lambda path, f: loaded[path] if f and set(f) == set(loaded.get(path) or ()) else f, fresh)
                self._rebuild_steps()
                logger.info("froze parameters matching %s", patterns)
        return meta


def _is_state_node(x) -> bool:
    """A leaf's optimizer state: ``{}`` or a dict of tensors."""
    return isinstance(x, dict) and not any(isinstance(v, dict) for v in x.values())


def _state_nodes(tree, prefix=""):
    """(path, state node) of every leaf of an optimizer state tree."""
    for key, node in tree.items():
        if _is_state_node(node):
            yield prefix + key, node
        else:
            yield from _state_nodes(node, prefix + key + "/")


def _map_state_nodes(fn, tree, prefix=""):
    return {key: fn(prefix + key, node) if _is_state_node(node) else _map_state_nodes(fn, node, prefix + key + "/")
            for key, node in tree.items()}


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
