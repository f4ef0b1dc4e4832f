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
  activity, and every thread where the installed torch can record them
  all) of that many steps from training step 1 on, written as a Chrome
  trace to ``<save_path>/profile/trace.json``.

Where the host time goes (``utils/tracing.py``): the loop, the prefetch
threads and the window path run in spans, ranges of any torch profiler's
trace while one records.  Training thread: ``train.wait_batch`` (the next
entry), ``train.step`` (a single step or accumulation micro-batch) or
``train.window`` (a window), ``train.log`` (the per-step stats, ``step_log``
and the cadences), ``train.drain`` (the host reads the loss sums: a sync);
inside a step ``train.forward``, ``train.backward``, ``train.optimizer``
(on the row-sparse path ``optim.dense`` and ``optim.rows``); the window
path ``graph.load``, ``graph.eager``, ``graph.capture``, ``graph.replay``.
Prefetch and producer threads: ``batch.build``, ``batch.plan``,
``batch.copy``, ``batch.pack``.  Their records for operators: the
``profile_steps`` trace, ``step_log``'s ``wait_ms``, ``step_ms``, ``plan_ms``
and ``flushed``, ``flush_counts``, and the TRAINING line at each print,
which adds since the last print the host ms a step waiting, launching and
planning, the steps replayed from a graph, and the flushed steps by reason.

Gradient accumulation (``batch_size_for_backward`` = k x ``batch_size``):
each micro-batch adds its gradients to an accumulator and every k-th runs
one optimizer update from the sum; on the row-sparse path k batches form a
window planned over one union row space.  The accumulator (and on the
sparse path the batches of an unfinished window) carries across epoch
boundaries, and ``training_steps`` counts micro-batches, as in the JAX
package.

Multi-step dispatch (``train_scan_steps`` = K > 1, as in the JAX package):
a producer thread groups the host-built batches into windows of K of one
array signature (a batch of another signature, and the epoch's tail, flush
as single steps), stacked into one pinned buffer; each window is one call of
``train/step.py::make_scanned_step``, on the card one replay of a CUDA graph
of the K steps that reads and writes the trainer's own tensors (single
steps write back into them too).  Print, save and eval fire when a window
crosses their cadence, at its last step; ``step_log`` gets a row per step.
Scan mode is off under gradient accumulation, on a mesh and with
step-keyed optimizer phases, as in the JAX package.  Loading a checkpoint
or a new optimizer drops every graph.

Checkpoints go through ``train/checkpoint.py::CheckpointManager``: the
host fetch on the training thread, the files, rotation and copies on a
background thread (one in flight; the in-loop ``save_freq`` saves return
before their files are written, the others wait), and ``load`` and the
run's end wait for the write.

Several processes (``parallel/``, a world set up by ``cli.train``): the
ranks form a [data, model] mesh with ``model_parallel`` ranks a model
group.  Every rank builds each global batch and its plans identically and
scores its block of the rows; on a model axis (``model_parallel > 1``) the
entity tables and their optimizer state live as slabs, each rank holding
its rows (``parallel/sharding.py``), and each rank encodes and scores its
block of the candidates.  The gradients of replicated leaves are summed
over the world and a slab's over its data group, so the replicas stay
equal (``train/step.py``).  Each data group evaluates a strided slice of
the eval set (``BatchBuilder(host_shard=...)``), a model group together
over its slabs of the candidates, and the metric sums are added over the
data group; rank 0 writes ``results.csv`` and decides early stopping for
every rank, and every rank writes its part of a per-shard checkpoint
(``CheckpointManager.save_sharded``, its files written in the
background, finalized by rank 0).
"""

from __future__ import annotations

import logging
import math
import os
import time
from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.batching import Batch, BatchBuilder, pad_batches_to_common_shape
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import TokenEmbedderBase
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, default_mesh
from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import shard_variables
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_checkpoint_meta,
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
    PackedWindow,
    arrays_to_device,
    eval_batch_to_arrays,
    make_accum_steps,
    make_eval_step,
    make_scanned_step,
    make_train_step,
    train_batch_to_arrays,
    unpack_eval_stats,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import ResultsLog
from open_knowledge_graph_embeddings_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


def running_mean(new, old=None, momentum=0.9):
    return new if old is None else momentum * old + (1 - momentum) * new


class Entry(NamedTuple):
    """One entry of the training loop: a single step (``kind`` "s") or a
    window of multi-step dispatch ("w"), its batches, their device arrays
    (a :class:`PackedWindow` for a window), each batch's host plan ms, and
    for a single step that left its window (scan mode), why:
    ``"tail"`` or ``"signature:<leaf>"``."""

    kind: str
    batches: List[Batch]
    arrays: Any
    plan_ms: List[float]
    flushed: Optional[str] = None


def _first_difference(a, b) -> str:
    """The first leaf, by name, whose shape or dtype differs between two
    array signatures, or that only one of them has."""
    da, db = {n: rest for n, *rest in a}, {n: rest for n, *rest in b}
    return next(n for n in sorted(da.keys() | db.keys()) if da.get(n) != db.get(n))


def _host_summary(rows) -> str:
    """The operator's summary of ``step_log`` rows: host ms a step waiting,
    launching and planning, the steps replayed from a CUDA graph, and the
    steps flushed out of a window by reason."""
    n = max(len(rows), 1)
    flushed = Counter(r["flushed"] for r in rows if r["flushed"] is not None)
    return ("host ms/step: wait %.3f step %.3f plan %.3f  replayed: %d/%d  flushed: %s" % (
        sum(r["wait_ms"] for r in rows) / n, sum(r["step_ms"] for r in rows) / n,
        sum(r["plan_ms"] for r in rows) / n, sum(r["window"] in ("replay", "capture") for r in rows), len(rows),
        dict(sorted(flushed.items())) or "none"))


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
        # several processes: the ranks of the world form a [data, model] mesh
        # (a world that model groups do not divide raises, and so does a
        # model axis without a world)
        model_parallel = int(args.get("model_parallel") or 1)
        self.rank, self.world = dist.process_index(), dist.process_count()
        self.mesh = default_mesh(model_parallel) if dist.is_initialized() or model_parallel > 1 else None
        model.set_mesh(self.mesh)
        self.variables = shard_variables(self.variables, self.mesh)
        if self.mesh is not None:
            logger.info("mesh %s: rank %d of %d (backend %s)%s", self.mesh.shape, self.rank, self.world,
                        dist.backend(), f", slabs {self.variables['slabs']}" if self.mesh.model > 1 else "")

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
        # multi-step dispatch: off wherever a window could not be the K
        # single steps (accumulation owns the step cadence, a mesh, a phase
        # switching at a step inside a window)
        self.scan_steps = max(1, int(args.get("train_scan_steps") or 1))
        if self.scan_steps > 1:
            step_phases = any("step" in p for phases in self.regimes.regimes for p in phases)
            if self.accum_steps > 1 or self.mesh is not None or step_phases:
                logger.info("train_scan_steps=%d disabled (%s)", self.scan_steps,
                            "gradient accumulation" if self.accum_steps > 1
                            else "device mesh" if self.mesh is not None else "step-keyed optimizer phases")
                self.scan_steps = 1
            else:
                logger.info("multi-step dispatch: %d steps/program", self.scan_steps)
        self.opt_state = self.regimes.init_state(self.variables["params"])
        self._rebuild_steps()
        self.train_builder = BatchBuilder(train_dataset, seed=seed)

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
        # host-sharded eval: each data group ranks a strided slice of the
        # eval set, a model group together (its ranks each score their slab
        # of the candidates); the metric sums are added over the data group
        val_shard = None
        if self.mesh is not None and self.mesh.data > 1:
            val_shard = (self.mesh.index(DATA_AXIS), self.mesh.data)
            logger.info("host-sharded eval: shard %s, eval mesh %s", val_shard,
                        dist.local_eval_mesh(self.mesh).shape)
        self.val_builder = (BatchBuilder(validation_dataset, batch_size=eval_bs, host_shard=val_shard)
                            if validation_dataset is not None else None)
        self._eval_batches_cache = None

        self.save_path = save_path
        self.ckpt = CheckpointManager(save_path, keep_checkpoints)
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
        #: per step (micro-batch): host ms waiting for the next planned batch
        #: (``wait_ms``) and launching the step (``step_ms``; a window's both
        #: on its first step, 0.0 on the others), host ms of its batch's plan
        #: on a prefetch thread (``plan_ms``), the loss per real cell (a
        #: device scalar), the tables that took the row-sparse update,
        #: whether an optimizer update ran after it (every step without
        #: accumulation), for a step inside a window how the window ran
        #: (``window``: ``ScannedStep.last_kind``; None for a single step),
        #: and for a single step that left its window why (``flushed``, as
        #: :class:`Entry`; else None)
        self.step_log: List[Dict[str, Any]] = []
        #: single steps of scan mode that left their window, by reason
        #: (``Entry.flushed``), as the loop runs them
        self.flush_counts: Counter = Counter()
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
        # a new step (a new optimizer, a load) drops the graphs of the old one
        self.train_step_scan = make_scanned_step(self.train_step, self.scan_steps) if self.scan_steps > 1 else None
        self.eval_step = make_eval_step(self.model, self.loss_type, self.label_smoothing)
        self._eval_step_topk = None  # built when log_predictions is set

    @property
    def epoch(self) -> int:
        return math.floor(self.training_steps / (self.len_train_batches + 1)) + 1

    def _plan(self, batches: List[Batch]):
        """The host plans of ``batches`` -> ``(array dicts, host ms)``: of
        one batch, or on the row-sparse path of an accumulation window,
        planned over one union row space."""
        with span("batch.plan") as planned:
            if len(batches) > 1:
                arrays = self._sparse_plan.plan_window(batches)
            else:
                arrays = [self._sparse_plan(batches[0]) if self.sparse else train_batch_to_arrays(batches[0])]
        return arrays, planned.ms

    def _planned(self, batch):
        """Runs on the prefetch threads: ``(batch, host arrays, plan ms)``."""
        (arrays,), ms = self._plan([batch])
        return batch, arrays, ms

    def _to_device(self, batch):
        """Runs on the prefetch threads: the host plan, then the copy ->
        ``(batch, device arrays, plan ms)``."""
        batch, arrays, ms = self._planned(batch)
        return batch, arrays_to_device(arrays, self.device), ms

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
        printed = len(self.step_log)  # the first step_log row since the last print

        def drain():
            nonlocal loss_sum_total, norm_total, items
            with span("train.drain"):  # the host syncs on the device here
                for stats, norm_loss in pending:
                    loss_sum_total += float(stats["loss_sum"])
                    norm_total += norm_loss
                    items += float(stats["normalizer_metric"])
                pending.clear()

        step_i = -1
        it = self._iter_train_entries(workers)
        try:
            while True:
                if self.profile_steps:
                    self._profile_before_step()
                with span("train.wait_batch") as wait:
                    entry = next(it, None)
                if entry is None:
                    break
                k = len(entry.batches)
                prev_step_i, step_i = step_i, step_i + k
                with span("train.window" if entry.kind == "w" else "train.step") as stepped:
                    stats, applied = self._run_entry(entry)

                with span("train.log"):
                    if entry.kind == "w":
                        per_step = [{n: v[i] for n, v in stats.items()} for i in range(k)]
                        names = {name for name, *_ in entry.arrays.layout}
                    else:
                        per_step, names = [stats], entry.arrays
                    if entry.flushed is not None:
                        self.flush_counts[entry.flushed] += 1
                    tables = tuple(t for t in self._sparse_tables if f"sparse/{t}/uids" in names)
                    for i, (batch, st) in enumerate(zip(entry.batches, per_step)):
                        self.step_log.append({
                            "wait_ms": wait.ms if i == 0 else 0.0,
                            "step_ms": stepped.ms if i == 0 else 0.0,
                            "plan_ms": entry.plan_ms[i],
                            "loss": st["loss_sum"] / batch.normalizer_loss,  # stays on the device
                            "sparse_tables": tables,
                            "applied": applied,
                            "window": self.train_step_scan.last_kind if entry.kind == "w" else None,
                            "flushed": entry.flushed,
                        })
                        pending.append((st, batch.normalizer_loss))
                    now = time.time()
                    items_t += now - batch_start
                    batch_start = now

                    # a cadence fires when an entry's steps hold a multiple of
                    # its frequency above 0, a window at its last step (JAX's
                    # rule compares with prev_step_i = -1 at a pass's first
                    # entry, so a window there fires for step 0, which no
                    # single step does: an extra eval and save a pass whatever
                    # the frequency)
                    def crossed(freq):
                        return freq > 0 and step_i > 0 and step_i // freq != max(prev_step_i, 0) // freq

                    if crossed(print_freq) or step_i >= n_batches - 1:
                        drain()
                        logger.info(
                            "TRAINING - EPOCH [%3d][%6d/%d]  time: %7.3f  items/sec: (%.0f)  loss: %.7f  %s",
                            self.epoch, step_i, n_batches, time.time() - epoch_start, items / items_t,
                            loss_sum_total / max(norm_total, 1e-30), _host_summary(self.step_log[printed:]),
                        )
                        printed = len(self.step_log)
                    if crossed(save_freq):
                        self.save(wait=False)
                    if val_hook is not None and crossed(eval_freq):
                        drain()
                        val_hook(last_step_of_epoch=False)
        finally:
            it.close()  # releases the window producer when the loop leaves early
        drain()
        return {"loss": loss_sum_total / max(norm_total, 1e-30), "items_per_s": items / items_t}

    def _run_entry(self, entry: Entry):
        """The step, window or accumulation micro-batch of one loop entry ->
        ``(stats, applied)``: its stats (stacked [K] for a window) and
        whether an optimizer update followed."""
        k = len(entry.batches)
        self.training_steps += k
        # a window consumes the state its first step would (epoch-keyed
        # phases switch only at an epoch's first entry)
        if self.regimes.update(self.epoch, self.training_steps - k + 1):
            # optimizer type changed: fresh state and a rebuilt step
            self.opt_state = self.regimes.init_state(self.variables["params"])
            self._rebuild_steps()
        args = (self.variables, self.opt_state, self.regimes.hparams(), entry.arrays, self.generator)
        if entry.kind == "w":
            self.variables, self.opt_state, stats = self.train_step_scan(*args)
        elif self.train_step_scan is not None:  # keeps the tensors the graphs read
            self.variables, self.opt_state, stats = self.train_step_scan.single(*args)
        elif self.accum_steps <= 1:
            self.variables, self.opt_state, stats = self.train_step(*args)
        else:
            return self._accumulate(entry.arrays)
        return stats, True

    def _profile_before_step(self) -> None:
        """Start the trace before the first entry after training step 1 and
        write it at the first entry ``profile_steps`` steps later, as the JAX
        package's trainer does (a window counts its K steps)."""
        if self._profiler is None and self.training_steps >= 1:  # a window may pass step 1
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities, **_every_thread())
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
        """``(batch, device arrays, plan ms)`` of one training pass.  The batches are
        built, planned and copied on the prefetch threads; with row-sparse
        accumulation ``accum_steps`` batches form a window planned over one
        union row space on this thread (``SparsePlanBuilder.plan_window``),
        and the batches of an unfinished window at the end of a pass wait
        in ``_window_buf`` for the next pass (a window's plan ms on its
        first batch)."""
        prefetch = max(2, workers)
        if not (self.sparse and self.accum_steps > 1):
            yield from self.train_builder.batches(shuffle=True, prefetch=prefetch, transform=self._to_device,
                                                  workers=workers)
            return
        for batch in self.train_builder.batches(shuffle=True, prefetch=prefetch, workers=workers):
            self._window_buf.append(batch)
            if len(self._window_buf) == self.accum_steps:
                window, self._window_buf = self._window_buf, []
                arrays, ms = self._plan(window)
                for i, (b, d) in enumerate(zip(window, arrays)):
                    yield b, arrays_to_device(d, self.device), ms if i == 0 else 0.0

    def _iter_train_entries(self, workers: int):
        """The training loop's :class:`Entry` objects of one pass."""
        if self.scan_steps <= 1:
            for batch, arrays, plan_ms in self._iter_train_arrays(workers):
                yield Entry("s", [batch], arrays, [plan_ms])
            return
        yield from self._window_entries(self.train_builder.batches(
            shuffle=True, prefetch=max(2, workers), transform=self._planned, workers=workers))

    def _window_entries(self, src):
        """Group host-built ``(batch, arrays, plan ms)`` triples into windows
        of ``scan_steps``, each stacked into one (pinned)
        :class:`PackedWindow`, on a thread of its own so that the training
        loop never waits on the stacking: :class:`Entry` objects.  A batch
        whose array signature differs from the window's (a table whose plan
        fell back to dense, another bucket) flushes the buffer as single
        steps (copied to the device on the thread), flushed for
        ``"signature:<leaf>"``, the first leaf that differed; the epoch's
        tail flushes for ``"tail"``.  Closing the generator releases the
        thread."""
        import queue
        import threading

        k, device = self.scan_steps, self.device
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()  # the consumer is gone

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            buf = []

            def flush(reason) -> bool:
                return all(put(Entry("s", [b], arrays_to_device(a, device), [ms], reason)) for b, a, ms, _ in buf)

            try:
                for batch, arrays, plan_ms in src:
                    if stop.is_set():
                        return
                    arrays = {n: np.asarray(a) for n, a in arrays.items()}
                    sig = tuple(sorted((n, a.shape, str(a.dtype)) for n, a in arrays.items()))
                    if buf and sig != buf[0][3]:
                        if not flush("signature:" + _first_difference(buf[0][3], sig)):
                            return
                        buf = []
                    buf.append((batch, arrays, plan_ms, sig))
                    if len(buf) == k:
                        with span("batch.pack"):
                            window = PackedWindow([a for _, a, _, _ in buf], pin=device.type == "cuda")
                        if not put(Entry("w", [b for b, *_ in buf], window, [ms for _, _, ms, _ in buf])):
                            return
                        buf = []
                flush("tail")
            except BaseException as e:  # surfaced on the consumer's thread
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():
                q.get_nowait()

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
        if log_preds and (self.mesh is None or self.mesh.index(MODEL_AXIS) == 0):  # a model group's are one
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
                if preds is not None and pred_file is not None:
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
        # host-sharded eval: every data group's slice (a model group's ranks
        # hold the same sums)
        sums = dist.all_processes_sum(sums, None if self.mesh is None else self.mesh.group(DATA_AXIS))
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
        self.ckpt.wait_finalized()

    def save_results(self) -> None:
        """Write results.csv: rank 0's, since the ranks share a directory."""
        if self.rank == 0:
            self.results.save()

    def save(self, is_best: bool = False, tags=None, save_all: bool = False, wait: bool = True) -> str:
        """Write the next ``checkpoint{i}`` (and its best-model and
        per-epoch copies) through the manager; returns its path.  The host
        fetch happens here; ``wait=False`` returns before the files are
        written.  Several ranks write one per-shard checkpoint together
        (never waited for here: the run's end does), rank 0 makes the
        copies."""
        meta = {
            "epoch": self.epoch,
            "training_steps": self.training_steps,
            "config": _jsonable(self.args),
            "optimizer_host_state": self.regimes.host_state(),
            "results": self.results.to_dicts(),
        }
        if self.world > 1:
            path = self.ckpt.save_sharded(self.variables, self.opt_state, meta, self.rank, self.world, dist.barrier,
                                          writes_slabs=self.mesh.index(DATA_AXIS) == 0, is_best=is_best, tags=tags,
                                          save_all=save_all)
        else:
            path = self.ckpt.save(self.variables, self.opt_state, meta, is_best=is_best, tags=tags, save_all=save_all)
            if wait:
                self.ckpt.wait()
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
        get the empty state, the others keep what was loaded.  A write in
        flight is waited for first; the graphs of the window step go."""
        self.ckpt.wait_finalized()  # a write in flight may be this path
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
        if self.train_step_scan is not None:  # the graphs read the old tensors
            self.train_step_scan.reset()
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


def _every_thread() -> Dict[str, Any]:
    """The profiler's keyword that records every thread (the batch.* spans
    of the prefetch threads), where the installed torch has it."""
    try:
        return {"experimental_config": torch._C._profiler._ExperimentalConfig(profile_all_threads=True)}
    except TypeError:
        return {}


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
