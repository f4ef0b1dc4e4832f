"""The train step (encode, fused score + BCE or scores + KL, backward,
optimizer update), its gradient-accumulation form and the eval step
(encode, loss, filtered ranks).

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/step.py``:
:func:`prefix_loss`, :func:`train_batch_to_arrays`, the dense step
:func:`make_train_step`, which differentiates with respect to every
parameter and is the reference the sparse step (train/sparse.py) is held
against, :func:`make_scanned_step` (K steps a call, on the card one CUDA
graph), :func:`make_accum_steps` and :func:`make_eval_step`.  PyTorch runs
eagerly, so a step is a plain function; the parameters and optimizer state
are updated in place.
"""

from __future__ import annotations

import time
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
from open_knowledge_graph_embeddings_tpu_torch.utils.tracing import span


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


def loss_and_grads(model: KGEModel, inputs, batch, loss_type: str, label_smoothing: float,
                   generator: Optional[torch.Generator], slabs=()):
    """The forward (``train.forward``) and backward (``train.backward``) of
    a train batch -> ``(grads, loss_sum, norm_metric, new_state)``.
    ``inputs()`` gives ``(variables, trees)``: the variables of the forward,
    whose params hold the autograd leaves of ``trees`` (a list of leaf
    trees); ``grads`` has one gradient tree per tree, summed over the ranks
    on a mesh with ``slabs`` as :func:`reduce_over_ranks` takes them."""
    with span("train.forward"):
        variables, trees = inputs()
        loss_sum, norm_metric, new_state, reg = prefix_loss(model, variables, batch, loss_type, label_smoothing,
                                                             generator)
    with span("train.backward"):
        ((loss_sum + reg) / batch["normalizer_loss"]).backward()
        grads = [grad_tree(t) for t in trees]
        loss_sum, norm_metric = reduce_over_ranks(model, grads, loss_sum, norm_metric, slabs)
    return grads, loss_sum.detach(), norm_metric, new_state


def optimizer_update(update):
    """``update``, an optimizer update of any arguments, run under the
    ``train.optimizer`` span."""

    def run(*args):
        with span("train.optimizer"):
            return update(*args)

    return run


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
    scalars as 0-d f32 tensors (the ``batch.copy`` span)."""

    def put(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a) if a.ndim else a.copy())  # ascontiguousarray makes 0-d 1-d
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device, non_blocking=True)

    with span("batch.copy"):
        return {k: put(v) for k, v in arrays.items()}


def make_train_step(model: KGEModel, regimes: OptimizerRegimes, params_example, loss_type: str = "bce",
                    label_smoothing: float = 0.0, grad_clip: Optional[float] = None):
    """``step(variables, opt_state, hparams, batch, generator) -> (variables,
    opt_state, stats)`` with dense gradients of every parameter."""
    apply_updates = optimizer_update(regimes.make_apply(params_example, grad_clip,
                                                        **sharded_norm(model, params_example)))

    def step(variables, opt_state, hparams, batch, generator=None):
        (grads,), loss_sum, norm_metric, new_state = loss_and_grads(
            model, lambda: leaf_inputs(variables), batch, loss_type, label_smoothing, generator,
            variables.get("slabs", ()))
        new_params, new_opt = apply_updates(grads, opt_state, variables["params"], hparams)
        new_variables = {**variables, "params": new_params, "state": new_state}
        return new_variables, new_opt, {"loss_sum": loss_sum, "normalizer_metric": norm_metric}

    return step


#: byte alignment of each leaf in a packed window (the card's allocation
#: alignment: every view is aligned as a tensor of its own would be)
WINDOW_ALIGN = 256


class PackedWindow:
    """K host array dicts of one signature stacked leaf by leaf into one
    byte buffer (pinned when ``pin``), so that a window reaches the card in
    one copy.  ``layout`` is ``((name, shape, numpy dtype, offset), ...)``
    with the leading [K] axis in each shape; int32 arrays are stored as
    int64, as :func:`arrays_to_device` gives them to a single step."""

    def __init__(self, arrays: Sequence[Dict[str, Any]], pin: bool = False):
        first = {n: np.asarray(a) for n, a in arrays[0].items()}
        layout, off = [], 0
        for name in sorted(first):
            dt = np.dtype(np.int64) if first[name].dtype == np.int32 else first[name].dtype
            shape = (len(arrays), *first[name].shape)
            layout.append((name, shape, dt, off))
            off += -(-int(np.prod(shape)) * dt.itemsize // WINDOW_ALIGN) * WINDOW_ALIGN
        self.layout = tuple(layout)
        self.host = torch.empty(off, dtype=torch.uint8, pin_memory=pin)
        flat = self.host.numpy()
        for name, shape, dt, o in self.layout:
            out = flat[o : o + int(np.prod(shape)) * dt.itemsize].view(dt).reshape(shape)
            np.stack([np.asarray(a[name]) for a in arrays], out=out)

    @property
    def signature(self):
        """What a graph is keyed by: the names, shapes and dtypes."""
        return tuple((name, shape, str(dt)) for name, shape, dt, _ in self.layout)


def window_views(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """The [K, ...] leaves of a packed window as views of the byte buffer
    ``buf`` (its host buffer, or a copy of it on the card)."""
    out = {}
    for name, shape, dt, off in layout:
        n = int(np.prod(shape)) * dt.itemsize
        out[name] = buf[off : off + n].view(torch.from_numpy(np.empty(0, dt)).dtype).view(shape)
    return out


def write_back(dst, src) -> None:
    """Copy every tensor of the tree ``src`` that is not already the tensor
    at the same place in ``dst`` into it, so that ``dst``'s tensors hold
    ``src``'s values (a step's new optimizer steps and batchnorm state land
    in the persistent tensors; leaves updated in place are skipped)."""
    for k, s in src.items():
        if k not in dst:
            raise KeyError(f"the step returned a leaf {k!r} its input did not have")
        if isinstance(s, dict):
            write_back(dst[k], s)
        elif isinstance(s, torch.Tensor) and s is not dst[k]:
            dst[k].copy_(s)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _stack_stats(stats: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {n: torch.stack([s[n] for s in stats]) for n in stats[0]}


class _Window:
    """A signature's static input buffer on the card, its views, and once
    captured its graph and the graph's stacked stats."""

    def __init__(self, layout, nbytes: int, device):
        self.layout = layout
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.views = window_views(self.buf, layout)
        self.graph = None
        self.stats = None

    def load(self, window: "PackedWindow") -> None:
        with span("graph.load"):
            self.buf.copy_(window.host, non_blocking=True)


class ScannedStep:
    """K train steps per call (see :func:`make_scanned_step`).  Counters:
    ``windows`` (every call), ``eager_windows`` (on the card a signature's
    first window, run step by step), ``captures``, ``replays`` (a capture's
    first replay included), ``resets`` (a changed hyperparameter or state
    address dropped every graph, to be built again); ``capture_s`` and
    ``instantiate_s`` sum the host seconds of the captures; spans
    ``graph.load``, ``graph.eager``, ``graph.capture``, ``graph.replay``;
    ``last_kind`` is how the last call ran:
    ``"loop"`` (the CPU: the steps a graph captures, run one after
    another), ``"eager"``, ``"capture"`` (captured, then
    replayed) or ``"replay"``."""

    def __init__(self, step, scan_steps: int):
        if scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
        self.step, self.k = step, int(scan_steps)
        self._windows: Dict[Any, _Window] = {}
        self._state_key = None
        self._pool = None
        self.windows = self.eager_windows = self.captures = self.replays = self.resets = 0
        self.capture_s = self.instantiate_s = 0.0
        self.last_kind: Optional[str] = None

    def reset(self) -> None:
        """Drop every graph (their memory returns with the pool)."""
        self._windows.clear()
        self._state_key = None
        self._pool = None

    def single(self, variables, opt_state, hparams, batch, generator=None):
        """One step whose results are written back into ``variables`` and
        ``opt_state`` (the tensors a graph reads stay the trainer's)."""
        new_v, new_o, stats = self.step(variables, opt_state, hparams, batch, generator)
        write_back(variables, new_v)
        write_back(opt_state, new_o)
        return variables, opt_state, stats

    def _steps(self, views, variables, opt_state, hparams, generator):
        stats = [self.single(variables, opt_state, hparams, {n: v[i] for n, v in views.items()}, generator)[2]
                 for i in range(self.k)]
        return _stack_stats(stats)

    def __call__(self, variables, opt_state, hparams, batches, generator=None):
        lead = {shape[0] for _, shape, *_ in batches.layout} if isinstance(batches, PackedWindow) else {
            len(v) for v in batches.values()}
        if lead != {self.k}:
            raise ValueError(f"a window of {self.k} steps got leaves of leading sizes {sorted(lead)}")
        self.windows += 1
        device = next(_tensors(variables["params"])).device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"no scanned step for device {device}")
        if not isinstance(batches, PackedWindow):
            batches = PackedWindow([{n: v[i].cpu().numpy() if isinstance(v, torch.Tensor) else v[i]
                                     for n, v in batches.items()} for i in range(self.k)])
        if device.type == "cpu":  # the plain version: the steps the graph captures, one after another
            self.last_kind = "loop"
            views = window_views(batches.host, batches.layout)
            return variables, opt_state, self._steps(views, variables, opt_state, hparams, generator)
        # a graph bakes in the hyperparameters (the Adagrad launches take
        # them as float arguments) and the addresses of the state it reads
        # and writes: when either changes, every graph goes
        state_key = (tuple(tuple(sorted(hp.items())) for hp in hparams),
                     tuple(t.data_ptr() for t in _tensors({"v": variables, "o": opt_state})))
        if state_key != self._state_key:
            if self._state_key is not None:  # the graphs read other hparams or tensors
                self.resets += 1
            self.reset()
            self._state_key = state_key
        sig, layout, nbytes = batches.signature, batches.layout, batches.host.numel()
        w = self._windows.get(sig)
        if w is None:  # the warm-up: builds, workspaces and tensor maps happen here
            w = self._windows[sig] = _Window(layout, nbytes, device)
            w.load(batches)
            self.eager_windows += 1
            self.last_kind = "eager"
            with span("graph.eager"):
                return variables, opt_state, self._steps(w.views, variables, opt_state, hparams, generator)
        w.load(batches)
        self.last_kind = "replay"
        if w.graph is None:
            self._capture(w, variables, opt_state, hparams, generator)
            self.last_kind = "capture"
        with span("graph.replay"):
            w.graph.replay()
        self.replays += 1
        # the graph's stats are overwritten by its next replay
        return variables, opt_state, {n: t.clone() for n, t in w.stats.items()}

    def _capture(self, w: _Window, variables, opt_state, hparams, generator) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:  # replays draw dropout masks as the eager steps would
            graph.register_generator_state(generator)
        with span("graph.capture"):
            t0 = time.perf_counter()
            # thread_local: the prefetch threads go on allocating and copying
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                w.stats = self._steps(w.views, variables, opt_state, hparams, generator)
            t1 = time.perf_counter()
            graph.instantiate()
            self.instantiate_s += time.perf_counter() - t1
            self.capture_s += t1 - t0
        self.captures += 1
        self._pool = graph.pool()
        w.graph = graph


def make_scanned_step(step, scan_steps: int) -> ScannedStep:
    """``scanned(variables, opt_state, hparams, batches, generator) ->
    (variables, opt_state, stats)``: ``scan_steps`` (K) consecutive steps
    of ``step`` (any step with the ``(variables, opt_state, hparams, batch,
    generator)`` contract: :func:`make_train_step`, the sparse step) in one
    call, the counterpart of the JAX package's ``lax.scan`` window.
    ``batches`` is a :class:`PackedWindow` or a dict whose every leaf has a
    leading [K] axis; ``stats`` come back stacked [K] per leaf.

    On the card the K steps are captured, unrolled, into one CUDA graph per
    batch signature, replayed once per window: a signature's first window
    runs its steps eagerly (the warm-up: kernel builds, cuBLAS workspaces,
    tensor maps), its second is captured (capture runs nothing) and
    replayed.  The graph reads and writes the caller's own tensors: every
    leaf a step returns as a new tensor is copied back into the given one
    inside the capture, so after a call ``variables`` and ``opt_state``
    (the same objects) hold the window's result.  The batch lands in the
    window's static buffer in one host-to-device copy.  The generator is
    registered with each graph, so a window draws its dropout masks as its
    K eager steps would.  A change of the hyperparameters or of the state's
    addresses drops every graph; all graphs share one memory pool.  A
    failed capture raises.

    On the CPU the K steps run one after another (the plain version)."""
    return ScannedStep(step, scan_steps)


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
    apply_updates = optimizer_update(regimes.make_apply(params_example, grad_clip,
                                                        **sharded_norm(model, params_example)))

    def zero_grads():
        return map_tree(torch.zeros_like, params_example)

    def grad_step(variables, acc, batch, generator=None):
        (grads,), loss_sum, norm_metric, new_state = loss_and_grads(
            model, lambda: leaf_inputs(variables), batch, loss_type, label_smoothing, generator,
            variables.get("slabs", ()))
        add_tree(acc, grads)
        new_variables = {**variables, "state": new_state}
        return new_variables, acc, {"loss_sum": loss_sum, "normalizer_metric": norm_metric}

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


def leaf_inputs(variables):
    """:func:`loss_and_grads`' inputs of a dense step: ``variables`` with
    every parameter an autograd leaf, and the one tree of those leaves."""
    leaves = leaf_tree(variables["params"])
    return {**variables, "params": leaves}, [leaves]


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
