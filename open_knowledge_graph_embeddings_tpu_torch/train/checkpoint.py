"""Checkpoints of both packages: the single-file format and the per-shard
format of multi-process runs, each read and written.

Single file: one directory per checkpoint; ``arrays.npz`` holds params,
batch-norm state and optimizer state flattened to slash-joined keys
(``params/entity_lstm/w_ih``, ``state/entity_bn/mean``,
``opt/entity_lstm/w_ih/sum``, ``opt/entity_lstm/w_ih/step``) and
``meta.json`` holds counters, the config and the optimizer's host state.
Buffers (token-id matrices) are not saved: they are rebuilt from the
dataset.

Per shard (the JAX package's multi-process format,
``open_knowledge_graph_embeddings_tpu/train/checkpoint.py``): each rank
writes ``arrays.p{rank}.npz`` with the chunks of the shards it owns and
``index.p{rank}.json`` mapping each flat key to its shape, dtype and chunks
(``{"entry", "start", "stop"}``), and rank 0 writes ``meta.json`` last.
:class:`_ShardReader` merges every rank's index and reads a leaf whole, or
a region of its rows.  :func:`save_checkpoint_sharded` writes it for the
port's several processes by JAX's replica-0 rule: a leaf whole on every
rank is written by rank 0; on a model axis each row-sharded table and its
accumulators (``parallel/sharding.py::slab_regions``) are written as row
chunks by the ranks of data index 0, each its slab's rows.  Loading into a
model axis reads each slab's rows from either format (``regions``).

:class:`CheckpointManager` (the JAX package's) rotates ``checkpoint{i}``,
makes the best-model and per-epoch copies and writes in the background:
the arrays are fetched to the host when a save is called, the files are
written on a thread, one write in flight.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def flatten_arrays(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Nested dict of tensors -> {"prefix/a/b": numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(leaf, dict):
            out.update(flatten_arrays(leaf, path))
        else:
            out[path] = leaf.detach().to("cpu", copy=True).numpy()  # a snapshot, never a view of a live leaf
    return out


def unflatten_arrays(arrays: Dict[str, np.ndarray], top: str) -> Dict[str, Any]:
    """The ``top/...`` entries of flattened arrays -> a nested dict of CPU
    tensors (the inverse of :func:`flatten_arrays`)."""
    out: Dict[str, Any] = {}
    for key, value in arrays.items():
        head, _, rest = key.partition("/")
        if head != top or not rest:
            continue
        node = out
        *path, leaf = rest.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(value, copy=True))
    return out


def variables_from_jax_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    """The JAX package's flattened ``params/...`` and ``state/...`` arrays
    (a checkpoint's ``arrays.npz``, or ``flatten_arrays`` of its variables)
    -> ``{"params": ..., "state": ...}`` nested dicts of CPU tensors with the
    same names and shapes.  Every weight that crosses between the packages
    passes through here; ``opt/...`` keys are ignored."""
    return {"params": unflatten_arrays(arrays, "params"), "state": unflatten_arrays(arrays, "state")}


def checkpoint_arrays(variables: Dict[str, Any], opt_state: Optional[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Everything a checkpoint stores, flattened: params, state, and the
    optimizer state under ``opt/``."""
    return {**flatten_arrays(variables.get("params", {}), "params"),
            **flatten_arrays(variables.get("state", {}), "state"), **flatten_arrays(opt_state or {}, "opt")}


def _write_checkpoint_files(directory: str, name: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> str:
    """Write ``<directory>/<name>`` (``arrays.npz``, ``meta.json``) through a
    temporary directory moved into place."""
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, default=str)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    logger.info("saved checkpoint %s", path)
    return path


def save_checkpoint(
    directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any],
    opt_state: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``variables``' params and state, and ``opt_state`` under
    ``opt/``, as ``<directory>/<name>``."""
    return _write_checkpoint_files(directory, name, checkpoint_arrays(variables, opt_state), meta)


def local_checkpoint_chunks(arrays: Dict[str, np.ndarray], rank: int,
                            regions: Optional[Dict[str, Tuple[int, int, int]]] = None, writes_slabs: bool = False
                            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict[str, Any]]]:
    """This rank's slab -> ``(chunks, index)`` by the replica-0 rule: each
    leaf whole on every rank is written once, by rank 0, as one chunk
    ``key::0`` spanning it; a key of ``regions`` (this rank holds rows
    ``[lo, hi)`` of its ``n``) is written by the ranks that ``writes_slabs``
    (data index 0) as the chunk of those rows.  ``index`` maps each key to
    ``{"shape", "dtype", "chunks": [{"entry", "start", "stop"}]}``, the JAX
    package's layout."""
    regions = regions or {}
    chunks: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict[str, Any]] = {}
    for key, arr in arrays.items():
        if key in regions:
            if not writes_slabs:
                continue
            lo, hi, n = regions[key]
            shape, start, stop = [n, *arr.shape[1:]], [lo] + [0] * (arr.ndim - 1), [hi, *arr.shape[1:]]
        elif rank == 0:
            shape, start, stop = list(arr.shape), [0] * arr.ndim, list(arr.shape)
        else:
            continue
        entry = f"{key}::0"
        chunks[entry] = arr
        index[key] = {"shape": shape, "dtype": str(arr.dtype),
                      "chunks": [{"entry": entry, "start": start, "stop": stop}]}
    return chunks, index


def _shard_chunks(variables, opt_state, rank: int, writes_slabs: bool):
    """This rank's chunks and index of a per-shard save, fetched to the host."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_regions

    return local_checkpoint_chunks(checkpoint_arrays(variables, opt_state), rank,
                                   slab_regions(variables, opt_state), writes_slabs)


def _write_shard(path: str, rank: int, n_ranks: int, chunks, index, meta, on_written, timeout_s: float) -> None:
    """Each rank's part of a per-shard save after the directory barrier: its
    slab and ``done.p{rank}`` in ``<path>.tmp``; rank 0 then waits for every
    sentinel, removes them, writes ``meta.json`` last, moves the directory
    into place and calls ``on_written(path)``."""
    import time

    tmp = path + ".tmp"
    np.savez(os.path.join(tmp, f"arrays.p{rank}.npz"), **chunks)
    with open(os.path.join(tmp, f"index.p{rank}.json"), "w") as f:
        json.dump(index, f)
    open(os.path.join(tmp, f"done.p{rank}"), "w").close()
    if rank != 0:
        return
    want = [os.path.join(tmp, f"done.p{r}") for r in range(n_ranks)]
    deadline = time.time() + timeout_s
    while not all(os.path.exists(w) for w in want):
        if time.time() > deadline:
            raise RuntimeError(f"per-shard save {path}: slab sentinels missing after {timeout_s} s")
        time.sleep(0.02)
    for w in want:
        os.remove(w)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, default=str)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    logger.info("saved per-shard checkpoint %s (%d ranks)", path, n_ranks)
    if on_written is not None:
        on_written(path)


def _make_shard_dir(path: str, rank: int, barrier) -> None:
    """Rank 0 clears ``<path>`` and makes ``<path>.tmp``; then every rank
    meets at ``barrier`` (JAX's one barrier of a per-shard save)."""
    if rank == 0:
        for d in (path, path + ".tmp"):
            if os.path.exists(d):
                shutil.rmtree(d)
        os.makedirs(path + ".tmp")
    barrier()


def save_checkpoint_sharded(directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any],
                            opt_state: Dict[str, Any], rank: int, n_ranks: int, barrier, on_written=None,
                            timeout_s: float = 1800.0, writes_slabs: bool = False) -> str:
    """The collective per-shard save, synchronous: every rank calls it in
    step on one shared ``directory``.  Rank 0 makes the temporary
    directory; after a barrier each rank writes its slab (``arrays.p{rank}.npz``,
    ``index.p{rank}.json``) and a ``done.p{rank}`` sentinel; rank 0 waits for
    every sentinel, removes them, writes ``meta.json`` last, moves the
    directory into place and calls ``on_written(path)`` (the best-model and
    per-epoch copies); a last barrier returns every rank after that.
    Returns the checkpoint's path.  On a model axis the slabs of
    ``variables["slabs"]`` are written by the ranks that ``writes_slabs``.
    :meth:`CheckpointManager.save_sharded` is its background form."""
    path = os.path.join(directory, name)
    chunks, index = _shard_chunks(variables, opt_state, rank, writes_slabs)
    _make_shard_dir(path, rank, barrier)
    _write_shard(path, rank, n_ranks, chunks, index, meta, on_written, timeout_s)
    barrier()
    return path


def copy_checkpoint(directory: str, path: str, name: str, epoch, is_best: bool = False, tags=None,
                    save_all: bool = False) -> None:
    """The copies a save makes beside ``path`` (the checkpoint ``name`` just
    written), as the JAX package's ``CheckpointManager._post_write`` does:
    with ``is_best`` ``model_best-{tag}`` for each of ``tags`` (default
    ``["best"]``), the previous one moved to ``model_best-{tag}-{name}``;
    with ``save_all`` ``checkpoint_epoch_{epoch}``."""
    for tag in (tags or ["best"]) if is_best else []:
        best = os.path.join(directory, f"model_best-{tag}")
        if os.path.exists(best):
            prev = os.path.join(directory, f"model_best-{tag}-{name}")
            if os.path.exists(prev):
                shutil.rmtree(prev)
            shutil.move(best, prev)
        shutil.copytree(path, best)
    if save_all:
        epoch_path = os.path.join(directory, f"checkpoint_epoch_{epoch}")
        if os.path.exists(epoch_path):
            shutil.rmtree(epoch_path)
        shutil.copytree(path, epoch_path)


class CheckpointManager:
    """Rotation (``checkpoint{0..keep-1}``), the best-model and per-epoch
    copies, and the background write, as the JAX package's
    ``CheckpointManager``: a save fetches the arrays to the host on the
    calling thread (a snapshot: the next train step, or the next replay of a
    CUDA graph, writes the parameters in place), then writes the files,
    rotates and copies on a thread.  At most one write is
    in flight (a save joins the previous one first, so rotation keeps its
    order); :meth:`wait` before reading a just-saved checkpoint.  An error
    of the write is raised by the next :meth:`wait`."""

    def __init__(self, save_path: str, keep_checkpoints: int = 5):
        self.save_path = save_path
        self.keep = keep_checkpoints
        self._counter = 0
        self._pending = None
        self._error: Optional[BaseException] = None
        self._last_finalized: Optional[str] = None
        os.makedirs(save_path, exist_ok=True)

    def next_name(self) -> str:
        name = f"checkpoint{self._counter}"
        self._counter = (self._counter + 1) % self.keep
        return name

    def wait(self) -> None:
        """Join the write in flight; raise its error if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed: {err}") from err

    def _run(self, job) -> None:
        self.wait()
        import threading

        def guarded():
            try:
                job()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._pending = threading.Thread(target=guarded, daemon=True)
        self._pending.start()

    def save(self, variables, opt_state, meta: Dict[str, Any], is_best: bool = False, tags=None,
             save_all: bool = False) -> str:
        """The next single-file checkpoint -> its path (written when
        :meth:`wait` returns)."""
        name = self.next_name()
        arrays = checkpoint_arrays(variables, opt_state)

        def job():
            path = _write_checkpoint_files(self.save_path, name, arrays, meta)
            copy_checkpoint(self.save_path, path, name, meta.get("epoch"), is_best=is_best, tags=tags,
                            save_all=save_all)

        self._run(job)
        return os.path.join(self.save_path, name)

    def save_sharded(self, variables, opt_state, meta: Dict[str, Any], rank: int, n_ranks: int, barrier,
                     writes_slabs: bool = False, is_best: bool = False, tags=None, save_all: bool = False,
                     timeout_s: float = 1800.0) -> str:
        """The collective per-shard save (every rank in step, one shared
        directory): the host fetch of this rank's chunks and the directory
        barrier on the calling thread, the slab write (and on rank 0 the
        finalize and the copies) in the background; :meth:`wait_finalized`
        returns once rank 0's ``meta.json`` is there."""
        name = self.next_name()
        path = os.path.join(self.save_path, name)
        self.wait()
        chunks, index = _shard_chunks(variables, opt_state, rank, writes_slabs)
        _make_shard_dir(path, rank, barrier)

        def copies(p):
            copy_checkpoint(self.save_path, p, name, meta.get("epoch"), is_best=is_best, tags=tags, save_all=save_all)

        self._last_finalized = os.path.join(path, "meta.json")
        self._run(lambda: _write_shard(path, rank, n_ranks, chunks, index, meta, copies, timeout_s))
        return path

    def wait_finalized(self, timeout: float = 1800.0) -> None:
        """:meth:`wait`, then until the last per-shard save is in place
        (rank 0 moves it there)."""
        import time

        self.wait()
        if self._last_finalized is None:
            return
        deadline = time.time() + timeout
        while not os.path.exists(self._last_finalized):
            if time.time() > deadline:
                raise RuntimeError(f"per-shard checkpoint {self._last_finalized} never finalized")
            time.sleep(0.02)


class _FullReader:
    """A single-file checkpoint (``arrays.npz``) behind the reader interface."""

    def __init__(self, path: str):
        self._z = np.load(os.path.join(path, "arrays.npz"))

    def keys(self) -> List[str]:
        return list(self._z.files)

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self._z[key].shape)

    def read_full(self, key: str) -> np.ndarray:
        return self._z[key]

    def read_region(self, key: str, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of the leaf."""
        return self._z[key][lo:hi]

    def close(self) -> None:
        self._z.close()


class _ShardReader:
    """A per-shard checkpoint: every ``index.p*.json`` merged, the slab files
    opened when a chunk of theirs is first read.

    Chunk entry names (``key::i``) are numbered per rank, so the same name
    recurs in several slabs when one leaf's shards were written by several
    ranks; each chunk is tagged with its slab at merge time and read by
    ``(slab, entry)``."""

    def __init__(self, path: str):
        self.index: Dict[str, Dict[str, Any]] = {}
        self._open: Dict[str, Any] = {}
        for idx_file in sorted(glob.glob(os.path.join(path, "index.p*.json"))):
            slab = idx_file.replace("index.p", "arrays.p").replace(".json", ".npz")
            with open(idx_file) as f:
                part = json.load(f)
            for key, info in part.items():
                entry = self.index.setdefault(key, {"shape": info["shape"], "dtype": info["dtype"], "chunks": []})
                entry["chunks"].extend({**c, "slab": slab} for c in info["chunks"])

    def keys(self) -> List[str]:
        return list(self.index)

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self.index[key]["shape"])

    def _load_entry(self, slab: str, entry: str) -> np.ndarray:
        if slab not in self._open:
            self._open[slab] = np.load(slab)
        return self._open[slab][entry]

    def read_full(self, key: str) -> np.ndarray:
        """The whole leaf from its chunks.  Its dtype is the chunks' own (a
        dtype string of the index such as ``bfloat16`` may name a type numpy
        knows only through ``ml_dtypes``); every element must be covered."""
        info = self.index[key]
        shape = tuple(info["shape"])
        chunks = info["chunks"]
        first = self._load_entry(chunks[0]["slab"], chunks[0]["entry"])
        if not shape:  # a scalar is one chunk
            return first
        out = np.empty(shape, dtype=first.dtype)
        filled = 0
        for c in chunks:
            src = first if c is chunks[0] else self._load_entry(c["slab"], c["entry"])
            out[tuple(slice(a, b) for a, b in zip(c["start"], c["stop"]))] = src
            filled += src.size
        if filled != out.size:
            raise ValueError(f"checkpoint chunks of {key} cover {filled} of {out.size} elements")
        return out

    def read_region(self, key: str, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of the leaf, from the chunks that overlap them
        (every element must be covered)."""
        info = self.index[key]
        rest = tuple(info["shape"][1:])
        out, filled = None, 0
        for c in info["chunks"]:
            a, b = max(lo, c["start"][0]), min(hi, c["stop"][0])
            if a >= b:
                continue
            src = self._load_entry(c["slab"], c["entry"])
            if out is None:
                out = np.empty((hi - lo, *rest), dtype=src.dtype)
            part = src[a - c["start"][0] : b - c["start"][0]]
            out[(slice(a - lo, b - lo), *(slice(s, e) for s, e in zip(c["start"][1:], c["stop"][1:])))] = part
            filled += part.size
        if out is None or filled != out.size:
            raise ValueError(f"checkpoint chunks of {key} cover {filled} of rows {lo}:{hi}")
        return out

    def close(self) -> None:
        for z in self._open.values():
            z.close()


def open_checkpoint_reader(path: str):
    """The reader of ``path``'s format: ``arrays.npz`` if it has one, else
    its per-shard slabs."""
    if os.path.exists(os.path.join(path, "arrays.npz")):
        return _FullReader(path)
    if not glob.glob(os.path.join(path, "index.p*.json")):
        raise FileNotFoundError(f"{path} holds neither arrays.npz nor per-shard index.p*.json files")
    return _ShardReader(path)


def load_checkpoint_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _shapes(tree: Dict[str, Any], prefix: str) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        out.update(_shapes(leaf, path) if isinstance(leaf, dict) else {path: tuple(leaf.shape)})
    return out


def _restore(tree: Dict[str, Any], prefix: str, by_target: Dict[str, str], reader, regions) -> Dict[str, Any]:
    """``tree`` with each leaf whose path is in ``by_target`` replaced by
    that checkpoint entry (its rows of ``regions`` for a slab), on the
    leaf's device and in its dtype."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(leaf, dict):
            out[key] = _restore(leaf, path, by_target, reader, regions)
        elif path in by_target:
            ck = by_target[path]
            arr = reader.read_region(ck, *regions[path][:2]) if path in regions else reader.read_full(ck)
            out[key] = torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = leaf
    return out


def load_checkpoint(path: str, variables: Dict[str, Any], opt_state: Dict[str, Any],
                    resume_filter: Optional[List[str]] = None, weight_map: Optional[Dict[str, str]] = None,
                    load_optimizer: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Restore a checkpoint (written by either package, single-file or per
    shard) into ``variables`` and ``opt_state`` -> ``(variables, opt_state,
    meta)``, as the JAX package's ``load_checkpoint`` does: ``weight_map``
    renames checkpoint keys first (``{"params/a": "params/b"}``), then
    ``resume_filter`` keeps of the ``params/`` keys only those whose path
    (after ``params/``) contains one of its strings, then entries whose
    shape differs from the target's are skipped with a warning (read from
    the index, no data read), and where a renamed and an unrenamed key land
    on one target the renamed one wins.  Leaves the checkpoint lacks keep
    their value; ``load_optimizer=False`` leaves ``opt_state`` as it is.
    The slabs of a model axis (``variables["slabs"]`` and their optimizer
    state) take their rows of the whole leaf, from either format."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_regions

    regions = slab_regions(variables, opt_state)
    reader = open_checkpoint_reader(path)
    try:
        keymap = {k: k for k in reader.keys()}  # checkpoint key -> target key
        for old, new in (weight_map or {}).items():
            if old in keymap:
                keymap[old] = new
        if resume_filter is not None:
            for ck, tk in list(keymap.items()):
                bare = tk.split("/", 1)[1] if "/" in tk else tk
                if tk.startswith("params/") and not any(f in bare for f in resume_filter):
                    del keymap[ck]
        example = {**_shapes(variables.get("params", {}), "params"), **_shapes(variables.get("state", {}), "state"),
                   **_shapes(opt_state, "opt")}
        for k, (_, _, n) in regions.items():  # a slab holds some rows of the whole leaf
            example[k] = (n, *example[k][1:])
        for ck, tk in list(keymap.items()):
            if tk in example and example[tk] != reader.shape(ck):
                logger.warning("skipping %s: shape %s != %s", tk, reader.shape(ck), example[tk])
                del keymap[ck]
        renamed = set(weight_map or ())
        by_target: Dict[str, str] = {}
        for ck, tk in keymap.items():
            if tk in by_target and by_target[tk] in renamed and ck not in renamed:
                continue
            if tk in by_target and ck != by_target[tk]:
                logger.warning("weight_map target collision on %s: using %s", tk,
                               ck if ck in renamed else by_target[tk])
            if tk not in by_target or ck in renamed:
                by_target[tk] = ck
        new_vars = dict(variables)
        new_vars["params"] = _restore(variables["params"], "params", by_target, reader, regions)
        new_vars["state"] = _restore(variables.get("state", {}), "state", by_target, reader, regions)
        new_opt = _restore(opt_state, "opt", by_target, reader, regions) if load_optimizer else opt_state
    finally:
        reader.close()
    meta = load_checkpoint_meta(path)
    logger.info("loaded checkpoint %s (training_steps=%s)", path, meta.get("training_steps"))
    return new_vars, new_opt, meta
