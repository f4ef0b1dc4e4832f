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
:class:`_ShardReader` merges every rank's index and reads each leaf whole
on one device.  :func:`save_checkpoint_sharded` writes it for the port's
several processes: on a data-parallel mesh every leaf is whole on every
rank, and JAX's replica-0 rule gives each to rank 0, so rank 0's slab
holds every leaf and the other ranks' indexes are empty.  A model axis
(ROADMAP Queue 1 item 16) would give each rank its row blocks.
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
            out[path] = leaf.detach().cpu().numpy()
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


def save_checkpoint(
    directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any],
    opt_state: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``variables``' params and state, and ``opt_state`` under
    ``opt/``, as ``<directory>/<name>``."""
    arrays = checkpoint_arrays(variables, opt_state)
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


def local_checkpoint_chunks(arrays: Dict[str, np.ndarray], rank: int) -> Tuple[Dict[str, np.ndarray],
                                                                               Dict[str, Dict[str, Any]]]:
    """This rank's slab -> ``(chunks, index)``: by the replica-0 rule each
    leaf whole on every rank is written once, by rank 0, as one chunk
    ``key::0`` spanning it; ``index`` maps each key to ``{"shape", "dtype",
    "chunks": [{"entry", "start", "stop"}]}``, the JAX package's layout."""
    if rank != 0:
        return {}, {}
    chunks: Dict[str, np.ndarray] = {}
    index: Dict[str, Dict[str, Any]] = {}
    for key, arr in arrays.items():
        entry = f"{key}::0"
        chunks[entry] = arr
        index[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                      "chunks": [{"entry": entry, "start": [0] * arr.ndim, "stop": list(arr.shape)}]}
    return chunks, index


def save_checkpoint_sharded(directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any],
                            opt_state: Dict[str, Any], rank: int, n_ranks: int, barrier, on_written=None,
                            timeout_s: float = 1800.0) -> str:
    """The collective per-shard save: every rank calls it in step on one
    shared ``directory``.  Rank 0 makes the temporary directory; after a
    barrier each rank writes its slab (``arrays.p{rank}.npz``,
    ``index.p{rank}.json``) and a ``done.p{rank}`` sentinel; rank 0 waits for
    every sentinel, removes them, writes ``meta.json`` last, moves the
    directory into place and calls ``on_written(path)`` (the best-model and
    per-epoch copies); a last barrier returns every rank after that.
    Returns the checkpoint's path."""
    import time

    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    chunks, index = local_checkpoint_chunks(checkpoint_arrays(variables, opt_state), rank)
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    barrier()
    np.savez(os.path.join(tmp, f"arrays.p{rank}.npz"), **chunks)
    with open(os.path.join(tmp, f"index.p{rank}.json"), "w") as f:
        json.dump(index, f)
    open(os.path.join(tmp, f"done.p{rank}"), "w").close()
    if rank == 0:
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


def _restore(tree: Dict[str, Any], prefix: str, by_target: Dict[str, str], reader) -> Dict[str, Any]:
    """``tree`` with each leaf whose path is in ``by_target`` replaced by
    that checkpoint entry, on the leaf's device and in its dtype."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(leaf, dict):
            out[key] = _restore(leaf, path, by_target, reader)
        elif path in by_target:
            out[key] = torch.from_numpy(np.array(reader.read_full(by_target[path]))).to(device=leaf.device,
                                                                                       dtype=leaf.dtype)
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
    their value; ``load_optimizer=False`` leaves ``opt_state`` as it is."""
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
        new_vars["params"] = _restore(variables["params"], "params", by_target, reader)
        new_vars["state"] = _restore(variables.get("state", {}), "state", by_target, reader)
        new_opt = _restore(opt_state, "opt", by_target, reader) if load_optimizer else opt_state
    finally:
        reader.close()
    meta = load_checkpoint_meta(path)
    logger.info("loaded checkpoint %s (training_steps=%s)", path, meta.get("training_steps"))
    return new_vars, new_opt, meta
