"""The single-file checkpoint format, read and written by both packages.

One directory per checkpoint: ``arrays.npz`` holds params, batch-norm state
and optimizer state flattened to slash-joined keys
(``params/entity_lstm/w_ih``, ``state/entity_bn/mean``,
``opt/entity_lstm/w_ih/sum``, ``opt/entity_lstm/w_ih/step``) and
``meta.json`` holds counters, the config and the optimizer's host state.  Buffers (token-id matrices)
are not saved: they are rebuilt from the dataset.  The per-shard format of
multi-process runs belongs to the port's multi-device work (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

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


def save_checkpoint(
    directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any],
    opt_state: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``variables``' params and state, and ``opt_state`` under
    ``opt/``, as ``<directory>/<name>``."""
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(flatten_arrays(variables.get("params", {}), "params"))
    arrays.update(flatten_arrays(variables.get("state", {}), "state"))
    arrays.update(flatten_arrays(opt_state or {}, "opt"))
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


def _arrays_path(path: str) -> str:
    if not os.path.exists(os.path.join(path, "arrays.npz")):
        raise NotImplementedError(
            f"{path} has no arrays.npz: per-shard checkpoints are not ported yet "
            "(ROADMAP Queue 1 item 14)"
        )
    return os.path.join(path, "arrays.npz")


def load_checkpoint_meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _shapes(tree: Dict[str, Any], prefix: str) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        out.update(_shapes(leaf, path) if isinstance(leaf, dict) else {path: tuple(leaf.shape)})
    return out


def _restore(tree: Dict[str, Any], prefix: str, by_target: Dict[str, str], z) -> Dict[str, Any]:
    """``tree`` with each leaf whose path is in ``by_target`` replaced by
    that checkpoint entry, on the leaf's device and in its dtype."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(leaf, dict):
            out[key] = _restore(leaf, path, by_target, z)
        elif path in by_target:
            out[key] = torch.from_numpy(np.array(z[by_target[path]])).to(device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = leaf
    return out


def load_checkpoint(path: str, variables: Dict[str, Any], opt_state: Dict[str, Any],
                    resume_filter: Optional[List[str]] = None, weight_map: Optional[Dict[str, str]] = None,
                    load_optimizer: bool = True) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """Restore a single-file checkpoint (written by either package) into
    ``variables`` and ``opt_state`` -> ``(variables, opt_state, meta)``,
    as the JAX package's ``load_checkpoint`` does: ``weight_map`` renames
    checkpoint keys first (``{"params/a": "params/b"}``), then
    ``resume_filter`` keeps of the ``params/`` keys only those whose path
    (after ``params/``) contains one of its strings, then entries whose
    shape differs from the target's are skipped with a warning, and where
    a renamed and an unrenamed key land on one target the renamed one wins.
    Leaves the checkpoint lacks keep their value; ``load_optimizer=False``
    leaves ``opt_state`` as it is."""
    with np.load(_arrays_path(path)) as z:
        keymap = {k: k for k in z.files}  # checkpoint key -> target key
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
            if tk in example and example[tk] != tuple(z[ck].shape):
                logger.warning("skipping %s: shape %s != %s", tk, tuple(z[ck].shape), example[tk])
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
        new_vars["params"] = _restore(variables["params"], "params", by_target, z)
        new_vars["state"] = _restore(variables.get("state", {}), "state", by_target, z)
        new_opt = _restore(opt_state, "opt", by_target, z) if load_optimizer else opt_state
    meta = load_checkpoint_meta(path)
    logger.info("loaded checkpoint %s (training_steps=%s)", path, meta.get("training_steps"))
    return new_vars, new_opt, meta
