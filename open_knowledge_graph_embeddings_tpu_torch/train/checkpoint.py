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
from typing import Any, Dict, Optional, Tuple

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


def _merge(target: Dict[str, Any], loaded: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """``target`` with each leaf present in ``loaded`` replaced (moved to the
    target leaf's device); shape mismatches are skipped with a warning."""
    out = {}
    for key, leaf in target.items():
        path = f"{prefix}/{key}"
        if isinstance(leaf, dict):
            out[key] = _merge(leaf, loaded.get(key, {}), path)
        elif key in loaded and tuple(loaded[key].shape) != tuple(leaf.shape):
            logger.warning("skipping %s: shape %s != %s", path, tuple(loaded[key].shape), tuple(leaf.shape))
            out[key] = leaf
        elif key in loaded:
            out[key] = loaded[key].to(device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = leaf
    return out


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


def load_checkpoint(path: str, variables: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore a single-file checkpoint (written by either package) into
    ``variables`` -> ``(variables, meta)``."""
    with np.load(_arrays_path(path)) as z:
        loaded = variables_from_jax_arrays({k: z[k] for k in z.files if not k.startswith("opt/")})
    new_vars = dict(variables)
    new_vars["params"] = _merge(variables["params"], loaded["params"], "params")
    new_vars["state"] = _merge(variables.get("state", {}), loaded["state"], "state")
    meta = load_checkpoint_meta(path)
    logger.info("loaded checkpoint %s (training_steps=%s)", path, meta.get("training_steps"))
    return new_vars, meta


def load_opt_state(path: str, opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the ``opt/...`` arrays of a checkpoint (written by either
    package) into ``opt_state``, leaf by leaf; leaves the checkpoint lacks
    keep their value."""
    with np.load(_arrays_path(path)) as z:
        loaded = unflatten_arrays({k: z[k] for k in z.files if k.startswith("opt/")}, "opt")
    return _merge(opt_state, loaded, "opt")
