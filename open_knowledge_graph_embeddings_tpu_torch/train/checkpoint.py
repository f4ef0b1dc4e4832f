"""The single-file checkpoint format, read and written by both packages.

One directory per checkpoint: ``arrays.npz`` holds params, batch-norm state
and optimizer accumulators flattened to slash-joined keys
(``params/entity_lstm/w_ih``, ``state/entity_bn/mean``, ``opt/...``) and
``meta.json`` holds counters and the config.  Buffers (token-id matrices)
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


def variables_from_jax_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, Dict[str, Any]]:
    """The JAX package's flattened ``params/...`` and ``state/...`` arrays
    (a checkpoint's ``arrays.npz``, or ``flatten_arrays`` of its variables)
    -> ``{"params": ..., "state": ...}`` nested dicts of CPU tensors with the
    same names and shapes.  Every weight that crosses between the packages
    passes through here; ``opt/...`` keys are ignored."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "state": {}}
    for key, value in arrays.items():
        top, _, rest = key.partition("/")
        if top not in out or not rest:
            continue
        node = out[top]
        *path, leaf = rest.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(value, copy=True))
    return out


def save_checkpoint(
    directory: str, name: str, variables: Dict[str, Any], meta: Dict[str, Any]
) -> str:
    """Write ``variables``' params and state as ``<directory>/<name>``."""
    arrays: Dict[str, np.ndarray] = {}
    arrays.update(flatten_arrays(variables.get("params", {}), "params"))
    arrays.update(flatten_arrays(variables.get("state", {}), "state"))
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


def load_checkpoint(path: str, variables: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore a single-file checkpoint (written by either package) into
    ``variables`` -> ``(variables, meta)``."""
    if not os.path.exists(os.path.join(path, "arrays.npz")):
        raise NotImplementedError(
            f"{path} has no arrays.npz: per-shard checkpoints are not ported yet "
            "(ROADMAP Queue 1 item 14)"
        )
    with np.load(os.path.join(path, "arrays.npz")) as z:
        loaded = variables_from_jax_arrays({k: z[k] for k in z.files if not k.startswith("opt/")})
    new_vars = dict(variables)
    new_vars["params"] = _merge(variables["params"], loaded["params"], "params")
    new_vars["state"] = _merge(variables.get("state", {}), loaded["state"], "state")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    logger.info("loaded checkpoint %s (training_steps=%s)", path, meta.get("training_steps"))
    return new_vars, meta
