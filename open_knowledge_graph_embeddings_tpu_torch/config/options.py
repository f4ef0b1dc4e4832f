"""YAML config + CLI override system.

The YAML file is the full configuration; every top-level key can be
overridden on the command line (``CONFIG.yaml --key value``); the packaged
``default.yaml`` (a copy of the JAX package's option schema) lies under it.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Optional, Sequence

import yaml

DEFAULT_YAML = os.path.join(os.path.dirname(__file__), "default.yaml")


def _parse_value(s: str) -> Any:
    if not isinstance(s, str):
        return s
    low = s.lower()
    if low in ("true", "yes", "t", "y"):
        return True
    if low in ("false", "no", "f", "n"):
        return False
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def load_config(
    config_path: Optional[str] = None, overrides: Optional[Sequence[str]] = None
) -> Dict[str, Any]:
    """Load default.yaml, layer the user config over it, then apply
    ``--key value`` CLI overrides to top-level keys."""
    with open(DEFAULT_YAML) as f:
        args = yaml.safe_load(f)
    if config_path:
        with open(config_path) as f:
            user = yaml.safe_load(f) or {}
        args.update(user)
    args["config_file"] = config_path

    overrides = list(overrides or [])
    i = 0
    while i < len(overrides):
        tok = overrides[i]
        if not tok.startswith("--"):
            raise SystemExit(f"expected --key, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(overrides):
                raise SystemExit(f"missing value for --{key}")
            val = overrides[i + 1]
            i += 2
        if key not in args:
            raise SystemExit(
                f"unknown option --{key}; top-level keys: {sorted(args)[:40]} ..."
            )
        args[key] = _parse_value(val)
    return args
