"""Root logger to the console (INFO) and optionally a file (DEBUG), and the
per-epoch results table (csv plus a json mirror), as in
``open_knowledge_graph_embeddings_tpu/utils/logging_utils.py``."""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional


def setup_logging(log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    for h in list(root.handlers):
        root.removeHandler(h)
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(level)
    console.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    root.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(name)s - %(message)s")
        )
        root.addHandler(fh)
    return root


class ResultsLog:
    """Append-only results rows persisted as csv (+ json mirror)."""

    def __init__(self, path: str):
        self.path = path
        self.rows: List[Dict[str, Any]] = []
        if os.path.exists(path):
            with open(path, newline="") as f:
                self.rows = [dict(r) for r in csv.DictReader(f)]

    def add(self, **kwargs) -> None:
        self.rows.append(kwargs)

    def save(self) -> None:
        if not self.rows:
            return
        keys: List[str] = []
        for r in self.rows:
            keys += [k for k in r if k not in keys]
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(self.rows)
        with open(os.path.splitext(self.path)[0] + ".json", "w") as f:
            json.dump(self.rows, f, default=str)

    def to_dicts(self) -> List[Dict[str, Any]]:
        return list(self.rows)
