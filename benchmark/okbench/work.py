"""The yardstick's arithmetic: published peaks, and the operations of a
training step or a served request computed from its shapes and from the
batch's actual active row-steps.

Counts are of the work the model needs, not of what an implementation does:
recomputation (the LSTM backward's gate recompute), padding rows and
duplicate rows a step may encode are left out, so no implementation can
read above 100 % of a share built on them.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates: bf16 on the tensor cores, and
#: TF32's rate for f32 work, the highest any f32-accurate method (FFMA or
#: 3xTF32) can reach
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ``not read``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def lstm_products(n_steps: int, rows: int, D: int, H: int):
    """Forward FLOP of one LSTM encode of ``rows`` rows with ``n_steps``
    active row-steps: the input products (one a row-step) and the recurrent
    products (none at a row's first step, where h is zero)."""
    return n_steps * 2 * D * 4 * H, (n_steps - rows) * 2 * H * 4 * H


class StepWork:
    """Work of the steps of one configuration (LSTM encoders over token
    rows, ComplEx scoring of every prefix against the candidates, BCE), from
    the benchmark's own token rows of the dataset."""

    def __init__(self, arrays: Dict[str, np.ndarray], dim: int, dtype: str, min_entity: int = 2):
        self.ent_len = (arrays["entity_tokens"] > 0).sum(1).astype(np.int64)
        self.rel_len = (arrays["relation_tokens"] > 0).sum(1).astype(np.int64)
        self.d = dim
        self.peak = PEAK_FLOPS[dtype]
        self.all_entities = np.arange(min_entity, len(self.ent_len))

    def step(self, ent_ids, rel_ids, n_rows: int, candidate_ids: Optional[np.ndarray], n_cols: int) -> Dict:
        """Model FLOP of one training step: every real candidate and each
        distinct query entity and relation encoded once, forward and
        backward (twice the forward: the input and weight gradients)."""
        d = self.d
        cand = self.all_entities if candidate_ids is None else candidate_ids[:n_cols]
        ents = np.unique(ent_ids[:n_rows])
        rels = np.unique(rel_ids[:n_rows])
        encodes = [(int(self.ent_len[cand].sum()), len(cand)), (int(self.ent_len[ents].sum()), len(ents)),
                   (int(self.rel_len[rels].sum()), len(rels))]
        x_ops = h_ops = 0
        for n_steps, rows in encodes:
            x, h = lstm_products(n_steps, rows, d, d)
            x_ops, h_ops = x_ops + x, h_ops + h
        score_ops = 2 * n_rows * n_cols * d
        return {"model_flops": 3 * (x_ops + h_ops) + 3 * score_ops}

    def request(self, ent_ids, rel_ids) -> float:
        """Forward FLOP of one served request: each distinct query entity and
        relation encoded once, every query scored against every entity."""
        d = self.d
        ops = 0
        for lens, ids in ((self.ent_len, np.unique(ent_ids)), (self.rel_len, np.unique(rel_ids))):
            x, h = lstm_products(int(lens[ids].sum()), len(ids), d, d)
            ops += x + h
        return ops + 2 * len(ent_ids) * len(self.all_entities) * d

    def batch(self, b) -> Dict:
        """:meth:`step` of a program batch (its ids, counts and candidates)."""
        return self.step(b.ent_ids, b.rel_ids, b.num_rows, b.candidate_ids, b.num_cols)
