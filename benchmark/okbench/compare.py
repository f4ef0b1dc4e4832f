"""The numbers that decide ``correct`` for a training cell, each a gap
between the program's reading and the reference's, taken by the worst leaf:

* ``loss_gap``: the largest relative gap of a checked step's loss, and
  ``loss1_gap`` the first step's alone (before any update);
* ``grad_gap``: the gap between the norms of the first step's gradient as
  Adagrad takes it (the program's from its Adagrad sums after that step),
  over the larger of the leaf's reference norm and the median leaf's, and
  ``grad_med_gap`` the median leaf's gap (steady where one leaf's gradient
  is a near-cancelling sum whose rounding swings from seed to seed);
* ``change_gap``: the same for the norm of each leaf's change over the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf below it moves by round-off);
* ``rows_gap``: for each token table, the norm of the gap between the
  program's and the reference's norms of the first gradient's rows, over
  the norm of the reference's; the worst table (a token altered or half
  of the rows left out moves gradient between rows, which the table's
  norm barely sees).

A window run as one CUDA-graph replay is compared from the program's own
state at its start (:func:`window_gaps`): its steps' losses
(``replay_loss_gap``, and its first step's, ``replay_loss1_gap``), the
root of the Adagrad sums' growth over the window in place of the first
gradient (``replay_grad_gap``, ``replay_grad_med_gap``,
``replay_rows_gap``), and the change over the window
(``replay_change_gap``), by the same rules.
"""

from __future__ import annotations

import statistics
from typing import Dict

import numpy as np

#: leaves whose reference gradient norm is under this share of the median
#: leaf's are left out of ``change_gap``
STILL_LEAF = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves}


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}}``."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError(f"{len(prog['loss'])} program losses against {len(ref['loss'])} reference losses")
    leaves = sorted(ref["grad"])
    if sorted(prog["grad"]) != leaves or sorted(prog["change"]) != leaves:
        raise ValueError("the program's leaves differ from the reference's")
    g_med = statistics.median(ref["grad"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad"][k] >= STILL_LEAF * g_med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "loss1_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "grad_gap": _worst(prog["grad"], ref["grad"], leaves),
        "grad_med_gap": statistics.median(leaf_gaps(prog["grad"], ref["grad"], leaves).values()),
        "change_gap": _worst(prog["change"], ref["change"], moved),
        "rows_gap": rows_gap(prog.get("rows", {}), ref.get("rows", {})),
    }


def rows_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> float:
    """The worst table's gap of row norms (0 where no table is compared)."""
    if sorted(prog) != sorted(ref):
        raise ValueError(f"row norms of {sorted(prog)} against {sorted(ref)}")
    return max((float(np.linalg.norm(prog[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-300)) for k in ref),
               default=0.0)


def window_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The gaps of a replayed window: ``prog`` and ``ref`` hold ``loss``
    [per step], ``growth`` and ``change`` {leaf: norm} and ``growth_rows``
    {token table: [rows]}."""
    out = gaps({"loss": prog["loss"], "grad": prog["growth"], "change": prog["change"],
                "rows": prog["growth_rows"]},
               {"loss": ref["loss"], "grad": ref["growth"], "change": ref["change"], "rows": ref["growth_rows"]})
    return {f"replay_{k}": v for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN, or a number not read, is
    over any)."""
    return all(numbers.get(k) is not None and numbers[k] <= limits[k] for k in limits)
