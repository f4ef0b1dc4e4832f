"""Streaming metric accumulation (host side).

Counterpart of ``open_knowledge_graph_embeddings_tpu/train/metrics.py`` (the
reference's AccumulateMeter / MetricResult): weighted running averages with
a fixed metric set {loss, h1, h3, h10, h50, mrr, mr}, greater- or
lesser-is-better per metric, and ``+`` merge across batches.  Mean rank
stays "greater is better", the reference's default.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict


class AccumulateMeter:
    def __init__(self, greater_is_better: bool = True, print_precision: int = 4):
        self.greater_is_better = greater_is_better
        self.print_precision = print_precision
        self.reset()

    def reset(self) -> None:
        self.avg = 0.0
        self.val = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.avg = (self.avg * self.count + val * n) / (self.count + n)
        self.count += n

    def __add__(self, other: "AccumulateMeter") -> "AccumulateMeter":
        if other.count > 0:
            self.update(other.avg, other.count)
        return self

    def avg_better_than(self, other: "AccumulateMeter") -> bool:
        return self.avg > other.avg if self.greater_is_better else self.avg < other.avg

    def avg_better_than_float(self, x: float) -> bool:
        return self.avg > x if self.greater_is_better else self.avg < x

    def __repr__(self) -> str:
        return f"{self.avg:.{self.print_precision}f}"


class MetricResult(OrderedDict):
    """Fixed metric set; h-at-k are fractions over golds, mr/mrr over ranks."""

    def __init__(self):
        super().__init__()
        self["loss"] = AccumulateMeter(greater_is_better=False, print_precision=7)
        self["h1"] = AccumulateMeter()
        self["h3"] = AccumulateMeter()
        self["h10"] = AccumulateMeter()
        self["h50"] = AccumulateMeter()
        self["mrr"] = AccumulateMeter()
        self["mr"] = AccumulateMeter(greater_is_better=True)  # reference default (utils/metrics.py:58)

    @property
    def averages(self) -> str:
        return "  ".join(f"{k}: {v}" for k, v in self.items())

    @property
    def averages_dict(self) -> Dict[str, float]:
        return {k: v.avg for k, v in self.items()}

    def __add__(self, other):
        if other is None:
            return self
        for tm, om in zip(self.values(), other.values()):
            tm += om
        return self

    def reset(self):
        for v in self.values():
            v.reset()

    def __repr__(self):
        return "".join(f"{k}: {v.avg}\n" for k, v in self.items())
