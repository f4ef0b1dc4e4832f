"""The readers of the program's host spans, on hand-built traces whose
device idle time inside each span is known; a trace without the spans (the
program before it had them) reads None."""

import pytest

import bench_tiny
from okbench import spans, spec
from okbench.trace import Trace

NS = 1e-9  # the traces below count nanoseconds, and their wall time in them

#: device busy over [0, 10), [20, 30), [50, 60) and [95, 100) of a 100 ns pass
DEVICE = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60), ("k", 95, 100)]
HOST = [
    ("train.wait_batch", 25, 45),  # idle 30-45: 15
    ("train.step", 5, 25),  # idle 10-20: 10
    ("aten::mm", 6, 8),  # another name: not read
    ("train.window", 45, 70),  # idle 45-50 and 60-70: 15
    ("train.step", 80, 90),  # idle 80-90: 10
]


def reader(name):
    return spec._reader(bench_tiny.BENCH, name)


def test_interval_union_and_overlap():
    assert spans.merged([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]
    assert spans.overlap_ns([(0, 4), (5, 10)], [(3, 6), (8, 20)]) == 1 + 1 + 2
    assert spans.overlap_ns([], [(0, 1)]) == 0


def test_idle_within_nested_and_overlapping_spans_counts_once():
    tr = Trace(DEVICE, [("train.step", 5, 25), ("train.step", 8, 22), ("train.window", 15, 35)], 100 * NS)
    # union 5-35, busy 5-10 and 20-30 inside: 30 - 15
    assert spans.idle_within_s(tr, ("train.step", "train.window")) == pytest.approx(15 * NS)


@pytest.mark.parametrize("name,want", [
    ("idle_in_step_pct.olp_train", 35.0),
    ("idle_in_step_pct.train", 35.0),
    ("idle_in_wait_pct.olp_train", 15.0),
    ("step_launch_ms.olp_train", 15e-6),  # two steps of 20 and 10 ns
])
def test_span_metrics_read_the_known_overlaps(name, want):
    assert reader(name)({"trace": Trace(DEVICE, HOST, 100 * NS)}) == pytest.approx(want)


@pytest.mark.parametrize("name", ["idle_in_step_pct.olp_train", "idle_in_step_pct.train",
                                  "idle_in_wait_pct.olp_train", "step_launch_ms.olp_train"])
def test_span_metrics_read_none_without_spans(name):
    read = reader(name)
    assert read({"trace": Trace(DEVICE, [("aten::mm", 6, 8), ("host.wait_batch", 25, 45)], 100 * NS)}) is None
    assert read({}) is None
