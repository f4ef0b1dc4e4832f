"""The program's host spans in a traced run: the device's idle time while a
span of some names is open, and the spans' durations.  A span is a range
the program opens in the profiler's trace (``record_function``), among the
trace's host intervals; a program without such spans reads None."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def durations_ns(trace, names) -> List[int]:
    """The durations of the trace's spans named one of ``names``."""
    return [e - s for n, s, e in trace.host_ops if n in names]


def idle_within_s(trace, names) -> Optional[float]:
    """Seconds in which a span named one of ``names`` is open and no
    operation runs on the device (the spans' union less its overlap with
    the device's busy intervals); None where the trace has no such span."""
    spans = merged((s, e) for n, s, e in trace.host_ops if n in names)
    if not spans:
        return None
    return (sum(e - s for s, e in spans) - overlap_ns(spans, trace.busy)) / 1e9
