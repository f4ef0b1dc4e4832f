"""The traced part of a window: torch.profiler over host and device, reduced
to the device's busy seconds (the union of its operations' intervals), the
operations that took most device time, and the longest idle gaps named by
what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

#: longest name kept for an operation in the breakdown
NAME_CHARS = 96
#: host operations started before a gap's middle that are searched for the
#: innermost one running there
HOST_LOOKBACK = 64


class Trace:
    """Device and host intervals of one profiled region."""

    def __init__(self, device_ops: List[Tuple[str, int, int]], host_ops: List[Tuple[str, int, int]],
                 wall_s: float):
        self.device_ops = device_ops  # (name, start ns, end ns)
        self.host_ops = host_ops
        self.wall_s = wall_s
        spans = sorted((s, e) for _, s, e in device_ops)
        self.busy: List[Tuple[int, int]] = []
        for s, e in spans:
            if self.busy and s <= self.busy[-1][1]:
                self.busy[-1] = (self.busy[-1][0], max(self.busy[-1][1], e))
            else:
                self.busy.append((s, e))

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def top_device_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device_ops:
            by[name[:NAME_CHARS]] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds between device operations, summed by the innermost
        host operation running at each gap's middle."""
        hosts = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        by: Dict[str, int] = defaultdict(int)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            mid = (e0 + s1) // 2
            best = None
            hi = bisect.bisect_right(starts, mid)
            for name, hs, he in hosts[max(0, hi - HOST_LOOKBACK): hi]:
                if hs <= mid < he and (best is None or he - hs < best[1]):
                    best = (name, he - hs)
            by[best[0][:NAME_CHARS] if best else "no host operation"] += s1 - e0
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def traced(out: list):
    """Profile the body; appends its :class:`Trace` to ``out``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(rec)
    out.append(Trace(device, host, wall))
