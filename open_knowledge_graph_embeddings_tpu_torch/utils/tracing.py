"""Host spans: named blocks of host code, timed on the host clock, that
also land in a torch profiler's trace while one records.

``with span("train.step") as s: ...`` leaves the block's host milliseconds
(``time.perf_counter``) in ``s.ms`` when it exits.  While a
``torch.profiler.profile`` records, anywhere in the process, the span also
opens a profiler range of its name around the block, so the block is a host
event of the same kineto trace as the device's kernels, on the same clock
(and an ``nsys`` range under ``emit_nvtx``).  A profiler keeps a thread's
ranges only where it records that thread: the profiling thread and the
autograd threads that inherit its state, or every thread with
``profile_all_threads``.

The range is a function-scope ``RecordFunction`` (torch's
``_RecordFunctionFast``), not ``torch.profiler.record_function``'s
user-scope one: kineto copies a user-scope range onto the device's timeline
as a GPU annotation spanning the kernels the block launched, an event of the
device's type that a reader of the trace would count as device work (on an
H100, a traced training pass read 45 % idle with such ranges, not 75 %).

``with clock() as c: ...`` sums the ms of every span that exits while the
block runs, on any thread, by name, in ``c.ms``.

With no profiler recording and no clock open, a span costs a check of two
flags and two clock reads: no dispatcher call, and no object but the handle
itself.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: a profiler range of the function scope, entered and exited by hand
_Range = torch._C._profiler._RecordFunctionFast

#: the open clocks, in the order they opened
_clocks: List["clock"] = []
_clocks_lock = threading.Lock()


class span:
    """A named block of host code: ``ms`` is its host milliseconds once it
    has exited (None before)."""

    __slots__ = ("name", "ms", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.ms: Optional[float] = None

    def __enter__(self) -> "span":
        # the process-wide flag that every torch.profiler.profile sets on
        # start (torch.autograd._profiler_enabled() reads the calling
        # thread's state: False on a worker thread while the profiler records)
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(*exc)
        if _clocks:
            with _clocks_lock:
                for c in _clocks:
                    c.ms[self.name] = c.ms.get(self.name, 0.0) + self.ms
        return False


class clock:
    """Sums the host ms of every span, by name, on any thread, while its
    block runs: ``ms`` maps a span's name to its summed ms (names that did
    not run are absent)."""

    def __init__(self):
        self.ms: Dict[str, float] = {}

    def __enter__(self) -> "clock":
        with _clocks_lock:
            _clocks.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        with _clocks_lock:
            _clocks.remove(self)
        return False
