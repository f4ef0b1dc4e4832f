"""What the host did during a window, for the run's log: the process's CPU
seconds and involuntary context switches (``getrusage``), and the share of
the machine's CPU time stolen by its hypervisor and spent idle
(``/proc/stat``; read only, and left out where the file is missing or
does not move)."""

from __future__ import annotations

import resource
import time
from typing import Dict, Optional


def _cpu_jiffies() -> Optional[Dict[str, int]]:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
    except OSError:
        return None
    names = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")
    return dict(zip(names, map(int, fields[1:1 + len(names)])))


class HostLoad:
    """Readings at construction; :meth:`summary` gives what changed since."""

    def __init__(self):
        self.t = time.perf_counter()
        self.ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu = _cpu_jiffies()

    def summary(self) -> str:
        wall = time.perf_counter() - self.t
        ru = resource.getrusage(resource.RUSAGE_SELF)
        used = ru.ru_utime + ru.ru_stime - self.ru.ru_utime - self.ru.ru_stime
        out = (f"host: process CPU {used:.3f} s over {wall:.3f} s ({used / max(wall, 1e-9):.2f} cores), "
               f"{ru.ru_nivcsw - self.ru.ru_nivcsw} involuntary switches")
        cpu = _cpu_jiffies()
        if cpu and self.cpu:
            d = {k: cpu[k] - self.cpu[k] for k in cpu}
            total = sum(d.values())
            out += (f"; machine steal {100 * d['steal'] / total:.2f} %, idle {100 * d['idle'] / total:.2f} %"
                    if total > 0 else "; the machine's CPU times do not move here")
        return out
