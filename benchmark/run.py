"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository: ``BENCHMARK.json`` names the
cells, their configurations, traffic mixes and metrics.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last the
numbers compared with their limits under ``checks``); the numbers compared
are also the last lines of standard error.
"""

import os
import sys
import time

T_START = time.perf_counter()
# one thread per operation on the host: the default pool of one thread a
# core spins beside the program's own loader threads on a shared host
# (PERF.md: 1.8 against 4.7 busy cores, and a faster, steadier loop)
os.environ["OMP_NUM_THREADS"] = "1"

if __name__ == "__main__":
    from okbench.cli import main

    sys.exit(main(sys.argv[1:], T_START))
