"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for
the benchmark's own tests (widths, batch, vocabulary and data scaled down;
the traffic, the comparison and its limits as the cell has them)."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from okbench import spec  # noqa: E402


def load(name: str):
    """The cell ``name`` of ``BENCHMARK.json``, assembled from its files."""
    return spec.load(name)


def tiny(name: str, dtype=None):
    w = copy.deepcopy(load(name))
    w.config["data"].update(mentions=2000, relations=40, train_triples=6000, eval_triples=100, entity_tokens=600,
                            relation_tokens=90)
    run = w.config["run"]
    run["model_config"].update(entity_slot_size=128, relation_slot_size=128)
    if dtype:
        run["model_config"]["dtype"] = dtype
    run["batch_size"] = run["train_data_config"]["batch_size"] = 128
    if run["train_data_config"].get("use_batch_shared_entities"):
        run["train_data_config"]["min_size_batch_labels"] = 128
        run["train_scan_steps"] = 4
        run["sparse_min_ratio"] = 1.0  # the tiny tables still take the row-sparse update
    run["workers"] = 2
    w.traffic["warmup_max_passes"] = 1
    return w
