"""One run of one cell: checks the cards, runs the cell's traffic runner,
reads its metrics, and prints the numbers compared and the result line."""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from okbench import serve_cell, spec, train_cell, work

#: the traffic runners, by a traffic mix's ``kind``
RUNNERS = {"train": train_cell.run, "serve": serve_cell.run}
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "open_knowledge_graph_embeddings_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description="run one cell of the benchmark once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(w: spec.Workload, context: Dict) -> Dict:
    out = {}
    for m in w.per_layer:
        value = m.read(context)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out


def is_correct(res: Dict) -> bool:
    """Every number compared read and at or under its limit, and no step or
    answer failed."""
    checks = res["checks"].values()
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks) and res["failed"] == 0


def end_to_end(name: str, measured: Dict[str, float]) -> float:
    """A cell's end-to-end metric from what its runner measured: the
    quantity of that name, or the one whose name ends the metric's after an
    underscore (``items_per_s`` for ``train_items_per_s``)."""
    if name in measured:
        return measured[name]
    found = [k for k in measured if name.endswith("_" + k)]
    if len(found) != 1:
        raise KeyError(f"the runner measures {sorted(measured)}, none of them {name!r}")
    return measured[found[0]]


def main(argv, t_start: float) -> int:
    a = parse(argv)
    sys.path.insert(0, str(spec.ROOT))  # the program lives at the checkout's root
    import torch

    w = spec.load(a.workload)
    chips = int(w.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{a.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"{a.workload}: seed {a.seed}, {a.seconds} s, trace {a.trace}; {torch.cuda.get_device_name(0)} "
        f"({work.power_limit()}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    res = RUNNERS[w.traffic["kind"]](w, a.seed, a.seconds, bool(a.trace), "cuda", t_start, log)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark may not load: {', '.join(found)}")
        return 3
    checks = res["checks"]
    correct = is_correct(res)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["memory_peak"])}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    if a.trace:
        ctx = res["context"]
        tr = ctx["trace"]
        line["metrics"] = per_layer(w, ctx)
        device.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        line["device"] = device
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        line["metrics"] = {m.name: {"value": end_to_end(m.name, res["e2e"]), "unit": m.unit} for m in w.end_to_end}
        line["device"] = device
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
