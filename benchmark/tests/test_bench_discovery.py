"""A configuration, a traffic mix, a cell and a per-layer metric added as
files (and entries in ``BENCHMARK.json``) are found by name, with no file of
the benchmark edited."""

import json
import shutil

import bench_tiny
from okbench import cli, spec


def test_added_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_tiny.BENCH, root / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(bench_tiny.BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    b = root / "benchmark"
    config = json.loads((b / "configs" / "fb15k237-lstm-complex.json").read_text())
    config["name"] = "fb15k237-lstm-complex-d256"
    (b / "configs" / "fb15k237-lstm-complex-d256.json").write_text(json.dumps(config))
    traffic = json.loads((b / "traffic" / "train_passes.json").read_text())
    traffic["trace_pass"] = 2
    (b / "traffic" / "train_passes_late_trace.json").write_text(json.dumps(traffic))
    (b / "cells" / "fb-d256-train.json").write_text(json.dumps({"limits": {"grad_gap": 1e-3}}))
    (b / "metrics" / "steps.train.py").write_text("def read(ctx):\n    return float(len(ctx['wait_ms']))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": config["name"], "source": "x",
                                "file": "benchmark/configs/fb15k237-lstm-complex-d256.json", "reduced": []})
    manifest["workloads"].append({"name": "fb-d256-train", "config": config["name"],
                                  "traffic": "train_passes_late_trace", "chips": 1, "why": "x"})
    next(m for m in manifest["end_to_end"] if m["name"] == "train_items_per_s")["workloads"].append("fb-d256-train")
    manifest["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                                  "source": "program_counter", "layer": "Trainer host loop",
                                  "moves": "train_items_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    w = spec.load("fb-d256-train", manifest=root / "BENCHMARK.json", bench_dir=b)
    assert w.config["name"] == "fb15k237-lstm-complex-d256"
    assert w.traffic["trace_pass"] == 2
    assert w.cell["limits"] == {"grad_gap": 1e-3}
    assert [m.name for m in w.end_to_end] == ["train_items_per_s", "setup_s"]
    per_layer = {m.name: m for m in w.per_layer}
    assert per_layer["steps.train"].read({"wait_ms": [1.0, 2.0]}) == 2.0
    assert "graph_step_share_pct.olp_train" not in per_layer  # listed for another cell only
    assert all((p in before and p.read_bytes() == before[p]) for p in before)


def test_every_cell_of_the_manifest_loads():
    manifest = json.loads((bench_tiny.BENCH.parent / "BENCHMARK.json").read_text())
    for entry in manifest["workloads"]:
        w = spec.load(entry["name"])
        assert w.traffic["kind"] in cli.RUNNERS
        assert {m.name for m in w.end_to_end} >= {"setup_s"}
        assert w.per_layer, entry["name"]
