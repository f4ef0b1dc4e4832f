"""The readings a cell's limits are set from (not run by the benchmark's own
runs).  A training cell:

* the program on each seed: its first ``checked_steps`` steps through
  ``Trainer.train_epoch`` at the cell's own size, against the reference;
* the control on each of the first ``--control-seeds`` seeds: the reference
  in the nearest precision below the configuration's (bfloat16: float8
  operands; float32: TF32 operands), put in the program's place;
* the planted faults on the same seeds, in the reference put in the
  program's place: half of the batch left out with the mean over the rest,
  and a token altered where it is produced.  (A state left unchanged reads
  1 by ``change_gap`` and needs no run.)

Where the trainer runs multi-step windows, each of these also reads the
first window the program runs as a CUDA-graph replay, from the program's
state at its start (the ``replay_`` numbers).

A serving cell: the program on each seed serves the requests a run checks
(the longest of a cycle of sizes among them), against the reference; the
control is the reference in float8 ranking in the program's place; the
faults, planted in the reference's answers put in the program's place, are
half of a request's queries answered with other queries' answers, and each
query's first answer altered.

    python3 benchmark/readings.py --workload olp-lstm-train --seeds 12 --first-seed 1000 [--out FILE]

Prints a JSON line per seed and reading, and a summary of the largest
program reading and the smallest control and fault readings per number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from okbench import compare, serve_cell, spec, train_cell  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}
FAULTS = ("half_batch", "token")


def _emitter(rows, out):
    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")

    return emit


def _summary(rows, kinds):
    numbers = [k for k in rows[0] if k.endswith("_gap")]
    summary = {"lower": {k: max(r[k] for r in rows if r["kind"] == "program" and k in r) for k in numbers}}
    for kind in kinds:
        got = [r for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {k: min(r[k] for r in got if k in r) for k in numbers if any(k in r for r in got)}
    print(json.dumps({"summary": summary}), flush=True)
    return summary


def serve_readings(w, seeds, control_seeds, device="cuda", out=None):
    rows = []
    emit = _emitter(rows, out)
    t, data = w.traffic, None
    k = int(t["k"])
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        s = serve_cell.Served(w, seed, torch.device(device), data)
        data, shapes = s.data, s.shapes
        plan = serve_cell.request_plan(t, seed, s.arrays, int(t["cycle"]))
        sample = serve_cell.checked_sample(seed, plan, len(plan), int(t["check_requests"]))
        outputs = {j: s.serve(plan[j]) for j in sample}
        del s
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = serve_cell.ServeReference(data[1], device)
        params = serve_cell.reference_params(w, shapes, seed, device)
        cache = ref.cache(params)
        emit({"seed": seed, "kind": "program", **serve_cell.gaps(ref, params, cache, plan, outputs, sample, k),
              "s": time.perf_counter() - t0})
        if i < control_seeds:
            ctrl = serve_cell.ServeReference(data[1], device, precision="fp8")
            emit({"seed": seed, "kind": "control", **serve_cell.gaps(
                ref, params, cache, plan, None, sample, k, precision_ref=(ctrl, ctrl.cache(params)))})
            del ctrl
            answers = {}
            for j in sample:
                req = plan[j]
                dev = cache.device
                q = ref.queries(params, torch.as_tensor(req["ent"], device=dev), torch.as_tensor(req["rel"], device=dev),
                                torch.full((len(req["ent"]),), req["sp"], dtype=torch.bool, device=dev))
                sc, cols = ref.topk(q, cache, k)
                answers[j] = (sc.cpu().numpy(), cols.cpu().numpy() + train_cell.MIN_ENTITY)
            half = {}
            for j, (sc, ids) in answers.items():
                h = len(ids) // 2
                half[j] = (np.concatenate([sc[:h], sc[: len(ids) - h]]), np.concatenate([ids[:h], ids[: len(ids) - h]]))
            altered = {j: (sc, np.concatenate([ids[:, :1] % (cache.shape[0] - 1) + 3, ids[:, 1:]], 1))
                       for j, (sc, ids) in answers.items()}
            for kind, outs in (("half_batch", half), ("token", altered)):
                emit({"seed": seed, "kind": kind, **serve_cell.gaps(ref, params, cache, plan, outs, sample, k)})
        del cache
    return rows, _summary(rows, ("control", "half_batch", "token"))


def readings(w, seeds, control_seeds, device="cuda", out=None, setup=None):
    if w.traffic["kind"] == "serve":
        return serve_readings(w, seeds, control_seeds, device, out)
    s = setup or train_cell.Setup(w, device)
    precision = CONTROL[w.config["run"]["model_config"].get("dtype") or "float32"]
    rows = []
    emit = _emitter(rows, out)
    n_entities = s.train_ds.meta.entities_size
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        trainer, probe = s.trainer(seed, stop_after_check=True)
        try:
            for _ in range(int(w.traffic["warmup_max_passes"])):
                trainer.train_epoch()
        except train_cell.Checked:
            pass
        prog = s.program_readings(probe)
        checked = probe.batches[: int(w.traffic["checked_steps"])]
        window = probe.window
        batches = [] if window is None else probe.batches[window["first"]:window["first"] + window["k"]]
        del trainer, probe
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = train_cell.reference_readings(w, s.arrays, checked, seed, n_entities, s.shapes, device)
        row = {"seed": seed, "kind": "program", **compare.gaps(prog, ref),
               "loss": prog["loss"], "ref_loss": ref["loss"],
               "grad_leaves": compare.leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"])),
               "ref_grad": ref["grad"], "change_leaves": compare.leaf_gaps(prog["change"], ref["change"],
                                                                           sorted(ref["change"]))}
        ref_w = None
        if window is not None:
            prog_w = train_cell.program_window(window, device)
            ref_w = train_cell.reference_window(w, s.arrays, window, batches, n_entities, device)
            row.update(compare.window_gaps(prog_w, ref_w), window_kind=window["kind"],
                       window_first=window["first"], replay_loss=prog_w["loss"], replay_ref_loss=ref_w["loss"],
                       replay_grad_leaves=compare.leaf_gaps(prog_w["growth"], ref_w["growth"], sorted(ref_w["growth"])),
                       replay_change_leaves=compare.leaf_gaps(prog_w["change"], ref_w["change"],
                                                              sorted(ref_w["change"])))
        emit(dict(row, s=time.perf_counter() - t0))
        if i < control_seeds:
            for kind, kw in [("control", {"precision": precision})] + [(f, {"fault": f}) for f in FAULTS]:
                other = train_cell.reference_readings(w, s.arrays, checked, seed, n_entities, s.shapes, device, **kw)
                row = {"seed": seed, "kind": kind, **compare.gaps(other, ref), "loss": other["loss"],
                       "grad_leaves": compare.leaf_gaps(other["grad"], ref["grad"], sorted(ref["grad"]))}
                if window is not None:
                    other_w = train_cell.reference_window(w, s.arrays, window, batches, n_entities, device, **kw)
                    row.update(compare.window_gaps(other_w, ref_w))
                emit(row)
        del window, batches
    return rows, _summary(rows, ("control",) + FAULTS)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    w = spec.load(a.workload)
    readings(w, [a.first_seed + i for i in range(a.seeds)], a.control_seeds, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
