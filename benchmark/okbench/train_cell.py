"""The ``train`` traffic: the program's ``Trainer.train_epoch``, pass after
pass, on its configuration's training split.

Set-up builds the data (once per checkout), the program's datasets, model
and trainer with the benchmark's weights, and warms up by whole passes
until a pass captures no new CUDA graph (at least ``warmup_min_passes``)
and, where the trainer runs multi-step windows, one window has run as a
replay of its CUDA graph.
The batches come in the order the traffic's ``order_seed`` draws, the same
for every run; ``--seed`` draws the weights and the dropout masks.  The
first ``checked_steps`` steps of the first pass are the ones the reference
follows: :class:`Probe` reads the program's state after them from outside
the loop, and the state before and after the first replayed window
(:class:`WindowProbe`).  The window then runs passes until ``--seconds`` have gone (the
last pass ends at the first step after), closes on a synchronize, and
counts the positives of every step completed in it.  With ``--trace 1``
the pass numbered ``trace_pass`` of the window runs whole under the
profiler.  After the window, the program's state is freed and the
reference runs the checked steps, and the replayed window's steps from the
program's state at its start.
"""

from __future__ import annotations

import gc
import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from okbench import compare, labels, synth, trace
from okbench.host import HostLoad
from okbench.params import leaves, make_params, nest, node
from okbench.reference import TOKEN_TABLES, TrainReference
from okbench.spec import BENCH_DIR, Workload
from okbench.work import StepWork

#: first real entity id (PAD and UNK come first)
MIN_ENTITY = 2


def weight_seed(seed: int) -> int:
    """The weights' generator seed, apart from the dropout generator's."""
    return (seed + 0x9E3779B97F4A7C15) % (1 << 63)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Probe:
    """Watches the program's training loop from outside: records each batch
    the loop consumes (the host's wait for it under a profiler range named
    ``host.wait_batch``), ends the loop's pass at ``deadline``, and reads
    the program's Adagrad sums after the first step, its parameters after
    ``checked`` steps and the loss of each of those steps.  Where the
    trainer runs multi-step windows it also reads the first window that
    runs as a CUDA-graph replay (:class:`WindowProbe`)."""

    def __init__(self, trainer, checked: int, start_params, stop_after_check: bool = False):
        self.checked, self.start_params = checked, start_params
        self.stop_after_check = stop_after_check
        self.batches: List = []
        self.steps = 0
        self.deadline = None  # the loop's batches end at this host time
        self.loss: List[float] = []
        self.grad: Dict[str, float] = {}
        self.rows: Dict[str, np.ndarray] = {}
        self.change: Dict[str, float] = {}
        self.window = None  # the replayed window's readings, once taken
        inner = trainer._iter_train_entries

        def entries(workers):
            it = inner(workers)
            try:
                while self.deadline is None or time.perf_counter() < self.deadline:
                    with torch.profiler.record_function("host.wait_batch"):
                        item = next(it, None)
                    if item is None:
                        return
                    self.batches.extend(item[1])
                    yield item
            finally:
                it.close()

        trainer._iter_train_entries = entries
        owner = trainer.train_step_scan
        self.wants_window = owner is not None
        if owner is not None:  # single steps and a window's eager steps both go through ``single``
            owner.single = self._wrap(owner.single)
            trainer.train_step_scan = WindowProbe(owner, self)
        else:
            trainer.train_step = self._wrap(trainer.train_step)

    @property
    def done(self) -> bool:
        """Every reading taken."""
        return self.steps >= self.checked and (self.window is not None or not self.wants_window)

    def _wrap(self, fn):
        def step(variables, opt_state, hparams, batch, generator=None):
            out = fn(variables, opt_state, hparams, batch, generator)
            self.steps += 1
            if self.steps <= self.checked:
                self.loss.append(float(out[2]["loss_sum"] / batch["normalizer_loss"]))
            if self.steps == 1:
                sums = {p: node(out[1], p)["sum"] for p, _ in leaves(out[0]["params"])}
                self.grad = {p: math.sqrt(float(a.double().sum())) for p, a in sums.items()}
                self.rows = {p: a.double().sum(1).sqrt().cpu().numpy() for p, a in sums.items() if p in TOKEN_TABLES}
            if self.steps == self.checked:
                start = self.start_params()
                self.change = {p: float((t - start[p]).double().norm()) for p, t in leaves(out[0]["params"])}
                if self.stop_after_check and self.done:
                    raise Checked()
            return out

        return step


#: how a window ran when its results come from a replay of its CUDA graph
#: (``loop``: on the CPU, the steps the graph would capture)
REPLAYED = ("replay", "loop")


def host_state(variables, opt_state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host copies of the parameters and their Adagrad sums."""
    params = dict(leaves(variables["params"]))
    return {"params": {p: t.detach().to("cpu", copy=True) for p, t in params.items()},
            "sums": {p: node(opt_state, p)["sum"].detach().to("cpu", copy=True) for p in params}}


class WindowProbe:
    """Stands in for the trainer's multi-step step: each window goes to it
    unchanged; until one has run as a replay of its CUDA graph, the
    program's state and dropout generator are copied to the host before
    the window, and after the replayed one its state and its steps'
    losses are kept with them (:attr:`Probe.window`)."""

    def __init__(self, scan, probe: Probe):
        self._scan, self._probe = scan, probe

    def __getattr__(self, name):
        return getattr(self._scan, name)

    def __call__(self, variables, opt_state, hparams, batches, generator=None):
        p = self._probe
        if p.window is not None:
            return self._scan(variables, opt_state, hparams, batches, generator)
        before = host_state(variables, opt_state)
        gen_state = generator.get_state() if generator is not None else None
        k = self._scan.k
        first = len(p.batches) - k
        out = self._scan(variables, opt_state, hparams, batches, generator)
        if self._scan.last_kind in REPLAYED:
            stats = out[2]
            p.window = {"first": first, "k": k, "kind": self._scan.last_kind, "before": before,
                        "gen_state": gen_state, "after": host_state(out[0], out[1]),
                        "loss": [float(stats["loss_sum"][i]) / float(b.normalizer_loss)
                                 for i, b in enumerate(p.batches[first:first + k])]}
            if p.stop_after_check and p.done:
                raise Checked()
        return out


def program_args(run_cfg: Dict, data_dir: Path, seed: int, save_path: Path) -> Dict:
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    args = load_config(None)
    args.update(run_cfg)
    args.update(dataset_dir=str(data_dir), seed=seed, experiment_dir=str(save_path))
    return args


def graph_count(trainer) -> int:
    scan = trainer.train_step_scan
    return 0 if scan is None else scan.eager_windows + scan.captures


def reference_batch(b, n_entities: int, device) -> Dict[str, torch.Tensor]:
    """A program batch's sample as device tensors for the reference: the
    full vocabulary where the batch has no candidate list, the positive
    cells without their padding."""
    def t(x, dtype=torch.long):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    if b.candidate_ids is None:
        cand = torch.arange(MIN_ENTITY, n_entities, device=device)
        col_valid = torch.ones(len(cand), dtype=torch.bool, device=device)
    else:
        cand, col_valid = t(b.candidate_ids), t(b.col_valid, torch.bool)
    pos = b.pos_rows >= 0
    return {"ent_ids": t(b.ent_ids), "rel_ids": t(b.rel_ids), "is_sp": t(b.is_sp, torch.bool),
            "row_valid": t(b.row_valid, torch.bool), "candidate_ids": cand, "col_valid": col_valid,
            "pos_rows": t(b.pos_rows[pos]), "pos_cols": t(b.pos_cols[pos]),
            "normalizer_loss": torch.tensor(float(b.normalizer_loss), device=device)}


class Checked(Exception):
    """Raised out of the training loop once the checked steps have run
    (the readings of the limits need no window)."""


class Setup:
    """The program's objects of one run: its dataset (reusable across
    seeds), model, trainer with the benchmark's weights, and the probe."""

    def __init__(self, w: Workload, device: str, data=None):
        from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset

        self.w, self.device = w, torch.device(device)
        self.run_cfg = w.config["run"]
        if data is None:
            data_dir = synth.ensure(w.config["data"], BENCH_DIR / ".cache")
            args = program_args(self.run_cfg, data_dir, 0, BENCH_DIR / ".cache" / "experiments" / w.name)
            data = (data_dir, synth.load_arrays(data_dir), setup_dataset(args))
        self.data_dir, self.arrays, self.train_ds = self.data = data

    def trainer(self, seed: int, stop_after_check: bool = False):
        from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
        from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer

        device = self.device
        order_seed = int(self.w.traffic["order_seed"])
        args = program_args(self.run_cfg, self.data_dir, order_seed, BENCH_DIR / ".cache" / "experiments" / self.w.name)
        model = build_model(args["model"], self.train_ds.meta, **args["model_config"])
        variables = model.init(torch.Generator(device=device).manual_seed(0))  # the structure; values replaced
        self.shapes = {p: tuple(t.shape) for p, t in leaves(variables["params"])}
        init_std = float(self.run_cfg["model_config"]["init_std"])

        def start_params():
            return make_params(self.shapes, weight_seed(seed), init_std, device)

        with torch.no_grad():
            for p, v in start_params().items():
                node(variables["params"], p).copy_(v)
        trainer = Trainer(args, model, self.train_ds, None, save_path=args["experiment_dir"], device=device,
                          variables=variables)
        trainer.generator = torch.Generator(device=device).manual_seed(seed)  # dropout from the run's seed
        probe = Probe(trainer, int(self.w.traffic["checked_steps"]), start_params, stop_after_check)
        return trainer, probe

    @staticmethod
    def program_readings(probe) -> Dict:
        return {"loss": probe.loss, "grad": probe.grad, "change": probe.change, "rows": probe.rows}


def warm_up(trainer, probe, traffic: Dict) -> int:
    """Whole passes until one captures no new CUDA graph (at least
    ``warmup_min_passes``) and the probe has read a replayed window where
    the trainer runs windows; returns the passes run."""
    for i in range(int(traffic["warmup_max_passes"])):
        before = graph_count(trainer)
        trainer.train_epoch()
        if i + 1 >= int(traffic["warmup_min_passes"]) and graph_count(trainer) == before and probe.done:
            break
    return i + 1


def program_window(window: Dict, device) -> Dict:
    """The program's readings of a replayed window (its steps' losses, the
    root of each leaf's Adagrad sums' growth, by row for the token tables,
    and each leaf's change), from the host copies of its state."""
    before, after = window["before"], window["after"]
    out = {"loss": window["loss"], "growth": {}, "growth_rows": {}, "change": {}}
    for p, start in before["params"].items():
        grown = (after["sums"][p].to(device) - before["sums"][p].to(device)).double()
        out["growth"][p] = float(grown.sum().clamp_min(0).sqrt())
        if p in TOKEN_TABLES:
            out["growth_rows"][p] = grown.sum(1).clamp_min(0).sqrt().cpu().numpy()
        out["change"][p] = float((after["params"][p].to(device) - start.to(device)).double().norm())
    return out


def reference_window(w: Workload, arrays, window: Dict, batches, n_entities: int, device, precision: str = "f32",
                     fault=None) -> Dict:
    """The reference's readings of a replayed window's steps, run from the
    program's state at the window's start (parameters, Adagrad sums and
    dropout generator): no reference follows the hundreds of steps before
    it.  ``precision`` and ``fault`` as :func:`reference_readings`'s."""
    before = window["before"]
    params = {p: t.to(device) for p, t in before["params"].items()}
    sums = {p: t.to(device) for p, t in before["sums"].items()}
    ref_batches = [reference_batch(b, n_entities, device) for b in batches]
    return TrainReference(arrays, w.config["run"], device, precision=precision, fault=fault).run(
        nest(params), ref_batches, 0, acc=sums, gen_state=window["gen_state"])


def run(w: Workload, seed: int, seconds: float, trace_on: bool, device: str, t_start: float, log) -> Dict:
    s = Setup(w, device)
    device, traffic, run_cfg, arrays = s.device, w.traffic, s.run_cfg, s.arrays
    trainer, probe = s.trainer(seed)
    warm_passes = warm_up(trainer, probe, traffic)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: {warm_passes} warm-up passes of {len(trainer.train_builder)} steps, "
        f"{graph_count(trainer)} windows eager or captured")

    # ------------------------------------------------------------ window
    passes, traces = [], []
    load = HostLoad()
    t0 = time.perf_counter()
    while True:
        traced_pass = trace_on and len(passes) == int(traffic["trace_pass"])
        s0, b0, tp = len(trainer.step_log), len(probe.batches), time.perf_counter()
        if traced_pass:  # a whole pass
            probe.deadline = None
            with trace.traced(traces):
                trainer.train_epoch()
        else:
            probe.deadline = t0 + seconds
            trainer.train_epoch()
        passes.append({"steps": (s0, len(trainer.step_log)), "batches": (b0, len(probe.batches)),
                       "s": time.perf_counter() - tp, "traced": traced_pass})
        if time.perf_counter() - t0 >= seconds and (not trace_on or traces):
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    s_lo, b_lo = passes[0]["steps"][0], passes[0]["batches"][0]
    rows = trainer.step_log[s_lo:]
    window_batches = probe.batches[b_lo:]
    items = int(sum(int((b.pos_rows >= 0).sum()) for b in window_batches))
    losses = torch.stack([torch.as_tensor(r["loss"]).float().reshape(()) for r in rows])
    failed = int((~torch.isfinite(losses)).sum())

    result = {"attempted": len(rows), "failed": failed, "window_s": window_s, "memory_peak": memory_peak,
              "setup_s": setup_s}
    if trace_on:
        result["context"] = _context(w, trainer, probe, passes, traces[0], arrays, run_cfg)
    else:
        result["e2e"] = {"items_per_s": items / window_s, "setup_s": setup_s}
    log(f"window {window_s:.3f} s: {len(passes)} passes, {len(rows)} steps, {items} positives; passes "
        + ", ".join(f"{p['steps'][1] - p['steps'][0]} steps {p['s']:.3f} s" for p in passes))
    log(load.summary())

    # ----------------------------------------------- the reference's steps
    checked = probe.batches[: int(traffic["checked_steps"])]
    prog = s.program_readings(probe)
    window = probe.window
    window_batches = [] if window is None else probe.batches[window["first"]:window["first"] + window["k"]]
    n_entities, shapes = s.train_ds.meta.entities_size, s.shapes
    del trainer, probe, s, rows, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(w, arrays, checked, seed, n_entities, shapes, device)
    t_labels = time.perf_counter()
    numbers = step_numbers(w, arrays, checked + window_batches, prog, ref)
    t_window = time.perf_counter()
    if window is not None:
        numbers.update(compare.window_gaps(
            program_window(window, device), reference_window(w, arrays, window, window_batches, n_entities, device)))
    log(f"reference {time.perf_counter() - t_ref:.3f} s: {len(checked)} first steps {t_labels - t_ref:.3f} s, "
        f"labels {t_window - t_labels:.3f} s"
        + ("" if window is None else f", a window of {window['k']} steps run as {window['kind']!r} from step "
           f"{window['first'] + 1} {time.perf_counter() - t_window:.3f} s"))
    log("numbers " + " ".join(f"{k} {v!r}" for k, v in numbers.items()))
    result["numbers"] = numbers
    result["checks"] = checks(numbers, dict(w.cell["limits"], label_faults=0.0))
    return result


def reference_readings(w: Workload, arrays, checked, seed: int, n_entities: int, shapes, device,
                       precision: str = "f32", fault=None) -> Dict:
    """The reference's readings of the ``checked`` batches (``precision``
    and ``fault`` select a control or a planted fault in its place)."""
    run_cfg = w.config["run"]
    params = make_params(shapes, weight_seed(seed), float(run_cfg["model_config"]["init_std"]), device)
    batches = [reference_batch(b, n_entities, device) for b in checked]
    return TrainReference(arrays, run_cfg, device, precision=precision, fault=fault).run(nest(params), batches, seed)


def step_numbers(w: Workload, arrays, checked, prog, ref) -> Dict[str, float]:
    """Every gap of ``prog`` from ``ref`` and the count of faults found in
    the checked batches' positive cells."""
    max_lines = int(w.config["run"]["train_data_config"].get("max_size_prefix_label") or -1)
    facts = labels.Facts(arrays)
    faults = [f for b in checked for f in facts.check(b, MIN_ENTITY, max_lines)]
    return dict(compare.gaps(prog, ref), label_faults=float(len(faults)))


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """The numbers the cell compares, each with its limit; a number the run
    could not read (a replayed window that never came) or that is not
    finite is None, which no limit passes."""
    def value(k):
        x = numbers.get(k)
        return x if x is not None and math.isfinite(x) else None

    return {k: {"value": value(k), "limit": v} for k, v in limits.items()}


def _context(w, trainer, probe, passes, tr, arrays, run_cfg) -> Dict:
    """What the per-layer readers read: the window's untraced passes (steps,
    host waits, model FLOP, wall seconds), its step kinds, and the traced
    pass's trace."""
    dtype = run_cfg["model_config"].get("dtype") or "float32"
    work = StepWork(arrays, int(run_cfg["model_config"]["entity_slot_size"]), dtype, MIN_ENTITY)
    plain = [p for p in passes if not p["traced"]]
    step_rows = [r for p in plain for r in trainer.step_log[p["steps"][0]:p["steps"][1]]]
    flops = sum(work.batch(b)["model_flops"] for p in plain for b in probe.batches[p["batches"][0]:p["batches"][1]])
    all_rows = trainer.step_log[passes[0]["steps"][0]:]
    return {
        "scan_steps": trainer.scan_steps,
        "wait_ms": [r["wait_ms"] for r in step_rows],
        "window_kinds": [r["window"] for r in all_rows],
        "plain_s": sum(p["s"] for p in plain),
        "model_flops": flops,
        "peak_flops": work.peak,
        "trace": tr,
    }
