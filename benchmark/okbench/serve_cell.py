"""The ``serve`` traffic: one client in a closed loop sends requests to the
program's ``inference.Predictor.predict`` and waits for each answer.

A request is ``queries_min`` to ``queries_max`` queries of one direction,
(s, r, ?) or (?, r, o), drawn uniformly from the test split's prefixes,
asking for the top ``k`` entities.  The sizes cycle through a fixed set of
``cycle`` sizes spread evenly over that range and the directions half and
half, each cycle in an order drawn from ``--seed``, so every seed serves the
same work.  Set-up builds the model with the benchmark's weights and the
predictor (its candidate cache) and serves the warm-up requests; the window
then serves requests until ``--seconds`` have gone, each timed from its
send to its top-k on the host.  With ``--trace 1`` the requests from
``trace_first`` on, ``trace_requests`` of them, run under the profiler.
Once the window has closed and the program's state is freed, the reference
ranks a sample of the finished requests drawn from the seed, the longest
among them.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from okbench import synth, trace
from okbench.host import HostLoad
from okbench.params import leaves, make_params, node
from okbench.reference import ServeReference
from okbench.spec import BENCH_DIR, Workload
from okbench.train_cell import MIN_ENTITY, checks, weight_seed
from okbench.work import StepWork


def request_plan(t: Dict, seed: int, arrays, n: int) -> List[Dict]:
    """``n`` requests: ``{"sp": bool, "ent": [B], "rel": [B]}``."""
    rng = np.random.default_rng([int(seed), 7])
    sizes = np.round(np.linspace(int(t["queries_min"]), int(t["queries_max"]), int(t["cycle"]))).astype(int)
    sp = np.arange(len(sizes)) % 2 == 0
    prefixes = {True: (arrays["test_s"], arrays["test_r"]), False: (arrays["test_o"], arrays["test_r"])}
    out = []
    while len(out) < n:
        order = rng.permutation(len(sizes))
        for size, is_sp in zip(sizes[order], rng.permutation(sp)):
            ent, rel = prefixes[bool(is_sp)]
            pick = rng.integers(0, len(ent), int(size))
            out.append({"sp": bool(is_sp), "ent": ent[pick].astype(np.int64), "rel": rel[pick].astype(np.int64)})
    return out[:n]


def warmup_plan(t: Dict, arrays) -> List[Dict]:
    """The shapes the traffic uses, both directions: the smallest and the
    largest request, and a size off a multiple of 8 (another LSTM path)."""
    lo, hi = int(t["queries_min"]), int(t["queries_max"])
    out = []
    for size in (lo, hi, lo + 1 if (lo + 1) % 8 else lo + 3):
        for sp in (True, False):
            ent = arrays["test_s" if sp else "test_o"][:size]
            out.append({"sp": sp, "ent": ent.astype(np.int64), "rel": arrays["test_r"][:size].astype(np.int64)})
    return out


class Served:
    """The program's serving objects with the benchmark's weights."""

    def __init__(self, w: Workload, seed: int, device, data=None):
        from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
        from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
        from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model

        run = w.config["run"]
        if data is None:
            data_dir = synth.ensure(w.config["data"], BENCH_DIR / ".cache")
            data = (data_dir, synth.load_arrays(data_dir),
                    load_meta(str(data_dir), tuple(run["experiment_settings"]["max_lengths_tuple"])))
        self.data = data
        self.arrays, meta = data[1], data[2]
        self.model = build_model(run["model"], meta, **run["model_config"])
        variables = self.model.init(torch.Generator(device=device).manual_seed(0))  # the structure
        self.shapes = {p: tuple(t.shape) for p, t in leaves(variables["params"])}
        with torch.no_grad():
            for p, v in make_params(self.shapes, weight_seed(seed), float(run["model_config"]["init_std"]),
                                    device).items():
                node(variables["params"], p).copy_(v)
        self.predictor = Predictor(self.model, variables)
        self.k = int(w.traffic["k"])

    def serve(self, req):
        key = "subj" if req["sp"] else "obj"
        return self.predictor.predict(**{key: req["ent"]}, rel=req["rel"], k=self.k)


def checked_sample(seed: int, plan: List[Dict], n_done: int, n_check: int) -> List[int]:
    """The finished requests the reference ranks: the longest, and others
    drawn from the seed."""
    longest = max(range(n_done), key=lambda i: len(plan[i]["ent"]))
    rest = [i for i in range(n_done) if i != longest]
    rng = np.random.default_rng([int(seed), 11])
    pick = rng.choice(len(rest), size=min(len(rest), n_check - 1), replace=False)
    return sorted([longest] + [rest[i] for i in pick])


def gaps(ref: ServeReference, params, cache, plan, outputs, sample, k, precision_ref=None) -> Dict[str, float]:
    """``topk_gap``: the widest gap, over the sampled queries and the k
    places, by which the reference's score of a served entity lies below
    the reference's own score at that place; ``score_gap``: the widest gap
    between a served score and the reference's score of that entity; both
    over the query's score scale, its vector's norm times the root mean
    square of the candidates' norms (a bound of a score's size that no
    near-zero best score can shrink).  ``precision_ref``
    (a control's reference) gives the top-k in the program's place."""
    topk_gap = score_gap = 0.0
    n = 0
    rms = cache.square().sum(1).mean().sqrt()
    for i in sample:
        req = plan[i]
        dev = cache.device
        ent, rel = torch.as_tensor(req["ent"], device=dev), torch.as_tensor(req["rel"], device=dev)
        is_sp = torch.full(ent.shape, req["sp"], dtype=torch.bool, device=dev)
        q = ref.queries(params, ent, rel, is_sp)
        best_s, _ = ref.topk(q, cache, k)
        if precision_ref is None:
            s_prog, ids = outputs[i]
            s_prog = torch.as_tensor(s_prog, device=dev)
            cols = torch.as_tensor(ids, device=dev) - MIN_ENTITY
        else:
            ctrl, ctrl_cache = precision_ref
            s_prog, cols = ctrl.topk(ctrl.queries(params, ent, rel, is_sp), ctrl_cache, k)
        ref_of_served = ref.scores_of(q, cache, cols)
        scale = (q.norm(dim=1, keepdim=True) * rms).clamp_min(1e-30)
        topk_gap = max(topk_gap, float(((best_s - ref_of_served) / scale).max()))
        score_gap = max(score_gap, float(((s_prog - ref_of_served).abs() / scale).max()))
        n += len(req["ent"])
    return {"topk_gap": topk_gap, "score_gap": score_gap, "queries_checked": float(n)}


def reference_params(w: Workload, shapes, seed: int, device):
    from okbench.params import nest

    return nest(make_params(shapes, weight_seed(seed), float(w.config["run"]["model_config"]["init_std"]), device))


def failed_answers(req, out, k: int, n_entities: int) -> bool:
    scores, ids = out
    B = len(req["ent"])
    return not (scores.shape == (B, k) and ids.shape == (B, k) and np.isfinite(scores).all()
                and ((ids >= MIN_ENTITY) & (ids < n_entities)).all() and (np.diff(scores, axis=1) <= 0).all())


def run(w: Workload, seed: int, seconds: float, trace_on: bool, device: str, t_start: float, log) -> Dict:
    device = torch.device(device)
    t = w.traffic
    s = Served(w, seed, device)
    n_entities = s.arrays["entity_tokens"].shape[0]
    for req in warmup_plan(t, s.arrays):
        s.serve(req)
    plan = request_plan(t, seed, s.arrays, int(t["plan_requests"]))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    lat, outputs, traces, traced = [], [], [], set()

    def one(i):
        t0 = time.perf_counter()
        outputs.append(s.serve(plan[i]))
        lat.append(time.perf_counter() - t0)

    load = HostLoad()
    t0 = time.perf_counter()
    i = 0
    while (time.perf_counter() - t0 < seconds or (trace_on and not traces)) and i < len(plan):
        if trace_on and not traces and i == int(t["trace_first"]):
            n = int(t["trace_requests"])
            with trace.traced(traces):
                for j in range(i, i + n):
                    one(j)
            traced.update(range(i, i + n))
            i += n
        else:
            one(i)
            i += 1
    window_s = time.perf_counter() - t0
    if i >= len(plan):
        raise RuntimeError(f"the plan's {len(plan)} requests ran out before the window closed")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(failed_answers(plan[j], outputs[j], s.k, n_entities) for j in range(i))
    result = {"attempted": i, "failed": failed, "window_s": window_s, "memory_peak": memory_peak,
              "setup_s": setup_s}
    lat_ms = np.array(lat) * 1e3
    if trace_on:
        run_cfg = w.config["run"]
        work = StepWork(s.arrays, int(run_cfg["model_config"]["entity_slot_size"]),
                        run_cfg["model_config"].get("dtype") or "float32", MIN_ENTITY)
        plain = [j for j in range(i) if j not in traced]
        result["context"] = {"trace": traces[0], "peak_flops": work.peak,
                             "serve_flops": sum(work.request(plan[j]["ent"], plan[j]["rel"]) for j in plain),
                             "serve_s": float(sum(lat[j] for j in plain))}
    else:
        result["e2e"] = {"p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": setup_s}
    log(f"window {window_s:.3f} s: {i} requests, p50 {np.percentile(lat_ms, 50):.3f} ms, "
        f"p95 {np.percentile(lat_ms, 95):.3f} ms, max {lat_ms.max():.3f} ms")
    log(load.summary())

    sample = checked_sample(seed, plan, i, int(t["check_requests"]))
    shapes = s.shapes
    del s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ServeReference(synth.load_arrays(synth.ensure(w.config["data"], BENCH_DIR / ".cache")), device)
    params = reference_params(w, shapes, seed, device)
    result["numbers"] = gaps(ref, params, ref.cache(params), plan, outputs, sample, int(t["k"]))
    result["checks"] = checks(result["numbers"], w.cell["limits"])
    return result
