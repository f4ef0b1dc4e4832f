#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from ``csrc/`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's full width and at ragged shapes, and time the kernel, the
   plain version and one PyTorch library call computing the same function;
4. drive the serving path the way a user does, at the flagship's full width
   (``configs/olpbench/synth-olpbench-2m47-demo.yaml``: LSTM-ComplEx, d=512,
   bf16, 2.47M entity mentions): generate the synthetic vocabulary with
   ``tools/make_synth_olpbench.py``, initialise the model from a seed, save a
   checkpoint, answer text queries through ``cli.predict`` and a batch of
   1024 queries through ``Predictor.predict``, with every kernel's launch
   count set to 0 just before and read just after;
5. check the results: launch counts, finite and sorted scores, ids in range,
   sampled cache rows and top-k scores against a plain CPU encode;
6. print the timings (cache encode; median and max of 20 timed batches of
   1024 queries and of 20 single queries), a torch.profiler breakdown of one
   cache chunk and one batch by device kernel, one JSON line with every
   kernel's numbers, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Needs one card; writes only under ``.bench_cache/``
and the package's ``_build/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "open_knowledge_graph_embeddings_tpu_torch"
FLAGSHIP = ROOT / "configs" / "olpbench" / "synth-olpbench-2m47-demo.yaml"
DATA_DIR = ROOT / ".bench_cache" / "synth_olp_2m47_smoke"
SEED = 0

# H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain version, and cache rows vs a plain CPU encode, are held to
# utils/numerics.py's bf16 rule: at most 4 bf16 ulps of max|want| and at most
# 2 % of elements not bit-equal (|h| here is up to ~0.11, so 4 ulps is
# 4 * 2^-11 ~ 2e-3, a tenth of a typical |h| of ~0.02; measured on an H100:
# 1 ulp, 0.72 % unequal).  Planted faults in the plain version must fail the
# same rule, or the check has no power.
# Top-k scores from the card vs a plain CPU encode of the same queries against
# the same cache: the query vectors differ in a few elements by one bf16 ulp,
# so a score moves by well under one bf16 ulp (2^-8) of the largest score.
SCORE_RTOL = 2 ** -8


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def synth_lengths(rng, n, max_len=10):
    """Mention lengths drawn like tools/make_synth_olpbench.py: 1-8 body
    tokens (Zipf 1.6) plus BOS/EOS, sorted descending."""
    body = 1 + (rng.zipf(1.6, size=n) - 1) % (max_len - 2)
    return np.sort(body + 2)[::-1].astype(np.int32).copy()


def cuda_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def lstm_inputs(torch, gen, L, B, D, H, lens_np):
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm import init_lstm_params

    p = init_lstm_params(gen, D, H, gen.device)
    emb = (torch.randn(L, B, D, generator=gen, device=gen.device) * 0.1).to(torch.bfloat16)
    return (
        emb,
        p["w_ih"].to(torch.bfloat16),
        p["w_hh"].to(torch.bfloat16),
        (p["b_ih"] + p["b_hh"]).float(),
        torch.as_tensor(lens_np, device=gen.device),
        p,
    )


def phase_kernels(torch):
    """Kernel vs plain version at full width and ragged shapes, with timings."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
        MAX_UNEQUAL_SHARE as share,
        bf16_agreement,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    L, B, D = 10, 32768, 512
    H = D
    lens = synth_lengths(rng, B, L)
    emb, wih, whh, bias, lens_t, p = lstm_inputs(torch, gen, L, B, D, H, lens)
    out = lk.lstm_encode_last_fused(emb, wih, whh, bias, lens_t)
    ref = lk.lstm_encode_last_plain(emb, wih, whh, bias, lens_t)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(), "kernel output not finite")
    agree = bf16_agreement(out, ref)
    print(f"lstm_last_fwd B={B} L={L} D=H={D} bf16: {agree} (tol {share:.0%})")
    check(agree.ok(), f"kernel disagrees with plain version: {agree}")
    max_err = agree.max_abs_err

    # the rule must fail a kernel that dropped the recurrent product or a bias
    faults = {
        "W_hh = 0": (emb, wih, torch.zeros_like(whh), bias, lens_t),
        "bias = b_ih only": (emb, wih, whh, p["b_ih"].float(), lens_t),
    }
    for fault, args in faults.items():
        planted = bf16_agreement(lk.lstm_encode_last_plain(*args), ref)
        print(f"planted fault {fault}: {planted}")
        check(not planted.ok(), f"the bf16 rule passes a planted fault ({fault}): {planted}")

    for b in (1, 37, 4099):
        lr = synth_lengths(rng, b, L)
        e, wi, wh, bi, ln, _ = lstm_inputs(torch, gen, L, b, D, H, lr)
        o = lk.lstm_encode_last_fused(e, wi, wh, bi, ln)
        r = lk.lstm_encode_last_plain(e, wi, wh, bi, ln)
        torch.cuda.synchronize()
        agree = bf16_agreement(o, r)
        print(f"lstm_last_fwd B={b} D=H={D}: {agree} (tol {share:.0%})")
        check(agree.ok(), f"kernel disagrees at B={b}: {agree}")
        max_err = max(max_err, agree.max_abs_err)

    ms = cuda_ms(lambda: lk.lstm_encode_last_fused(emb, wih, whh, bias, lens_t), iters=20)
    plain_ms = cuda_ms(lambda: lk.lstm_encode_last_plain(emb, wih, whh, bias, lens_t), iters=5)
    library_ms, library_note = library_lstm_ms(torch, p, emb, lens, ref)

    # the work these lengths need: every active (row, step) multiplies x by
    # W_ih; h by W_hh only from step 1 on (h_0 = 0).  Bytes: the active
    # token rows, both weights, bias and lengths read once, last written once.
    n_steps = int(np.maximum(lens, 1).sum())
    flops = n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H
    bytes_ = n_steps * D * 2 + (D + H) * 4 * H * 2 + 4 * H * 4 + B * 4 + B * H * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
    row = {
        "name": "lstm_last_fwd",
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_last_fwd.cu",
        "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:479",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    print(
        f"lstm_last_fwd timing B={B} L={L} d={D}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms} ms ({library_note}), bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}: {flops:.4e} FLOP, {bytes_:.4e} B, {n_steps} row-steps)"
    )
    return row


def library_lstm_ms(torch, p, emb, lens, ref):
    """One PyTorch call computing the same function: nn.LSTM over a packed
    sequence, whose h_n is each row's last state.  Timed, never used by the
    port."""
    D = emb.shape[2]
    H = p["w_hh"].shape[1]
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(p["w_ih"])
        lstm.weight_hh_l0.copy_(p["w_hh"])
        lstm.bias_ih_l0.copy_(p["b_ih"])
        lstm.bias_hh_l0.copy_(p["b_hh"])
    # cuDNN's flat weight buffer does not take bf16, so each call packs the
    # 4 MiB of weights anew (a few microseconds) and warns about it
    warnings.filterwarnings("ignore", message="RNN module weights are not part")
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        emb, torch.as_tensor(np.maximum(lens, 1)), enforce_sorted=True
    )
    try:
        with torch.no_grad():
            _, (h_n, _) = lstm(packed)
            torch.cuda.synchronize()
            diff = (h_n[0].float() - ref.float()).abs().max().item()
            ms = cuda_ms(lambda: lstm(packed), iters=10)
    except RuntimeError as e:  # a library build without bf16 LSTM support
        return None, f"nn.LSTM bf16 unavailable: {str(e).splitlines()[0]}"
    return ms, f"nn.LSTM packed bf16, max |h_n - plain| {diff:.3e}"


def ensure_dataset():
    if (DATA_DIR / "test.txt").exists():
        return 0.0
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(DATA_DIR),
         "--mentions", "2470000", "--relations", "50000", "--triples", "20000",
         "--ent-tokens", "200000", "--rel-tokens", "50000", "--eval-size", "1000",
         "--seed", str(SEED)],
        check=True, timeout=900,
    )
    return time.perf_counter() - t0


def first_names(path, n, skip=0):
    out = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f):
            if ln == 0 and line.startswith("#"):
                continue
            if ln > skip:
                out.append(line.split("\t")[0])
            if len(out) == n:
                break
    return out


def load_user_path(torch, device):
    """What cli.predict does before it serves: config, metadata, model,
    seeded init."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model

    args = load_config(str(FLAGSHIP), ["--dataset_dir", str(DATA_DIR)])
    meta = load_meta(args["dataset_dir"], tuple(args["experiment_settings"]["max_lengths_tuple"]))
    model = build_model(args["model"], meta, **args["model_config"])
    variables = model.init(torch.Generator(device=device).manual_seed(SEED))
    return args, meta, model, variables


def wall_ms(fn):
    """Host clock around one call whose result is on the host (predict
    returns numpy arrays, so the device work is finished)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def summary(ms):
    return {"n": len(ms), "median": float(np.median(ms)), "max": max(ms)}


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_main_path(torch, timings, device="cuda"):
    from open_knowledge_graph_embeddings_tpu_torch.cli import predict as cli_predict
    from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import lstm_encode_last_fused
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    timings["dataset_gen_s"] = ensure_dataset()
    t0 = time.perf_counter()
    args, meta, model, variables = load_user_path(torch, device)
    timings["meta_and_init_s"] = time.perf_counter() - t0
    ckpt = save_checkpoint(str(DATA_DIR.parent), "smoke_ckpt", variables, {"training_steps": 0})
    del variables
    print(f"model {args['model']} d={model.embedder.entity_dim} dtype={model.embedder.dtype} "
          f"entities={meta.entities_size} relations={meta.relations_size}")

    ents = first_names(DATA_DIR / "entity_id_map.txt", 2, skip=10)
    rels = first_names(DATA_DIR / "relation_id_map.txt", 2, skip=5)
    queries = [f"{ents[0]}|{rels[0]}|?", f"{ents[1]}|{rels[1]}|?",
               f"?|{rels[0]}|{ents[1]}", f"?|{rels[1]}|{ents[0]}"]
    chunk = 32768
    n_chunks = -(-meta.entities_size // chunk)
    rng = np.random.default_rng(SEED)
    nq = 1024
    ent_ids = rng.integers(meta.min_entities_size, meta.entities_size, nq)
    rel_ids = rng.integers(meta.min_relations_size, meta.relations_size, nq)
    n_timed = 10  # per direction: 20 timed batches, 20 timed single queries

    # ---- the main path: counts set to 0 just before, read just after
    lstm_encode_last_fused.launches = 0
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(queries) + "\n")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_predict.main([str(FLAGSHIP), "--resume", ckpt, "--dataset_dir", str(DATA_DIR),
                              "-k", "10", "--device", str(device)])
    finally:
        sys.stdin = stdin
    sync(torch, device)
    timings["cli_predict_s"] = time.perf_counter() - t0

    _, _, model, variables = load_user_path(torch, device)
    variables, _ = load_checkpoint(ckpt, variables)
    sync(torch, device)
    t0 = time.perf_counter()
    predictor = Predictor(model, variables)  # ids only: the cache encode alone is timed
    sync(torch, device)
    timings["cache_encode_s"] = time.perf_counter() - t0
    results, batch_ms, single_ms = {}, [], []
    for direction in ("subj", "obj"):
        kw = {direction: ent_ids, "rel": rel_ids, "k": 10}
        results[direction] = predictor.predict(**kw)  # first call, untimed
        for _ in range(n_timed):
            batch_ms.append(wall_ms(lambda: predictor.predict(**kw)))
        single_ms += [wall_ms(lambda: predictor.predict(
            **{direction: ent_ids[i : i + 1]}, rel=rel_ids[i : i + 1], k=10)) for i in range(n_timed)]
    timings[f"predict_{nq}_ms"] = summary(batch_ms)
    timings["predict_1_ms"] = summary(single_ms)
    launches = lstm_encode_last_fused.launches
    # ---- end of the main path

    # checks
    cli_lines = [ln.split(None, 2) for ln in out.getvalue().splitlines() if ln.strip()]
    check("!!" not in err.getvalue(), f"cli.predict rejected a query: {err.getvalue()[-500:]}")
    check(len(cli_lines) == 10 * len(queries), f"cli.predict printed {len(cli_lines)} lines")
    for qi in range(len(queries)):
        s = np.array([float(x[1]) for x in cli_lines[qi * 10 : (qi + 1) * 10]])
        check(np.isfinite(s).all() and (np.diff(s) <= 0).all(), f"cli scores not sorted: {s}")
    print("cli.predict:", out.getvalue().splitlines()[0].strip(), "...")
    E = meta.entities_size
    for direction, (scores, ids) in results.items():
        check(scores.shape == (nq, 10) and ids.shape == (nq, 10), f"{direction} shapes")
        check(np.isfinite(scores).all(), f"{direction}: non-finite scores")
        check((np.diff(scores, axis=1) <= 0).all(), f"{direction}: scores increase along k")
        check(((ids >= meta.min_entities_size) & (ids < E)).all(), f"{direction}: ids out of range")
    # encodes: the cache twice (cli.predict, Predictor), an entity and a
    # relation encode per query batch; each runs one launch per step
    encodes = 2 * n_chunks + 2 * (len(queries) + 2 * (1 + 2 * n_timed))
    want = encodes * meta.max_length[0]
    check(meta.max_length[0] == meta.max_length[1], "entity and relation lengths differ")
    check(launches == want, f"lstm kernel launched {launches} times, want {want}")
    print(f"main path: lstm_last_fwd launches={launches} = {encodes} encodes ({n_chunks} cache "
          f"chunks x 2 + query encodes) x L={meta.max_length[0]} steps")

    check_against_plain(torch, model, predictor, ent_ids, rel_ids)
    if torch.device(device).type == "cuda":
        ids = torch.arange(meta.min_entities_size, meta.min_entities_size + chunk, device=device)
        with torch.no_grad():
            device_breakdown(torch, f"cache chunk encode ({chunk} rows)",
                             lambda: model.embedder.encode_entity(predictor.variables, ids))
        device_breakdown(torch, f"predict ({nq} subj queries, k=10)",
                         lambda: predictor.predict(subj=ent_ids, rel=rel_ids, k=10))
    return launches


def device_breakdown(torch, label, fn, top=8):
    """Device time by kernel of one call of ``fn`` under torch.profiler, and
    the device's busy share of the call's wall time (host clock, profiler on,
    so the host side is slower than unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        print(f"profile {label}: no device time in the trace (not measured)")
        return
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:100]}")


def check_against_plain(torch, model, predictor, ent_ids, rel_ids):
    """Sampled cache rows and top-k scores against a plain encode on the CPU."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
        MAX_UNEQUAL_SHARE as share,
        bf16_agreement,
    )

    def to_cpu(tree):
        return {k: to_cpu(x) if isinstance(x, dict) else x.cpu() for k, x in tree.items()}

    cpu = to_cpu(predictor.variables)
    rng = np.random.default_rng(SEED + 1)
    off = predictor.offset
    ids = torch.as_tensor(rng.integers(off, predictor.meta.entities_size, 4096))
    want, _, _ = model.embedder.encode_entity(cpu, ids)
    got = predictor.cand_emb[(ids - off).to(predictor.device)].cpu()
    agree = bf16_agreement(got, want)
    print(f"cache rows vs plain CPU encode (4096 ids): {agree} (tol {share:.0%})")
    check(agree.ok(), f"cache rows disagree with the plain encode: {agree}")

    n = 16
    e, r = torch.as_tensor(ent_ids[:n]), torch.as_tensor(rel_ids[:n])
    is_sp = torch.ones(n, dtype=torch.bool)
    q, _, _ = model.queries(cpu, e, r, is_sp)
    want_s = torch.topk(score_against_candidates(q.to(predictor.device), predictor.cand_emb), 10)
    want_s = want_s.values.cpu().numpy()
    got_s, _ = predictor.predict(subj=ent_ids[:n], rel=rel_ids[:n], k=10)
    rel_err = np.abs(got_s - want_s).max() / max(np.abs(want_s).max(), 1e-6)
    print(f"top-10 scores vs plain CPU queries ({n} queries): max rel err={rel_err:.3e} (tol {SCORE_RTOL:.3e})")
    check(rel_err <= SCORE_RTOL, f"top-k scores disagree with the plain path: {rel_err}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / PKG).is_dir() or not FLAGSHIP.exists():
        print(f"chip_smoke: run from a checkout of the repository ({PKG}/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    timings = {}
    try:
        t0 = time.perf_counter()
        cuda_build.build(["lstm_last_fwd.cu"])
        timings["build_s"] = time.perf_counter() - t0
        for name, log in cuda_build.BUILD_LOGS.items():
            info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            print(f"nvcc {name}: " + " | ".join(info))
        print(f"build: {timings['build_s']:.2f} s")
        row = phase_kernels(torch)
        row["launches"] = phase_main_path(torch, timings)
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print("timings: " + json.dumps(timings))
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
