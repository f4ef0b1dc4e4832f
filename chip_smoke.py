#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. print the card's name and power limit (nvidia-smi);
2. build every kernel from the checkout: the CUDA sources of ``csrc/`` with
   one nvcc each, all started together, and the two Triton kernels (compiled
   by a first launch on a few elements); print the build seconds;
3. hold the forward LSTM kernel against its plain PyTorch version at the
   serving shapes (B=32768) and at ragged B, with two planted faults;
4. the training path, the way a user drives it, at the flagship's full width
   (``configs/olpbench/synth-olpbench-2m47-demo.yaml``: LSTM-ComplEx, d=512,
   bf16, sparse token tables, Adagrad, 4096 prefixes x 4096 batch-shared
   candidates): generate the 2.47M-mention synthetic set with
   ``tools/make_synth_olpbench.py`` (80000 triples, so one epoch has >= 20
   steps of 4096, counted on the CPU first), then ``cli.train --epochs 2``
   (two passes, by the reference's epoch rule) with every kernel's launch
   count set to 0 just before and read just after.  The inputs of the first step to each training kernel are
   recorded on the way;
5. check the training run: every kernel launched (and how often), the loss
   finite and falling, which tables went row-sparse on how many steps, and
   the checkpoint (optimizer state included) loading back; then time steps
   after warm-up (median and max ms/step, items/s), the host plan per batch,
   and a torch.profiler breakdown of one step by device kernel;
6. hold each training kernel against its plain version on the recorded
   first-step inputs (the entity and the relation pass of the LSTM forward
   with its hs/cs residuals and of the LSTM backward; an LSTM weight for the
   dense Adagrad; both token tables for the row update) and at ragged
   shapes, with planted faults that must fail (among them misplaced bf16
   rounding points), print the yardsticks of the backward's share rule, and
   time the kernel, the plain version and one PyTorch library call where
   one computes the same function;
7. the serving path on the trained checkpoint: ``cli.predict`` answers text
   queries and ``Predictor.predict`` batches of 1024 queries, with the launch
   counts set to 0 just before and read just after; check ids, scores, cache
   rows and top-k scores against a plain CPU encode;
8. print the timings, one JSON line with every kernel's numbers, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Needs one card; writes only under ``.bench_cache/``
and the package's ``_build/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "open_knowledge_graph_embeddings_tpu_torch"
FLAGSHIP = ROOT / "configs" / "olpbench" / "synth-olpbench-2m47-demo.yaml"
DATA_DIR = ROOT / ".bench_cache" / "synth_olp_2m47_smoke"
TRAIN_DIR = ROOT / ".bench_cache" / "smoke_train"
SEED = 0
# OLPBench's vocabulary sizes; 80000 triples give 104626 training prefixes,
# 25 steps of 4096 (counted on the CPU); serving reads only the vocabulary
DATA_ARGS = ["--mentions", "2470000", "--relations", "50000", "--triples", "80000",
             "--ent-tokens", "200000", "--rel-tokens", "50000", "--eval-size", "1000", "--seed", str(SEED)]
MIN_TRAIN_STEPS = 20
TRAIN_ARGS = [str(FLAGSHIP), "--dataset_dir", str(DATA_DIR), "--eval_epoch_freq", "0", "--epochs", "2",
              "--experiment_dir", str(TRAIN_DIR)]

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
# The LSTM backward's db sums the unrounded f32 dgates over every active
# (row, step) in another order than the plain version: held to 1e-4 of
# max|db| (measured ~1e-5 on an H100 at d=512; a dropped dc*f carry or a
# skipped dlast injection moves db by tens of percent).  demb and dW are bf16
# and held to the bf16 rule with the backward's share of unequal elements
# (utils/numerics.py MAX_UNEQUAL_SHARE_BWD).
DB_RTOL = 1e-4


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
    """Generate the smoke dataset unless one made with the same arguments
    is there (a cached set of another triple count is made anew)."""
    marker = DATA_DIR / ".smoke_args"
    if (DATA_DIR / "test.txt").exists() and marker.exists() and marker.read_text() == " ".join(DATA_ARGS):
        return 0.0
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(DATA_DIR), *DATA_ARGS],
                   check=True, timeout=900)
    marker.write_text(" ".join(DATA_ARGS))
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


def load_user_path(torch):
    """What cli.predict does before it serves: config, metadata, model,
    seeded init."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model

    args = load_config(str(FLAGSHIP), ["--dataset_dir", str(DATA_DIR)])
    meta = load_meta(args["dataset_dir"], tuple(args["experiment_settings"]["max_lengths_tuple"]))
    model = build_model(args["model"], meta, **args["model_config"])
    variables = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    return args, meta, model, variables


def wall_ms(fn):
    """Host clock around one call whose result is on the host (predict
    returns numpy arrays, so the device work is finished)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def summary(ms):
    return {"n": len(ms), "median": float(np.median(ms)), "max": max(ms)}


def phase_main_path(torch, timings, ckpt=None):
    """The serving path on ``ckpt`` (a seeded random init when None)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import predict as cli_predict
    from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import lstm_encode_last_fused
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    timings.setdefault("dataset_gen_s", ensure_dataset())
    t0 = time.perf_counter()
    args, meta, model, variables = load_user_path(torch)
    timings["meta_and_init_s"] = time.perf_counter() - t0
    if ckpt is None:
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
                              "-k", "10", "--device", "cuda"])
    finally:
        sys.stdin = stdin
    torch.cuda.synchronize()
    timings["cli_predict_s"] = time.perf_counter() - t0

    _, _, model, variables = load_user_path(torch)
    variables, _ = load_checkpoint(ckpt, variables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor = Predictor(model, variables)  # ids only: the cache encode alone is timed
    torch.cuda.synchronize()
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
    ids = torch.arange(meta.min_entities_size, meta.min_entities_size + chunk, device="cuda")
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


# ------------------------------------------------------------------ training


class Capture:
    """Records the first training step's inputs to each training kernel: the
    two LSTM forward launches that write the hs/cs residuals (entity pass,
    then relation pass) with what they returned, the two LSTM backward
    launches (relation pass, then entity pass), the dense Adagrad of one
    [2048, 512] LSTM weight and the row updates of the token tables (p and
    acc cloned before the in-place update).  It wraps the modules' CUDA
    launchers and calls them through, so the wrappers launch and count as
    they do without it."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel, lstm_kernel, scatter_adagrad_kernel

        self.fwd, self.bwd, self.dense, self.rows = [], [], None, []
        self._patches = [(lstm_kernel, "_launch_backward", self._bwd),
                         (adagrad_kernel, "_launch", self._dense),
                         (scatter_adagrad_kernel, "_launch", self._rows),
                         (lstm_kernel, "_launch_forward", self._fwd)]
        self._orig = [getattr(mod, name) for mod, name, _ in self._patches]

    def __enter__(self):
        for mod, name, fn in self._patches:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), orig in zip(self._patches, self._orig):
            setattr(mod, name, orig)

    def _bwd(self, *args):
        if len(self.bwd) < 2:
            self.bwd.append(args)
        return self._orig[0](*args)

    def _dense(self, g, p, acc, clr, wd, eps):
        if self.dense is None and tuple(p.shape) == (2048, 512):
            self.dense = (g.clone(), p.clone(), acc.clone(), clr.clone(), wd, eps)
        return self._orig[1](g, p, acc, clr, wd, eps)

    def _rows(self, g_rows, uids, valid, p, acc, clr, wd, eps):
        if len(self.rows) < 2:
            self.rows.append((g_rows.clone(), uids.clone(), valid.clone(), p.clone(), acc.clone(), clr.clone(),
                              wd, eps))
        return self._orig[2](g_rows, uids, valid, p, acc, clr, wd, eps)

    def _fwd(self, emb_tm, w_ih, w_hh, bias, lengths, residuals):
        out = self._orig[3](emb_tm, w_ih, w_hh, bias, lengths, residuals)
        if residuals and len(self.fwd) < 2:
            last, hs, cs = out
            self.fwd.append(((emb_tm, w_ih, w_hh, bias, lengths), (last.clone(), hs, cs)))
        return out


def kernel_counters():
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel, lstm_kernel, scatter_adagrad_kernel

    return {"lstm_last_fwd": lstm_kernel.lstm_encode_last_fused, "lstm_last_bwd": lstm_kernel.lstm_last_backward,
            "adagrad_update": adagrad_kernel.adagrad_update,
            "scatter_adagrad": scatter_adagrad_kernel.scatter_adagrad}


def count_train_steps():
    """Training prefixes and steps of the smoke set, built on the CPU (this
    also writes the metadata and records caches the run then reads)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    args = load_config(TRAIN_ARGS[0], TRAIN_ARGS[1:])
    ds = setup_dataset(args)
    return len(ds), len(ds) // ds.batch_size


def phase_train(torch, timings):
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train

    timings["dataset_gen_s"] = ensure_dataset()
    t0 = time.perf_counter()
    n_records, n_steps = count_train_steps()
    timings["train_records_s"] = time.perf_counter() - t0
    print(f"training set: {n_records} prefixes, {n_steps} steps of 4096 (counted on the CPU)")
    check(n_steps >= MIN_TRAIN_STEPS, f"one epoch has {n_steps} steps, want >= {MIN_TRAIN_STEPS}")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    # ---- the training path: counts set to 0 just before, read just after
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Capture() as capture:
        trainer = cli_train.cli_main(TRAIN_ARGS + ["--device", "cuda"])
    torch.cuda.synchronize()
    timings["cli_train_s"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    # ---- end of the training path
    return trainer, capture, launches, n_steps


def check_training(torch, trainer, launches, n_steps):
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint, load_opt_state
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    log = trainer.step_log
    # epoch = floor(steps / (len + 1)) + 1, the reference's rule: `epochs: 2`
    # runs two passes over the data
    check(len(log) == 2 * n_steps, f"cli.train ran {len(log)} steps, want 2 passes of {n_steps}")
    n_steps = len(log)
    losses = np.array([float(s["loss"]) for s in log])
    check(np.isfinite(losses).all(), f"non-finite training loss: {losses}")
    first, last = losses[:3].mean(), losses[-3:].mean()
    print(f"training loss per step: {np.array2string(losses, precision=5, max_line_width=200)}")
    check(last < first, f"the loss did not fall over the epoch: first 3 steps {first:.5f}, last 3 {last:.5f}")
    sparse = Counter(t for s in log for t in s["sparse_tables"])
    print(f"cli.train: {n_steps} steps (2 passes); row-sparse updates: {dict(sparse)} of {n_steps} steps "
          "(the rest dense)")
    L = trainer.model.meta.max_length[0]
    n_sparse = sum(sparse.values())
    n_dense = 12 * n_steps + 2 * n_steps - n_sparse  # 12 LSTM and batchnorm leaves + dense tables
    want = {"lstm_last_fwd": 2 * n_steps * L, "lstm_last_bwd": 2 * n_steps * (2 * L + 1),
            "adagrad_update": n_dense, "scatter_adagrad": n_sparse}
    print(f"training path launches: {launches} (want {want}: two LSTM passes per step, one launch per step "
          f"forward, 2 per step + 1 backward; one dense Adagrad per dense leaf, one row update per sparse table)")
    check(all(launches[k] > 0 for k in want), f"a training kernel was never launched: {launches}")
    check(launches == want, f"training launches {launches}, want {want}")

    ckpt = Path(trainer.save_path) / "checkpoint0"
    variables, meta = load_checkpoint(str(ckpt), trainer.model.init(torch.Generator(device="cuda").manual_seed(1)))
    opt = load_opt_state(str(ckpt), trainer.regimes.init_state(variables["params"]))
    flat = lambda tree: dict(leaves(tree))  # noqa: E731
    for got, want_tree in ((variables["params"], trainer.variables["params"]),
                           (variables["state"], trainer.variables["state"]), (opt, trainer.opt_state)):
        g, w = flat(got), flat(want_tree)
        check(set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w), "checkpoint does not load back")
    check(meta["training_steps"] == n_steps, f"checkpoint training_steps {meta['training_steps']}")
    print(f"checkpoint {ckpt.name}: params, batchnorm state and {len(flat(opt))} optimizer leaves load back equal")
    return str(ckpt)


def time_train_steps(torch, trainer, timings, n=8):
    """Steps after warm-up with a synchronize around each (device-bound, no
    host overlap), the host plan per batch, and a profile of one step."""
    builder, plan = trainer.train_builder, trainer._sparse_plan
    order = np.random.default_rng(SEED + 1).permutation(len(builder.rec))
    batch_ms, plan_ms, batches = [], [], []
    for i in range(n + 1):
        t0 = time.perf_counter()
        batches.append(builder.build(order[i * builder.batch_size : (i + 1) * builder.batch_size]))
        t1 = time.perf_counter()
        plan(batches[-1])
        batch_ms.append((t1 - t0) * 1e3)
        plan_ms.append((time.perf_counter() - t1) * 1e3)
    dev = [trainer._to_device(b)[1] for b in batches]
    step_ms, positives = [], 0.0
    for i, arrays in enumerate(dev[:n]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.variables, trainer.opt_state, stats = trainer.train_step(
            trainer.variables, trainer.opt_state, trainer.regimes.hparams(), arrays, trainer.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        positives += float(stats["normalizer_metric"])
    timings["train_step_ms"] = summary(step_ms)
    timings["train_items_per_s"] = positives / (sum(step_ms) / 1e3)
    timings["host_plan_ms_per_batch"] = summary(plan_ms)
    timings["host_batch_ms_per_batch"] = summary(batch_ms)
    timings["cli_epoch_items_per_s"] = trainer.last_epoch["items_per_s"]
    timings["cli_epoch_host_wait_ms"] = summary([s["wait_ms"] for s in trainer.step_log[1:]])
    print(f"train step (synchronized, after warm-up): median {np.median(step_ms):.3f} ms, max {max(step_ms):.3f} ms, "
          f"{timings['train_items_per_s']:.0f} items/s; host plan {np.median(plan_ms):.3f} ms/batch, "
          f"batch build {np.median(batch_ms):.3f} ms/batch (one host thread each); cli epoch "
          f"{timings['cli_epoch_items_per_s']:.0f} items/s")
    device_breakdown(torch, "train step (4096 x 4096, d=512, bf16)", lambda: trainer.train_step(
        trainer.variables, trainer.opt_state, trainer.regimes.hparams(), dev[n], trainer.generator), top=12)


def active_mask(torch, args):
    """[L, B]: the positions each row reaches (step < max(len, 1))."""
    lens = args[4]
    return torch.arange(args[0].shape[0], device=lens.device)[:, None] < lens.clamp(min=1)[None, :]


def plain_c_f32(torch, args, hs):
    """The plain forward's cell states in f32, recomputed from ``hs`` (its
    residual cs is their bf16 rounding): the input of two planted faults."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import _gates

    emb, w_ih, w_hh, bias = args[:4]
    c, out = 0.0, []
    for t in range(emb.shape[0]):
        h_prev = hs[t - 1] if t else torch.zeros_like(hs[0])
        i, f, g, _ = _gates(emb[t], h_prev, w_ih.float().t(), w_hh.float().t(), bias).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        out.append(c)
    return torch.stack(out)


def residual_agreement(torch, args, got, want):
    """Kernel 1's training outputs against the plain version's by the bf16
    rule: last, and hs and cs at the positions each row reaches (the kernel
    leaves the others unwritten)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import bf16_agreement

    act = active_mask(torch, args)
    agree = {"last": bf16_agreement(got[0], want[0]), "hs": bf16_agreement(got[1][act], want[1][act]),
             "cs": bf16_agreement(got[2][act], want[2][act])}
    text = "; ".join(f"{k} {a}" for k, a in agree.items())
    return all(a.ok() for a in agree.values()), text, max(a.max_abs_err for a in agree.values())


def check_lstm_residuals(torch, captured):
    """Kernel 1 with residuals (the training forward) against its plain
    version on the first step's entity and relation passes, as the training
    run launched it, with planted faults; returns the largest error."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE as share

    max_err = 0.0
    for name, (args, got) in zip(("entity pass", "relation pass"), captured):
        want = lk.lstm_encode_last_plain(*args, residuals=True)
        ok, text, err = residual_agreement(torch, args, got, want)
        print(f"lstm_last_fwd with residuals, training {name} B={args[0].shape[1]}: {text} (tol {share:.0%})")
        check(ok, f"the forward kernel's residuals disagree with the plain version on the {name}")
        max_err = max(max_err, err)

    # planted faults: hs written one step late, cs stored in f32 (not rounded)
    args, got = captured[0]
    last, hs, cs = lk.lstm_encode_last_plain(*args, residuals=True)
    c32 = plain_c_f32(torch, args, hs)
    check(torch.equal(c32.to(cs.dtype), cs), "the f32 cell states do not round to the plain version's cs")
    faults = {"hs one step late": (last, torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), cs),
              "cs not rounded to bf16": (last, hs, c32)}
    for fault, planted in faults.items():
        ok, text, _ = residual_agreement(torch, args, got, planted)
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    return max_err


def backward_agreement(torch, args, got, want):
    """Kernel 2's outputs against the plain version's: demb at the positions
    each row reaches and both dW by the bf16 rule with the backward's share,
    db to DB_RTOL of max|db|.  Returns (ok, text, largest error)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE_BWD, bf16_agreement

    want = [w.to(got[0].device) for w in want]
    act = active_mask(torch, args).to(got[0].device)
    agree = [bf16_agreement(got[0][act], want[0][act]), bf16_agreement(got[1], want[1]),
             bf16_agreement(got[2], want[2])]
    db_err = (got[3] - want[3]).abs().max().item()
    db_ok = db_err <= DB_RTOL * want[3].abs().max().item()
    ok = all(a.ok(MAX_UNEQUAL_SHARE_BWD) for a in agree) and db_ok
    text = (f"demb {agree[0]}; dW_ih {agree[1]}; dW_hh {agree[2]}; db max err {db_err:.3e} "
            f"({db_err / max(want[3].abs().max().item(), 1e-30):.2e} of max|db|, tol {DB_RTOL})")
    return ok, text, max([a.max_abs_err for a in agree] + [db_err])


def demb_shares_by_step(torch, args, got, want):
    """The share of demb elements not bit-equal, step by step."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import bf16_agreement

    act = active_mask(torch, args).to(got[0].device)
    shares = [bf16_agreement(got[0][t][act[t]], want[0][t].to(got[0].device)[act[t]]).unequal_share
              for t in range(len(act))]
    return f"  demb unequal share by step t=0..{len(act) - 1}: " + " ".join(f"{x:.2%}" for x in shares)


def check_backward_faults(torch, args, kernel_out):
    """Planted faults in the plain backward must fail the rule against the
    kernel's ``kernel_out`` on ``args``: two in the cell arithmetic, and two
    misplaced bf16 rounding points (c_t read in f32; dgates not rounded
    before the products: the plain version at f32 on the same bf16 values,
    its outputs rounded where the bf16 version rounds them)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    emb, w_ih, w_hh, bias, lens, hs, cs, dlast = args
    L = emb.shape[0]
    c32 = plain_c_f32(torch, args, hs)
    cell = lk._bwd_cell
    steps = []

    def c_t_f32(g, cp, ct, dh, dc, dl):
        steps.append(L - 1 - len(steps))  # the plain version walks t = L-1 .. 0
        return cell(g, cp, c32[steps[-1]], dh, dc, dl)

    def unrounded_dgates():
        out = lk.lstm_last_backward_plain(*(x.float() for x in (emb, w_ih, w_hh)), bias, lens,
                                          *(x.float() for x in (hs, cs, dlast)))
        return (*(x.to(emb.dtype) for x in out[:3]), out[3])

    def with_cell(fn):
        def run():
            lk._bwd_cell = fn
            try:
                return lk.lstm_last_backward_plain(*args)
            finally:
                lk._bwd_cell = cell
        return run

    faults = {
        "dc*f carry dropped": with_cell(
            lambda g, cp, ct, dh, dc, dl: (cell(g, cp, ct, dh, dc, dl)[0], torch.zeros_like(dc))),
        "dlast injection skipped": with_cell(
            lambda g, cp, ct, dh, dc, dl: cell(g, cp, ct, dh, dc, torch.zeros_like(dl))),
        "c_t read in f32": with_cell(c_t_f32),
        "dgates not rounded before the products": unrounded_dgates,
    }
    for fault, run in faults.items():
        planted = run()
        ok, text, _ = backward_agreement(torch, args, kernel_out, planted)
        print(f"planted fault {fault}: {text}")
        print(demb_shares_by_step(torch, args, kernel_out, planted))
        check(not ok, f"the rule passes a planted fault ({fault})")


def check_lstm_backward(torch, captured):
    """Kernel 2 against its plain version on the first step's entity and
    relation passes and at ragged B (with kernel 1's residuals there); the
    share rule's yardsticks; planted faults; timings."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    max_err = 0.0
    # autograd runs the relation pass's backward first (it was encoded last)
    relation, entity = captured
    plain = {}
    for name, args in (("entity pass", entity), ("relation pass", relation)):
        got = lk.lstm_last_backward(*args)
        want = plain[name] = lk.lstm_last_backward_plain(*args)
        torch.cuda.synchronize()
        ok, text, err = backward_agreement(torch, args, got, want)
        print(f"lstm_last_bwd {name} B={args[0].shape[1]} L={args[0].shape[0]} D=H={args[0].shape[2]}: {text}")
        print(demb_shares_by_step(torch, args, got, want))
        check(ok, f"LSTM backward kernel disagrees with its plain version on the {name}")
        max_err = max(max_err, err)
    # the yardsticks of the share rule, on the relation pass: the plain
    # version on the card against the same on the CPU (f32 products in other
    # summation orders), and the plain version with tensor-core products
    # (TF32, exact for bf16 operands, f32 accumulation as in the kernel's
    # mma) against the same with f32 SIMT products
    args = relation
    cpu_want = lk.lstm_last_backward_plain(*(x.cpu() for x in args))
    _, text, _ = backward_agreement(torch, args, plain["relation pass"], cpu_want)
    print(f"lstm_last_bwd relation pass, plain on the card vs plain on the CPU: {text}")
    print(demb_shares_by_step(torch, args, plain["relation pass"], cpu_want))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tensor_core = lk.lstm_last_backward_plain(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, text, _ = backward_agreement(torch, args, tensor_core, plain["relation pass"])
    print(f"lstm_last_bwd relation pass, plain with TF32 tensor-core products vs plain with f32 products: {text}")
    print(demb_shares_by_step(torch, args, tensor_core, plain["relation pass"]))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    fwd_err = 0.0
    # ragged B with the synthetic lengths, and lengths uniform in 0..10 (rows
    # of length 0 and 1, and more long rows: the share of unequal elements
    # runs higher there)
    cases = [(f"B={b}", synth_lengths(rng, b)) for b in (1, 37, 4099)]
    cases.append(("B=37, lengths uniform in 0..10", np.sort(rng.integers(0, 11, 37)).astype(np.int32)[::-1].copy()))
    for label, lens in cases:
        b = len(lens)
        emb, wih, whh, bias, lens_t, _ = lstm_inputs(torch, gen, 10, b, 512, 512, lens)
        fwd_args = (emb, wih, whh, bias, lens_t)
        last, hs, cs = lk._forward(*fwd_args, residuals=True)
        ok, text, err = residual_agreement(torch, fwd_args, (last, hs, cs),
                                           lk.lstm_encode_last_plain(*fwd_args, residuals=True))
        print(f"lstm_last_fwd with residuals {label}: {text}")
        check(ok, f"the forward kernel's residuals disagree at {label}")
        fwd_err = max(fwd_err, err)
        dlast = (torch.randn(b, 512, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        args = (*fwd_args, hs, cs, dlast)
        got, want = lk.lstm_last_backward(*args), lk.lstm_last_backward_plain(*args)
        ok, text, err = backward_agreement(torch, args, got, want)
        print(f"lstm_last_bwd {label}: {text}")
        check(ok, f"LSTM backward kernel disagrees at {label}")
        max_err = max(max_err, err)

    args = entity
    check_backward_faults(torch, args, lk.lstm_last_backward(*args))

    ms = cuda_ms(lambda: lk.lstm_last_backward(*args), iters=10)
    plain_ms = cuda_ms(lambda: lk.lstm_last_backward_plain(*args), iters=3)
    library_ms, note = library_lstm_backward_ms(torch, args)
    emb, w_ih, w_hh, bias, lens = args[:5]
    L, B, D = emb.shape
    H = w_hh.shape[1]
    lens_np = lens.clamp(min=1).cpu().numpy()
    n_steps = int(lens_np.sum())
    # 3x the forward's work: gate recompute, demb and dW_ih per active
    # row-step; dh, the h half of the recompute and dW_hh from step 1 on
    flops = 3 * (n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H)
    bytes_ = (n_steps * (D + 2 * H) * 2 + B * H * 2 + B * 4 + 4 * H * 4  # emb, hs, cs, dlast, lens, bias in
              + 2 * 4 * H * (D + H) * 2  # both weights in, both dW out
              + n_steps * D * 2 + 4 * H * 4)  # demb, db out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
    print_unported_bounds(L, B, D, H, n_steps)
    print(f"lstm_last_bwd timing entity pass B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms} ms ({note}), bound {max(t_ops, t_bytes):.4f} ms ({flops:.4e} FLOP, {bytes_:.4e} B, "
          f"{n_steps} row-steps)")
    return {"name": "lstm_last_bwd", "route": "cuda", "source": f"{PKG}/csrc/lstm_last_bwd.cu",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:569",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}, fwd_err


def print_unported_bounds(L, B, D, H, n_steps):
    """Bounds of the TPU kernels not ported yet (PERF.md rows 5-8) at the
    entity pass's shape: L steps, B rows, n_steps active row-steps.  Rows 5
    and 6 are the fused length-aware LSTM writing every hs (and its backward
    with a full dhs): the work of rows 1 and 2, plus the hs/cs (and dhs)
    bytes.  Rows 7 and 8 are the scan recurrence over a precomputed
    x_proj [L, B, 4H]: every row every step, the h products from step 1 on
    (the backward: the recompute and dh; its dW is an einsum outside the
    kernel)."""
    fwd_ops = n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H
    w = (D + H) * 4 * H * 2
    rows = {
        5: (fwd_ops, n_steps * D * 2 + w + 4 * H * 4 + 2 * n_steps * H * 2),
        6: (3 * fwd_ops, n_steps * (D + 3 * H) * 2 + 2 * w + 4 * H * 4 + n_steps * D * 2 + 4 * H * 4),
        7: ((L - 1) * B * 2 * H * 4 * H, L * B * 4 * H * 2 + H * 4 * H * 2 + 2 * L * B * H * 2),
        8: (2 * (L - 1) * B * 2 * H * 4 * H, L * B * (4 * H + 3 * H) * 2 + H * 4 * H * 2 + L * B * 4 * H * 2),
    }
    for row, (ops, bytes_) in rows.items():
        t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
        print(f"bound of TPU kernel row {row} (not ported) at L={L} B={B} D=H={D}, {n_steps} row-steps: "
              f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
              f"{ops:.4e} FLOP, {bytes_:.4e} B)")


def library_lstm_backward_ms(torch, args):
    """cuDNN's packed ``nn.LSTM`` backward on the same inputs and cotangent
    (h_n's gradient into the inputs and weights), timed alone over a
    retained graph; never used by the port."""
    emb, w_ih, w_hh, bias, lens, _, _, dlast = args
    D, H = emb.shape[2], w_hh.shape[1]
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih)
        lstm.weight_hh_l0.copy_(w_hh)
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    warnings.filterwarnings("ignore", message="RNN module weights are not part")
    x = emb.detach().clone().requires_grad_()
    try:
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens.clamp(min=1).cpu(), enforce_sorted=True)
        _, (h_n, _) = lstm(packed)
        grad = dlast[None]
        ms = cuda_ms(lambda: h_n.backward(grad, retain_graph=True), iters=10)
    except RuntimeError as e:  # a library build without bf16 LSTM backward
        return None, f"nn.LSTM bf16 backward unavailable: {str(e).splitlines()[0]}"
    return ms, "nn.LSTM packed bf16 backward (cuDNN), h_n cotangent into inputs and weights"


def _adagrad_state(torch, gen, shape):
    g = torch.randn(*shape, generator=gen, device="cuda") * 1e-2
    p = torch.randn(*shape, generator=gen, device="cuda") * 0.1
    acc = torch.rand(*shape, generator=gen, device="cuda")
    return g, p, acc


def check_adagrad(torch, captured, table_heights):
    """Kernel 3 bit-equal to its plain version on the first step's LSTM
    weight, at the token tables' padded heights and at a ragged height;
    timings; torch.optim.Adagrad as the library yardstick."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    g, p, acc, clr, wd, eps = captured
    cases = [("LSTM weight, first step", (g, p, acc, clr, wd, eps))]
    for h in (*table_heights, 1234):
        cases.append((f"[{h}, 512]", (*_adagrad_state(torch, gen, (h, 512)), clr, 1e-3, eps)))
    max_err = 0.0
    for name, (g_, p_, a_, c_, w_, e_) in cases:
        p1, a1, p2, a2 = p_.clone(), a_.clone(), p_.clone(), a_.clone()
        ak.adagrad_update(g_, p1, a1, c_, w_, e_)
        ak.adagrad_update_plain(g_, p2, a2, c_, w_, e_)
        torch.cuda.synchronize()
        err = max((p1 - p2).abs().max().item(), (a1 - a2).abs().max().item())
        print(f"adagrad_update {name}: max abs err {err:.3e}, bit-equal {torch.equal(p1, p2) and torch.equal(a1, a2)}")
        check(torch.equal(p1, p2) and torch.equal(a1, a2), f"dense Adagrad kernel is not bit-equal at {name}")
        max_err = max(max_err, err)
    p1, a1 = p.clone(), acc.clone()
    ms = cuda_ms(lambda: ak.adagrad_update(g, p1, a1, clr, wd, eps), iters=50)
    plain_ms = cuda_ms(lambda: ak.adagrad_update_plain(g, p1, a1, clr, wd, eps), iters=50)
    library_ms, note = library_adagrad_ms(torch, g, p, acc, clr.item(), wd, eps)
    bytes_ = 5 * 4 * p.numel()  # read g, p, acc; write p, acc
    bound = bytes_ / PEAK_BYTES_PER_S * 1e3
    print(f"adagrad_update timing {list(p.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms} ms ({note}), bound {bound:.4f} ms (bytes: {bytes_:.4e} B)")
    return {"name": "adagrad_update", "route": "triton", "source": f"{PKG}/ops/adagrad_kernel.py",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/adagrad_kernel.py:28",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms}


def library_adagrad_ms(torch, g, p, acc, lr, wd, eps):
    """``torch.optim.Adagrad.step`` on the same tensor, in the fastest form
    this torch has (fused, else foreach); never used by the port."""
    for form in ("fused", "foreach"):
        param = torch.nn.Parameter(p.clone())
        param.grad = g.clone()
        try:
            opt = torch.optim.Adagrad([param], lr=lr, weight_decay=wd, eps=eps, **{form: True})
            opt.step()
        except (RuntimeError, TypeError, ValueError) as e:
            last = f"{form}: {str(e).splitlines()[0]}"
            continue
        return cuda_ms(opt.step, iters=50), f"torch.optim.Adagrad({form}=True).step"
    return None, f"torch.optim.Adagrad unavailable ({last})"


def check_row_adagrad(torch, captured):
    """Kernel 4 bit-equal to its plain version on the first step's two token
    tables and at a ragged height with padding entries on row 0 (weight
    decay on); a plain version that also writes a padding entry must fail."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sk

    def faulty(g, uids, valid, p, acc, clr, wd, eps):
        """Also read-modify-writes the first padding entry's row."""
        sk.scatter_adagrad_plain(g, uids, valid, p, acc, clr, wd, eps)
        pad = torch.nonzero(~valid)[:1, 0]
        sk.scatter_adagrad_plain(g[pad], uids[pad], torch.ones_like(valid[pad]), p, acc, clr, wd, eps)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    V, U, n = 1234, 512, 300
    g, p, acc = _adagrad_state(torch, gen, (V, 512))
    uids = torch.zeros(U, dtype=torch.long, device="cuda")
    uids[1:n] = torch.randperm(V - 1, generator=gen, device="cuda")[: n - 1].sort().values + 1
    valid = torch.arange(U, device="cuda") < n
    cases = [(f"{t} table, first step", c) for t, c in zip(("entity token", "relation token"), captured)]
    cases.append((f"ragged [{V}, 512], {U - n} padding entries on row 0, wd 1e-2",
                  (g[:U], uids, valid, p, acc, captured[0][5], 1e-2, 1e-10)))
    max_err = 0.0
    for name, (g_, u_, v_, p_, a_, c_, w_, e_) in cases:
        outs = []
        for fn in (sk.scatter_adagrad, sk.scatter_adagrad_plain, faulty):
            p1, a1 = p_.clone(), a_.clone()
            fn(g_, u_, v_, p1, a1, c_, w_, e_)
            outs.append((p1, a1))
        torch.cuda.synchronize()
        (pk, ak_), (pp, ap), (pf, af) = outs
        err = max((pk - pp).abs().max().item(), (ak_ - ap).abs().max().item())
        fault_err = max((pk - pf).abs().max().item(), (ak_ - af).abs().max().item())
        print(f"scatter_adagrad {name}: {int(v_.sum())} of {len(u_)} entries valid, max abs err {err:.3e}; "
              f"planted fault (a padding entry written): max abs err {fault_err:.3e}")
        check(torch.equal(pk, pp) and torch.equal(ak_, ap), f"row Adagrad kernel is not bit-equal at {name}")
        check(fault_err > 0 or bool(v_.all()), f"the rule passes a planted fault at {name}")
        max_err = max(max_err, err)
    g_, u_, v_, p_, a_, c_, w_, e_ = captured[0]
    p1, a1 = p_.clone(), a_.clone()
    ms = cuda_ms(lambda: sk.scatter_adagrad(g_, u_, v_, p1, a1, c_, w_, e_), iters=50)
    plain_ms = cuda_ms(lambda: sk.scatter_adagrad_plain(g_, u_, v_, p1, a1, c_, w_, e_), iters=50)
    n_valid, d = int(v_.sum()), g_.shape[1]
    bytes_ = 5 * 4 * n_valid * d + len(u_) * (u_.element_size() + 1)
    bound = bytes_ / PEAK_BYTES_PER_S * 1e3
    print(f"scatter_adagrad timing entity token table {list(p_.shape)}, {n_valid} rows: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library none (no single PyTorch call computes a row-sparse Adagrad with "
          f"weight decay), bound {bound:.4f} ms (bytes: {bytes_:.4e} B)")
    return {"name": "scatter_adagrad", "route": "triton", "source": f"{PKG}/ops/scatter_adagrad_kernel.py",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/scatter_adagrad_kernel.py:52",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def build_kernels(torch, timings):
    """nvcc for every CUDA source (started together), then one launch of each
    Triton kernel on a few elements, which compiles it."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update
    from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(["lstm_last_fwd.cu", "lstm_last_bwd.cu"])
    timings["build_cuda_s"] = time.perf_counter() - t0
    for name, log in cuda_build.BUILD_LOGS.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"nvcc {name}: " + " | ".join(info))
    t0 = time.perf_counter()
    x = torch.zeros(4, 8, device="cuda")
    clr = torch.tensor(0.1, device="cuda")
    adagrad_update(x.clone(), x.clone(), x.clone(), clr, 0.0, 1e-10)
    scatter_adagrad(x.clone(), torch.zeros(4, dtype=torch.long, device="cuda"),
                    torch.ones(4, dtype=torch.bool, device="cuda"), x.clone(), x.clone(), clr, 0.0, 1e-10)
    torch.cuda.synchronize()
    timings["build_triton_s"] = time.perf_counter() - t0
    print(f"build: nvcc {timings['build_cuda_s']:.2f} s (2 sources in parallel), Triton "
          f"{timings['build_triton_s']:.2f} s (2 kernels)")


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

    timings = {}
    try:
        build_kernels(torch, timings)
        row_fwd = phase_kernels(torch)
        trainer, capture, train_launches, n_steps = phase_train(torch, timings)
        ckpt = check_training(torch, trainer, train_launches, n_steps)
        time_train_steps(torch, trainer, timings)
        table_heights = [trainer.variables["params"][t].shape[0]
                         for t in ("entity_token_embedding", "relation_token_embedding")]
        del trainer
        row_bwd, fwd_err = check_lstm_backward(torch, capture.bwd)
        fwd_err = max(fwd_err, check_lstm_residuals(torch, capture.fwd))
        row_fwd["max_abs_err"] = max(row_fwd["max_abs_err"], fwd_err)
        rows = [row_fwd, row_bwd,
                check_adagrad(torch, capture.dense, table_heights),
                check_row_adagrad(torch, capture.rows)]
        del capture
        torch.cuda.empty_cache()
        serve_launches = phase_main_path(torch, timings, ckpt=ckpt)
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    by_path = {row["name"]: {"train": train_launches[row["name"]]} for row in rows}
    by_path["lstm_last_fwd"]["serve"] = serve_launches
    for row in rows:
        row["launches"] = sum(by_path[row["name"]].values())
        row["launches_by_path"] = by_path[row["name"]]
    print("timings: " + json.dumps(timings))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
