#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. print the card's name and power limit (nvidia-smi);
2. build every kernel from the checkout: the CUDA sources of ``csrc/`` with
   one nvcc each, all started together, and the two Triton kernels (compiled
   by a first launch on a few elements); print the build seconds;
3. hold the forward LSTM kernel against its plain PyTorch version at the
   serving shapes (B=32768) and at ragged B, with two planted faults; time it
   in turns with cuDNN's packed ``nn.LSTM`` on the same inputs, beside its
   bound and its two measuring variants (no epilogue, no products);
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
   one computes the same function (the forward on both recorded passes as
   in 3);
7. the fused every-state LSTM (kernels 5 and 6, the every-state modes of the
   fused kernels) against its plain versions on the recorded entity pass and
   at ragged B, with a planted fault each, timed; then the op that reaches
   them (``ops/lstm.py::lstm_forward_tm_sorted``) forward and backward with
   the counts set to 0 just before and read just after;
8. the unfused training path: the same ``cli.train`` run with
   ``OKET_DISABLE_LSTM_FUSED=1`` set in this process for that run only (the
   input projection, then kernels 7 and 8 over every row and step), checked
   and timed as in 5; then kernels 7 and 8 against their plain versions on
   its recorded first step and at ragged B, with planted faults, timed;
9. the serving path on the trained checkpoint: ``cli.predict`` answers text
   queries and ``Predictor.predict`` batches of 1024 queries and single
   queries, with the launch counts set to 0 just before and read just after
   (the cache chunks and the batches take the fused kernel, the single
   queries, B = 1, the unfused path, by the JAX package's rule); check ids,
   scores, cache rows and top-k scores against a plain CPU encode; then the
   same on the unfused run's checkpoint with the switch set (every encode
   unfused);
10. the f32 model: the flagship config with its ``dtype`` line removed (a
   copy under ``.bench_cache/``), through the same entry points: kernel 1's
   f32 mode at B=32768 and ragged B, ``cli.train`` fused and unfused, each
   f32 mode (kernels 1, 2, 5-8) against its plain version on the recorded
   passes and ragged B by the f32 rule of ``utils/numerics.py`` with planted
   faults (the TF32 yardstick, a dropped bias or recurrent product, and for
   the 3xTF32 backward of kernels 2 and 6 its 1xTF32 variant), the
   backward's launches (split, gate, product, dW) timed each against its
   part of the 3xTF32 bound, the op of kernels 5 and 6, and serving of the
   f32 checkpoint; then the unfused
   path at H = 100 in bf16 and f32 (kernels 7 and 8 through the padded
   route);
11. print the timings, one JSON line with every kernel's numbers (the
   eight ports and the f32 modes of the six LSTM kernels, launches by path:
   an LSTM row counts the paths of its dtype), and last
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
# the flagship with its dtype line removed: the f32 model (written by
# write_f32_config under the git-ignored cache; configs/ is not edited)
F32_CONFIG = ROOT / ".bench_cache" / "synth-olpbench-2m47-demo-f32.yaml"
# the JAX package's switch that sends every LSTM encode down the unfused path
UNFUSED_SWITCH = "OKET_DISABLE_LSTM_FUSED"
SEED = 0
# every CUDA source of the port's kernels, one nvcc each
CUDA_SOURCES = ["lstm_last_fwd.cu", "lstm_last_fwd_f32.cu", "lstm_last_bwd.cu", "lstm_scan.cu"]
# the kernels line, in order: the port of each TPU kernel (PERF.md rows 1-8),
# then the f32 modes of the LSTM kernels (rows 1, 2, 5-8 at f32)
KERNEL_ROWS = ["lstm_last_fwd", "lstm_last_bwd", "adagrad_update", "scatter_adagrad", "lstm_all_fwd", "lstm_all_bwd",
               "lstm_scan_fwd", "lstm_scan_bwd", "lstm_last_fwd_f32", "lstm_last_bwd_f32", "lstm_all_fwd_f32",
               "lstm_all_bwd_f32", "lstm_scan_fwd_f32", "lstm_scan_bwd_f32"]
# OLPBench's vocabulary sizes; 80000 triples give 104626 training prefixes,
# 25 steps of 4096 (counted on the CPU); serving reads only the vocabulary
DATA_ARGS = ["--mentions", "2470000", "--relations", "50000", "--triples", "80000",
             "--ent-tokens", "200000", "--rel-tokens", "50000", "--eval-size", "1000", "--seed", str(SEED)]
MIN_TRAIN_STEPS = 20


def train_args(config, out_dir):
    """cli.train's arguments: two passes over the smoke set, no eval."""
    return [str(config), "--dataset_dir", str(DATA_DIR), "--eval_epoch_freq", "0", "--epochs", "2",
            "--experiment_dir", str(out_dir)]

# H100 SXM published peaks (dense bf16 tensor-core rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# The least time for f32-accurate products: 3xTF32 on the tensor cores, three
# TF32 products (at half the bf16 rate) for each f32 one.  The f32 kernels'
# bounds are taken at it (the FFMA bound, their bound before, is printed beside them).
PEAK_3XTF32_FLOPS = PEAK_BF16_FLOPS / 6

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
# Kernels 6 and 8 take a cotangent at every step, so one flipped dgate of a
# long row feeds the dh carry of every earlier step of that row, and the
# share of unequal elements is a statistic over independent rows: on an H100
# one row of length 10 read 12.0 % (kernel 6, demb) where 37 rows and more
# read 1.2-1.6 %.  Below this many rows only the ulp bound is held.
SHARE_MIN_ROWS = 32


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


def tf32_operands(*args, keep=(3,)):
    """The planted TF32 yardstick of the f32 rule: ``args`` with every f32
    tensor but those at ``keep`` (the bias, which no product reads; the cell
    states) rounded to TF32's 10 mantissa bits, as a TF32 tensor-core product
    would round its operands."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import round_to_tf32

    return tuple(round_to_tf32(x) if i not in keep and getattr(x, "dtype", None) is not None
                 and str(x.dtype) == "torch.float32" else x for i, x in enumerate(args))


def lstm_inputs(torch, gen, L, B, D, H, lens_np, dtype=None):
    """Random inputs of the fused LSTM in ``dtype`` (bf16 by default)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm import init_lstm_params

    dtype = dtype or torch.bfloat16
    p = init_lstm_params(gen, D, H, gen.device)
    emb = (torch.randn(L, B, D, generator=gen, device=gen.device) * 0.1).to(dtype)
    return (
        emb,
        p["w_ih"].to(dtype),
        p["w_hh"].to(dtype),
        (p["b_ih"] + p["b_hh"]).float(),
        torch.as_tensor(lens_np, device=gen.device),
        p,
    )


def phase_kernels(torch, dtype=None):
    """Kernel 1 vs plain version at full width and ragged shapes, with
    timings, in ``dtype`` (bf16 by default; f32: its f32 mode)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    sfx = "_f32" if f32 else ""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    L, B, D = 10, 32768, 512
    H = D
    lens = synth_lengths(rng, B, L)
    emb, wih, whh, bias, lens_t, p = lstm_inputs(torch, gen, L, B, D, H, lens, dtype)
    out = lk.lstm_encode_last_fused(emb, wih, whh, bias, lens_t)
    ref = lk.lstm_encode_last_plain(emb, wih, whh, bias, lens_t)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(), "kernel output not finite")
    agree = agreement(out, ref)
    print(f"lstm_last_fwd{sfx} B={B} L={L} D=H={D} {dtype}: {agree}")
    check(agree.ok(), f"kernel disagrees with plain version: {agree}")
    max_err = agree.max_abs_err

    # the rule must fail a kernel that dropped the recurrent product or a
    # bias, and at f32 the plain version with TF32 operands
    faults = {
        "W_hh = 0": (emb, wih, torch.zeros_like(whh), bias, lens_t),
        "bias = b_ih only": (emb, wih, whh, p["b_ih"].float(), lens_t),
    }
    if f32:
        faults["TF32 operands (yardstick)"] = tf32_operands(emb, wih, whh, bias, lens_t)
    for fault, args in faults.items():
        planted = agreement(lk.lstm_encode_last_plain(*args), ref)
        print(f"planted fault {fault}: {planted}")
        check(not planted.ok(), f"the {dtype} rule passes a planted fault ({fault}): {planted}")

    for b in (1, 37, 4099):
        lr = synth_lengths(rng, b, L)
        e, wi, wh, bi, ln, _ = lstm_inputs(torch, gen, L, b, D, H, lr, dtype)
        o = lk.lstm_encode_last_fused(e, wi, wh, bi, ln)
        r = lk.lstm_encode_last_plain(e, wi, wh, bi, ln)
        torch.cuda.synchronize()
        agree = agreement(o, r)
        print(f"lstm_last_fwd{sfx} B={b} D=H={D}: {agree}")
        check(agree.ok(), f"kernel disagrees at B={b}: {agree}")
        max_err = max(max_err, agree.max_abs_err)

    timing = time_forward(torch, f"cache chunk B={B}", (emb, wih, whh, bias, lens_t), residuals=False)
    plain_ms = cuda_ms(lambda: lk.lstm_encode_last_plain(emb, wih, whh, bias, lens_t), iters=5)
    print(f"lstm_last_fwd{sfx} plain version B={B}: {plain_ms:.4f} ms")
    return {
        "name": "lstm_last_fwd" + sfx,
        "route": "cuda",
        "source": f"{PKG}/csrc/lstm_last_fwd{sfx}.cu",
        "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:479",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": plain_ms,
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }


def forward_bound(args):
    """Kernel 1's least time on this card for the work these lengths need:
    every active (row, step) multiplies x by W_ih, and h by W_hh from step 1
    on (h_0 = 0); the active token rows, both weights, bias and lengths are
    read once and last written once, in the inputs' dtype at its peak rate.
    Returns (ms, "operations" or "bytes", FLOP, bytes, active row-steps)."""
    emb, w_ih, w_hh, _, lens = args
    _, B, D = emb.shape
    H = w_hh.shape[1]
    es = emb.element_size()
    n_steps = int(lens.clamp(min=1).sum().item())
    flops = n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H
    bytes_ = n_steps * D * es + (D + H) * 4 * H * es + 4 * H * 4 + B * 4 + B * H * es
    bound, by = bound_ms(flops, bytes_, peak_flops(emb.dtype))
    return bound, by, flops, bytes_, n_steps


def time_forward(torch, label, args, residuals, reps=3):
    """Kernel 1 on ``args`` as its caller runs it (with the hs/cs residuals
    in training), timed in turns with cuDNN's packed ``nn.LSTM`` forward on
    the same inputs so that their ratio holds within this call (median of
    ``reps`` turns), beside its bound and its two measuring variants (no
    epilogue, no products: what the stream of tiles with the products, and
    with the epilogue, take alone)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    def run(variant="kernel"):
        return lambda: lk._launch_steps(*args, residuals, True, lk.lstm_encode_last_fused, variant=variant)

    ms, lib = [], []
    for _ in range(reps):
        ms.append(cuda_ms(run(), iters=20))
        lib_ms, note = library_lstm_ms(torch, args)
        lib.append(lib_ms)
    variants = ({v: cuda_ms(run(v), iters=20) for v in lk.FORWARD_VARIANTS if v != "kernel"}
                if args[0].dtype != torch.float32 else {})  # the bf16 Hopper kernel's measuring variants
    bound, by, flops, bytes_, n_steps = forward_bound(args)
    out = {"ms": float(np.median(ms)), "bound_ms": bound, "bound_by": by,
           "library_ms": None if None in lib else float(np.median(lib))}
    print(f"lstm_last_fwd timing {label} L={args[0].shape[0]} d={args[0].shape[2]} {args[0].dtype}"
          f"{' with residuals' if residuals else ''}: kernel {out['ms']:.4f} ms (turns {ms}), library "
          f"{out['library_ms']} ms (turns {lib}; {note}), kernel/library "
          f"{out['ms'] / out['library_ms'] if out['library_ms'] else float('nan'):.3f}, bound {bound:.4f} ms "
          f"({by}: {flops:.4e} FLOP, {bytes_:.4e} B, {n_steps} row-steps; {bound / out['ms']:.1%} of it"
          f"{ffma_note(flops, args[0].dtype)}); " + ", ".join(f"{v} {t:.4f} ms" for v, t in variants.items()))
    return out


def library_lstm_ms(torch, args):
    """One PyTorch call computing the same function: nn.LSTM over a packed
    sequence, whose h_n is each row's last state.  Timed, never used by the
    port.  Returns (ms or None, note)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    emb, w_ih, w_hh, bias, lens = args
    D, H = emb.shape[2], w_hh.shape[1]
    dt = str(emb.dtype).replace("torch.", "")
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=emb.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w_ih)
        lstm.weight_hh_l0.copy_(w_hh)
        lstm.bias_ih_l0.copy_(bias)
        lstm.bias_hh_l0.zero_()
    # cuDNN's flat weight buffer does not take bf16, so each call packs the
    # 4 MiB of weights anew (a few microseconds) and warns about it
    warnings.filterwarnings("ignore", message="RNN module weights are not part")
    packed = torch.nn.utils.rnn.pack_padded_sequence(emb, lens.clamp(min=1).cpu(), enforce_sorted=True)
    try:
        with torch.no_grad():
            _, (h_n, _) = lstm(packed)
            diff = (h_n[0].float() - lk.lstm_encode_last_plain(*args).float()).abs().max().item()
            ms = cuda_ms(lambda: lstm(packed), iters=10)
    except RuntimeError as e:  # a library build without LSTM support in this dtype
        return None, f"nn.LSTM {dt} unavailable: {str(e).splitlines()[0]}"
    return ms, f"nn.LSTM packed {dt} forward (cuDNN), max |h_n - plain| {diff:.3e}"


def time_forward_passes(torch, captured):
    """Kernel 1 on the first training step's entity and relation passes as
    the training run launched them (with residuals)."""
    for name, (args, _) in zip(("entity pass", "relation pass"), captured):
        time_forward(torch, f"training {name} B={args[0].shape[1]}", args, residuals=True)


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


def load_user_path(torch, config=FLAGSHIP):
    """What cli.predict does before it serves: config, metadata, model,
    seeded init."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model

    args = load_config(str(config), ["--dataset_dir", str(DATA_DIR)])
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


def phase_main_path(torch, timings, ckpt=None, unfused=False, config=FLAGSHIP, tag=""):
    """The serving path of ``config``'s model on ``ckpt`` (a seeded random
    init when None).  With ``unfused`` the switch is set for the whole phase
    and every encode takes the unfused path; without it the cache chunks and
    the 1024-query batches take the fused one and the single queries (B = 1)
    the unfused one, by the JAX package's rule.  ``tag`` prefixes the
    timings' keys."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import predict as cli_predict
    from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    pre = tag + ("unfused_" if unfused else "")
    timings.setdefault("dataset_gen_s", ensure_dataset())
    t0 = time.perf_counter()
    args, meta, model, variables = load_user_path(torch, config)
    timings[pre + "meta_and_init_s"] = time.perf_counter() - t0
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
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(queries) + "\n")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_predict.main([str(config), "--resume", ckpt, "--dataset_dir", str(DATA_DIR),
                              "-k", "10", "--device", "cuda"])
    finally:
        sys.stdin = stdin
    torch.cuda.synchronize()
    timings[pre + "cli_predict_s"] = time.perf_counter() - t0

    _, _, model, variables = load_user_path(torch, config)
    variables, _ = load_checkpoint(ckpt, variables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor = Predictor(model, variables)  # ids only: the cache encode alone is timed
    torch.cuda.synchronize()
    timings[pre + "cache_encode_s"] = time.perf_counter() - t0
    results, batch_ms, single_ms = {}, [], []
    for direction in ("subj", "obj"):
        kw = {direction: ent_ids, "rel": rel_ids, "k": 10}
        results[direction] = predictor.predict(**kw)  # first call, untimed
        for _ in range(n_timed):
            batch_ms.append(wall_ms(lambda: predictor.predict(**kw)))
        single_ms += [wall_ms(lambda: predictor.predict(
            **{direction: ent_ids[i : i + 1]}, rel=rel_ids[i : i + 1], k=10)) for i in range(n_timed)]
    timings[f"{pre}predict_{nq}_ms"] = summary(batch_ms)
    timings[pre + "predict_1_ms"] = summary(single_ms)
    launches = {name: fn.launches for name, fn in counters.items()}
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
    # encodes: the cache twice (cli.predict, Predictor; every chunk padded
    # to 32768 rows), an entity and a relation encode per predict call: 4
    # text queries and 20 single queries (B = 1), 22 batches of 1024; each
    # encode runs one launch per step
    L = meta.max_length[0]
    check(L == meta.max_length[1], "entity and relation lengths differ")
    fused_encodes = 2 * n_chunks + 2 * 2 * (1 + n_timed)
    single_encodes = 2 * (len(queries) + 2 * n_timed)
    if unfused:
        fused_encodes, single_encodes = 0, fused_encodes + single_encodes
    want = {name: 0 for name in counters}
    want["lstm_last_fwd"], want["lstm_scan_fwd"] = fused_encodes * L, single_encodes * L
    check(all(launches[k] > 0 for k, v in want.items() if v), f"a serving kernel was never launched: {launches}")
    check(launches == want, f"serving launches {launches}, want {want}")
    print(f"main path{' (' + UNFUSED_SWITCH + '=1)' if unfused else ''}: lstm_last_fwd launches="
          f"{launches['lstm_last_fwd']} = {fused_encodes} fused encodes x L={L}; lstm_scan_fwd launches="
          f"{launches['lstm_scan_fwd']} = {single_encodes} unfused encodes x L={L} ({n_chunks} cache chunks, "
          f"1024-query batches {'un' if unfused else ''}fused, single queries unfused)")

    check_against_plain(torch, model, predictor, ent_ids, rel_ids)
    ids = torch.arange(meta.min_entities_size, meta.min_entities_size + chunk, device="cuda")
    with torch.no_grad():
        device_breakdown(torch, f"{pre}cache chunk encode ({chunk} rows)",
                         lambda: model.embedder.encode_entity(predictor.variables, ids))
    device_breakdown(torch, f"{pre}predict ({nq} subj queries, k=10)",
                     lambda: predictor.predict(subj=ent_ids, rel=rel_ids, k=10))
    device_breakdown(torch, f"{pre}predict (1 subj query, k=10)",
                     lambda: predictor.predict(subj=ent_ids[:1], rel=rel_ids[:1], k=10))
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
    """Sampled cache rows and top-k scores against a plain encode on the CPU,
    by the rule of the model's dtype (at f32 the scores too)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32, agreement

    def to_cpu(tree):
        return {k: to_cpu(x) if isinstance(x, dict) else x.cpu() for k, x in tree.items()}

    cpu = to_cpu(predictor.variables)
    rng = np.random.default_rng(SEED + 1)
    off = predictor.offset
    ids = torch.as_tensor(rng.integers(off, predictor.meta.entities_size, 4096))
    want, _, _ = model.embedder.encode_entity(cpu, ids)
    got = predictor.cand_emb[(ids - off).to(predictor.device)].cpu()
    agree = agreement(got, want)
    print(f"cache rows vs plain CPU encode (4096 ids, {want.dtype}): {agree}")
    check(agree.ok(), f"cache rows disagree with the plain encode: {agree}")

    n = 16
    e, r = torch.as_tensor(ent_ids[:n]), torch.as_tensor(rel_ids[:n])
    is_sp = torch.ones(n, dtype=torch.bool)
    q, _, _ = model.queries(cpu, e, r, is_sp)
    want_s = torch.topk(score_against_candidates(q.to(predictor.device), predictor.cand_emb), 10)
    want_s = want_s.values.cpu().numpy()
    got_s, _ = predictor.predict(subj=ent_ids[:n], rel=rel_ids[:n], k=10)
    rel_err = np.abs(got_s - want_s).max() / max(np.abs(want_s).max(), 1e-6)
    tol = SCORE_RTOL if want.dtype == torch.bfloat16 else MAX_REL_ERR_F32
    print(f"top-10 scores vs plain CPU queries ({n} queries): max rel err={rel_err:.3e} (tol {tol:.3e})")
    check(rel_err <= tol, f"top-k scores disagree with the plain path: {rel_err}")


# ------------------------------------------------------------------ training


class Capture:
    """Records the first training step's inputs to each training kernel: the
    two LSTM forward launches that write the hs/cs residuals (entity pass,
    then relation pass) with what they returned, the two LSTM backward
    launches (relation pass, then entity pass), the same four of the
    recurrence-only LSTM on the unfused path, the dense Adagrad of one
    [2048, 512] LSTM weight and the row updates of the token tables (p and
    acc cloned before the in-place update).  It wraps the modules' CUDA
    launchers and calls them through, so the wrappers launch and count as
    they do without it.  The recorded inputs are copies: at f32 the weights
    a kernel gets are the parameters themselves (``.to`` of an f32 tensor
    returns it), which the optimizer then updates in place."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.ops import (
            adagrad_kernel,
            lstm_kernel,
            lstm_scan_kernel,
            scatter_adagrad_kernel,
        )

        self.fwd, self.bwd, self.dense, self.rows = [], [], None, []
        self.scan_fwd, self.scan_bwd = [], []
        self._patches = [(lstm_kernel, "_launch_backward", self._bwd),
                         (adagrad_kernel, "_launch", self._dense),
                         (scatter_adagrad_kernel, "_launch", self._rows),
                         (lstm_kernel, "_launch_forward", self._fwd),
                         (lstm_scan_kernel, "_launch_forward", self._scan_fwd),
                         (lstm_scan_kernel, "_launch_backward", self._scan_bwd)]
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
            self.bwd.append(_copies(args))
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
            self.fwd.append((_copies((emb_tm, w_ih, w_hh, bias, lengths)), _copies(out)))
        return out

    def _scan_fwd(self, x_proj, w_hh):
        hs, cs = self._orig[4](x_proj, w_hh)
        if len(self.scan_fwd) < 2:
            self.scan_fwd.append((_copies((x_proj, w_hh)), _copies((hs, cs))))
        return hs, cs

    def _scan_bwd(self, *args):
        if len(self.scan_bwd) < 2:
            self.scan_bwd.append(_copies(args))
        return self._orig[5](*args)


def _copies(tensors):
    return tuple(x.clone() for x in tensors)


def kernel_counters():
    """Every kernel wrapper's launch counter, by the kernel's row name."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import (
        adagrad_kernel,
        lstm_kernel,
        lstm_scan_kernel,
        scatter_adagrad_kernel,
    )

    return {"lstm_last_fwd": lstm_kernel.lstm_encode_last_fused, "lstm_last_bwd": lstm_kernel.lstm_last_backward,
            "adagrad_update": adagrad_kernel.adagrad_update,
            "scatter_adagrad": scatter_adagrad_kernel.scatter_adagrad,
            "lstm_all_fwd": lstm_kernel.lstm_all_forward, "lstm_all_bwd": lstm_kernel.lstm_all_backward,
            "lstm_scan_fwd": lstm_scan_kernel.lstm_scan_forward,
            "lstm_scan_bwd": lstm_scan_kernel.lstm_scan_backward}


def count_train_steps(config):
    """Training prefixes and steps of the smoke set, built on the CPU (this
    also writes the metadata and records caches the run then reads)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    args = train_args(config, ROOT / ".bench_cache" / "smoke_train")
    args = load_config(args[0], args[1:])
    ds = setup_dataset(args)
    return len(ds), len(ds) // ds.batch_size


@contextlib.contextmanager
def unfused_switch(on=True):
    """``OKET_DISABLE_LSTM_FUSED=1`` in this process while the block runs."""
    import os

    if on:
        os.environ[UNFUSED_SWITCH] = "1"
    try:
        yield
    finally:
        if on:
            os.environ.pop(UNFUSED_SWITCH, None)


def phase_train(torch, timings, unfused=False, config=FLAGSHIP, tag=""):
    """``cli.train`` on ``config`` (the flagship by default), two passes;
    with ``unfused`` the switch is set in this process for this run only.
    Each run writes to its own experiment directory; ``tag`` prefixes the
    timings' keys and names the directory."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train

    pre = tag + ("unfused_" if unfused else "")
    timings.setdefault("dataset_gen_s", ensure_dataset())
    t0 = time.perf_counter()
    n_records, n_steps = count_train_steps(config)
    timings[pre + "train_records_s"] = time.perf_counter() - t0
    print(f"training set: {n_records} prefixes, {n_steps} steps of 4096 (counted on the CPU)")
    check(n_steps >= MIN_TRAIN_STEPS, f"one epoch has {n_steps} steps, want >= {MIN_TRAIN_STEPS}")
    out_dir = ROOT / ".bench_cache" / ("smoke_train" + ("_" + pre.rstrip("_") if pre else ""))
    shutil.rmtree(out_dir, ignore_errors=True)
    args = train_args(config, out_dir) + ["--device", "cuda"]

    with unfused_switch(unfused):
        # ---- the training path: counts set to 0 just before, read just after
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with Capture() as capture:
            trainer = cli_train.cli_main(args)
        torch.cuda.synchronize()
        timings[pre + "cli_train_s"] = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        # ---- end of the training path
    return trainer, capture, launches, n_steps


def check_training(torch, trainer, launches, n_steps, unfused=False):
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
    want = {name: 0 for name in launches}
    want.update({"adagrad_update": n_dense, "scatter_adagrad": n_sparse})
    if unfused:  # every step of every row forward, a gate and (from step 1) a product launch per step backward
        want.update({"lstm_scan_fwd": 2 * n_steps * L, "lstm_scan_bwd": 2 * n_steps * (2 * L - 1)})
    else:  # both passes fused (B % 8 == 0 at the flagship's 512-row buckets)
        want.update({"lstm_last_fwd": 2 * n_steps * L,
                     "lstm_last_bwd": 2 * n_steps * backward_launches(L, trainer.model.embedder.dtype)})
    print(f"training path launches{' (' + UNFUSED_SWITCH + '=1)' if unfused else ''}: {launches} (want {want}: "
          "two LSTM passes per step; one dense Adagrad per dense leaf, one row update per sparse table)")
    check(all(launches[k] > 0 for k, v in want.items() if v), f"a training kernel was never launched: {launches}")
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


def time_train_steps(torch, trainer, timings, n=8, pre=""):
    """Steps after warm-up with a synchronize around each (device-bound, no
    host overlap), the host plan per batch, and a profile of one step;
    timings keyed with the prefix ``pre``."""
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
    timings[pre + "train_step_ms"] = summary(step_ms)
    timings[pre + "train_items_per_s"] = positives / (sum(step_ms) / 1e3)
    timings[pre + "host_plan_ms_per_batch"] = summary(plan_ms)
    timings[pre + "host_batch_ms_per_batch"] = summary(batch_ms)
    timings[pre + "cli_epoch_items_per_s"] = trainer.last_epoch["items_per_s"]
    timings[pre + "cli_epoch_host_wait_ms"] = summary([s["wait_ms"] for s in trainer.step_log[1:]])
    print(f"{pre}train step (synchronized, after warm-up): median {np.median(step_ms):.3f} ms, max "
          f"{max(step_ms):.3f} ms, {timings[pre + 'train_items_per_s']:.0f} items/s; host plan "
          f"{np.median(plan_ms):.3f} ms/batch, batch build {np.median(batch_ms):.3f} ms/batch (one host thread "
          f"each); cli epoch {timings[pre + 'cli_epoch_items_per_s']:.0f} items/s")
    label = f"{pre}train step (4096 x 4096, d=512, {trainer.model.embedder.dtype})"
    device_breakdown(torch, label, lambda: trainer.train_step(
        trainer.variables, trainer.opt_state, trainer.regimes.hparams(), dev[n], trainer.generator), top=16)


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
    """Kernel 1's training outputs against the plain version's by the rule
    of their dtype: last, and hs and cs at the positions each row reaches
    (the kernel leaves the others unwritten)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    act = active_mask(torch, args)
    agree = {"last": agreement(got[0], want[0]), "hs": agreement(got[1][act], want[1][act]),
             "cs": agreement(got[2][act], want[2][act])}
    text = "; ".join(f"{k} {a}" for k, a in agree.items())
    return all(a.ok() for a in agree.values()), text, max(a.max_abs_err for a in agree.values())


def check_lstm_residuals(torch, captured):
    """Kernel 1 with residuals (the training forward) against its plain
    version on the first step's entity and relation passes, as the training
    run launched it, with planted faults; returns the largest error."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    max_err = 0.0
    for name, (args, got) in zip(("entity pass", "relation pass"), captured):
        want = lk.lstm_encode_last_plain(*args, residuals=True)
        ok, text, err = residual_agreement(torch, args, got, want)
        print(f"lstm_last_fwd with residuals, training {name} B={args[0].shape[1]} {args[0].dtype}: {text}")
        check(ok, f"the forward kernel's residuals disagree with the plain version on the {name}")
        max_err = max(max_err, err)

    # planted faults: hs written one step late; at bf16 cs stored in f32 (not
    # rounded), at f32 the TF32 yardstick and a dropped bias
    args, got = captured[0]
    last, hs, cs = lk.lstm_encode_last_plain(*args, residuals=True)
    faults = {"hs one step late": (last, torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), cs)}
    if cs.dtype == torch.bfloat16:
        c32 = plain_c_f32(torch, args, hs)
        check(torch.equal(c32.to(cs.dtype), cs), "the f32 cell states do not round to the plain version's cs")
        faults["cs not rounded to bf16"] = (last, hs, c32)
    else:
        faults["TF32 operands (yardstick)"] = lk.lstm_encode_last_plain(*tf32_operands(*args), residuals=True)
        faults["bias dropped"] = lk.lstm_encode_last_plain(*args[:3], torch.zeros_like(args[3]), args[4],
                                                           residuals=True)
    for fault, planted in faults.items():
        ok, text, _ = residual_agreement(torch, args, got, planted)
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    return max_err


def backward_agreement(torch, args, got, want, share=True):
    """Kernel 2's (or 6's) outputs against the plain version's: demb at the
    positions each row reaches and both dW by the rule of their dtype (bf16:
    with the backward's share, or without ``share`` the ulp bound alone), db
    to DB_RTOL of max|db| at bf16 and by the f32 rule at f32.  Returns (ok,
    text, largest error)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
        MAX_UNEQUAL_SHARE_BWD,
        agreement,
        f32_agreement,
    )

    want = [w.to(got[0].device) for w in want]
    act = active_mask(torch, args).to(got[0].device)
    agree = [agreement(got[0][act], want[0][act]), agreement(got[1], want[1]), agreement(got[2], want[2])]
    if got[0].dtype == torch.bfloat16:
        db_err = (got[3] - want[3]).abs().max().item()
        db_ok = db_err <= DB_RTOL * want[3].abs().max().item()
        db_text = (f"db max err {db_err:.3e} ({db_err / max(want[3].abs().max().item(), 1e-30):.2e} of max|db|, "
                   f"tol {DB_RTOL})")
    else:
        db_agree = f32_agreement(got[3], want[3])
        db_err, db_ok, db_text = db_agree.max_abs_err, db_agree.ok(), f"db {db_agree}"
    ok = all(a.ok(MAX_UNEQUAL_SHARE_BWD if share else 1.0) for a in agree) and db_ok
    text = f"demb {agree[0]}; dW_ih {agree[1]}; dW_hh {agree[2]}; {db_text}"
    return ok, text, max([a.max_abs_err for a in agree] + [db_err])


def demb_shares_by_step(torch, args, got, want):
    """The share of demb elements not bit-equal (bf16), or demb's error
    relative to its max (f32), step by step."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    act = active_mask(torch, args).to(got[0].device)
    steps = [agreement(got[0][t][act[t]], want[0][t].to(got[0].device)[act[t]]) for t in range(len(act))]
    if got[0].dtype == torch.bfloat16:
        return f"  demb unequal share by step t=0..{len(act) - 1}: " + " ".join(f"{a.unequal_share:.2%}" for a in steps)
    return f"  demb relative error by step t=0..{len(act) - 1}: " + " ".join(f"{a.rel_err:.2e}" for a in steps)


def check_backward_faults(torch, args, kernel_out):
    """Planted faults in the plain backward must fail the rule against the
    kernel's ``kernel_out`` on ``args``: two in the cell arithmetic; at bf16
    two misplaced bf16 rounding points (c_t read in f32; dgates not rounded
    before the products: the plain version at f32 on the same bf16 values,
    its outputs rounded where the bf16 version rounds them), at f32 the TF32
    yardstick and a dropped bias."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    emb, w_ih, w_hh, bias, lens, hs, cs, dlast = args
    L = emb.shape[0]
    c32 = plain_c_f32(torch, args, hs) if emb.dtype == torch.bfloat16 else None
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
    }
    if emb.dtype == torch.bfloat16:
        faults["c_t read in f32"] = with_cell(c_t_f32)
        faults["dgates not rounded before the products"] = unrounded_dgates
    else:
        faults["TF32 operands (yardstick)"] = lambda: lk.lstm_last_backward_plain(*tf32_operands(*args, keep=(3, 6)))
        faults["bias dropped"] = lambda: lk.lstm_last_backward_plain(*args[:3], torch.zeros_like(bias), *args[4:])
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
        print(f"lstm_last_bwd {name} B={args[0].shape[1]} L={args[0].shape[0]} D=H={args[0].shape[2]} "
              f"{args[0].dtype}: {text}")
        print(demb_shares_by_step(torch, args, got, want))
        check(ok, f"LSTM backward kernel disagrees with its plain version on the {name}")
        max_err = max(max_err, err)
    # the yardsticks of the share rule, on the relation pass: the plain
    # version on the card against the same on the CPU (f32 products in other
    # summation orders), and the plain version with tensor-core products
    # (TF32, exact for bf16 operands, f32 accumulation as in the kernel's
    # mma) against the same with f32 SIMT products.  At f32 the TF32 products
    # round the operands: the f32 rule must fail them.
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
    ok, text, _ = backward_agreement(torch, args, tensor_core, plain["relation pass"])
    print(f"lstm_last_bwd relation pass, plain with TF32 tensor-core products vs plain with f32 products: {text}")
    print(demb_shares_by_step(torch, args, tensor_core, plain["relation pass"]))
    check(args[0].dtype == torch.bfloat16 or not ok, "the f32 rule passes the plain version's TF32 products")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    dtype = args[0].dtype
    sfx = "_f32" if dtype == torch.float32 else ""
    fwd_err = 0.0
    # ragged B with the synthetic lengths, and lengths uniform in 0..10 (rows
    # of length 0 and 1, and more long rows: the share of unequal elements
    # runs higher there)
    cases = [(f"B={b}", synth_lengths(rng, b)) for b in (1, 37, 4099)]
    cases.append(("B=37, lengths uniform in 0..10", np.sort(rng.integers(0, 11, 37)).astype(np.int32)[::-1].copy()))
    for label, lens in cases:
        b = len(lens)
        emb, wih, whh, bias, lens_t, _ = lstm_inputs(torch, gen, 10, b, 512, 512, lens, dtype)
        fwd_args = (emb, wih, whh, bias, lens_t)
        last, hs, cs = lk._forward(*fwd_args, residuals=True)
        ok, text, err = residual_agreement(torch, fwd_args, (last, hs, cs),
                                           lk.lstm_encode_last_plain(*fwd_args, residuals=True))
        print(f"lstm_last_fwd{sfx} with residuals {label}: {text}")
        check(ok, f"the forward kernel's residuals disagree at {label}")
        fwd_err = max(fwd_err, err)
        dlast = (torch.randn(b, 512, generator=gen, device="cuda") * 0.1).to(dtype)
        args = (*fwd_args, hs, cs, dlast)
        got, want = lk.lstm_last_backward(*args), lk.lstm_last_backward_plain(*args)
        ok, text, err = backward_agreement(torch, args, got, want)
        print(f"lstm_last_bwd{sfx} {label}: {text}")
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
    es = emb.element_size()
    # 3x the forward's work: gate recompute, demb and dW_ih per active
    # row-step; dh, the h half of the recompute and dW_hh from step 1 on
    parts = backward_parts(B, D, H, n_steps)
    flops = sum(parts.values())
    bytes_ = (n_steps * (D + 2 * H) * es + B * H * es + B * 4 + 4 * H * 4  # emb, hs, cs, dlast, lens, bias in
              + 2 * 4 * H * (D + H) * es  # both weights in, both dW out
              + n_steps * D * es + 4 * H * 4)  # demb, db out
    t_ops, t_bytes = flops / peak_flops(dtype) * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
    print(f"lstm_last_bwd{sfx} timing entity pass B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms} ms ({note}), kernel/library {ms / library_ms if library_ms else float('nan'):.3f}, bound "
          f"{max(t_ops, t_bytes):.4f} ms ({flops:.4e} FLOP, {bytes_:.4e} B, {n_steps} row-steps)"
          f"{ffma_note(flops, dtype)}")
    if dtype == torch.float32:
        check_1xtf32_variant(torch, args, False, plain["entity pass"])
        by_kind = backward_launch_ms(torch, lambda: lk.lstm_last_backward(*args))
        if by_kind is None:
            print("lstm_last_bwd_f32 launches: no device time in the trace (not measured)")
        else:
            print(f"lstm_last_bwd_f32 launches on the entity pass, device ms per call (torch.profiler): "
                  + ", ".join(f"{k} {v:.4f}" + (f" (3xTF32 bound of its part {parts[k] / PEAK_3XTF32_FLOPS * 1e3:.4f}"
                                                f", {parts[k] / PEAK_3XTF32_FLOPS * 1e3 / v:.1%} of it)"
                                                if k in parts and v else "")
                              for k, v in by_kind.items())
                  + f"; sum {sum(by_kind.values()):.4f}")
    return {"name": "lstm_last_bwd" + sfx, "route": "cuda", "source": f"{PKG}/csrc/lstm_last_bwd.cu",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:569",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}, fwd_err


def backward_launches(L, dtype):
    """Launches of one call of kernel 2 or 6 over L steps at ``dtype``
    ("bfloat16"/"float32", or a torch dtype): a gate and a product launch per
    step and one for dW and db; at f32 one more, the weight split."""
    return 2 * L + (2 if str(dtype).removeprefix("torch.") == "float32" else 1)


def backward_parts(B, D, H, n_steps):
    """FLOP of the three product parts of kernel 2 (and 6) for B rows and
    n_steps active row-steps: the gate recompute (x part per active
    row-step, h part from step 1 on), the dh/demb product (demb per active
    row-step, dh from step 1 on) and dW (dW_ih, and dW_hh from step 1 on).
    Each is the forward's work."""
    part = n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H
    return {"gate": part, "product": part, "dW": part}


def ffma_note(ops, dtype):
    """At f32, the bound at the FFMA rate (the f32 kernels' bound before
    3xTF32), for comparison; empty at bf16."""
    if str(dtype) != "torch.float32":
        return ""
    return f"; FFMA bound {ops / PEAK_FP32_FLOPS * 1e3:.4f} ms"


def backward_launch_ms(torch, fn, reps=5):
    """Device ms per call of each kind of launch of the f32 backward (split,
    gate, product, dW: all the call's launches of that kind), from
    torch.profiler over ``reps`` calls of ``fn``; None where the trace has
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kinds = {"split": "split_kernel_tf32", "gate": "gate_kernel_tf32", "product": "product_kernel_tf32",
             "dW": "dw_kernel_tf32"}
    out = {k: 0.0 for k in kinds}
    for e in prof.key_averages():
        for k, sub in kinds.items():
            if sub in e.key:
                out[k] += e.self_device_time_total / 1e3 / reps
    return out if any(out.values()) else None


def check_1xtf32_variant(torch, args, every_step, want):
    """The f32 backward's planted 1xTF32 variant (one TF32 product where the
    kernel takes three) against the plain version ``want`` must fail the f32
    rule: the rule sees the correction products.  On the CPU, where there is
    no kernel, the variant is the plain version with each product emulated
    as one TF32 product (``utils/numerics.py::matmul_3xtf32``)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import matmul_3xtf32

    class Uncounted:
        launches = 0

    if args[0].is_cuda:
        got = lk._launch_bwd_steps(*args, every_step, Uncounted, variant="1xTF32")
    else:
        matmul = torch.matmul
        torch.matmul = lambda a, b: matmul_3xtf32(a, b, passes=1)
        try:
            got = (lk.lstm_all_backward_plain if every_step else lk.lstm_last_backward_plain)(*args)
        finally:
            torch.matmul = matmul
    ok, text, _ = backward_agreement(torch, args, got, want)
    print(f"planted fault 1xTF32 variant of lstm_{'all' if every_step else 'last'}_bwd_f32: {text}")
    check(not ok, "the f32 rule passes the backward kernel's 1xTF32 variant")


def lstm_bound(row, L, B, D, H, n_steps, es=2):
    """(operations, bytes) of PERF.md's LSTM kernel rows 5-8 for L steps of B
    rows with n_steps active row-steps, with elements of ``es`` bytes (2:
    bf16, 4: f32).  Rows 5 and 6 are the fused length-aware LSTM writing every
    hs and cs (and its backward with a full dhs): the work of rows 1 and 2,
    plus the hs/cs (and dhs) bytes.  Rows 7 and 8 are the recurrence over a
    precomputed x_proj [L, B, 4H]: every row every step, the h products from
    step 1 on (the backward: the recompute and dh; its dW_hh is a product
    outside the kernels)."""
    fwd_ops = n_steps * 2 * D * 4 * H + (n_steps - B) * 2 * H * 4 * H
    w = (D + H) * 4 * H * es
    return {
        5: (fwd_ops, n_steps * D * es + w + 4 * H * 4 + B * 4 + 2 * n_steps * H * es),
        6: (3 * fwd_ops, n_steps * (D + 3 * H) * es + B * 4 + 4 * H * 4 + 2 * w + n_steps * D * es + 4 * H * 4),
        7: ((L - 1) * B * 2 * H * 4 * H, L * B * 4 * H * es + H * 4 * H * es + 2 * L * B * H * es),
        8: (2 * (L - 1) * B * 2 * H * 4 * H, L * B * (4 * H + 3 * H) * es + H * 4 * H * es + L * B * 4 * H * es),
    }[row]


def bound_ms(ops, bytes_, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = ops / peak * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# The card's FP32 rate outside the tensor cores (FFMA: 128 lanes per SM, 2
# FLOP each per clock), computed by read_fp32_peak from the SM count and the
# card's maximum SM clock; the FFMA bound of the f32 kernels, printed beside
# their 3xTF32 bounds.
PEAK_FP32_FLOPS = None


def read_fp32_peak(torch):
    """SM count x 128 lanes x 2 FLOP x the maximum SM clock nvidia-smi reads."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * 2 * mhz * 1e6, sms, mhz


def peak_flops(dtype):
    """The peak rate the kernels of ``dtype`` are bound by: bf16 tensor cores,
    or at f32 the 3xTF32 rate (the least time for f32-accurate products)."""
    return PEAK_3XTF32_FLOPS if str(dtype) == "torch.float32" else PEAK_BF16_FLOPS


def library_lstm_backward_ms(torch, args):
    """cuDNN's packed ``nn.LSTM`` backward on the same inputs and cotangent
    (h_n's gradient into the inputs and weights), timed alone over a
    retained graph; never used by the port."""
    emb, w_ih, w_hh, bias, lens, _, _, dlast = args
    D, H = emb.shape[2], w_hh.shape[1]
    dt = str(emb.dtype).replace("torch.", "")
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=emb.dtype)
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
    except RuntimeError as e:  # a library build without this dtype's LSTM backward
        return None, f"nn.LSTM {dt} backward unavailable: {str(e).splitlines()[0]}"
    return ms, f"nn.LSTM packed {dt} backward (cuDNN), h_n cotangent into inputs and weights"


# ------------------------------------------------- kernels 7 and 8: the unfused path


def scan_inputs(torch, gen, L, B, H, dtype=None):
    """Random inputs of the recurrence at the unfused path's scale: x_proj
    (the projection of token embeddings of std 0.1, plus the bias) and
    W_hh as ``nn.LSTM`` initializes it, in ``dtype`` (bf16 by default)."""
    dtype = dtype or torch.bfloat16
    k = 1.0 / H ** 0.5
    x_proj = (torch.randn(L, B, 4 * H, generator=gen, device=gen.device) * 0.5).to(dtype)
    w_hh = torch.empty(4 * H, H, device=gen.device).uniform_(-k, k, generator=gen).to(dtype)
    return x_proj, w_hh


def scan_agreement(torch, got, want, backward=False):
    """Kernel 7's (hs, cs) or kernel 8's dx_proj against the plain version's
    by the rule of their dtype; at bf16 with the forward's 2 % share: dx_proj
    is the rounded dgates themselves, not a product of them (a misplaced
    rounding point moves ~10 % of it), and below SHARE_MIN_ROWS rows kernel 8
    is held to the ulp bound alone.  Returns (ok, text, largest error)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE, agreement

    if backward:
        a = agreement(got, want.to(got.device))
        share = MAX_UNEQUAL_SHARE if got.shape[1] >= SHARE_MIN_ROWS else 1.0
        return a.ok(share), f"dx_proj {a} (tol {share:.0%})", a.max_abs_err
    hs, cs = (agreement(g, w.to(g.device)) for g, w in zip(got, want))
    return (hs.ok(MAX_UNEQUAL_SHARE) and cs.ok(MAX_UNEQUAL_SHARE), f"hs {hs}; cs {cs} (tol {MAX_UNEQUAL_SHARE:.0%})",
            max(hs.max_abs_err, cs.max_abs_err))


def check_scan(torch, captured_fwd, captured_bwd, ragged=(1, 37, 4099)):
    """Kernels 7 and 8 against their plain versions on the first unfused
    step's entity and relation passes (as the training run launched them)
    and at ragged B, with planted faults that must fail: x_proj of step t+1
    read at t (forward); a dropped dc*f carry, dhs[t] not added, dgates not
    rounded before the dh product (backward).  The device is the tensors'.
    Returns (forward error, backward error)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    fwd_err = bwd_err = 0.0
    cases = [(f"training {name}", args, out) for name, (args, out) in zip(("entity pass", "relation pass"),
                                                                           captured_fwd)]
    x_proj, w_hh = captured_fwd[0][0]
    dtype = x_proj.dtype
    sfx = "_f32" if dtype == torch.float32 else ""
    gen = torch.Generator(device=x_proj.device).manual_seed(SEED + 5)
    for b in ragged:
        args = scan_inputs(torch, gen, x_proj.shape[0], b, w_hh.shape[1], dtype)
        cases.append((f"B={b}", args, sk.lstm_scan_forward(*args)))
    for label, args, got in cases:
        ok, text, err = scan_agreement(torch, got, sk.lstm_scan_forward_plain(*args))
        print(f"lstm_scan_fwd{sfx} {label} B={args[0].shape[1]}: {text}")
        check(ok, f"the recurrence kernel disagrees with its plain version at {label}")
        fwd_err = max(fwd_err, err)
        if label.startswith("B="):  # kernel 8 on kernel 7's residuals and a random cotangent
            dhs = (torch.randn(*got[0].shape, generator=gen, device=gen.device) * 0.1).to(dtype)
            bargs = (*args, *got, dhs)
            ok, text, err = scan_agreement(torch, sk.lstm_scan_backward(*bargs),
                                           sk.lstm_scan_backward_plain(*bargs), backward=True)
            print(f"lstm_scan_bwd{sfx} {label}: {text}")
            check(ok, f"the recurrence backward kernel disagrees with its plain version at {label}")
            bwd_err = max(bwd_err, err)
    # autograd runs the relation pass's backward first (it was encoded last)
    for name, bargs in zip(("relation pass", "entity pass"), captured_bwd):
        got, want = sk.lstm_scan_backward(*bargs), sk.lstm_scan_backward_plain(*bargs)
        ok, text, err = scan_agreement(torch, got, want, backward=True)
        print(f"lstm_scan_bwd{sfx} training {name} B={bargs[0].shape[1]}: {text}")
        check(ok, f"the recurrence backward kernel disagrees with its plain version on the {name}")
        bwd_err = max(bwd_err, err)

    # planted faults, on the entity pass; at f32 also the TF32 yardstick and a
    # dropped recurrent product
    args, got = captured_fwd[0]
    late = (torch.cat([args[0][1:], args[0][-1:]]), args[1])
    fwd_faults = {"x_proj of step t+1 read at t": late}
    if dtype == torch.float32:
        fwd_faults.update({"TF32 operands (yardstick)": tf32_operands(*args, keep=()),
                           "W_hh = 0": (args[0], torch.zeros_like(args[1]))})
    for fault, fargs in fwd_faults.items():
        ok, text, _ = scan_agreement(torch, got, sk.lstm_scan_forward_plain(*fargs))
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    bargs = captured_bwd[1]
    kernel_out = sk.lstm_scan_backward(*bargs)
    cell = lk._bwd_cell

    def with_cell(fn):
        def run():
            lk._bwd_cell = fn
            try:
                return sk.lstm_scan_backward_plain(*bargs)
            finally:
                lk._bwd_cell = cell
        return run

    faults = {
        "dc*f carry dropped": with_cell(
            lambda g, cp, ct, dh, dc, d: (cell(g, cp, ct, dh, dc, d)[0], torch.zeros_like(dc))),
        "dhs[t] not added": with_cell(lambda g, cp, ct, dh, dc, d: cell(g, cp, ct, dh, dc, torch.zeros_like(d))),
    }
    if dtype == torch.bfloat16:
        faults["dgates not rounded before the dh product"] = (
            lambda: sk.lstm_scan_backward_plain(*(x.float() for x in bargs)).to(bargs[0].dtype))
    else:
        faults["TF32 operands (yardstick)"] = lambda: sk.lstm_scan_backward_plain(*tf32_operands(*bargs, keep=(3,)))
    for fault, run in faults.items():
        ok, text, _ = scan_agreement(torch, kernel_out, run(), backward=True)
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    return fwd_err, bwd_err


def library_lstm_all_ms(torch, D, H, emb, lens=None, grad=None):
    """One cuDNN ``nn.LSTM`` call in ``emb``'s dtype over ``emb`` [L, B, D]:
    unpacked, or packed by ``lens`` (every output returned either way).  With
    ``grad`` (the outputs' cotangent) the backward alone, timed over a
    retained graph.  Timed, never used by the port; returns (ms or None,
    note)."""
    dt = str(emb.dtype).replace("torch.", "")
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=emb.dtype)
    # cuDNN's flat weight buffer does not take bf16, so each call packs the
    # 4 MiB of weights anew (a few microseconds) and warns about it
    warnings.filterwarnings("ignore", message="RNN module weights are not part")
    x = emb.detach().clone().requires_grad_(grad is not None)
    form = "packed" if lens is not None else "unpacked"

    def pack(t):
        return t if lens is None else torch.nn.utils.rnn.pack_padded_sequence(
            t, lens.clamp(min=1).cpu(), enforce_sorted=True)

    try:
        inp = pack(x)
        if grad is None:
            with torch.no_grad():
                return cuda_ms(lambda: lstm(inp), iters=10), f"nn.LSTM {form} {dt} forward (cuDNN), every output"
        out, _ = lstm(inp)
        out, g = (out, grad) if lens is None else (out.data, pack(grad).data)
        return (cuda_ms(lambda: out.backward(g, retain_graph=True), iters=10),
                f"nn.LSTM {form} {dt} backward (cuDNN), every output's cotangent into inputs and weights")
    except RuntimeError as e:  # a library build without LSTM support in this dtype
        return None, f"nn.LSTM {dt} {form} unavailable: {str(e).splitlines()[0]}"


def time_scan(torch, captured_fwd, captured_bwd, fwd_err, bwd_err):
    """Kernels 7 and 8 on the first unfused step's entity pass: kernel,
    plain version, bound, and cuDNN's unpacked ``nn.LSTM`` (which also does
    the input projection) forward and backward.  Returns the two rows."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    (x_proj, w_hh), _ = captured_fwd[0]
    bargs = captured_bwd[1]
    L, B, H4 = x_proj.shape
    H = H4 // 4
    dtype = x_proj.dtype
    sfx = "_f32" if dtype == torch.float32 else ""
    emb = torch.randn(L, B, H, device="cuda").to(dtype) * 0.1
    rows = []
    for name, row, fn, plain, grad, err in (
            ("lstm_scan_fwd", 7, lambda: sk.lstm_scan_forward(x_proj, w_hh),
             lambda: sk.lstm_scan_forward_plain(x_proj, w_hh), None, fwd_err),
            ("lstm_scan_bwd", 8, lambda: sk.lstm_scan_backward(*bargs),
             lambda: sk.lstm_scan_backward_plain(*bargs), bargs[4], bwd_err)):
        ms = cuda_ms(fn, iters=10)
        plain_ms = cuda_ms(plain, iters=3)
        library_ms, note = library_lstm_all_ms(torch, H, H, emb, grad=grad)
        ops, bytes_ = lstm_bound(row, L, B, H, H, L * B, x_proj.element_size())
        bound, by = bound_ms(ops, bytes_, peak_flops(dtype))
        print(f"{name}{sfx} timing training entity pass L={L} B={B} H={H}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {library_ms} ms ({note}), bound {bound:.4f} ms ({by}: {ops:.4e} FLOP, {bytes_:.4e} B)"
              f"{ffma_note(ops, dtype)}")
        rows.append({"name": name + sfx, "route": "cuda", "source": f"{PKG}/csrc/lstm_scan.cu",
                     "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:"
                                 + ("47" if row == 7 else "110"),
                     "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})
    return rows


# ----------------------------------- kernels 5 and 6: the fused every-state LSTM


def every_state_agreement(torch, args, got, want):
    """Kernel 5's (hs, cs) against the plain version's at the positions each
    row reaches, by the forward's rule of their dtype."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    act = active_mask(torch, args)
    hs, cs = (agreement(g[act], w.to(g.device)[act]) for g, w in zip(got, want))
    return hs.ok() and cs.ok(), f"hs {hs}; cs {cs}", max(hs.max_abs_err, cs.max_abs_err)


def every_state_cases(torch, fwd_args, ragged):
    """The recorded fused entity pass and ragged B of the same width: each
    case's forward arguments and a cotangent of every state, zero at the
    positions a row never reaches."""
    emb = fwd_args[0]
    D, H = emb.shape[2], fwd_args[2].shape[1]
    gen = torch.Generator(device=emb.device).manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    cases = [(f"training entity pass B={emb.shape[1]}", fwd_args)]
    for b in ragged:
        e, wi, wh, bi, ln, _ = lstm_inputs(torch, gen, emb.shape[0], b, D, H, synth_lengths(rng, b), emb.dtype)
        cases.append((f"B={b}", (e, wi, wh, bi, ln)))
    out = []
    for label, args in cases:
        act = active_mask(torch, args)
        L, B = act.shape
        dhs = (torch.randn(L, B, H, generator=gen, device=emb.device) * 0.1 * act[..., None]).to(emb.dtype)
        out.append((label, args, dhs))
    return out


def check_every_state(torch, fwd_args, ragged=(1, 37, 4099)):
    """Kernels 5 and 6 against their plain versions on the first fused
    step's recorded entity pass and at ragged B, with a planted fault each
    (hs written one step late; the cotangent added only at each row's last
    step), and at f32 the TF32 yardstick and a dropped bias each.  Returns
    (forward error, backward error)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    fwd_err = bwd_err = 0.0
    f32 = fwd_args[0].dtype == torch.float32
    sfx = "_f32" if f32 else ""
    cases = every_state_cases(torch, fwd_args, ragged)
    for label, args, dhs in cases:
        hs, cs = lk.lstm_all_forward(*args)
        ok, text, err = every_state_agreement(torch, args, (hs, cs), lk.lstm_all_forward_plain(*args))
        print(f"lstm_all_fwd{sfx} {label}: {text}")
        check(ok, f"the every-state forward kernel disagrees with its plain version at {label}")
        fwd_err = max(fwd_err, err)
        bargs = (*args, hs, cs, dhs)
        share = args[0].shape[1] >= SHARE_MIN_ROWS
        ok, text, err = backward_agreement(torch, bargs, lk.lstm_all_backward(*bargs),
                                           lk.lstm_all_backward_plain(*bargs), share=share)
        print(f"lstm_all_bwd{sfx} {label}: {text}{'' if share or f32 else ' (ulp bound only: one row)'}")
        check(ok, f"the every-state backward kernel disagrees with its plain version at {label}")
        bwd_err = max(bwd_err, err)

    _, args, dhs = cases[0]
    got = lk.lstm_all_forward(*args)
    hs, cs = lk.lstm_all_forward_plain(*args)
    no_bias = (*args[:3], torch.zeros_like(args[3]), args[4])
    fwd_faults = {"hs one step late": (torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]), cs)}
    if f32:
        fwd_faults.update({"TF32 operands (yardstick)": lk.lstm_all_forward_plain(*tf32_operands(*args)),
                           "bias dropped": lk.lstm_all_forward_plain(*no_bias)})
    for fault, planted in fwd_faults.items():
        ok, text, _ = every_state_agreement(torch, args, got, planted)
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    bargs = (*args, *got, dhs)
    lens = args[4].clamp(min=1).long()
    dlast = dhs[lens - 1, torch.arange(len(lens), device=lens.device)]
    bwd_faults = {"cotangent added only at each row's last step": lambda: lk.lstm_last_backward_plain(
        *args, *got, dlast)}
    if f32:
        bwd_faults.update({
            "TF32 operands (yardstick)": lambda: lk.lstm_all_backward_plain(*tf32_operands(*bargs, keep=(3, 6))),
            "bias dropped": lambda: lk.lstm_all_backward_plain(*no_bias, *got, dhs)})
    kernel_out = lk.lstm_all_backward(*bargs)
    for fault, run in bwd_faults.items():
        ok, text, _ = backward_agreement(torch, bargs, kernel_out, run())
        print(f"planted fault {fault}: {text}")
        check(not ok, f"the rule passes a planted fault ({fault})")
    if f32:
        check_1xtf32_variant(torch, bargs, True, lk.lstm_all_backward_plain(*bargs))
    return fwd_err, bwd_err


def time_every_state(torch, fwd_args, fwd_err, bwd_err):
    """Kernels 5 and 6 on the first fused step's entity pass: kernel, plain
    version, bound, and cuDNN's packed ``nn.LSTM`` returning every output
    (forward, and backward of every output's cotangent).  Returns the two
    rows."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    _, args, dhs = every_state_cases(torch, fwd_args, ())[0]
    hs, cs = lk.lstm_all_forward(*args)
    bargs = (*args, hs, cs, dhs)
    emb, lens = args[0], args[4]
    L, B, D = emb.shape
    H = args[2].shape[1]
    sfx = "_f32" if emb.dtype == torch.float32 else ""
    n_steps = int(lens.clamp(min=1).sum().item())
    rows = []
    for name, row, fn, plain, grad, err, src, line in (
            ("lstm_all_fwd", 5, lambda: lk.lstm_all_forward(*args), lambda: lk.lstm_all_forward_plain(*args),
             None, fwd_err, f"lstm_last_fwd{sfx}.cu", "272"),
            ("lstm_all_bwd", 6, lambda: lk.lstm_all_backward(*bargs), lambda: lk.lstm_all_backward_plain(*bargs),
             dhs, bwd_err, "lstm_last_bwd.cu", "341")):
        ms = cuda_ms(fn, iters=10)
        plain_ms = cuda_ms(plain, iters=3)
        library_ms, note = library_lstm_all_ms(torch, D, H, emb, lens=lens, grad=grad)
        ops, bytes_ = lstm_bound(row, L, B, D, H, n_steps, emb.element_size())
        bound, by = bound_ms(ops, bytes_, peak_flops(emb.dtype))
        print(f"{name}{sfx} timing training entity pass L={L} B={B} D=H={D}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms} ms ({note}), kernel/library "
              f"{ms / library_ms if library_ms else float('nan'):.3f}, bound {bound:.4f} ms ({by}: {ops:.4e} FLOP, "
              f"{bytes_:.4e} B, {n_steps} row-steps){ffma_note(ops, emb.dtype)}")
        rows.append({"name": name + sfx, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                     "replaces": f"open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:{line}",
                     "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})
    return rows


def phase_every_state_op(torch, fwd_args):
    """The op that reaches kernels 5 and 6, ``ops/lstm.py::lstm_forward_tm_sorted``
    (the JAX package's tests are its only callers), forward and backward on
    the recorded entity pass with f32 parameters, counts set to 0 just
    before and read just after."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm import lstm_forward_tm_sorted

    emb, w_ih, w_hh, bias, lens = fwd_args
    params = {"w_ih": w_ih.detach().float().requires_grad_(), "w_hh": w_hh.detach().float().requires_grad_(),
              "b_ih": bias.detach().clone().requires_grad_(), "b_hh": torch.zeros_like(bias).requires_grad_()}
    x = emb.detach().clone().requires_grad_()
    act = active_mask(torch, fwd_args)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    hs = lstm_forward_tm_sorted(params, x, lens)
    (torch.where(act[..., None], hs.float(), 0.0) ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    L = emb.shape[0]
    want = {name: 0 for name in counters}
    want.update({"lstm_all_fwd": L, "lstm_all_bwd": backward_launches(L, str(emb.dtype))})
    # x.grad (demb) holds unread garbage at the positions a row never reaches
    grads = {**{n: p.grad for n, p in params.items()}, "x": x.grad[act]}
    finite = {n: torch.isfinite(g).all().item() for n, g in grads.items()}
    print(f"lstm_forward_tm_sorted forward and backward, entity pass B={emb.shape[1]}: launches {launches}, "
          f"finite gradients {finite}")
    check(launches == want, f"lstm_forward_tm_sorted launches {launches}, want {want}")
    check(all(finite.values()), f"lstm_forward_tm_sorted gave non-finite gradients: {finite}")
    return launches


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
    library_ms, note = library_row_adagrad_ms(torch, g_, u_, v_, p_, a_, c_, e_)
    print(f"scatter_adagrad timing entity token table {list(p_.shape)}, {n_valid} rows: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {library_ms} ms ({note}), bound {bound:.4f} ms "
          f"(bytes: {bytes_:.4e} B)")
    return {"name": "scatter_adagrad", "route": "triton", "source": f"{PKG}/ops/scatter_adagrad_kernel.py",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/scatter_adagrad_kernel.py:52",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms}


def library_row_adagrad_ms(torch, g_rows, uids, valid, p, acc, clr, eps):
    """``torch.optim.Adagrad.step`` on a sparse COO gradient of the same rows
    of the same table and accumulator, with ``weight_decay=0``: torch refuses
    weight decay with sparse gradients, so this is the row update without
    the kernel's lazy weight decay.  Timed, never used by the port."""
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    try:
        idx = uids[valid]
        grad = torch.sparse_coo_tensor(idx[None], g_rows[valid], p.shape).coalesce()
        param = torch.nn.Parameter(p.clone())
        opt = torch.optim.Adagrad([param], lr=float(clr), eps=eps, weight_decay=0)
        opt.state[param]["sum"].copy_(acc)

        def step():
            param.grad = grad
            opt.step()

        return cuda_ms(step, iters=50), "torch.optim.Adagrad.step, sparse COO gradient of the same rows, weight_decay=0"
    except (RuntimeError, TypeError, ValueError) as e:
        return None, f"torch.optim.Adagrad with a sparse gradient unavailable: {str(e).splitlines()[0]}"


# ------------------------------------------------------------ the f32 model


def write_f32_config():
    """The flagship config with its ``dtype`` line removed, so the model
    computes in float32, the default of both packages."""
    import yaml

    cfg = yaml.safe_load(FLAGSHIP.read_text())
    cfg["model_config"].pop("dtype")
    F32_CONFIG.parent.mkdir(parents=True, exist_ok=True)
    F32_CONFIG.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return F32_CONFIG


def phase_f32(torch, timings, by_path):
    """The f32 model through the same entry points as the bf16 phases, with
    the f32 modes of kernels 1, 2 and 5-8 held to their plain versions by the
    f32 rule (the TF32 yardstick, a dropped bias and a dropped recurrent
    product must fail it); fills ``by_path`` with the launch counts of its
    paths and returns the six f32 kernel rows."""
    config = write_f32_config()
    rows = [phase_kernels(torch, torch.float32)]
    trainer, capture, by_path["train_f32"], n_steps = phase_train(torch, timings, config=config, tag="f32_")
    check(trainer.model.embedder.dtype == "float32", f"the f32 config built a {trainer.model.embedder.dtype} model")
    ckpt = check_training(torch, trainer, by_path["train_f32"], n_steps)
    time_train_steps(torch, trainer, timings, pre="f32_")
    del trainer
    row_bwd, fwd_err = check_lstm_backward(torch, capture.bwd)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], fwd_err, check_lstm_residuals(torch, capture.fwd))
    rows.append(row_bwd)
    entity_pass = capture.fwd[0][0]
    del capture
    rows += time_every_state(torch, entity_pass, *check_every_state(torch, entity_pass))
    by_path["op_f32"] = phase_every_state_op(torch, entity_pass)
    del entity_pass
    torch.cuda.empty_cache()

    trainer, capture, by_path["train_unfused_f32"], n_steps = phase_train(
        torch, timings, unfused=True, config=config, tag="f32_")
    check(not (capture.fwd or capture.bwd) and len(capture.scan_fwd) == len(capture.scan_bwd) == 2,
          "the unfused f32 run recorded fused launches or missed the recurrence's")
    check_training(torch, trainer, by_path["train_unfused_f32"], n_steps, unfused=True)
    del trainer
    rows += time_scan(torch, capture.scan_fwd, capture.scan_bwd, *check_scan(torch, capture.scan_fwd, capture.scan_bwd))
    del capture
    torch.cuda.empty_cache()

    by_path["serve_f32"] = phase_main_path(torch, timings, ckpt=ckpt, config=config, tag="f32_")
    torch.cuda.empty_cache()
    return rows


def phase_any_h(torch):
    """The unfused path at H = 100 (D = 64), in bf16 and f32: kernels 7 and 8
    through the padded route (bf16 pads H to 104, f32 takes 100 as it is)
    against their plain versions on the same inputs, and the op
    ``ops/lstm.py::lstm_forward_tm`` forward and backward on the card against
    the CPU, with exact launch counts."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
        MAX_UNEQUAL_SHARE,
        MAX_UNEQUAL_SHARE_BWD,
        agreement,
    )

    L, B, D, H = 10, 1024, 64, 100
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        x_proj, w_hh = scan_inputs(torch, gen, L, B, H, dtype)
        dhs = (torch.randn(L, B, H, generator=gen, device="cuda") * 0.1).to(dtype)
        before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
        hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
        dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
        launches = (sk.lstm_scan_forward.launches - before[0], sk.lstm_scan_backward.launches - before[1])
        want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
        checks = {"hs": agreement(hs, want_hs), "cs": agreement(cs, want_cs),
                  "dx_proj": agreement(dxp, sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs))}
        print(f"H={H} {dtype} kernels 7/8 vs plain, B={B}: launches {launches}; "
              + "; ".join(f"{k} {a}" for k, a in checks.items()))
        check(launches == (L, 2 * L - 1), f"H={H} {dtype}: launches {launches}, want {(L, 2 * L - 1)}")
        check(all(a.ok(MAX_UNEQUAL_SHARE_BWD if k == "dx_proj" else MAX_UNEQUAL_SHARE) for k, a in checks.items()),
              f"H={H} {dtype}: kernels 7/8 disagree with their plain versions")

        rng = np.random.default_rng(SEED + 7)
        init = {"w_ih": (4 * H, D), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
        params = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32) for n, s in init.items()}
        x = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
        cot = torch.from_numpy((rng.standard_normal((L, B, H)) * 0.5).astype(np.float32))
        res = []
        for dev in ("cuda", "cpu"):
            p = {n: torch.from_numpy(v).to(dev).requires_grad_() for n, v in params.items()}
            px = torch.from_numpy(x).to(dev).requires_grad_()
            out = port_lstm.lstm_forward_tm(p, px.to(dtype))
            (out.float() * cot.to(dev)).sum().backward()
            res.append([t.detach().cpu() for t in (out, px.grad, p["w_ih"].grad, p["w_hh"].grad)])
        names = ("hs", "dx", "dW_ih", "dW_hh")
        agree = {n: agreement(g.to(dtype), w.to(dtype)) for n, g, w in zip(names, *res)}
        print(f"H={H} {dtype} lstm_forward_tm on the card vs the CPU, B={B} D={D}: "
              + "; ".join(f"{k} {a}" for k, a in agree.items()))
        check(all(a.ok(MAX_UNEQUAL_SHARE if k == "hs" else MAX_UNEQUAL_SHARE_BWD) for k, a in agree.items()),
              f"H={H} {dtype}: the unfused op on the card disagrees with the CPU")


def build_kernels(torch, timings):
    """nvcc for every CUDA source (started together), then one launch of each
    Triton kernel on a few elements, which compiles it."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update
    from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(CUDA_SOURCES)
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
    print(f"build: nvcc {timings['build_cuda_s']:.2f} s ({len(CUDA_SOURCES)} sources in parallel), Triton "
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
        global PEAK_FP32_FLOPS
        PEAK_FP32_FLOPS, sms, mhz = read_fp32_peak(torch)
        print(f"FP32 peak outside the tensor cores: {sms} SMs x 128 lanes x 2 FLOP x {mhz:.0f} MHz (max SM clock) = "
              f"{PEAK_FP32_FLOPS / 1e12:.2f} TFLOP/s; 3xTF32 (the f32 kernels' bound): {PEAK_BF16_FLOPS / 1e12:.0f} / 6 = "
              f"{PEAK_3XTF32_FLOPS / 1e12:.2f} TFLOP/s")
        build_kernels(torch, timings)
        row_fwd = phase_kernels(torch)
        by_path = {}
        trainer, capture, by_path["train"], n_steps = phase_train(torch, timings)
        ckpt = check_training(torch, trainer, by_path["train"], n_steps)
        time_train_steps(torch, trainer, timings)
        table_heights = [trainer.variables["params"][t].shape[0]
                         for t in ("entity_token_embedding", "relation_token_embedding")]
        del trainer
        row_bwd, fwd_err = check_lstm_backward(torch, capture.bwd)
        fwd_err = max(fwd_err, check_lstm_residuals(torch, capture.fwd))
        time_forward_passes(torch, capture.fwd)
        row_fwd["max_abs_err"] = max(row_fwd["max_abs_err"], fwd_err)
        rows = [row_fwd, row_bwd,
                check_adagrad(torch, capture.dense, table_heights),
                check_row_adagrad(torch, capture.rows)]
        fused_entity_pass = capture.fwd[0][0]
        del capture
        rows += time_every_state(torch, fused_entity_pass, *check_every_state(torch, fused_entity_pass))
        by_path["op"] = phase_every_state_op(torch, fused_entity_pass)
        del fused_entity_pass
        torch.cuda.empty_cache()

        trainer, capture, by_path["train_unfused"], n_steps = phase_train(torch, timings, unfused=True)
        check(not (capture.fwd or capture.bwd) and len(capture.scan_fwd) == len(capture.scan_bwd) == 2,
              "the unfused run recorded fused launches or missed the recurrence's")
        ckpt_unfused = check_training(torch, trainer, by_path["train_unfused"], n_steps, unfused=True)
        with unfused_switch():
            time_train_steps(torch, trainer, timings, pre="unfused_")
        del trainer
        rows += time_scan(torch, capture.scan_fwd, capture.scan_bwd,
                          *check_scan(torch, capture.scan_fwd, capture.scan_bwd))
        del capture
        torch.cuda.empty_cache()

        by_path["serve"] = phase_main_path(torch, timings, ckpt=ckpt)
        with unfused_switch():
            by_path["serve_unfused"] = phase_main_path(torch, timings, ckpt=ckpt_unfused, unfused=True)
        torch.cuda.empty_cache()

        by_path_f32 = {}
        rows += phase_f32(torch, timings, by_path_f32)
        phase_any_h(torch)
        check([row["name"] for row in rows] == KERNEL_ROWS, f"kernel rows {[row['name'] for row in rows]}")
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    for row in rows:
        # an LSTM row counts the paths of its dtype; the Adagrads run on both
        name = row["name"].removesuffix("_f32")
        paths = (by_path_f32 if row["name"].endswith("_f32") else by_path) if name.startswith("lstm_") else {
            **by_path, **by_path_f32}
        row["launches_by_path"] = {path: counts[name] for path, counts in paths.items()}
        row["launches"] = sum(row["launches_by_path"].values())
    print("timings: " + json.dumps(timings))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
