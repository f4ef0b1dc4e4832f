#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. print the card's name and power limit (nvidia-smi);
2. build every kernel from the checkout: the CUDA sources of ``csrc/`` with
   one nvcc each, all started together, while every smoke dataset is
   generated beside them; print the build seconds (and a timeline line at
   the end of each phase);
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
   (two passes, by the reference's epoch rule) at the config's own eval
   cadence (a batch-shared validation eval after each pass, 32768
   candidates, model selection on MRR) with every kernel's launch count set
   to 0 just before and read just after.  The inputs of the first step to
   each training kernel are recorded on the way;
5. check the training run: every kernel launched (and how often: the
   evals' kernel 1 passes included), the loss finite and falling, which
   tables went row-sparse on how many steps, the validation rows of
   results.csv and ``model_best-mrr`` loading back, and the last checkpoint
   (optimizer state included) loading back; then time steps
   after warm-up (median and max ms/step, items/s), the host plan per batch,
   and a torch.profiler breakdown of one step by device kernel;
6. hold each training kernel against its plain version on the recorded
   first-step inputs (the entity and the relation pass of the LSTM forward
   with its hs/cs residuals and of the LSTM backward; the dense Adagrad's
   whole group of 12 leaves and the row update's two token tables, each as
   the optimizer launched it, bit-equal with their new steps) and at ragged
   shapes, with planted faults that must fail (among them misplaced bf16
   rounding points, a learning rate taken as a reciprocal and a product, a
   dropped scalar tail, a padding row written), print the yardsticks of the
   backward's share rule, and
   time the kernel, the plain version and one PyTorch library call where
   one computes the same function (the forward on both recorded passes as
   in 3; the Adagrads' device ms from the profiler with L2 flushed before
   each launch and from a CUDA graph of 50 launches, and their host µs per
   launch), and the backward's launches by kind (gate, product,
   dW) each beside its part of the bound on both passes; in bf16 the dW
   launch alone on the entity pass with the rows past each step's active
   prefix zero and NaN (the same bits), and hold the backward's recomputed
   gates to kernel 1's bitwise (both in their measuring variant that stores
   the f32 pre-activation gates, on the entity pass and at B=37 with
   lengths uniform in 0..10: 0 elements may differ);
7. the fused every-state LSTM (kernels 5 and 6, the every-state modes of the
   fused kernels) against its plain versions on the recorded entity pass and
   at ragged B, with a planted fault each, timed; kernel 6 at B = 1 twice
   on the same inputs (bit for bit), and its demb's unequal share against
   the plain version and both errors against an f64 backward over 128
   cotangents; then the op that reaches them
   (``ops/lstm.py::lstm_forward_tm_sorted``) forward and backward with the
   counts set to 0 just before and read just after;
7b. evaluation of the trained checkpoint through ``cli.train --resume CKPT
   --evaluate True``: the batch-shared validation split, and with
   ``--evaluate_on_validation False`` the full-vocabulary test split
   (2.47M candidates, the chunked branch), each with the counts set to 0
   just before and read just after and held exactly (``eval_launches``);
   the metrics finite and ordered, every gold counted, the scores-file
   row; the ranks of one validation batch (from its [B, N] scores) and of
   two test batches (from the port's own gold-row chunk products) recounted
   on the host with numpy (0 may differ; the filter dropped and ties
   counted as ``>`` must each change a rank), the test ranks against f64
   products of the same rows within the f32 error bound; timed (the
   validation pass, the cache encode and the ranking, one device batch of
   256 rows beside its bound) and one batch profiled;
8. the unfused training path: the same ``cli.train`` run with
   ``OKET_DISABLE_LSTM_FUSED=1`` set in this process for that run only (the
   input projection, then kernels 7 and 8 over every row and step), checked
   and timed as in 5; then kernels 7 and 8 against their plain versions on
   its recorded first step and at ragged B, with planted faults, timed (the
   kernel alone, and the port's unfused LSTM with the input projection and
   its products, the work of cuDNN's call beside it), kernel 8's launches by
   kind (gate, product) each beside its part of the bound; in bf16 kernel 8's
   recomputed gates held to kernel 7's bitwise (both in their measuring
   variant that stores the f32 pre-activation gates, on the entity pass and
   at B=37: 0 elements may differ);
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
   f32 mode at B=32768 and ragged B, timed with its measuring variants and
   its split and step launches apart, ``cli.train`` fused and unfused, each
   f32 mode (kernels 1, 2, 5-8) against its plain version on the recorded
   passes and ragged B by the f32 rule of ``utils/numerics.py`` with planted
   faults (the TF32 yardstick, a dropped bias or recurrent product, and for
   the 3xTF32 kernels 1, 2, 5-8 their 1xTF32 variants), the backward's
   launches (split, gate, product, dW) timed each against its part of the
   3xTF32 bound, and kernels 7 and 8's (split apart from the steps; split,
   gate, product), kernel 8's recomputed gates held to kernel 7's bitwise as
   in bf16, kernels 7 and 8 on the trained unfused checkpoint against f64,
   the op of kernels 5 and 6, the test eval of the f32 checkpoint as in 7b,
   and serving of the f32 checkpoint, with exact launch counts (``forward_launches``, ``scan_launches``: an f32 forward is
   L + 1 launches, the weight split and L steps, kernel 8 at f32 2L); then the unfused
   path at H = 100 in bf16 and f32 (kernels 7 and 8 through the padded
   route);
11. the model families (lookup ComplEx, DistMult and Tucker3, unigram and
   bigram pooling, LSTM-Tucker3, the two data-bias diagnostics) through the
   same entry points: an FB15k-237-shaped set from
   ``tools/make_synth_olpbench.py`` (14,541 mentions, 237 relations,
   272,115 triples; valid and test cut to 1000 triples each); lookup
   ComplEx at ``configs/fb15k237/fb15k237-complex-kge.yaml``'s widths
   (d = 200, full-vocabulary 1-vs-all over every entity, batch 512) with
   ``cli.train`` for two passes and a validation eval after each (a copy of
   the config under ``.bench_cache/`` with ``dataset_dir``,
   ``eval_epoch_freq`` 1 and ``save_epoch_freq`` 1), kernel 3 once a step
   and no other kernel, the loss falling, ``model_best-mrr`` and the
   checkpoint with its optimizer state loading back, timed (steps, a
   profile, kernel 3 at these leaves beside its bound), the test eval
   through ``--evaluate`` with one batch's ranks recounted on the host,
   and served (``cli.predict``, ``Predictor`` top-k against a plain CPU
   Predictor); the other seven names two passes over the split's first
   24,000 triples (the data-bias models over the 2.47M-mention set) with
   one validation eval each at their configs' widths, every launch count
   exact (``family_launches``); lookup ComplEx with row-sparse tables on
   the 2.47M-mention set, 4096 x 4096 batch-shared, kernel 4 launched on
   the tables the plans sparsified and its first launch bit-equal to its
   plain version;
12. gradient accumulation, the KL loss, the other optimizers and the lr
   schedulers, and ``resume_filter`` (``phase_objectives``), each through
   ``cli.train`` with exact launch counts: the flagship with
   ``batch_size_for_backward`` 16384 (windows of 4 micro-batches, two
   passes; each window's row-sparse tables counted on the CPU first with
   the port's ``plan_window``), the first window's kernel 3 and 4 launches
   bit-equal to their plain versions and its summed row gradients against
   its four micro-batches' recomputed alone (the f32 rule; one left out
   must fail), the batches carried at the end, ``model_best-mrr``; then
   ``--resume`` from it with ``resume_filter: [lstm]`` and one more pass
   (the LSTM leaves the checkpoint's, the rest the seeded init, at the
   first step); the flagship with ``loss: kl`` (two passes, then
   ``--evaluate`` on both splits: the full-vocabulary test batch 0's loss
   against a dense f32 ``log_softmax`` over every candidate, relative
   1e-4, its ranks recounted on the host), timed beside BCE; and lookup
   ComplEx at FB15k-237's widths under Adam with StepLR, RMSprop (relation
   tables) and Adagrad under ReduceLROnPlateau, and Adagrad switching to
   Adadelta at step 20 under CosineAnnealingLR (every step's lr the
   scheduler's closed form, the lr kernel 3 is handed, JAX's state keys);
12b. benchmark creation (``phase_create_data``): an OPIEC-shaped corpus
   written with numpy and the port's avro writer (250,000 records in 8
   files: 50,000 linked entities with 1-3 surface forms drawn Zipf-like,
   5,000 relation phrases), ``cli.create_data -c`` in a subprocess under
   ``configs/preprocessing/acl2020.yaml``'s settings (each job's seconds,
   each split's lines; no thorough-train pair meets a test pair, every
   ``mapped_to_ids`` file there, a second run skips every job); then on
   its ``train_data_thorough.txt`` the flagship's widths through
   ``cli.train`` (two passes, ``sparse_min_ratio: 2``, ``profile_steps: 2``: the trace under the
   experiment's ``profile/`` names kernel 1's and kernel 2's CUDA
   functions), ``--evaluate`` on its test split and ``cli.predict`` of 4
   text queries, every launch count exact (path ``create_data``) and the
   training run's kernels held to their plain versions;
12c. the per-shard checkpoint read (``phase_shard_ckpt``): the bf16
   flagship checkpoint of 4 cut into two rank slabs in the JAX package's
   per-shard layout (``split_checkpoint``); ``--evaluate`` on the test
   split from the slabs and from the original exactly equal, ``cli.predict``
   the same answers, ``Trainer.load`` every leaf bit-equal (path
   ``shard_ckpt``: the slabs' runs);
12d. the native host helpers (``phase_native``): the C++ library
   (``native/oket_native.cpp``) builds with g++ and loads on the card's host
   (fail if not); on flagship batches of the 2.47M set ``SparsePlanBuilder``
   gives the same arrays with the native branch and with
   ``OKET_DISABLE_NATIVE`` (unique-and-remap, gather-sum plans, dedup),
   timed both ways; the native reader equals the python reader on the
   train file, timed both ways; beside the flagship run's host wait per
   step (``Trainer.step_log``);
12e. data parallelism over ranks (``phase_data_parallel``; each rank a
   process of this script, ``--dp-rank``): ``cli.train`` of the flagship at
   full width with 2 ranks sharing the card through ``gloo`` (two passes
   over the train file's first 20,000 triples, a host-sharded validation
   eval after each, the end-of-run per-shard save), the ranks' params and
   optimizer state bit-equal after every step, the loss finite and falling,
   each rank's launches exact (``dp_launches``: three LSTM blocks a step)
   and its recorded kernels held to their plain versions
   (``check_family_kernels``), the first step against a world of one
   (f32 ranks by the f32 rule; the bf16 gradients no further from the f32
   world of one's than ``DP_BF16_FACTOR`` x the bf16 world of one's), the
   bf16 runs' validation MRRs; the slabs through ``--evaluate`` (test) and
   ``cli.predict`` in one process equal to a single-file save of the same
   params; lookup ComplEx on the FB15k-shaped set with 2 ranks against a
   world of one on ``nccl``, every parameter within the f32 rule; per rank
   ms per step, collective ms per step (synchronized) and peak memory (each
   world of one of this phase and of ``phase_model_parallel`` runs beside
   its ranks: times of ranks sharing the card show correctness, not
   speed);
12f. multi-step dispatch (``phase_scan``, ``train_scan_steps``): the
   flagship in bf16 at its config's windows of 64 on a 500,000-triple cut
   of the 2.47M-mention set (a run with single steps and one with windows,
   from one weight file), in f32 with windows of 8 in a new
   process under torch.profiler (``--scan-profile``: kernels 1-4 counted
   from the device records), and FB15k-237 lookup ComplEx with windows of
   64; each window run's counters with its replays' launches against its
   eager twin's (a), the device records (b), one Adagrad launch a step
   (c), its first captured launches held to their plain versions
   (against f64 beside the plain version, the step being a late one), the
   first captured window again eagerly from its state (the first loss
   bit-equal, the rest within ``SCAN_RULE_FACTOR`` times two eager runs'
   gap; the state by ``window_rule``: the step counters equal, the same
   leaves moved, the largest leaf gap within that factor of the eager
   runs', a rule that the state left unchanged, one step short or with
   its largest table's update left out must fail), a background save right after it against the state it was taken
   from, loaded back and evaluated; ms a step inside a window against
   eager, the busy share, capture and instantiate s, peak memory;
13. the Adagrads' host cost through the entry points every tree of the port
   has (``launch_cost``; ``python3 chip_smoke.py --launch-cost DIR`` runs
   only that, on the port in the checkout at DIR, to hold two trees against
   each other in one call); print the timings, one JSON line with every
   kernel's numbers (the
   eight ports and the f32 modes of the six LSTM kernels, launches by path:
   an LSTM row counts the paths of its dtype), and last
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --mrr-spread`` runs only the validation MRR of the
data-parallel cut over ``MRR_SEEDS`` in every layout (a world of one, data
parallel, the model axis; bf16 and f32).  ``python3 chip_smoke.py
--backward-split DIR`` times only the bf16 and f32 backwards' launches by
kind of the port in the checkout at DIR on seeded inputs at the flagship's
pass shapes, and the dW launch alone in its variants and at f32 against
f64 (``backward_split``), so that a parent and a change run in turns in one
call.

Imports nothing of JAX.  Needs one card; writes only under ``.bench_cache/``
and the package's ``_build/``.
"""

from __future__ import annotations

import contextlib
import csv
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
CUDA_SOURCES = ["lstm_last_fwd.cu", "lstm_last_fwd_f32.cu", "lstm_last_bwd.cu", "lstm_scan.cu", "adagrad.cu"]
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


def train_args(config, out_dir, evaluate=False):
    """cli.train's arguments: two passes over the smoke set; with
    ``evaluate`` the config's own eval cadence (the flagship's: a
    validation eval after each pass, model selection on MRR), else none."""
    return [str(config), "--dataset_dir", str(DATA_DIR), *([] if evaluate else ["--eval_epoch_freq", "0"]),
            "--epochs", "2", "--experiment_dir", str(out_dir)]

# H100 SXM HBM3 bandwidth (published)
PEAK_BYTES_PER_S = 3.35e12


def card_peaks(sms, mhz):
    """(bf16 tensor-core, 3xTF32, FP32 FFMA) FLOP/s of ``sms`` SMs at ``mhz``:
    per SM and clock, 4096 dense bf16 FLOP on the tensor cores (NVIDIA's
    published 989 TFLOP/s is 132 SMs at 1830 MHz, below the 1980 MHz the SMs
    reach) and 128 lanes x 2 FLOP of FFMA.  3xTF32, the least time for
    f32-accurate products and the f32 kernels' bound, takes three TF32
    products (at half the bf16 rate) for each f32 one."""
    bf16 = sms * 4096 * mhz * 1e6
    return bf16, bf16 / 6, sms * 128 * 2 * mhz * 1e6


# The peak rates of the bounds, from the card's SM count and maximum SM clock
# (read_peaks, in main); until then an H100 SXM's 132 SMs at 1980 MHz.
PEAK_BF16_FLOPS, PEAK_3XTF32_FLOPS, PEAK_FP32_FLOPS = card_peaks(132, 1980)

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
    if f32:
        check_forward_1xtf32_variant(torch, (emb, wih, whh, bias, lens_t), (ref,), residuals=False, with_last=True)

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
    if f32:
        print_forward_launch_ms(torch, f"lstm_last_fwd_f32 cache chunk B={B}", (emb, wih, whh, bias, lens_t),
                                lambda: lk.lstm_encode_last_fused(emb, wih, whh, bias, lens_t))
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
    ``reps`` turns), beside its bound and its measuring variants (no
    epilogue, no products: what the stream of tiles with the products, and
    with the epilogue, take alone; "no epilogue" multiplies an h drawn like
    a real one, as it writes none; at f32 also 1xTF32, a third of the
    products)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    def run(variant="kernel"):
        return lambda: lk._launch_steps(*args, residuals, True, lk.lstm_encode_last_fused, variant=variant)

    ms, lib = [], []
    for _ in range(reps):
        ms.append(cuda_ms(run(), iters=20))
        lib_ms, note = library_lstm_ms(torch, args)
        lib.append(lib_ms)
    names = lk.FORWARD_F32_VARIANTS if args[0].dtype == torch.float32 else lk.FORWARD_VARIANTS
    variants = {v: cuda_ms(run(v), iters=20) for v in names if v != "kernel"}
    bound, by, flops, bytes_, n_steps = forward_bound(args)
    out = {"ms": float(np.median(ms)), "bound_ms": bound, "bound_by": by,
           "library_ms": None if None in lib else float(np.median(lib))}
    print(f"lstm_last_fwd timing {label} L={args[0].shape[0]} d={args[0].shape[2]} {args[0].dtype}"
          f"{' with residuals' if residuals else ''}: kernel {out['ms']:.4f} ms (turns {ms}), library "
          f"{out['library_ms']} ms (turns {lib}; {note}), kernel/library "
          f"{out['ms'] / out['library_ms'] if out['library_ms'] else float('nan'):.3f}, bound {bound:.4f} ms "
          f"({by}: {flops:.4e} FLOP, {bytes_:.4e} B, {n_steps} row-steps; {bound / out['ms']:.1%} of it"
          f"{ffma_note(flops, args[0].dtype)}); " + ", ".join(f"{v} {t:.4f} ms ({bound / t:.1%} of the bound)"
                                                            for v, t in variants.items()))
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


def start_datasets(sets):
    """Start generating each smoke dataset of ``sets`` (``(directory,
    arguments)`` pairs) that is not there yet (a cached set of other
    arguments is made anew), each in a process of its own -> the jobs for
    ``finish_datasets``."""
    jobs = []
    for data_dir, data_args in sets:
        marker = data_dir / ".smoke_args"
        if (data_dir / "test.txt").exists() and marker.exists() and marker.read_text() == " ".join(data_args):
            continue
        shutil.rmtree(data_dir, ignore_errors=True)
        cmd = [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(data_dir), *data_args]
        jobs.append((data_dir, data_args, subprocess.Popen(cmd), time.perf_counter()))
    return jobs


def finish_datasets(jobs):
    """Wait for ``start_datasets``' jobs (every one stopped if one fails) ->
    the seconds each took, by directory."""
    took = {}
    try:
        for data_dir, data_args, proc, t0 in jobs:
            rc = proc.wait(timeout=max(1.0, 900 - (time.perf_counter() - t0)))
            check(rc == 0, f"generating {data_dir} exited {rc}")
            (data_dir / ".smoke_args").write_text(" ".join(data_args))
            took[data_dir] = time.perf_counter() - t0
    finally:
        for *_, proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return took


def ensure_dataset(data_dir=DATA_DIR, data_args=DATA_ARGS):
    """Generate a smoke dataset (the flagship's by default) unless it is
    there -> the seconds it took."""
    return finish_datasets(start_datasets([(data_dir, data_args)])).get(data_dir, 0.0)


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

    queries = text_queries(DATA_DIR)
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
    cli_lines, timings[pre + "cli_predict_s"] = cli_predict_lines(torch, config, ckpt, DATA_DIR, queries)

    _, _, model, variables = load_user_path(torch, config)
    variables, _, _ = load_checkpoint(ckpt, variables, {})
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

    # checks (cli.predict's lines: cli_predict_lines)
    print("cli.predict:", " ".join(cli_lines[0]), "...")
    E = meta.entities_size
    for direction, (scores, ids) in results.items():
        check(scores.shape == (nq, 10) and ids.shape == (nq, 10), f"{direction} shapes")
        check(np.isfinite(scores).all(), f"{direction}: non-finite scores")
        check((np.diff(scores, axis=1) <= 0).all(), f"{direction}: scores increase along k")
        check(((ids >= meta.min_entities_size) & (ids < E)).all(), f"{direction}: ids out of range")
    # encodes: the cache twice (cli.predict, Predictor; every chunk padded
    # to 32768 rows), an entity and a relation encode per predict call: 4
    # text queries and 20 single queries (B = 1), 22 batches of 1024; each
    # encode runs one launch per step, and a fused f32 encode one more
    L = meta.max_length[0]
    check(L == meta.max_length[1], "entity and relation lengths differ")
    fused_encodes = 2 * n_chunks + 2 * 2 * (1 + n_timed)
    single_encodes = 2 * (len(queries) + 2 * n_timed)
    if unfused:
        fused_encodes, single_encodes = 0, fused_encodes + single_encodes
    dtype = model.embedder.dtype
    want = serving_launches(counters, L, fused_encodes, single_encodes, dtype)
    check(all(launches[k] > 0 for k, v in want.items() if v), f"a serving kernel was never launched: {launches}")
    check(launches == want, f"serving launches {launches}, want {want}")
    split = ", the weight split" if forward_launches(L, dtype) > L else ""
    print(f"main path{' (' + UNFUSED_SWITCH + '=1)' if unfused else ''}: lstm_last_fwd launches="
          f"{launches['lstm_last_fwd']} = {fused_encodes} fused encodes x {forward_launches(L, dtype)} (L={L} steps"
          f"{split}); lstm_scan_fwd launches={launches['lstm_scan_fwd']} = {single_encodes} unfused encodes x "
          f"{scan_launches(L, dtype)[0]} (L={L} steps{split}; {n_chunks} cache chunks, "
          f"1024-query batches {'un' if unfused else ''}fused, single queries unfused)")

    check_against_plain(torch, model, predictor, ent_ids, rel_ids)
    ids = torch.arange(meta.min_entities_size, meta.min_entities_size + chunk, device="cuda")
    if model.embedder.dtype == "float32":
        check_trained_backward(torch, check_trained_forward(torch, model, predictor.variables, ids[:4096]))
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
    so the host side is slower than unprofiled); returns {kernel: ms}."""
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
        return {}
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({busy_us / wall_us:.1%})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:100]}")
    return {e.key: e.self_device_time_total / 1e3 for e in kernels}


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


def check_trained_forward(torch, model, variables, ids):
    """Kernel 1 f32 on a trained checkpoint's entity encode of ``ids`` (the
    inputs the serving encode hands the kernel) against the same recurrence
    in f64, beside the plain version on the card (cuBLAS f32 products)
    against both.  The trained recurrence amplifies every gate error (the
    initial weights do not), so this is where the products' accuracy shows.
    The plain version's own error is of the same order there (2.3e-5 and
    2.6e-5 of max|want| in two runs on an H100, near the f32 rule's limit),
    so the kernel passes by the f32 rule against f64 or, where the f32
    products themselves come near the limit, by reading within twice the
    plain version's error (one tensor-core accumulator over all of K read
    22-37 times it on an H100).  Returns the recorded inputs."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    got = []
    forward = lk._forward

    def record(*args, **kw):
        got.append(_copies(args[:5]))
        return forward(*args, **kw)

    lk._forward = record
    try:
        with torch.no_grad():
            model.embedder.encode_entity(variables, ids)
    finally:
        lk._forward = forward
    check(len(got) == 1, f"the entity encode ran the fused forward {len(got)} times, want once")
    args = got[0]
    kernel = lk._launch_steps(*args, False, True, Uncounted)[0] if args[0].is_cuda else lk.lstm_encode_last_plain(*args)
    plain = lk.lstm_encode_last_plain(*args)
    exact = plain_last_f64(torch, *args)
    yard = agreement(plain.double(), exact)

    def holds(got):
        agree = agreement(got.double(), exact)
        return agree.ok() or agree.rel_err <= 2 * yard.rel_err, agree

    ok, agree = holds(kernel)
    print(f"lstm_last_fwd_f32 on the trained checkpoint's entity encode ({len(ids)} ids), kernel vs f64: {agree}; "
          f"plain (cuBLAS f32) vs f64: {yard}; kernel/plain error {agree.rel_err / max(yard.rel_err, 1e-30):.2f} "
          f"(at most 2 where the rule fails); kernel vs plain {agreement(kernel, plain)}")
    check(ok, f"the f32 forward kernel is less accurate than f32 products on trained weights: {agree}; plain {yard}")
    if args[0].is_cuda:  # the planted fault: one tensor-core accumulator over all of K, no fold
        ok, planted = holds(lk._launch_steps(*args, False, True, Uncounted, variant="one accumulator")[0])
        print(f"planted fault one accumulator (no fold) of lstm_last_fwd_f32, vs f64: {planted}; "
              f"{planted.rel_err / max(yard.rel_err, 1e-30):.2f} times the plain version's error")
        check(not ok, "the trained-weights check passes the forward kernel without its fold")
    return args


def check_trained_backward(torch, args):
    """Kernel 2 f32 on the trained checkpoint's entity encode (``args``, as
    ``check_trained_forward`` recorded it), with the residuals kernel 1
    writes there and a cotangent made from the seed, against the same
    backward in f64, beside the plain version (cuBLAS f32 on the card)
    against both: each output (demb where rows reach, dW_ih, dW_hh, db) by
    the f32 rule against f64, or within twice the plain version's error.
    The planted 1xTF32 variant must fail it (on the CPU, emulated); the
    variant with one tensor-core accumulator over all of K in the gate and
    product launches (no fold) is measured beside it."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    emb = args[0]
    B, H = emb.shape[1], args[2].shape[1]
    forward = lk._launch_steps if emb.is_cuda else lambda *a: lk.lstm_encode_last_plain(*a[:5], residuals=True)
    _, hs, cs = forward(*args, True, True, Uncounted)
    gen = torch.Generator().manual_seed(SEED)
    rest = (hs, cs, torch.randn(B, H, generator=gen).to(emb.device))
    act = active_mask(torch, args)
    names = ("demb", "dW_ih", "dW_hh", "db")

    def parts(out):
        return [out[0][act], *out[1:]]

    exact = parts(plain_last_backward_f64(torch, *args, *rest))
    yard = [agreement(p.double(), e) for p, e in zip(parts(lk.lstm_last_backward_plain(*args, *rest)), exact)]

    def holds(out):
        return f64_agreement(torch, parts(out), exact, yard)

    def text(agree):
        return "; ".join(f"{n} {a.rel_err:.3e} ({a.rel_err / max(y.rel_err, 1e-30):.2f}x plain)"
                         for n, a, y in zip(names, agree, yard))

    def run(variant="kernel"):
        if emb.is_cuda:
            return lk._launch_bwd_steps(*args, *rest, False, Uncounted, variant=variant)
        with one_tf32_product(torch) if variant == "1xTF32" else contextlib.nullcontext():
            return lk.lstm_last_backward_plain(*args, *rest)

    ok, agree = holds(run())
    print(f"lstm_last_bwd_f32 on the trained checkpoint's entity encode ({B} ids), error vs f64 relative to "
          f"max|want| (limit 3e-5, or twice the plain version's): kernel {text(agree)}; plain (cuBLAS f32) "
          + "; ".join(f"{n} {y.rel_err:.3e}" for n, y in zip(names, yard)))
    check(ok, f"the f32 backward kernel is less accurate than f32 products on trained weights: {text(agree)}")
    for variant in ("1xTF32", "one accumulator") if emb.is_cuda else ("1xTF32",):
        v_ok, v_agree = holds(run(variant))
        print(f"{'planted fault' if variant == '1xTF32' else 'measured'} {variant} variant of lstm_last_bwd_f32 on "
              f"trained weights, vs f64: {text(v_agree)}; {'passes' if v_ok else 'fails'}")
        if variant == "1xTF32":
            check(not v_ok, "the trained-weights check passes the backward kernel's 1xTF32 variant")


def plain_last_f64(torch, emb, w_ih, w_hh, bias, lengths):
    """The last state of ``lstm_encode_last_plain``'s recurrence in f64."""
    f = lambda x: x.double()  # noqa: E731
    w_ih_t, w_hh_t = f(w_ih).t(), f(w_hh).t()
    lens = lengths.clamp(min=1)
    h = torch.zeros(emb.shape[1], w_hh.shape[1], dtype=torch.float64, device=emb.device)
    c, last = torch.zeros_like(h), torch.zeros_like(h)
    for t in range(emb.shape[0]):
        i, g_f, g, o = (f(emb[t]) @ w_ih_t + f(bias) + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(g_f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        last = torch.where((lens == t + 1)[:, None], h, last)
    return last


def plain_last_backward_f64(torch, emb, w_ih, w_hh, bias, lengths, hs, cs, dlast, every_step=False):
    """``lstm_last_backward_plain``'s loop in f64 on the same inputs (the
    residuals and cotangent): (demb, dW_ih, dW_hh, db); with ``every_step``
    ``dlast`` is the cotangent of every state [L, B, H] and enters at every
    step a row reaches (``lstm_all_backward_plain``)."""
    f = lambda x: x.double()  # noqa: E731
    L, B, D = emb.shape
    H = w_hh.shape[1]
    lens = lengths.clamp(min=1)
    zeros = torch.zeros(B, H, dtype=torch.float64, device=emb.device)
    dh, dc = zeros, zeros
    demb = torch.zeros(L, B, D, dtype=torch.float64, device=emb.device)
    dw_ih, dw_hh, db = torch.zeros_like(f(w_ih)), torch.zeros_like(f(w_hh)), torch.zeros_like(f(bias))
    for t in reversed(range(L)):
        active = (lens > t)[:, None]
        h_prev = torch.where(active, f(hs[t - 1]), 0.0) if t > 0 else zeros
        c_prev = f(cs[t - 1]) if t > 0 else zeros
        i, g_f, g, o = (f(emb[t]) @ f(w_ih).t() + f(bias) + h_prev @ f(w_hh).t()).chunk(4, dim=-1)
        i, g_f, g, o = torch.sigmoid(i), torch.sigmoid(g_f), torch.tanh(g), torch.sigmoid(o)
        dh = dh + (torch.where(active, f(dlast[t]), 0.0) if every_step
                   else torch.where((lens == t + 1)[:, None], f(dlast), 0.0))
        tc = torch.tanh(f(cs[t]))
        dc = dc + dh * o * (1.0 - tc * tc)
        dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * g_f * (1.0 - g_f), dc * i * (1.0 - g * g),
                        dh * tc * o * (1.0 - o)], dim=-1)
        dg = torch.where(active, dg, 0.0)
        demb[t] = dg @ f(w_ih)
        dw_ih += dg.t() @ f(emb[t])
        dw_hh += dg.t() @ h_prev
        db += dg.sum(0)
        dh = torch.where(active, dg @ f(w_hh), 0.0)
        dc = torch.where(active, dc * g_f, 0.0)
    return demb, dw_ih, dw_hh, db


def plain_scan_f64(torch, x_proj, w_hh):
    """``lstm_scan_forward_plain``'s recurrence in f64: (hs, cs)."""
    f = lambda x: x.double()  # noqa: E731
    w_hh_t = f(w_hh).t()
    h = torch.zeros(x_proj.shape[1], w_hh.shape[1], dtype=torch.float64, device=x_proj.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(x_proj.shape[0]):
        i, g_f, g, o = (f(x_proj[t]) + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(g_f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def plain_scan_backward_f64(torch, x_proj, w_hh, hs, cs, dhs):
    """``lstm_scan_backward_plain``'s loop in f64 on the same inputs (the f32
    residuals and cotangent): dx_proj."""
    f = lambda x: x.double()  # noqa: E731
    L, B, H4 = x_proj.shape
    w = f(w_hh)
    zeros = torch.zeros(B, H4 // 4, dtype=torch.float64, device=x_proj.device)
    dh, dc = zeros, zeros
    dxp = torch.zeros(L, B, H4, dtype=torch.float64, device=x_proj.device)
    for t in reversed(range(L)):
        h_prev, c_prev = (f(hs[t - 1]), f(cs[t - 1])) if t > 0 else (zeros, zeros)
        i, g_f, g, o = (f(x_proj[t]) + h_prev @ w.t()).chunk(4, dim=-1)
        i, g_f, g, o = torch.sigmoid(i), torch.sigmoid(g_f), torch.tanh(g), torch.sigmoid(o)
        dh = dh + f(dhs[t])
        tc = torch.tanh(f(cs[t]))
        dc = dc + dh * o * (1.0 - tc * tc)
        dxp[t] = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * g_f * (1.0 - g_f), dc * i * (1.0 - g * g),
                            dh * tc * o * (1.0 - o)], dim=-1)
        dh = dxp[t] @ w
        dc = dc * g_f
    return dxp


def f64_agreement(torch, got, exact, yard):
    """Each output of ``got`` against its f64 value ``exact``, held by the
    f32 rule or within twice the error of ``yard`` (the plain version's
    agreements with ``exact``): (ok, agreements)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    agree = [agreement(g.double(), e) for g, e in zip(got, exact)]
    return all(a.ok() or a.rel_err <= 2 * y.rel_err for a, y in zip(agree, yard)), agree


def record_scan_encode(torch, config, ckpt, n_ids=4096):
    """What kernel 7 gets from an unfused entity encode of ``n_ids`` entities
    of the checkpoint ``ckpt`` (the switch set, so the encode goes unfused at
    any B), and the rows' lengths that the last-state select then reads:
    copies of (x_proj, w_hh, lengths)."""
    from open_knowledge_graph_embeddings_tpu_torch.models import embedders
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint

    _, meta, model, variables = load_user_path(torch, config)
    variables, _, _ = load_checkpoint(ckpt, variables, {})
    ids = torch.arange(meta.min_entities_size, meta.min_entities_size + n_ids, device="cuda")
    got, lens = [], []
    forward, select = sk._launch_forward, embedders.last_states

    def record(x_proj, w_hh, *a, **kw):
        got.append(_copies((x_proj, w_hh)))
        return forward(x_proj, w_hh, *a, **kw)

    def record_lengths(out_tm, lengths):
        lens.append(lengths.clone())
        return select(out_tm, lengths)

    sk._launch_forward, embedders.last_states = record, record_lengths
    try:
        with unfused_switch(), torch.no_grad():
            model.embedder.encode_entity(variables, ids)
    finally:
        sk._launch_forward, embedders.last_states = forward, select
    check(len(got) == len(lens) == 1, f"the unfused entity encode ran kernel 7 {len(got)} times, want once")
    return (*got[0], lens[0])


def scan_steps(torch, x_proj, w_hh, hs, cs, dtype):
    """Each step of the recurrence taken alone, in ``dtype``, from the state
    (hs[t-1], cs[t-1]) of a recorded run (zero at t = 0): (h_t, c_t) for
    every t, [L, B, H].  In f64 it is the exact step; in f32 it is the plain
    version's arithmetic (one f32 product, the f32 gate math)."""
    L, B, H4 = x_proj.shape
    f = lambda x: x.to(dtype)  # noqa: E731
    zero = torch.zeros(1, B, H4 // 4, dtype=dtype, device=x_proj.device)
    h_prev, c_prev = torch.cat([zero, f(hs[:-1])]), torch.cat([zero, f(cs[:-1])])
    gates = f(x_proj) + torch.matmul(h_prev.reshape(L * B, -1), f(w_hh).t()).reshape(L, B, H4)
    i, g_f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(g_f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def check_trained_scan(torch, x_proj, w_hh, lengths):
    """Kernels 7 and 8 f32 on a trained unfused checkpoint's entity encode
    (``x_proj``, ``w_hh`` and the rows' ``lengths`` as
    ``record_scan_encode`` recorded them) against f64, beside the plain
    version (cuBLAS f32 on the card), each by the f32 rule against f64 or
    within twice the plain version's error (``f64_agreement``):
    - kernel 7's hs and cs at the positions each row reaches (the last-state
      select reads no other), each step against the same step in f64 from
      the kernel's own state (``scan_steps``), and the plain version's step
      from that state beside it;
    - kernel 8's dx_proj against the backward in f64 on kernel 7's residuals,
      with a cotangent at each row's last position made from the seed (as
      the select sends one).
    The trained recurrence amplifies the f32 rounding of every step, of the
    kernel and of cuBLAS alike, so the whole recurrence against f64 is
    printed, not held: on an H100 80GB HBM3 at 700 W kernel 7 read 0.77-2.61
    times cuBLAS's error there across runs (each a new training), where its
    single steps read 0.37-0.48 times cuBLAS's.  The planted 1xTF32 variants
    must fail it (on the CPU, emulated)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    L, B, H4 = x_proj.shape
    last = lengths.to(x_proj.device).long().clamp(1, L) - 1
    reach = torch.arange(L, device=x_proj.device)[:, None] <= last[None, :]  # [L, B]
    gen = torch.Generator().manual_seed(SEED)
    dhs = torch.zeros(L, B, H4 // 4, device=x_proj.device)
    dhs[last, torch.arange(B, device=x_proj.device)] = torch.randn(B, H4 // 4, generator=gen).to(x_proj.device)

    def run(variant="kernel"):
        if x_proj.is_cuda:
            hs, cs = sk._launch_forward(x_proj, w_hh, Uncounted, variant=variant)
            return hs, cs, sk._launch_backward(x_proj, w_hh, hs, cs, dhs, Uncounted, variant=variant)
        with one_tf32_product(torch) if variant == "1xTF32" else contextlib.nullcontext():
            hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
            return hs, cs, sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)

    def holds(out):
        hs, cs, dxp = out
        exact = (*scan_steps(torch, x_proj, w_hh, hs, cs, torch.float64),
                 plain_scan_backward_f64(torch, x_proj, w_hh, hs, cs, dhs))
        plain = (*scan_steps(torch, x_proj, w_hh, hs, cs, torch.float32),
                 sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs))
        read = [lambda x: x[reach]] * 2 + [lambda x: x]
        yard = [agreement(f(p).double(), f(e)) for f, p, e in zip(read, plain, exact)]
        ok, agree = f64_agreement(torch, [f(x) for f, x in zip(read, out)], [f(e) for f, e in zip(read, exact)],
                                  yard)
        text = "; ".join(f"{n} {a.rel_err:.3e} ({a.rel_err / max(y.rel_err, 1e-30):.2f}x plain {y.rel_err:.3e})"
                         for n, a, y in zip(("hs step", "cs step", "dx_proj"), agree, yard))
        return ok, text

    out = run()
    ok, text = holds(out)
    print(f"lstm_scan_fwd_f32 / lstm_scan_bwd_f32 on the trained unfused checkpoint's entity encode ({B} ids, "
          f"{int(reach.sum())} reached positions), error vs f64 relative to max|want| (limit 3e-5, or twice the "
          f"plain version's): {text}")
    check(ok, f"kernels 7/8 f32 are less accurate than f32 products on trained weights: {text}")
    whole = plain_scan_f64(torch, x_proj, w_hh)[0][reach]
    k, pl = (agreement(h[reach].double(), whole).rel_err
             for h in (out[0], sk.lstm_scan_forward_plain(x_proj, w_hh)[0]))
    print(f"measured the whole trained recurrence vs f64, hs at the reached positions: kernel 7 {k:.3e}, plain "
          f"{pl:.3e} ({k / max(pl, 1e-30):.2f}x; not held)")
    v_ok, v_text = holds(run("1xTF32"))
    print(f"planted fault 1xTF32 variant of lstm_scan_fwd_f32 / lstm_scan_bwd_f32 on trained weights, vs f64: "
          f"{v_text}; {'passes' if v_ok else 'fails'}")
    check(not v_ok, "the trained-weights check passes the 1xTF32 variant of kernels 7/8")


# ------------------------------------------------------------------ training


class Capture:
    """Records the first training step's inputs to each training kernel: the
    two LSTM forward launches that write the hs/cs residuals (entity pass,
    then relation pass) with what they returned, the two LSTM backward
    launches (relation pass, then entity pass), the same four of the
    recurrence-only LSTM on the unfused path, the dense Adagrad's group
    launch (every dense leaf) and the row update's launch (both token
    tables), p, acc and the steps cloned before the in-place update.  It
    wraps the modules' CUDA launchers and calls them through, so the
    wrappers launch and count as they do without it.  The recorded inputs are copies: at f32 the weights
    a kernel gets are the parameters themselves (``.to`` of an f32 tensor
    returns it), which the optimizer then updates in place."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.ops import (
            adagrad_kernel,
            lstm_kernel,
            lstm_scan_kernel,
            scatter_adagrad_kernel,
        )

        self.fwd, self.bwd, self.dense, self.rows = [], [], None, None
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

    def _dense(self, gs, ps, accs, steps, clr, hp):
        if self.dense is None and steps is not None:
            self.dense = (*(_clones(x) for x in (gs, ps, accs, steps)), dict(hp))
        return self._orig[1](gs, ps, accs, steps, clr, hp)

    def _rows(self, g_rows, uids, valid, ps, accs, steps, clr, hp):
        if self.rows is None and steps is not None:
            self.rows = (*(_clones(x) for x in (g_rows, uids, valid, ps, accs, steps)), dict(hp))
        return self._orig[2](g_rows, uids, valid, ps, accs, steps, clr, hp)

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


def counted_steps(log):
    """The rows of a step log whose launches the kernel counters saw: every
    step but those of a window replayed from a CUDA graph (a replay
    launches through no wrapper; a capture counts its steps once)."""
    return [s for s in log if s.get("window") != "replay"]


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


def phase_train(torch, timings, unfused=False, config=FLAGSHIP, tag="", evaluate=False):
    """``cli.train`` on ``config`` (the flagship by default), two passes;
    with ``unfused`` the switch is set in this process for this run only;
    with ``evaluate`` at the config's eval cadence.  Each run writes to its
    own experiment directory; ``tag`` prefixes the timings' keys and names
    the directory."""
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
    args = train_args(config, out_dir, evaluate) + ["--device", "cuda"]

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
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint
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
    # one regime group: a dense launch every step (12 LSTM and batchnorm
    # leaves, and a table that falls back to dense), a row launch every step
    # with a row-sparse table
    steps = counted_steps(log)
    n_dense, n_sparse = len(steps), sum(1 for s in steps if s["sparse_tables"])
    val_batches = check_selection(torch, trainer) if trainer.args.get("eval_epoch_freq") else 0
    want = training_launches(launches, L, len(steps), n_dense, n_sparse, trainer.model.embedder.dtype, unfused,
                             val_batches)
    print(f"training path launches{' (' + UNFUSED_SWITCH + '=1)' if unfused else ''}: {launches} (want {want}: "
          "two LSTM passes per step; one dense Adagrad launch per step and one row update launch per step with "
          f"a sparse table, for the one regime group; {val_batches} validation batches of two kernel 1 passes)")
    check(all(launches[k] > 0 for k, v in want.items() if v), f"a training kernel was never launched: {launches}")
    check(launches == want, f"training launches {launches}, want {want}")

    ckpt = Path(trainer.last_checkpoint)
    init = trainer.model.init(torch.Generator(device="cuda").manual_seed(1))
    variables, opt, meta = load_checkpoint(str(ckpt), init, trainer.regimes.init_state(init["params"]))
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
    step_ms, opt_ms, positives = [], [], 0.0
    with OptimizerClock(trainer.regimes) as opt_clock:
        for i, arrays in enumerate(dev[:n]):
            torch.cuda.synchronize()
            t0, opt0 = time.perf_counter(), dict(opt_clock.ms)
            trainer.variables, trainer.opt_state, stats = trainer.train_step(
                trainer.variables, trainer.opt_state, trainer.regimes.hparams(), arrays, trainer.generator)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            opt_ms.append({k: v - opt0[k] for k, v in opt_clock.ms.items()})
            positives += float(stats["normalizer_metric"])
    timings[pre + "optimizer_host_ms_per_step"] = summary([sum(m.values()) for m in opt_ms])
    opt_parts = {k: float(np.median([m[k] for m in opt_ms])) for k in opt_clock.ms}
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
    kernels = device_breakdown(torch, label, lambda: trainer.train_step(
        trainer.variables, trainer.opt_state, trainer.regimes.hparams(), dev[n], trainer.generator), top=16)
    adagrad = {k: ms for k, ms in kernels.items() if "adagrad" in k}
    timings[pre + "optimizer_device_ms_profiled_step"] = sum(adagrad.values())
    parts = ", ".join(f"{k} {v:.3f}" for k, v in opt_parts.items())
    print(f"{pre}optimizer: host {timings[pre + 'optimizer_host_ms_per_step']['median']:.3f} ms a step (median of "
          f"{n}, wall clock without a synchronize; by part {parts}); device {sum(adagrad.values()):.4f} ms in the "
          f"profiled step ({', '.join(f'{k} {v:.4f}' for k, v in adagrad.items())})")


class OptimizerClock:
    """Host time of the sparse step's optimizer calls while the block runs,
    by wall clock, no synchronize, summed in ``ms`` by part:
    ``regimes.make_apply``, the apply it returns (the dense update), and the
    row update (``train/sparse.py``'s ``_SPARSE_RULES``)."""

    def __init__(self, regimes):
        from open_knowledge_graph_embeddings_tpu_torch.train import sparse

        self.regimes, self.rules = regimes, sparse._SPARSE_RULES
        self.ms = {"make_apply": 0.0, "dense apply": 0.0, "row update": 0.0}

    def _timed(self, part, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.ms[part] += (time.perf_counter() - t0) * 1e3
            return out

        return run

    def __enter__(self):
        make_apply = self.regimes.make_apply
        self.regimes.make_apply = self._timed(
            "make_apply", lambda *a, **k: self._timed("dense apply", make_apply(*a, **k)))
        self._rules = dict(self.rules)
        self.rules.update({k: self._timed("row update", fn) for k, fn in self._rules.items()})
        return self

    def __exit__(self, *exc):
        del self.regimes.make_apply
        self.rules.update(self._rules)


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


def plain_states_f64(torch, emb, w_ih, w_hh, bias, lengths):
    """``lstm_encode_last_plain``'s recurrence in f64: (last, hs, cs)."""
    f = lambda x: x.double()  # noqa: E731
    w_ih_t, w_hh_t = f(w_ih).t(), f(w_hh).t()
    lens = lengths.clamp(min=1)
    h = torch.zeros(emb.shape[1], w_hh.shape[1], dtype=torch.float64, device=emb.device)
    c, last, hs, cs = torch.zeros_like(h), torch.zeros_like(h), [], []
    for t in range(emb.shape[0]):
        i, g_f, g, o = (f(emb[t]) @ w_ih_t + f(bias) + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(g_f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        last = torch.where((lens == t + 1)[:, None], h, last)
        hs.append(h)
        cs.append(c)
    return last, torch.stack(hs), torch.stack(cs)


def forward_f64_agreement(torch, args, got, want):
    """Kernel 1's training outputs (``got``: last, and hs and cs where each
    row reaches) and the plain version's (``want``) against the recurrence
    in f64: each of the kernel's by the f32 rule or within twice the plain
    version's error (``f64_agreement``), the rule of trained weights, where
    ``residual_agreement``'s unequal share, set at the first step, read up
    to 2.03 % on the captured path (its limit 2 %); that rule's reading
    printed beside.  Returns (ok, text, largest error against the plain
    version)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    act = active_mask(torch, args).to(got[0].device)

    def parts(out):
        return [out[0], out[1][act], out[2][act]]

    exact = parts(plain_states_f64(torch, *args))
    yard = [agreement(p.double(), e) for p, e in zip(parts(want), exact)]
    ok, agree = f64_agreement(torch, parts(got), exact, yard)
    _, share_text, err = residual_agreement(torch, args, got, want)
    text = ("error vs f64 relative to max|want|, kernel / plain version: "
            + "; ".join(f"{n} {a.rel_err:.3e} / {y.rel_err:.3e}" for n, a, y in zip(("last", "hs", "cs"), agree, yard))
            + f" (kernel within twice the plain version's); against the plain version: {share_text}")
    return ok, text, err


def backward_f64_agreement(torch, args, got, want):
    """Kernel 2's outputs (``got``) and the plain version's (``want``)
    against the same backward in f64 (demb where rows reach, dW_ih, dW_hh,
    db): each of the kernel's by the f32 rule or within twice the plain
    version's error (``f64_agreement``), the rule of trained weights, where
    ``backward_agreement``'s share and db rule, set at the first step, read
    up to 13.5 % unequal and 1.27e-4 of max|db| on the captured path (its
    limits 10 % and 1e-4); that rule's reading printed beside.  Returns (ok, text, largest error
    against the plain version)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    act = active_mask(torch, args).to(got[0].device)

    def parts(out):
        return [out[0][act], *out[1:]]

    exact = parts(plain_last_backward_f64(torch, *args))
    yard = [agreement(p.double(), e) for p, e in zip(parts(want), exact)]
    ok, agree = f64_agreement(torch, parts(got), exact, yard)
    _, share_text, err = backward_agreement(torch, args, got, want)
    names = ("demb", "dW_ih", "dW_hh", "db")
    text = ("error vs f64 relative to max|want|, kernel / plain version: "
            + "; ".join(f"{n} {a.rel_err:.3e} / {y.rel_err:.3e}" for n, a, y in zip(names, agree, yard))
            + f" (kernel within twice the plain version's); against the plain version: {share_text}")
    return ok, text, err


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
    # rounded), at f32 the TF32 yardstick, a dropped bias and the kernel's
    # 1xTF32 variant
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
    if cs.dtype == torch.float32:
        check_forward_1xtf32_variant(torch, args, (last, hs, cs), residuals=True, with_last=True)
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
    if dtype == torch.bfloat16:
        check_gates_bitwise(torch, f"training entity pass B={entity[0].shape[1]}", entity[:5])
    check_dw_poisoned_rows(torch, "training entity pass", entity)
    for label, lens in cases:
        b = len(lens)
        emb, wih, whh, bias, lens_t, _ = lstm_inputs(torch, gen, 10, b, 512, 512, lens, dtype)
        fwd_args = (emb, wih, whh, bias, lens_t)
        if dtype == torch.bfloat16 and "uniform" in label:
            check_gates_bitwise(torch, label, fwd_args)
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
    print_backward_launch_ms(torch, f"lstm_last_bwd{sfx}", args, lambda: lk.lstm_last_backward(*args))
    t0 = time.perf_counter()
    print_backward_launch_ms(torch, f"lstm_last_bwd{sfx}", relation, lambda: lk.lstm_last_backward(*relation),
                             label="relation pass")
    print(f"lstm_last_bwd{sfx} relation pass launch split: {time.perf_counter() - t0:.1f} s")
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


def forward_launches(L, dtype):
    """Launches of one call of kernel 1 or 5 over L steps at ``dtype``
    ("bfloat16"/"float32", or a torch dtype): one per step; at f32 one more,
    the weight split."""
    return L + (1 if str(dtype).removeprefix("torch.") == "float32" else 0)


def scan_launches(L, dtype):
    """Launches of one forward and one backward call of kernels 7 and 8 over L
    steps at ``dtype`` ("bfloat16"/"float32", or a torch dtype): one per
    step forward; a gate launch per step and a product launch from step 1 on
    backward; at f32 one more each, the weight split."""
    split = 1 if str(dtype).removeprefix("torch.") == "float32" else 0
    return L + split, 2 * L - 1 + split


def training_launches(names, L, n_steps, n_dense, n_sparse, dtype, unfused=False, val_batches=0):
    """The launches a cli.train run of ``n_steps`` steps must count, by
    kernel row: two LSTM passes per step, fused (kernels 1 and 2) or unfused
    (kernels 7 and 8, ``scan_launches``); ``n_dense`` dense Adagrad and
    ``n_sparse`` row update launches (each one a step and regime group, the
    row update only on a step with a row-sparse table of the group:
    ``train/sparse.py::make_sparse_train_step``); and the evals' kernel 1
    launches over ``val_batches`` batch-shared validation batches
    (``eval_launches``)."""
    want = eval_launches(names, L, dtype, val_batches=val_batches)
    want.update({"adagrad_update": n_dense, "scatter_adagrad": n_sparse})
    if unfused:
        fwd, bwd = scan_launches(L, dtype)
        want.update({"lstm_scan_fwd": 2 * n_steps * fwd, "lstm_scan_bwd": 2 * n_steps * bwd})
    else:  # both passes fused (B % 8 == 0 at the flagship's 512-row buckets)
        want["lstm_last_fwd"] += 2 * n_steps * forward_launches(L, dtype)
        want["lstm_last_bwd"] = 2 * n_steps * backward_launches(L, dtype)
    return want


def serving_launches(names, L, fused_encodes, single_encodes, dtype):
    """The launches a serving run must count: kernel 1 per fused encode,
    kernel 7 per unfused one."""
    want = {name: 0 for name in names}
    want.update({"lstm_last_fwd": fused_encodes * forward_launches(L, dtype),
                 "lstm_scan_fwd": single_encodes * scan_launches(L, dtype)[0]})
    return want


def op_launches(names, L, dtype):
    """The launches of one forward and backward of
    ``lstm_forward_tm_sorted``: kernels 5 and 6."""
    want = {name: 0 for name in names}
    want.update({"lstm_all_fwd": forward_launches(L, dtype), "lstm_all_bwd": backward_launches(L, dtype)})
    return want


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


# the kinds of launch of the f32 kernels, by a part of their kernel's name
BACKWARD_F32_KINDS = {"split": "split_kernel_tf32", "gate": "gate_kernel_tf32", "product": "product_kernel_tf32",
                      "dW": "dw_kernel_tf32"}
# and of the bf16 backward (the f32 gate and product kernels' names hold
# these too, so they are read only from a bf16 call)
BACKWARD_BF16_KINDS = {"gate": "lstm_bwd_gate_kernel", "product": "lstm_bwd_product_kernel",
                       "dW": "lstm_bwd_dw_kernel_bf16"}
# the same kinds in any tree of the port, the dW launch by a prefix of the
# names of each dtype's kernels in every tree (``--backward-split``: a
# parent beside a change; the f32 dW launch kept its name when it moved
# from mma.sync to wgmma)
BACKWARD_BF16_KINDS_ANY_TREE = {**BACKWARD_BF16_KINDS, "dW": "lstm_bwd_dw_kernel"}
BACKWARD_F32_KINDS_ANY_TREE = {**BACKWARD_F32_KINDS, "dW": "lstm_bwd_dw_kernel_tf32"}
FORWARD_F32_KINDS = {"split": "split_kernel_tf32", "steps": "fwd_step_kernel_tf32"}


# traces taken of a call before its launch split is given up as not measured,
# and the launches of a small fill that open the first (four times as many
# each try after)
LAUNCH_TRACE_TRIES = 3
LAUNCH_TRACE_PAD = 128


def launch_ms(torch, fn, kinds=BACKWARD_F32_KINDS, reps=5, want=None):
    """Device ms per call of each kind of launch of ``fn`` (all the call's
    launches of that kind; the f32 backward's split, gate, product, dW by
    default), from torch.profiler over ``reps`` calls of ``fn``; None where
    the trace has no device time.  With ``want`` (each kind's launches a
    call) the trace's records are counted: minutes into a busy process the
    profiler loses a session's first GPU records (the first 6 of an f32
    backward's trace, ~80 of a bf16 one's, on an H100; PERF.md §6), so the
    session opens with ``LAUNCH_TRACE_PAD`` launches of a small fill that
    no kind counts, and a trace still short of a kind's launches is taken
    again with four times the fill, up to ``LAUNCH_TRACE_TRIES`` times;
    None where none held them all.  A kind with no record while every
    other kind holds all of its launches is no loss (a lost prefix of whole
    calls takes every kind of them): it is returned at 0."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.empty(1, device="cuda") if want and torch.cuda.is_available() else None
    for attempt in range(LAUNCH_TRACE_TRIES if want else 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCH_TRACE_PAD * 4 ** attempt if pad is not None else 0):
                pad.zero_()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, counts = {k: 0.0 for k in kinds}, {k: 0 for k in kinds}
        for e in prof.key_averages():
            for k, sub in kinds.items():
                if sub in e.key:
                    out[k] += e.self_device_time_total / 1e3 / reps
                    if want:
                        counts[k] += e.count
        whole = all(not counts[k] or counts[k] >= reps * n for k, n in (want or {}).items()) and any(counts.values())
        if not want or whole:
            return out if any(out.values()) else None
        print(f"launch split: the trace holds {counts} of {({k: reps * n for k, n in want.items()})} launches "
              f"(records lost)")
    return None


def print_backward_launch_ms(torch, name, args, fn, kinds=None, label="entity pass"):
    """The launches of one call ``fn`` of kernel 2 or 6 on ``args`` by kind
    (device ms per call, torch.profiler): at bf16 gate, product and dW, at
    f32 also the split (``kinds`` by default); each product kind beside the
    bound of its part (``backward_parts``, at the dtype's peak rate).
    Returns the ms by kind, or None where no trace holds every launch
    (``launch_ms``); a trace with all the launches of some kinds but none of
    another fails (a kernel renamed away from its kind would be read as
    free)."""
    emb, lens = args[0], args[4]
    L = emb.shape[0]
    f32 = emb.dtype == torch.float32
    kinds = kinds or (BACKWARD_F32_KINDS if f32 else BACKWARD_BF16_KINDS)
    want = {"split": 1, "gate": L, "product": L, "dW": 1}
    by_kind = launch_ms(torch, fn, kinds, want={k: want[k] for k in kinds})
    if by_kind is None:
        print(f"{name} launches: no whole trace of the call's launches (not measured)")
        return None
    check(all(by_kind.values()), f"{name}: no device time for the kinds "
          f"{[k for k, v in by_kind.items() if not v]} ({kinds})")
    parts = backward_parts(emb.shape[1], emb.shape[2], args[2].shape[1], int(lens.clamp(min=1).sum().item()))
    peak = peak_flops(emb.dtype)
    rate = "3xTF32" if f32 else "bf16"

    def part(k, v):
        if k not in parts or not v:
            return ""
        bound = parts[k] / peak * 1e3
        return f" ({rate} bound of its part {bound:.4f}, {bound / v:.1%} of it)"

    print(f"{name} launches on the {label} B={emb.shape[1]}, device ms per call (torch.profiler): "
          + ", ".join(f"{k} {v:.4f}{part(k, v)}" for k, v in by_kind.items()) + f"; sum {sum(by_kind.values()):.4f}")
    return by_kind


def gates_unequal(torch, fwd_args, fwd_gates, bwd_gates):
    """(elements not bitwise equal, elements compared) of two [L, B, 4H]
    f32 stores of the pre-activation gates at the positions each row
    reaches; the others are never written."""
    act = active_mask(torch, fwd_args)
    got, want = fwd_gates[act].view(torch.int32), bwd_gates[act].view(torch.int32)
    return int((got != want).sum().item()), got.numel()


def check_gates_bitwise(torch, label, fwd_args, stored=None):
    """Kernel 1 (with residuals, as training runs it) and the bf16
    backward's gate launch on its residuals, each in its measuring variant
    that stores the f32 pre-activation gates of every step: the two must be
    bitwise equal (they run one loop, lstm_bf16.cuh, on the same tiles).
    ``stored`` gives the two stores instead of running the launches (the
    CPU test plants a difference there)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    emb, w_hh = fwd_args[0], fwd_args[2]
    if stored is None:
        L, B, H = emb.shape[0], emb.shape[1], w_hh.shape[1]
        stored = [torch.zeros(L, B, 4 * H, dtype=torch.float32, device=emb.device) for _ in range(2)]
        _, hs, cs = lk._launch_steps(*fwd_args, True, True, Uncounted, gates=stored[0])
        dlast = torch.zeros(B, H, dtype=emb.dtype, device=emb.device)
        lk._launch_bwd_steps(*fwd_args, hs, cs, dlast, False, Uncounted, gates=stored[1])
        torch.cuda.synchronize()
    n, total = gates_unequal(torch, fwd_args, *stored)
    print(f"gates bitwise, kernel 1 vs the backward's gate launch, {label}: {n} of {total} f32 pre-activation "
          f"gates unequal")
    check(n == 0, f"the backward's gate launch does not recompute kernel 1's gates bitwise at {label}: {n} unequal")


def check_dw_poisoned_rows(torch, label, args):
    """The dW launch alone (``lstm_kernel._launch_dw``, bf16 or f32 as the
    pass) on a pass's x, hs and lengths with a seeded dg and db_part, twice:
    with the rows of dg, x and hs past each step's active prefix (and
    db_part's inactive row tiles) zero, and filled with NaN.  The kernel
    zeroes a step's last chunk past its prefix (in the ring's slot at bf16,
    in the transposed tiles it writes at f32; TMA zero-fills only past B),
    so the two must be the same bits; dW is held to f32
    products of the active rows by the rule of its dtype (bf16's, or the
    f32 rule), db to the f32 sum of the active tiles within ``DB_RTOL``."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement, f32_agreement

    t0 = time.perf_counter()
    emb, lens, hs = args[0], args[4], args[5]
    L, B, D = emb.shape
    H = hs.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lens_i = lens.to(torch.int32).contiguous()
    nrows = [int(n) for n in (lens_i.clamp(min=1)[None, :] > torch.arange(L, device="cuda")[:, None]).sum(1)]
    rows = torch.arange(B, device="cuda")
    past = torch.stack([rows >= n for n in nrows])  # [L, B]: row past step t's prefix
    past_h = torch.ones_like(past)  # hs[t] is read at step t + 1 only
    past_h[:-1] = past[1:]
    nrb = -(-B // 128)
    tile_past = torch.stack([torch.arange(nrb, device="cuda") * 128 >= n for n in nrows])  # [L, nrb]
    dt = emb.dtype
    dg = (torch.randn(L, B, 4 * H, generator=gen, device="cuda") * 0.05).to(dt)
    db_part = torch.randn(L, nrb, 4 * H, generator=gen, device="cuda")
    outs = {}
    for fill in (0.0, float("nan")):
        filled = [x.masked_fill(m[..., None], fill) for x, m in ((dg, past), (emb, past), (hs, past_h),
                                                                  (db_part, tile_past))]
        out = (torch.empty(4 * H, D, dtype=dt, device="cuda"), torch.empty(4 * H, H, dtype=dt, device="cuda"),
               torch.empty(4 * H, device="cuda"))
        lk._launch_dw(*filled[:3], lens_i, filled[3], *out, lk._sm_count(0), torch.cuda.current_stream().cuda_stream)
        outs[fill == 0.0] = out
    torch.cuda.synchronize()
    zero, nan = outs[True], outs[False]
    unequal = [int((a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
                    != b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32)).sum().item())
               for a, b in zip(zero, nan)]
    dgf, xf, hf = (x.masked_fill(m[..., None], 0.0).float() for x, m in ((dg, past), (emb, past), (hs, past_h)))
    want_ih = torch.einsum("lbg,lbd->gd", dgf, xf)
    want_hh = torch.einsum("lbg,lbh->gh", dgf[1:], hf[:-1])
    want_db = db_part.masked_fill(tile_past[..., None], 0.0).sum((0, 1))
    if dt == torch.float32:
        a_ih, a_hh = f32_agreement(zero[0], want_ih), f32_agreement(zero[1], want_hh)
    else:
        a_ih, a_hh = agreement(zero[0], want_ih.to(dt)), agreement(zero[1], want_hh.to(dt))
    db_err = (zero[2] - want_db).abs().max().item() / want_db.abs().max().item()
    print(f"dW launch alone, {label} B={B} {dt}: dW_ih {a_ih}; dW_hh {a_hh}; db {db_err:.3e} of max|want|; NaN "
          f"past each step's prefix vs zero there: {unequal} of {[x.numel() for x in zero]} elements unequal (dW_ih, "
          f"dW_hh, db); {time.perf_counter() - t0:.1f} s")
    check(unequal == [0, 0, 0], f"the dW launch reads rows past the active prefix at {label}: {unequal} unequal")
    check(a_ih.ok() and a_hh.ok(), f"the dW launch disagrees with f32 products at {label}")
    check(db_err <= DB_RTOL, f"db of the dW launch off by {db_err:.3e} of max|want| at {label}")


def check_scan_gates_bitwise(torch, label, x_proj, w_hh, stored=None):
    """Kernel 7 and kernel 8's gate launch (bf16 or f32) on kernel 7's
    residuals, each in its measuring variant that stores the f32
    pre-activation gates of every (row, step): the two must be bitwise equal
    (they run one function of their dtype, lstm_scan.cu's
    ``scan_gate_tiles``, on the same tiles and maps).
    ``stored`` gives the two stores instead of running the launches (the
    CPU test plants a difference there)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    if stored is None:
        L, B, H4 = x_proj.shape
        stored = [torch.zeros(L, B, H4, dtype=torch.float32, device=x_proj.device) for _ in range(2)]
        hs, cs = sk._launch_forward(x_proj, w_hh, Uncounted, gates=stored[0])
        sk._launch_backward(x_proj, w_hh, hs, cs, torch.zeros_like(hs), Uncounted, gates=stored[1])
        torch.cuda.synchronize()
    fwd, bwd = stored
    check(bool(torch.isfinite(fwd).all()) and fwd.abs().max().item() > 0,
          f"kernel 7's stored gates at {label} are not finite or all zero")
    n = int((fwd.view(torch.int32) != bwd.view(torch.int32)).sum().item())
    print(f"gates bitwise, kernel 7 vs kernel 8's gate launch, {label}: {n} of {fwd.numel()} f32 pre-activation "
          f"gates unequal")
    check(n == 0, f"kernel 8's gate launch does not recompute kernel 7's gates bitwise at {label}: {n} unequal")


def check_1xtf32_variant(torch, args, every_step, want):
    """The f32 backward's planted 1xTF32 variant (one TF32 product where the
    kernel takes three) against the plain version ``want`` must fail the f32
    rule: the rule sees the correction products.  On the CPU, where there is
    no kernel, the variant is the plain version with each product emulated
    as one TF32 product (``utils/numerics.py::matmul_3xtf32``)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    if args[0].is_cuda:
        got = lk._launch_bwd_steps(*args, every_step, Uncounted, variant="1xTF32")
    else:
        with one_tf32_product(torch):
            got = (lk.lstm_all_backward_plain if every_step else lk.lstm_last_backward_plain)(*args)
    ok, text, _ = backward_agreement(torch, args, got, want)
    print(f"planted fault 1xTF32 variant of lstm_{'all' if every_step else 'last'}_bwd_f32: {text}")
    check(not ok, "the f32 rule passes the backward kernel's 1xTF32 variant")


class Uncounted:
    """A launch counter for the launches that compare a kernel with its
    plain version (not the main path's)."""

    launches = 0


@contextlib.contextmanager
def one_tf32_product(torch):
    """``torch.matmul`` as one TF32 product (hi.hi' alone) while the block
    runs: the 1xTF32 variants of the f32 kernels, emulated on the CPU
    (``utils/numerics.py::matmul_3xtf32``), where there is no kernel."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import matmul_3xtf32

    matmul = torch.matmul
    torch.matmul = lambda a, b: matmul_3xtf32(a, b, passes=1)
    try:
        yield
    finally:
        torch.matmul = matmul


def check_forward_1xtf32_variant(torch, args, want, residuals, with_last):
    """The f32 forward's planted 1xTF32 variant (one TF32 product where the
    kernel takes three) in the mode ``residuals`` / ``with_last`` must fail
    the f32 rule against the plain outputs ``want`` (those the mode writes,
    in the order last, hs, cs; hs and cs at the positions each row
    reaches).  On the CPU the variant is the plain version with each
    product emulated as one TF32 product."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import agreement

    if args[0].is_cuda:
        out = lk._launch_steps(*args, residuals, with_last, Uncounted, variant="1xTF32")
    else:
        with one_tf32_product(torch):
            out = lk.lstm_encode_last_plain(*args, residuals=True)
    names = [n for n, keep in (("last", with_last), ("hs", residuals), ("cs", residuals)) if keep]
    got = [x for x, keep in zip(out, (with_last, residuals, residuals)) if keep]
    act = active_mask(torch, args)
    agree = {n: agreement(g, w) if n == "last" else agreement(g[act], w[act]) for n, g, w in zip(names, got, want)}
    text = "; ".join(f"{n} {a}" for n, a in agree.items())
    kernel = "lstm_last_fwd_f32" if with_last else "lstm_all_fwd_f32"
    print(f"planted fault 1xTF32 variant of {kernel}{' with residuals' if with_last and residuals else ''}: {text}")
    check(not all(a.ok() for a in agree.values()), "the f32 rule passes the forward kernel's 1xTF32 variant")


def print_forward_launch_ms(torch, label, args, fn):
    """The f32 forward's split launch and its L step launches apart (device
    ms per call of ``fn``, torch.profiler), each beside its bound: the
    split moves bytes (both weights read, their hi and lo parts written),
    the steps do the forward's products (``forward_bound``)."""
    kinds = launch_ms(torch, fn, FORWARD_F32_KINDS)
    if kinds is None:
        print(f"{label} launches: no device time in the trace (not measured)")
        return
    w_ih, w_hh = args[1], args[2]
    split_bytes = 3 * (w_ih.numel() + w_hh.numel()) * 4
    split_bound = split_bytes / PEAK_BYTES_PER_S * 1e3
    step_bound = forward_bound(args)[0]
    print(f"{label} launches, device ms per call (torch.profiler): split {kinds['split']:.4f} (bytes bound "
          f"{split_bound:.4f}, {split_bytes:.4e} B), steps {kinds['steps']:.4f} (3xTF32 bound {step_bound:.4f}, "
          f"{step_bound / kinds['steps'] if kinds['steps'] else float('nan'):.1%} of it); sum "
          f"{sum(kinds.values()):.4f}")


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


def bound_ms(ops, bytes_, peak=None):
    t_ops, t_bytes = ops / (peak or PEAK_BF16_FLOPS) * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def read_peaks(torch):
    """Sets the peak rates from this card's SM count and the maximum SM clock
    nvidia-smi reads; returns (SMs, MHz)."""
    global PEAK_BF16_FLOPS, PEAK_3XTF32_FLOPS, PEAK_FP32_FLOPS
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PEAK_BF16_FLOPS, PEAK_3XTF32_FLOPS, PEAK_FP32_FLOPS = card_peaks(sms, mhz)
    return sms, mhz


def peak_flops(dtype):
    """The peak rate the kernels of ``dtype`` are bound by: bf16 tensor cores,
    or at f32 the 3xTF32 rate (the least time for f32-accurate products)."""
    return PEAK_3XTF32_FLOPS if str(dtype) == "torch.float32" else PEAK_BF16_FLOPS


# rounds of 10 calls each in which cuDNN's LSTM backward is timed: one
# round's reading moved 1.09-2.87 ms within and between calls on the same
# seeded passes (NVIDIA H100 80GB HBM3), so its median stands for it
LIBRARY_ROUNDS = 7


def library_lstm_backward_ms(torch, args):
    """cuDNN's packed ``nn.LSTM`` backward on the same inputs and cotangent
    (h_n's gradient into the inputs and weights), timed alone over a
    retained graph: the median ms of ``LIBRARY_ROUNDS`` rounds of 10 calls,
    the rounds' least and largest in the note; never used by the port."""
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
        rounds = [cuda_ms(lambda: h_n.backward(grad, retain_graph=True), iters=10) for _ in range(LIBRARY_ROUNDS)]
    except RuntimeError as e:  # a library build without this dtype's LSTM backward
        return None, f"nn.LSTM {dt} backward unavailable: {str(e).splitlines()[0]}"
    return float(np.median(rounds)), (f"nn.LSTM packed {dt} backward (cuDNN), h_n cotangent into inputs and weights; "
                                      f"median of {LIBRARY_ROUNDS} rounds, least {min(rounds):.4f}, "
                                      f"largest {max(rounds):.4f}")


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


def check_scan_gates(torch, entity_pass):
    """Kernel 8's recomputed gates against kernel 7's, bitwise, in the dtype
    of the unfused training entity pass ``entity_pass`` (x_proj, w_hh): on
    that pass and at B=37."""
    x_proj, w_hh = entity_pass
    dt = "f32 " if x_proj.dtype == torch.float32 else ""
    check_scan_gates_bitwise(torch, f"{dt}unfused training entity pass B={x_proj.shape[1]}", x_proj, w_hh)
    gen = torch.Generator(device=x_proj.device).manual_seed(SEED + 9)
    check_scan_gates_bitwise(torch, f"{dt}B=37",
                             *scan_inputs(torch, gen, x_proj.shape[0], 37, w_hh.shape[1], x_proj.dtype))


def check_scan_1xtf32_variant(torch, entity_pass, bargs):
    """Kernels 7 and 8 at f32 in their planted 1xTF32 variant (one TF32
    product where the kernels take three) on the unfused training entity
    pass, run as the unfused LSTM runs them: kernel 7's variant on
    ``entity_pass`` (x_proj, w_hh), then kernel 8's on its residuals with
    ``bargs``' cotangent (that pass's recorded backward: the selected last
    states' cotangent).  Against the plain versions, the f32 rule must fail
    the pair on some output (hs, cs, dx_proj), as it must fail kernel 2's
    variant.  Kernel 8's variant alone, on ``bargs``' residuals, must read
    at least ten times the kernel's error there: at the initial weights it
    reads within the rule (2.68e-05 of max|want| on an H100 80GB HBM3 at
    700 W; the dh carry is the only product it feeds, and the recurrence is
    short there), so the rule alone does not see it; the trained-weights
    check (``check_trained_scan``) holds it too.  On the CPU, where there is
    no kernel, the variant is the plain version with each product emulated
    as one TF32 product (``utils/numerics.py::matmul_3xtf32``) and the
    kernel is the plain version."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh = entity_pass
    dhs = bargs[4]
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_pair = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    if x_proj.is_cuda:
        got_f = sk._launch_forward(x_proj, w_hh, Uncounted, variant="1xTF32")
        got_pair = sk._launch_backward(x_proj, w_hh, *got_f, dhs, Uncounted, variant="1xTF32")
        got_alone = sk._launch_backward(*bargs, Uncounted, variant="1xTF32")
        kernel_alone = sk._launch_backward(*bargs, Uncounted)
    else:
        with one_tf32_product(torch):
            got_f = sk.lstm_scan_forward_plain(x_proj, w_hh)
            got_pair = sk.lstm_scan_backward_plain(x_proj, w_hh, *got_f, dhs)
            got_alone = sk.lstm_scan_backward_plain(*bargs)
        kernel_alone = sk.lstm_scan_backward_plain(*bargs)
    B = x_proj.shape[1]
    ok_f, text_f, _ = scan_agreement(torch, got_f, (hs, cs))
    ok_b, text_b, _ = scan_agreement(torch, got_pair, want_pair, backward=True)
    print(f"planted fault 1xTF32 variant of lstm_scan_fwd_f32 + lstm_scan_bwd_f32 B={B}: {text_f}; {text_b}")
    check(not (ok_f and ok_b), "the f32 rule passes the 1xTF32 variant of kernels 7 and 8")
    want_alone = sk.lstm_scan_backward_plain(*bargs)
    (_, text_v, err_v), (_, text_k, err_k) = (scan_agreement(torch, g, want_alone, backward=True)
                                              for g in (got_alone, kernel_alone))
    print(f"planted fault 1xTF32 variant of lstm_scan_bwd_f32 alone B={B}, on the recorded residuals: {text_v}; "
          f"the kernel {text_k}; variant/kernel error {err_v / max(err_k, 1e-30):.1f} (at least 10)")
    check(err_v >= 10 * err_k, "kernel 8's 1xTF32 variant is not visibly less accurate than the kernel")


def library_lstm_all_ms(torch, D, H, emb, lens=None, grad=None):
    """One cuDNN ``nn.LSTM`` call in ``emb``'s dtype over ``emb`` [L, B, D]:
    unpacked, or packed by ``lens`` (every output returned either way).  With
    ``grad`` (the outputs' cotangent) the backward alone, timed over a
    retained graph: the median of ``LIBRARY_ROUNDS`` rounds of 10 calls, the
    rounds' least and largest in the note.  Timed, never used by the port;
    returns (ms or None, note)."""
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
        rounds = [cuda_ms(lambda: out.backward(g, retain_graph=True), iters=10) for _ in range(LIBRARY_ROUNDS)]
        return float(np.median(rounds)), (f"nn.LSTM {form} {dt} backward (cuDNN), every output's cotangent into "
                                          f"inputs and weights; median of {LIBRARY_ROUNDS} rounds, least "
                                          f"{min(rounds):.4f}, largest {max(rounds):.4f}")
    except RuntimeError as e:  # a library build without LSTM support in this dtype
        return None, f"nn.LSTM {dt} {form} unavailable: {str(e).splitlines()[0]}"


# kernel 8's kinds of launch, by a part of their names (both dtypes), and at
# f32 the weight split before them; kernel 7's at f32: the split and the steps
SCAN_BACKWARD_KINDS = {"gate": "scan_bwd_gate_kernel", "product": "product_kernel"}
SCAN_BACKWARD_F32_KINDS = {"split": "split_kernel_tf32", **SCAN_BACKWARD_KINDS}
SCAN_FORWARD_F32_KINDS = {"split": "split_kernel_tf32", "steps": "scan_step_kernel_tf32"}


def scan_backward_parts(L, B, H, es):
    """(operations, bytes) of kernel 8's kinds of launch over L steps of B
    rows with elements of ``es`` bytes: the gate launches recompute the h
    products from step 1 on and read x_proj, hs, cs, dhs and W_hh and write
    dx_proj; the product launches (from step 1 on) read dx_proj and W_hh and
    write the f32 dh carry; at f32 (``es`` = 4) the split reads W_hh and
    writes the hi and lo parts of it and of its transpose."""
    prod = (L - 1) * B * 2 * H * 4 * H
    w = 4 * H * H * es
    parts = {"gate": (prod, L * B * (4 * H + 3 * H + 4 * H) * es + w),
             "product": (prod, (L - 1) * B * (4 * H * es + H * 4) + w)}
    return {"split": (0, 5 * w), **parts} if es == 4 else parts


def print_scan_backward_launch_ms(torch, label, bargs, fn):
    """Kernel 8's launches of one call ``fn`` on ``bargs`` by kind (at f32
    the split, then gate, product; device ms per call, torch.profiler), each
    beside the bound of its part (``scan_backward_parts``, at the dtype's
    peak rate).  Returns the ms by kind, or None where the trace has no
    device time."""
    x_proj = bargs[0]
    by_kind = launch_ms(torch, fn, SCAN_BACKWARD_F32_KINDS if x_proj.dtype == torch.float32 else SCAN_BACKWARD_KINDS)
    if by_kind is None:
        print(f"{label} launches: no device time in the trace (not measured)")
        return None
    L, B, H4 = x_proj.shape
    parts = scan_backward_parts(L, B, H4 // 4, x_proj.element_size())

    def part(k, v):
        bound, by = bound_ms(*parts[k], peak_flops(x_proj.dtype))
        return f"{k} {v:.4f} (bound of its part {bound:.4f}, {by}, {bound / v if v else float('nan'):.1%} of it)"

    print(f"{label} launches, device ms per call (torch.profiler): "
          + ", ".join(part(k, v) for k, v in by_kind.items()) + f"; sum {sum(by_kind.values()):.4f}")
    return by_kind


def print_scan_forward_launch_ms(torch, label, x_proj, w_hh, fn):
    """Kernel 7 f32's split launch and its L step launches apart (device ms
    per call of ``fn``, torch.profiler), each beside its bound: the split
    moves bytes (W_hh read, its hi and lo parts written), the steps do
    kernel 7's work (``lstm_bound`` row 7)."""
    kinds = launch_ms(torch, fn, SCAN_FORWARD_F32_KINDS)
    if kinds is None:
        print(f"{label} launches: no device time in the trace (not measured)")
        return
    L, B, H4 = x_proj.shape
    split_bytes = 3 * w_hh.numel() * 4
    split_bound = split_bytes / PEAK_BYTES_PER_S * 1e3
    step_bound, by = bound_ms(*lstm_bound(7, L, B, H4 // 4, H4 // 4, L * B, 4), PEAK_3XTF32_FLOPS)
    print(f"{label} launches, device ms per call (torch.profiler): split {kinds['split']:.4f} (bytes bound "
          f"{split_bound:.4f}, {split_bytes:.4e} B), steps {kinds['steps']:.4f} (bound {step_bound:.4f}, {by}, "
          f"{step_bound / kinds['steps'] if kinds['steps'] else float('nan'):.1%} of it); sum "
          f"{sum(kinds.values()):.4f}")


def same_work_ms(torch, w_hh, emb, grad=None):
    """The port's unfused LSTM over ``emb`` [L, B, D] (``ops/lstm.py::
    lstm_forward_tm``): the input projection and kernel 7, or with ``grad``
    (every output's cotangent) its backward alone over a retained graph,
    kernel 8 and the dW_hh, dx, dW_ih and db products: the work of cuDNN's
    unpacked ``nn.LSTM`` call on the same shapes.  ``w_hh`` is the
    recurrence's; W_ih and the biases are random."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm

    L, B, D = emb.shape
    H = w_hh.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    k = 1.0 / H ** 0.5
    params = {"w_ih": torch.empty(4 * H, D, device="cuda").uniform_(-k, k, generator=gen).to(emb.dtype),
              "w_hh": w_hh.clone(),
              "b_ih": torch.empty(4 * H, device="cuda").uniform_(-k, k, generator=gen),
              "b_hh": torch.empty(4 * H, device="cuda").uniform_(-k, k, generator=gen)}
    if grad is None:
        with torch.no_grad():
            return cuda_ms(lambda: port_lstm.lstm_forward_tm(params, emb), iters=10)
    for v in params.values():
        v.requires_grad_()
    x = emb.detach().clone().requires_grad_()
    out = port_lstm.lstm_forward_tm(params, x)
    return cuda_ms(lambda: out.backward(grad, retain_graph=True), iters=10)


def time_scan(torch, captured_fwd, captured_bwd, fwd_err, bwd_err):
    """Kernels 7 and 8 on the first unfused step's entity pass: kernel,
    plain version, bound, cuDNN's unpacked ``nn.LSTM`` (which also does the
    input projection, and in its backward the dx and dW products) forward
    and backward, and the port's unfused LSTM doing that same work
    (``same_work_ms``); kernel 8's launches by kind, and at f32 kernel 7's
    split apart from its steps.  Returns the two rows."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    (x_proj, w_hh), _ = captured_fwd[0]
    bargs = captured_bwd[1]
    L, B, H4 = x_proj.shape
    H = H4 // 4
    dtype = x_proj.dtype
    sfx = "_f32" if dtype == torch.float32 else ""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    emb = torch.randn(L, B, H, generator=gen, device="cuda").to(dtype) * 0.1
    rows = []
    for name, row, fn, plain, grad, err in (
            ("lstm_scan_fwd", 7, lambda: sk.lstm_scan_forward(x_proj, w_hh),
             lambda: sk.lstm_scan_forward_plain(x_proj, w_hh), None, fwd_err),
            ("lstm_scan_bwd", 8, lambda: sk.lstm_scan_backward(*bargs),
             lambda: sk.lstm_scan_backward_plain(*bargs), bargs[4], bwd_err)):
        ms = cuda_ms(fn, iters=10)
        plain_ms = cuda_ms(plain, iters=3)
        library_ms, note = library_lstm_all_ms(torch, H, H, emb, grad=grad)
        same_ms = same_work_ms(torch, w_hh, emb, grad)
        ops, bytes_ = lstm_bound(row, L, B, H, H, L * B, x_proj.element_size())
        bound, by = bound_ms(ops, bytes_, peak_flops(dtype))
        print(f"{name}{sfx} timing training entity pass L={L} B={B} H={H}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {library_ms} ms ({note}), bound {bound:.4f} ms ({by}: {ops:.4e} FLOP, {bytes_:.4e} B)"
              f"{ffma_note(ops, dtype)}")
        work = "input projection + kernel 7" if row == 7 else "kernel 8 + the dW_hh, dx, dW_ih and db products"
        ratio = f"{same_ms / library_ms:.3f}" if library_ms else "not measured"
        print(f"{name}{sfx} same work as the library call (the port's unfused LSTM, {work}): {same_ms:.4f} ms, "
              f"library {library_ms} ms, port/library {ratio}")
        rows.append({"name": name + sfx, "route": "cuda", "source": f"{PKG}/csrc/lstm_scan.cu",
                     "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py:"
                                 + ("47" if row == 7 else "110"),
                     "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})
    print_scan_backward_launch_ms(torch, f"lstm_scan_bwd{sfx} training entity pass B={B}", bargs,
                                  lambda: sk.lstm_scan_backward(*bargs))
    if dtype == torch.float32:
        print_scan_forward_launch_ms(torch, f"lstm_scan_fwd{sfx} training entity pass B={B}", x_proj, w_hh,
                                     lambda: sk.lstm_scan_forward(x_proj, w_hh))
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
    step), and at f32 the TF32 yardstick, a dropped bias and the kernels'
    1xTF32 variants.  Returns (forward error, backward error)."""
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
    if f32:
        check_forward_1xtf32_variant(torch, args, (hs, cs), residuals=True, with_last=False)
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


def one_row_inputs(torch, D=512, L=10, seed=1, device="cuda"):
    """The inputs of ``tests/test_torch_cuda.py``'s one-row case of kernels
    5 and 6 (its ``_inputs`` at B = 1, seed B): lengths 0..L, bf16
    embeddings and gate-major weights, f32 bias, on the card."""
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, 1).astype(np.int32))[::-1].copy()
    k = 1.0 / np.sqrt(D)
    emb = (rng.standard_normal((L, 1, D)) * 0.5).astype(np.float32)
    w_ih = rng.uniform(-k, k, (4 * D, D)).astype(np.float32)
    w_hh = rng.uniform(-k, k, (4 * D, D)).astype(np.float32)
    bias = rng.uniform(-2 * k, 2 * k, 4 * D).astype(np.float32)
    bf = lambda x: torch.from_numpy(x).to(device, torch.bfloat16)  # noqa: E731
    return bf(emb), bf(w_ih), bf(w_hh), torch.from_numpy(bias).to(device), torch.from_numpy(lens).to(device)


def check_one_row_backward(torch, draws=128, device="cuda"):
    """Kernel 6 in bf16 at B = 1, D = H = 512 (the card test's one-row case):
    twice on the same inputs, bit for bit (demb at the positions the row
    reaches, dW, db); then over ``draws`` cotangents of every state (draw k
    from numpy's generator seeded 201 + k: draw 0 is the test's) demb's
    share of elements unequal to the plain version's, and the error of each
    against the f64 backward on the same inputs (largest difference over
    max|f64| at the reached positions).  Prints the distributions."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE_BWD, agreement

    args = one_row_inputs(torch, device=device)
    act = active_mask(torch, args)
    L, B = act.shape
    H = args[2].shape[1]
    hs, cs = lk.lstm_all_forward(*args)
    shares, k_err, p_err = [], [], []
    for k in range(draws):
        rng = np.random.default_rng(201 + k)
        dhs = torch.from_numpy((rng.standard_normal((L, B, H)) * 0.5).astype(np.float32)).to(device)
        bargs = (*args, hs, cs, (dhs * act[..., None]).to(torch.bfloat16))
        got = lk.lstm_all_backward(*bargs)
        if k == 0:
            again = lk.lstm_all_backward(*bargs)
            sync(torch, again[0])
            bits = lambda x: x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)  # noqa: E731
            same = [torch.equal(bits(got[0][act]), bits(again[0][act]))] + [
                torch.equal(bits(a), bits(b)) for a, b in zip(got[1:], again[1:])]
            print(f"lstm_all_bwd B=1 D=H={H}: twice on the same inputs, bitwise equal (demb, dW_ih, dW_hh, db): "
                  f"{same}")
            check(all(same), "kernel 6 at B = 1 gave two results for the same inputs")
        want = lk.lstm_all_backward_plain(*bargs)
        exact = plain_last_backward_f64(torch, *bargs, every_step=True)[0][act]
        shares.append(agreement(got[0][act], want[0][act]).unequal_share)
        scale = exact.abs().max().item()
        k_err.append((got[0][act].double() - exact).abs().max().item() / scale)
        p_err.append((want[0][act].double() - exact).abs().max().item() / scale)
    shares, k_err, p_err = np.array(shares), np.array(k_err), np.array(p_err)
    print(f"lstm_all_bwd B=1 D=H={H}, {draws} cotangent draws ({int(act.sum())} reached positions): demb unequal to "
          f"the plain version: min {shares.min():.3%}, median {np.median(shares):.3%}, max {shares.max():.3%}, "
          f"above {MAX_UNEQUAL_SHARE_BWD:.0%} in {np.mean(shares > MAX_UNEQUAL_SHARE_BWD):.1%} of draws (draw 0, the "
          f"test's: {shares[0]:.3%}); demb error vs f64 (of max|f64|): kernel median {np.median(k_err):.3e} max "
          f"{k_err.max():.3e}, plain median {np.median(p_err):.3e} max {p_err.max():.3e}, kernel above plain in "
          f"{np.mean(k_err > p_err):.1%} of draws")
    return shares, k_err, p_err


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
        if sfx and row == 5:
            print_forward_launch_ms(torch, f"lstm_all_fwd_f32 training entity pass B={B}", args, fn)
        if row == 6:
            print_backward_launch_ms(torch, name + sfx, bargs, fn)
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
    want = op_launches(counters, L, emb.dtype)
    # x.grad (demb) holds unread garbage at the positions a row never reaches
    grads = {**{n: p.grad for n, p in params.items()}, "x": x.grad[act]}
    finite = {n: torch.isfinite(g).all().item() for n, g in grads.items()}
    print(f"lstm_forward_tm_sorted forward and backward, entity pass B={emb.shape[1]}: launches {launches}, "
          f"finite gradients {finite}")
    check(launches == want, f"lstm_forward_tm_sorted launches {launches}, want {want}")
    check(all(finite.values()), f"lstm_forward_tm_sorted gave non-finite gradients: {finite}")
    return launches


def _adagrad_state(torch, gen, shape):
    g = torch.randn(*shape, generator=gen, device=gen.device) * 1e-2
    p = torch.randn(*shape, generator=gen, device=gen.device) * 0.1
    acc = torch.rand(*shape, generator=gen, device=gen.device)
    return g, p, acc


def unaligned(torch, x):
    """A contiguous copy of ``x`` 4 bytes past a 16-byte boundary (the
    Adagrad kernels' scalar path)."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return out.copy_(x)


# Steps (the state's count before the update) at which lr / (1 + (step' - 1)
# * 0.01) at lr 0.2 rounds differently as a reciprocal and a product: the
# ragged cases sit on them, so that fault cannot pass.
RECIPROCAL_STEPS = (10.0, 16.0, 20.0, 23.0, 24.0, 25.0)
RAGGED_HP = {"lr": 0.2, "lr_decay": 0.01, "weight_decay": 1e-2, "eps": 1e-10}


def graph_ms(torch, fn, n=50, reps=3):
    """Device ms per call of ``fn``: CUDA events around a replay of a CUDA
    graph of ``n`` calls, so no host gap falls between the launches (median
    of ``reps`` replays)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return float(np.median(times))


# The kernels ``cold_kernel_ms`` times: the profiler's kernel name -> the
# wrapper (module of the port's ``ops``, function) that launches it.
COLD_KERNELS = {"adagrad_dense_kernel": ("adagrad_kernel", "adagrad_update_leaves"),
                "adagrad_rows_kernel": ("scatter_adagrad_kernel", "scatter_adagrad_tables")}


def cold_kernel_ms(torch, name, args, n=20):
    """``cold_kernels_ms`` of one kernel."""
    return cold_kernels_ms(torch, [(name, args)], n)[0]


def cold_kernels_ms(torch, jobs, n=20):
    """Device ms a launch of each kernel ``name`` of ``jobs`` ((name, args)
    pairs; a name is a key of ``COLD_KERNELS``) on its wrapper's ``args``,
    by torch.profiler, with 256 MB written before each launch so that it
    finds L2 (50 MB) cold, as the training step finds the rows and leaves it
    updates.  Taken in a new process, one for all of ``jobs`` (each new
    process takes ~15 s to start on the card's host), that shares the args
    through CUDA IPC (the wrapper updates them in place): minutes into a
    busy process, every profiler session of that process loses its first
    GPU records, more the longer the process has run, while a new process
    started at the same moment keeps them all (PERF.md §6).  Each trace must
    hold exactly ``n`` launches."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    torch.cuda.synchronize()
    name = " and ".join(name for name, _ in jobs)
    proc = ctx.Process(target=_cold_kernel_child, args=(jobs, n, send))
    proc.start()
    try:
        send.close()
        check(recv.poll(600), f"the profile of {name} gave no result in 600 s")
        try:
            ok, out = recv.recv()
        except EOFError:
            ok, out = False, "its process ended without a result"
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    check(ok, f"the profile of {name}: {out}")
    return out


def cold_args(captured):
    """A recorded Adagrad launch's wrapper arguments (kernel 3: gs, ps, accs,
    steps, hp; kernel 4: g_rows, uids, valid, ps, accs, steps, hp) with the
    values and sums cloned, for ``cold_kernels_ms`` to update in place."""
    *head, ps, accs, steps, hp = captured
    return (*head, _clones(ps), _clones(accs), steps, hp)


def _cold_kernel_child(jobs, n, send):
    """``cold_kernels_ms``'s process: sends (True, [ms a job]) or (False,
    why)."""
    try:
        import importlib

        import torch
        from torch.profiler import ProfilerActivity, profile

        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
        out = []
        for name, args in jobs:
            module, entry = COLD_KERNELS[name]
            wrapper = getattr(importlib.import_module(f"{PKG}.ops.{module}"), entry)
            wrapper(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    flush.zero_()
                    wrapper(*args)
                torch.cuda.synchronize()
            found = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
            check(len(found) == 1 and found[0].count == n,
                  f"the profile has {[(e.key, e.count) for e in found]} for {name}")
            out.append(found[0].self_device_time_total / n / 1e3)
        send.send((True, out))
    except BaseException as e:  # noqa: BLE001 - reported to the parent, which fails
        send.send((False, f"{type(e).__name__}: {e}"))
    finally:
        send.close()


def host_us(torch, fn, n=200):
    """Host µs per call of ``fn`` by wall clock, with no synchronize between
    the calls: what the launching thread spends while the card runs behind."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _clones(xs):
    return [x.clone() for x in xs]


def sync(torch, x):
    """Wait for the card when ``x`` lies on it."""
    if x.is_cuda:
        torch.cuda.synchronize()


def dense_faults(ak):
    """Planted faults of the dense update's plain twin, each (gs, ps, accs,
    steps, hp) in place: the learning rate as ``lr / tensor`` (torch's
    reciprocal and product, two roundings) and the scalar tail of a leaf
    whose size is not a multiple of 4 left out."""

    def reciprocal_clr(gs, ps, accs, steps, hp):
        for g, p, acc, step in zip(gs, ps, accs, steps):
            step = step + 1.0
            ak.adagrad_update_plain(g, p, acc, hp["lr"] / (1.0 + (step - 1.0) * hp["lr_decay"]),
                                    hp["weight_decay"], hp["eps"])

    def dropped_tail(gs, ps, accs, steps, hp):
        for g, p, acc, step in zip(gs, ps, accs, steps):
            m = p.numel() - p.numel() % 4
            ak.adagrad_update_plain(g.reshape(-1)[:m], p.view(-1)[:m], acc.view(-1)[:m],
                                    ak.adagrad_clr(step + 1.0, hp["lr"], hp["lr_decay"]), hp["weight_decay"],
                                    hp["eps"])

    return {"learning rate as lr / tensor": reciprocal_clr, "scalar tail (n % 4) dropped": dropped_tail}


def ragged_dense_group(torch, table_heights, device="cuda"):
    """Leaves the training group never has: the token tables' heights (a
    table that falls back to dense joins the group), a ragged height, a size
    that is not a multiple of 4, an unaligned leaf and a 3 x 5 one, each at
    its own step, lr_decay 0.01."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    shapes = [(h, 512) for h in table_heights] + [(1234, 512), (7,), (2048,), (3, 5)]
    gs, ps, accs = zip(*(_adagrad_state(torch, gen, s) for s in shapes))
    gs, ps, accs = list(gs), list(ps), list(accs)
    i = len(table_heights) + 2
    gs[i], ps[i], accs[i] = (unaligned(torch, x) for x in (gs[i], ps[i], accs[i]))
    steps = [torch.tensor(s, device=device) for s in RECIPROCAL_STEPS[: len(shapes)]]
    return gs, ps, accs, steps, dict(RAGGED_HP)


def check_adagrad_cases(torch, name, cases, kernel, plain, faults):
    """Each case (label, (*tensors, steps, hp)) through ``kernel`` and
    ``plain`` on copies of the updated tensors: p, acc and the new steps bit
    for bit, the given steps unchanged; on the cases marked ragged every
    planted fault must differ somewhere.  Returns the largest difference."""
    max_err = 0.0
    for label, args, ragged in cases:
        *fixed, ps, accs, steps, hp = args
        steps0 = _clones(steps)
        outs = []
        for fn in (kernel, plain):
            p, a = _clones(ps), _clones(accs)
            outs.append((p, a, fn(*fixed, p, a, steps, hp)))
        sync(torch, ps[0])
        (pk, ak_, sk), (pp, ap, sp) = outs
        equal = all(torch.equal(x, y) for x, y in zip(pk + ak_ + sk, pp + ap + sp))
        err = max((x - y).abs().max().item() if x.numel() else 0.0 for x, y in zip(pk + ak_, pp + ap))
        print(f"{name} {label}: {len(ps)} in one call, max abs err {err:.3e}, p/acc/steps bit-equal {equal}")
        check(equal, f"{name} is not bit-equal to its plain twin at {label}")
        check(all(torch.equal(x, y) for x, y in zip(steps, steps0)), f"{name} wrote its input steps at {label}")
        max_err = max(max_err, err)
        if not ragged:
            continue
        for fault, fn in faults.items():
            p, a = _clones(ps), _clones(accs)
            fn(*fixed, p, a, steps, hp)
            sync(torch, ps[0])
            caught = not all(torch.equal(x, y) for x, y in zip(pk + ak_, p + a))
            print(f"planted fault ({name}, {label}) {fault}: {'fails' if caught else 'passes'} the bitwise check")
            check(caught, f"the bitwise check passes a planted fault of {name} ({fault})")
    return max_err


def check_adagrad(torch, captured, table_heights, cold_ms):
    """Kernel 3 bit-equal to its plain twin on the first training step's
    whole group (the 12 dense leaves at their shapes, as the optimizer
    launched it), on a ragged group with planted faults, and through the
    one-leaf entry with a given learning rate; timed on the group: device ms
    (the profiler, L2 flushed; and a CUDA graph of 50 launches), host µs per
    launch, the plain twin, and torch.optim.Adagrad over the same leaves in
    one step()."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak

    gs, ps, accs, steps, hp = captured
    check(len(ps) == 12, f"the first step's dense group has {len(ps)} leaves, want 12")
    cases = [("first training step's group", (gs, ps, accs, steps, hp), False),
             ("ragged group", ragged_dense_group(torch, table_heights), True)]
    max_err = check_adagrad_cases(torch, "adagrad_update", cases, ak.adagrad_update_leaves,
                                  ak.adagrad_update_leaves_plain, dense_faults(ak))
    clr = ak.adagrad_clr(steps[0] + 1.0, hp["lr"], hp["lr_decay"])
    one = [(g.clone(), p.clone(), a.clone()) for g, p, a in [(gs[0], ps[0], accs[0])] * 2]
    ak.adagrad_update(*one[0], clr, hp["weight_decay"], hp["eps"])
    ak.adagrad_update_plain(*one[1], clr, hp["weight_decay"], hp["eps"])
    torch.cuda.synchronize()
    print(f"adagrad_update one-leaf entry (given clr) on {list(ps[0].shape)}: bit-equal "
          f"{torch.equal(one[0][1], one[1][1]) and torch.equal(one[0][2], one[1][2])}")
    check(torch.equal(one[0][1], one[1][1]) and torch.equal(one[0][2], one[1][2]),
          "the one-leaf entry is not bit-equal to its plain version")

    p1, a1 = _clones(ps), _clones(accs)
    run = lambda: ak.adagrad_update_leaves(gs, p1, a1, steps, hp)  # noqa: E731
    ms = cold_ms
    warm_ms = graph_ms(torch, run)
    events_ms = cuda_ms(run, iters=50)
    launch_us = host_us(torch, run)
    plain_ms = cuda_ms(lambda: ak.adagrad_update_leaves_plain(gs, p1, a1, steps, hp), iters=20)
    library_ms, note = library_adagrad_ms(torch, gs, ps, hp)
    n = sum(p.numel() for p in ps)
    bytes_ = 5 * 4 * n + 2 * 4 * len(ps)  # read g, p, acc; write p, acc; a step in and out a leaf
    bound = bytes_ / PEAK_BYTES_PER_S * 1e3
    print(f"adagrad_update timing, the group ({len(ps)} leaves, {n} elements): device {ms:.4f} ms a launch (profiler, "
          f"L2 flushed before each), {warm_ms:.4f} ms (CUDA graph of 50 back to back), {events_ms:.4f} ms a call from "
          f"Python (events over 50), host {launch_us:.2f} us a launch, "
          f"plain twin {plain_ms:.4f} ms, library {library_ms} ms ({note}), bound {bound:.4f} ms (bytes: "
          f"{bytes_:.4e} B)")
    return {"name": "adagrad_update", "route": "cuda", "source": f"{PKG}/csrc/adagrad.cu",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/adagrad_kernel.py:28",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms, "host_us": launch_us}


def library_adagrad_ms(torch, gs, ps, hp):
    """``torch.optim.Adagrad.step`` over the same leaves (gradients and
    values; its own sums) in one call, in the multi-tensor form this torch has (foreach,
    else fused), events over 50 calls; never used by the port."""
    last = ""
    for form in ("foreach", "fused"):
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        try:
            opt = torch.optim.Adagrad(params, lr=hp["lr"], lr_decay=hp["lr_decay"], weight_decay=hp["weight_decay"],
                                      eps=hp["eps"], **{form: True})
            for param, g in zip(params, gs):
                param.grad = g.clone()
            opt.step()
        except (RuntimeError, TypeError, ValueError, KeyError) as e:
            last = f"{form}: {str(e).splitlines()[0]}"
            continue
        return cuda_ms(opt.step, iters=50), f"torch.optim.Adagrad({form}=True).step over the {len(ps)} leaves"
    return None, f"torch.optim.Adagrad unavailable ({last})"


def padding_writer(sk):
    """The planted fault of the row update's plain twin: it also
    read-modify-writes each table's first padding entry (row 0)."""

    def faulty(g_rows, uids, valid, ps, accs, steps, hp):
        for g, u, v, p, acc, step in zip(g_rows, uids, valid, ps, accs, steps):
            clr = sk.adagrad_clr(step + 1.0, hp["lr"], hp["lr_decay"])
            sk.scatter_adagrad_plain(g, u, v, p, acc, clr, hp["weight_decay"], hp["eps"])
            pad = (~v).nonzero()[:1, 0]
            sk.scatter_adagrad_plain(g[pad], u[pad], v[pad] | True, p, acc, clr, hp["weight_decay"], hp["eps"])

    def reciprocal_clr(g_rows, uids, valid, ps, accs, steps, hp):
        for g, u, v, p, acc, step in zip(g_rows, uids, valid, ps, accs, steps):
            step = step + 1.0
            sk.scatter_adagrad_plain(g, u, v, p, acc, hp["lr"] / (1.0 + (step - 1.0) * hp["lr_decay"]),
                                     hp["weight_decay"], hp["eps"])

    return {"a padding entry (row 0) written": faulty, "learning rate as lr / tensor": reciprocal_clr}


def ragged_row_tables(torch, device="cuda"):
    """Tables the training step never has: a ragged height with padding
    entries on row 0 and weight decay, a width off the float4 path (100,
    int32 uids), an unaligned table; each at its own step, lr_decay 0.01."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    tables = []
    for i, (V, d, U, n, uid_dtype) in enumerate([(1234, 512, 512, 300, torch.int64), (999, 100, 256, 200, torch.int32),
                                                 (3000, 512, 512, 41, torch.int64)]):
        g, p, acc = _adagrad_state(torch, gen, (V, d))
        uids = torch.zeros(U, dtype=uid_dtype, device=device)
        uids[1:n] = torch.randperm(V - 1, generator=gen, device=device)[: n - 1].sort().values.to(uid_dtype) + 1
        valid = torch.arange(U, device=device) < n
        if i == 2:
            p, acc = unaligned(torch, p), unaligned(torch, acc)
        tables.append((g[:U].contiguous(), uids, valid, p, acc, torch.tensor(RECIPROCAL_STEPS[i], device=device)))
    return (*(list(x) for x in zip(*tables)), dict(RAGGED_HP))


def check_row_adagrad(torch, captured, cold_ms):
    """Kernel 4 bit-equal to its plain twin on the first training step's two
    token tables in one launch (as the sparse step launched it) and on
    ragged tables with planted faults (a padding entry written, the
    learning rate as a reciprocal and a product); timed on the two tables:
    device ms (the profiler, L2 flushed; and a CUDA graph of 50 launches),
    host µs per launch, the plain twin, and torch.optim.Adagrad with sparse
    COO gradients of the same rows."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sk

    g_rows, uids, valid, ps, accs, steps, hp = captured
    check(len(ps) == 2, f"the first step's row update has {len(ps)} tables, want 2")
    cases = [("both token tables, first training step", captured, False),
             ("ragged tables", ragged_row_tables(torch), True)]
    max_err = check_adagrad_cases(torch, "scatter_adagrad", cases, sk.scatter_adagrad_tables,
                                  sk.scatter_adagrad_tables_plain, padding_writer(sk))
    p1, a1 = _clones(ps), _clones(accs)
    run = lambda: sk.scatter_adagrad_tables(g_rows, uids, valid, p1, a1, steps, hp)  # noqa: E731
    ms = cold_ms
    warm_ms = graph_ms(torch, run)
    events_ms = cuda_ms(run, iters=50)
    launch_us = host_us(torch, run)
    plain_ms = cuda_ms(lambda: sk.scatter_adagrad_tables_plain(g_rows, uids, valid, p1, a1, steps, hp), iters=20)
    n_valid = [int(v.sum()) for v in valid]
    bytes_ = sum(5 * 4 * n * g.shape[1] + len(u) * (u.element_size() + 1) + 8
                 for n, g, u in zip(n_valid, g_rows, uids))
    bound = bytes_ / PEAK_BYTES_PER_S * 1e3
    library_ms, note = library_row_adagrad_ms(torch, g_rows, uids, valid, ps, hp)
    print(f"scatter_adagrad timing, both token tables {[list(p.shape) for p in ps]}, {n_valid} valid rows: device "
          f"{ms:.4f} ms a launch (profiler, L2 flushed before each), {warm_ms:.4f} ms (CUDA graph of 50 back to back: "
          f"the rows fit in L2), {events_ms:.4f} ms a call from Python (events over 50), host "
          f"{launch_us:.2f} us a launch, plain twin {plain_ms:.4f} ms, library {library_ms} ms ({note}), bound "
          f"{bound:.4f} ms (bytes: {bytes_:.4e} B)")
    return {"name": "scatter_adagrad", "route": "cuda", "source": f"{PKG}/csrc/adagrad.cu",
            "replaces": "open_knowledge_graph_embeddings_tpu/ops/pallas/scatter_adagrad_kernel.py:52",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms, "host_us": launch_us}


def library_row_adagrad_ms(torch, g_rows, uids, valid, ps, hp):
    """``torch.optim.Adagrad.step`` on sparse COO gradients of the same rows
    of the same tables (one optimizer over both, its own sums), with
    ``weight_decay=0``: torch refuses weight decay with sparse gradients, so
    this is the row update without the kernel's lazy weight decay.  Timed,
    never used by the port."""
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    try:
        grads = [torch.sparse_coo_tensor(u[v][None], g[v], p.shape).coalesce()
                 for g, u, v, p in zip(g_rows, uids, valid, ps)]
        params = [torch.nn.Parameter(p.clone()) for p in ps]
        opt = torch.optim.Adagrad(params, lr=hp["lr"], lr_decay=hp["lr_decay"], eps=hp["eps"], weight_decay=0)

        def step():
            for param, grad in zip(params, grads):
                param.grad = grad
            opt.step()

        return cuda_ms(step, iters=50), ("torch.optim.Adagrad.step, sparse COO gradients of the same rows of both "
                                         "tables, weight_decay=0")
    except (RuntimeError, TypeError, ValueError, KeyError) as e:
        return None, f"torch.optim.Adagrad with sparse gradients unavailable: {str(e).splitlines()[0]}"


# the flagship's dense Adagrad group: per LSTM (entity, relation) W_ih and
# W_hh [2048, 512] and the bias [2048] twice, and the two batchnorms' scale
# and offset [512]
FLAGSHIP_LEAVES = [(2048, 512)] * 4 + [(2048,)] * 4 + [(512,)] * 4


def launch_cost(torch, reps=200):
    """The host's cost of the Adagrads, through entry points the port has
    had since training was ported, so that a call can hold two trees of it
    against each other (``--launch-cost DIR``): the one-leaf
    ``adagrad_update`` on a [2048, 512] leaf and the one-table
    ``scatter_adagrad`` on the entity token table's plan (host µs a call,
    no synchronize), and ``OptimizerRegimes.make_apply``'s update of the
    flagship's 12 dense leaves (host ms a call without a synchronize, wall
    ms with one).  Returns the numbers."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import adagrad_update
    from open_knowledge_graph_embeddings_tpu_torch.ops.scatter_adagrad_kernel import scatter_adagrad
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    clr = torch.tensor(0.2, device="cuda")
    g, p, acc = _adagrad_state(torch, gen, (2048, 512))
    out = {"adagrad_update_one_leaf_host_us": host_us(torch, lambda: adagrad_update(g, p, acc, clr, 1e-10, 1e-10),
                                                      reps)}
    gt, pt, at = _adagrad_state(torch, gen, (200002, 512))
    uids = torch.zeros(4096, dtype=torch.long, device="cuda")
    uids[1:3900] = torch.randperm(200001, generator=gen, device="cuda")[:3899].sort().values + 1
    valid = torch.arange(4096, device="cuda") < 3900
    out["scatter_adagrad_one_table_host_us"] = host_us(
        torch, lambda: scatter_adagrad(gt[:4096], uids, valid, pt, at, clr, 1e-10, 1e-10), reps)
    regimes = OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.2, "weight_decay": 1e-10})
    regimes.update(1, 0)
    params = {f"leaf{i}": torch.randn(*s, generator=gen, device="cuda") * 0.1 for i, s in enumerate(FLAGSHIP_LEAVES)}
    grads = {k: torch.randn(*v.shape, generator=gen, device="cuda") * 1e-2 for k, v in params.items()}
    state = regimes.init_state(params)
    apply, hp = regimes.make_apply(params), regimes.hparams()

    def step():
        nonlocal state
        _, state = apply(grads, state, params, hp)

    def synced_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out["optimizer_12_leaves_host_ms"] = host_us(torch, step, reps // 4) / 1e3
    out["optimizer_12_leaves_wall_ms"] = float(np.median([synced_ms() for _ in range(20)]))
    print("launch cost: " + json.dumps(out))
    return out


# the flagship's fused passes: entity (B = 5632 rows) and relation (B = 3072
# deduplicated rows), L = 10, D = H = 512
SPLIT_SHAPES = {"entity pass": 5632, "relation pass": 3072}


def backward_split(torch):
    """The bf16 and the f32 backward of the port this process imports, on
    seeded inputs at the flagship's pass shapes (``SPLIT_SHAPES``, lengths
    by ``synth_lengths``, kernel 1's residuals): its launches by kind
    (gate, product, dW, and at f32 the split; device ms per call,
    torch.profiler) each beside its part of the bound, the whole call (CUDA
    events) beside cuDNN's packed backward, and where the port has the dW
    launch's measuring variants (``lstm_kernel.DW_VARIANTS``, and
    ``DW_F32_VARIANTS`` at f32) the launch alone in each.  The inputs
    depend on the seed alone, so ``--backward-split DIR`` run on two trees
    in turns (parent, change, change, parent) compares them in one call.
    Returns the ms by dtype and pass."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    out = {}
    for dtype, kinds, variants in ((torch.bfloat16, BACKWARD_BF16_KINDS_ANY_TREE, "DW_VARIANTS"),
                                   (torch.float32, BACKWARD_F32_KINDS_ANY_TREE, "DW_F32_VARIANTS")):
        sfx = "_f32" if dtype == torch.float32 else ""
        for label, B in SPLIT_SHAPES.items():
            gen = torch.Generator(device="cuda").manual_seed(SEED + 30 + B)
            lens = synth_lengths(np.random.default_rng(SEED + 30 + B), B)
            emb, wih, whh, bias, lens_t, _ = lstm_inputs(torch, gen, 10, B, 512, 512, lens, dtype)
            _, hs, cs = lk._forward(emb, wih, whh, bias, lens_t, residuals=True)
            dlast = (torch.randn(B, 512, generator=gen, device="cuda") * 0.1).to(dtype)
            args = (emb, wih, whh, bias, lens_t, hs, cs, dlast)

            def call():
                return lk.lstm_last_backward(*args)

            row = {"by_kind": print_backward_launch_ms(torch, "lstm_last_bwd" + sfx, args, call, kinds=kinds,
                                                       label=label),
                   "ms": cuda_ms(call, iters=10)}
            row["library_ms"], note = library_lstm_backward_ms(torch, args)
            if hasattr(lk, variants):
                # the dW launch alone in each variant (the kernel, without its
                # products: the loads alone), on a seeded dg and this pass's
                # x, hs and lengths
                dg = (torch.randn(10, B, 2048, generator=gen, device="cuda") * 0.05).to(dtype)
                db_part = torch.randn(10, -(-B // 128), 2048, generator=gen, device="cuda")
                outs = (torch.empty(2048, 512, dtype=dtype, device="cuda"),
                        torch.empty(2048, 512, dtype=dtype, device="cuda"), torch.empty(2048, device="cuda"))
                lens_i = lens_t.to(torch.int32)
                row["dw_alone_ms"] = {v: launch_ms(torch, lambda v=v: lk._launch_dw(
                    dg, emb, hs, lens_i, db_part, *outs, lk._sm_count(0), torch.cuda.current_stream().cuda_stream,
                    variant=v), {"dW": kinds["dW"]})["dW"] for v in getattr(lk, variants)}
                if dtype == torch.float32:
                    row["dw_vs_f64"] = dw_accuracy(torch, dg, emb, hs, lens_i, db_part, outs)
            print(f"backward split{sfx} {label} B={B}: kernel {row['ms']:.4f} ms, cuDNN packed backward "
                  f"{row['library_ms']} ms ({note}); "
                  + json.dumps({k: v for k, v in row.items() if k.startswith("dw")}))
            out[f"{label}{sfx}"] = row
    return out


def dw_accuracy(torch, dg, x, hs, lens, db_part, outs):
    """The f32 dW launch alone and the plain version's sum (per-step f32
    products, cuBLAS, steps added in reverse as ``lstm_last_backward_plain``
    adds them) against the f64 sum of the same operands over each step's
    active rows: the largest difference over max|want|, and the signed
    mean difference over mean|want| (the sum's bias), dW_ih and dW_hh.  The
    kernel's largest must pass the f32 rule."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32

    L = x.shape[0]
    act = (lens.clamp(min=1)[None, :] > torch.arange(L, device=lens.device)[:, None])[..., None]
    g, xa, ha = torch.where(act, dg, 0.0), torch.where(act, x, 0.0), torch.where(act[1:], hs[:-1], 0.0)
    exact = (torch.einsum("lbg,lbd->gd", g.double(), xa.double()),
             torch.einsum("lbg,lbh->gh", g[1:].double(), ha.double()))
    lk._launch_dw(dg, x, hs, lens, db_part, *outs, lk._sm_count(0), torch.cuda.current_stream().cuda_stream)
    plain = [torch.zeros_like(outs[0]), torch.zeros_like(outs[1])]
    for t in reversed(range(L)):
        plain[0] += g[t].t() @ xa[t]
        if t > 0:
            plain[1] += g[t].t() @ ha[t - 1]
    torch.cuda.synchronize()

    def rel(got):
        return [float((a.double() - e).abs().max() / e.abs().max()) for a, e in zip(got, exact)]

    def bias(got):  # signed: below 0, the sum shrinks
        return [float(((a.double() - e) * e.sign()).sum() / e.abs().sum()) for a, e in zip(got, exact)]

    out = {"kernel": rel(outs[:2]), "plain f32": rel(plain), "kernel bias": bias(outs[:2]),
           "plain f32 bias": bias(plain)}
    check(max(out["kernel"]) <= MAX_REL_ERR_F32, f"f32 dW launch alone vs the f64 sum: {out['kernel']}")
    return out


# ------------------------------------------------------------------ eval

# the chunk the full-vocabulary eval scores (train/evaluate.py eval_stats_chunked)
EVAL_CHUNK = 131072
# the unit roundoff of f32: an f32 product of d terms lies within
# d * u / (1 - d * u) * sum |q_i c_i| of the exact one
F32_UNIT_ROUNDOFF = 2.0 ** -24


class EvalCapture:
    """Records what the eval step hands the ranking while the block runs:
    for every full-vocabulary batch (``eval_stats_chunked``) the query
    vectors, the eval arrays, the ranks and the loss, with the candidate
    cache; for
    every batch-shared one (``ranks_from_scores``) the ranks, and for the
    first its [B, N] scores and arrays.  It wraps the functions in the eval
    step's module and calls them through."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.train import step

        self.step = step
        self.chunked, self.dense, self.cache = [], [], None
        self._orig = (step.eval_stats_chunked, step.ranks_from_scores)

    def __enter__(self):
        self.step.eval_stats_chunked, self.step.ranks_from_scores = self._chunked, self._dense
        return self

    def __exit__(self, *exc):
        self.step.eval_stats_chunked, self.step.ranks_from_scores = self._orig

    def _chunked(self, q, cand_emb, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, *rest, **kw):
        out = self._orig[0](q, cand_emb, pos_rows, pos_cols, row_valid, col_valid, n_real_cols, *rest, **kw)
        self.cache = cand_emb
        self.chunked.append({"q": q.clone(), "golds": _copies(rest[:4]), "col_valid": col_valid,
                             "ranks": out[1].clone(), "gold_valid": out[2].clone(), "loss": out[0].clone(),
                             "pos": _copies((pos_rows, pos_cols, row_valid))})
        return out

    def _dense(self, scores, filter_rows, filter_cols, gold_rows, gold_mention_cols, col_valid):
        ranks, gold_valid = self._orig[1](scores, filter_rows, filter_cols, gold_rows, gold_mention_cols, col_valid)
        rec = {"ranks": ranks.clone(), "gold_valid": gold_valid.clone()}
        if not self.dense:
            rec.update(scores=scores.clone(), golds=_copies((filter_rows, filter_cols, gold_rows, gold_mention_cols)),
                       col_valid=col_valid)
        self.dense.append(rec)
        return ranks, gold_valid


def eval_launches(names, L, dtype, val_batches=0, cache_chunks=0, test_batches=0):
    """The launches an eval must count: kernel 1 only (no gradient), per
    batch-shared batch a pass over the candidates and the query entities
    together and one over the relations; per cache chunk one; per
    full-vocabulary batch one over the query entities and one over the
    relations."""
    want = {name: 0 for name in names}
    want["lstm_last_fwd"] = (2 * val_batches + cache_chunks + 2 * test_batches) * forward_launches(L, dtype)
    return want


def host_golds(golds, col_valid):
    """An eval batch's golds on the host: (valid gold indices, their rows,
    their mention columns, each one's filter columns, the column mask or
    None)."""
    fr, fc, gr, gm = (x.cpu().numpy() for x in golds)
    gi = np.flatnonzero((gr >= 0) & (gm >= 0).any(axis=1))
    f_ok = (fr >= 0) & (fc >= 0)
    filt = [fc[f_ok & (fr == gr[g])] for g in gi]
    return gi, gr[gi], gm[gi], filt, None if col_valid is None else col_valid.cpu().numpy()


def host_ranks(rows, mention_cols, filter_cols, col_valid=None):
    """The filtered ranks recounted on the host, one gold at a time, with
    numpy: ``rows`` [G, N] f32 holds each gold's query row scored against
    every candidate; true = the largest score of its mention columns (-1
    padded); the filtered row sets the gold row's known-true columns to
    -1e8 and leaves the padding columns out; rank = #(> true) + #(== true)
    // 2.  Returns the ranks and those of two planted faults the check must
    catch: the filter dropped, and ties counted as ``>``; and per gold the
    unfiltered candidates its true score ties (its own columns are
    filtered)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import FILTER_VALUE

    out = {k: np.empty(len(rows), np.int64) for k in ("ranks", "no filter", "ties as >", "tied")}
    for g, row in enumerate(rows):
        m = mention_cols[g][mention_cols[g] >= 0]
        true = row[m].max()
        filtered = row.copy()
        filtered[filter_cols[g]] = np.float32(FILTER_VALUE)
        raw = row
        if col_valid is not None:
            filtered, raw = filtered[col_valid], row[col_valid]
        gt, eq = int((filtered > true).sum()), int((filtered == true).sum())
        out["ranks"][g] = gt + eq // 2
        out["ties as >"][g] = gt + eq
        out["tied"][g] = eq
        out["no filter"][g] = int((raw > true).sum()) + int((raw == true).sum()) // 2
    return out


def chunk_product_rows(torch, q_g, cache, chunk=EVAL_CHUNK):
    """[G, N] f32 on the host: the gold rows scored by the port's own chunk
    products, of the shape eval_stats_chunked runs (the same G rows against
    C candidates, the last chunk overlapping the one before it)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates

    N = cache.shape[0]
    C = min(chunk, N)
    out = np.empty((q_g.shape[0], N), np.float32)
    for c0 in range(0, N, C):
        s0 = min(c0, N - C)
        out[:, c0 : s0 + C] = score_against_candidates(q_g, cache[s0 : s0 + C])[:, c0 - s0 :].cpu().numpy()
    return out


def check_ranking(label, cases, ties_expected=True):
    """Each case (rows [G, N], mention columns, filter columns, column mask,
    the port's ranks of those golds): the host recount must find 0 ranks
    that differ, and each planted fault must change at least one rank over
    the cases.  With ``ties_expected`` False (random lookup embeddings,
    whose scores make no exact ties) the ties fault is only reported.
    Returns the number of golds held."""
    n, ties, faults = 0, 0, Counter()
    for rows, gm, filt, col_valid, ranks in cases:
        got = host_ranks(rows, gm, filt, col_valid)
        bad = int((got["ranks"] != ranks).sum())
        check(bad == 0, f"{label}: the host recount differs from the port in {bad} of {len(ranks)} ranks")
        for fault in ("no filter", "ties as >"):
            faults[fault] += int((got[fault] != ranks).sum())
        n += len(ranks)
        ties += int((got["tied"] > 0).sum())
    print(f"{label}: host recount (numpy) of {n} filtered ranks from the port's own products: 0 differ; {ties} "
          "golds tie another candidate; planted " + ", ".join(f"{k}: {v} ranks differ" for k, v in faults.items()))
    for fault in ("no filter", "ties as >") if ties_expected else ("no filter",):
        check(faults[fault] > 0, f"{label}: the planted fault '{fault}' changes no rank: the check has no power")
    return n


def f64_ranks(torch, q_g, cache, mention_cols, filt, col_valid, block=32):
    """The golds' filtered ranks with f64 products of the card's own f32
    query rows and cache rows, and per gold the number of unfiltered
    candidates whose f64 score lies within the f32 products' error bound of
    true (d u / (1 - d u) times sum |q_i c_i|, for the candidate and for
    true's mention): only those can rank differently in f32.  Returns
    (ranks, near)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import FILTER_VALUE

    d, dev = q_g.shape[1], q_g.device
    gamma = d * F32_UNIT_ROUNDOFF / (1 - d * F32_UNIT_ROUNDOFF)
    cache64 = cache.double()
    ok = None if col_valid is None else torch.from_numpy(col_valid).to(dev)
    ranks, near = np.empty(len(q_g), np.int64), np.empty(len(q_g), np.int64)
    for b0 in range(0, len(q_g), block):
        q64 = q_g[b0 : b0 + block].double()
        s = q64 @ cache64.t()
        err = gamma * (q64.abs() @ cache64.abs().t())
        for j in range(s.shape[0]):
            g = b0 + j
            m = torch.from_numpy(mention_cols[g][mention_cols[g] >= 0]).to(dev)
            # an f32 true is its mentions' largest f32 score: within the
            # largest of their bounds of the f64 true
            t, t_err = s[j, m].max(), err[j, m].max()
            f = torch.from_numpy(filt[g]).long().to(dev)
            keep = torch.ones(s.shape[1], dtype=torch.bool, device=dev)
            keep[f] = False
            row = s[j].clone()
            row[f] = FILTER_VALUE
            if ok is not None:
                row, keep, e = row[ok], keep[ok], err[j][ok]
            else:
                e = err[j]
            ranks[g] = int((row > t).sum()) + int((row == t).sum()) // 2
            near[g] = int((keep & ((s[j] if ok is None else s[j][ok]) - t).abs().le(e + t_err)).sum())
    del cache64
    return ranks, near


def metrics_of(ranks):
    r = np.asarray(ranks, np.float64)
    return {"mrr": float(np.mean(1.0 / (r + 1.0))), "mr": float(r.mean()),
            **{f"h{k}": float(np.mean(r < k)) for k in (1, 3, 10, 50)}}


def check_against_f64(torch, label, capture):
    """The full-vocabulary ranks of every recorded batch against f64
    products of the same q and cache rows: per gold the difference must lie
    within the number of candidates in the f32 error bound of true
    (``f64_ranks``); prints how many ranks differ and MRR/hits both ways."""
    got, want, near = [], [], []
    for rec in capture.chunked:
        gi, g_rows, gm, filt, col_valid = host_golds(rec["golds"], rec["col_valid"])
        q_g = rec["q"][torch.from_numpy(g_rows).long().to(rec["q"].device)]
        r64, n64 = f64_ranks(torch, q_g, capture.cache, gm, filt, col_valid)
        got.append(rec["ranks"].cpu().numpy()[gi])
        want.append(r64)
        near.append(n64)
    got, want, near = (np.concatenate(x) for x in (got, want, near))
    diff = np.abs(got - want)
    m32, m64 = metrics_of(got), metrics_of(want)
    print(f"{label} vs f64 (the card's q and cache rows, f64 products): {int((diff > 0).sum())} of {len(got)} ranks "
          f"differ, largest difference {int(diff.max())}; tolerance per gold: the candidates within the f32 error "
          f"bound of true (d u / (1 - d u) sum |q_i c_i|, u = 2^-24), {int(near.sum())} over all golds, at most "
          f"{int(near.max())} for one; MRR {m32['mrr']:.6f} vs f64 {m64['mrr']:.6f}, "
          + ", ".join(f"{k} {m32[k]:.4f} vs {m64[k]:.4f}" for k in ("h1", "h3", "h10", "h50")))
    over = int((diff > near).sum())
    check(over == 0, f"{label}: {over} ranks differ from f64 by more than the f32 error bound allows")
    return m32, m64


def eval_batch_bound(N, d, es, B, Gv):
    """The least time of one full-vocabulary eval batch on this card: the
    cache (``es`` bytes an element) streamed once per product pass (the
    loss pass of the B rows, and the two passes of the Gv gold rows), and
    their f32 FLOP at the FFMA peak (TF32 is off)."""
    return bound_ms(2 * d * N * (B + 2 * Gv), 3 * N * d * es, PEAK_FP32_FLOPS)


def eval_row(path, split):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1, f"{split}: evaluate_scores_file has {len(rows)} rows, want 1")
    return rows[0]


def check_eval_metrics(label, row, capture_recs, n_golds):
    """The user's outputs of one eval: the scores-file row's metrics finite
    and ordered, MRR in (0, 1], the golds counted, and the row's MRR the
    mean over the ranks the step returned."""
    m = {k: float(row[k]) for k in ("loss", "mrr", "mr", "h1", "h3", "h10", "h50")}
    check(all(np.isfinite(v) for v in m.values()), f"{label}: non-finite metrics {m}")
    check(0 < m["mrr"] <= 1, f"{label}: MRR {m['mrr']}")
    check(m["h1"] <= m["h3"] <= m["h10"] <= m["h50"] <= 1, f"{label}: hits not ordered {m}")
    count = sum(int(r["gold_valid"].sum()) for r in capture_recs)
    check(count == n_golds, f"{label}: {count} golds ranked, the split has {n_golds}")
    ranks = np.concatenate([r["ranks"].cpu().numpy()[r["gold_valid"].cpu().numpy()] for r in capture_recs])
    mrr = metrics_of(ranks)["mrr"]
    check(abs(mrr - m["mrr"]) <= 1e-6 * m["mrr"], f"{label}: the row's MRR {m['mrr']} is not its ranks' {mrr}")
    print(f"{label}: count {count} (every gold of the split), " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    return m


def run_evaluate(torch, config, ckpt, out_dir, on_validation, data_dir=DATA_DIR):
    """``cli.train --resume CKPT --evaluate True`` with the launch counts
    set to 0 just before and read just after -> (trainer, capture,
    launches, scores-file row, wall s)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train

    shutil.rmtree(out_dir, ignore_errors=True)
    scores = out_dir / "scores.csv"
    args = [str(config), "--dataset_dir", str(data_dir), "--resume", ckpt, "--evaluate", "True",
            "--evaluate_on_validation", str(on_validation), "--experiment_dir", str(out_dir),
            "--evaluate_scores_file", str(scores), "--device", "cuda"]
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with EvalCapture() as capture:
        trainer = cli_train.cli_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    return trainer, capture, launches, eval_row(scores, "validation" if on_validation else "test"), wall


def phase_eval(torch, timings, ckpt, config=FLAGSHIP, tag="", validation=True):
    """``cli.train --evaluate`` on ``ckpt``: the batch-shared validation
    split (with ``validation``) and the full-vocabulary test split through
    the chunked branch, each with exact kernel 1 launch counts and its
    outputs checked; the ranking held on the card exactly (host recounts
    of recorded batches from the port's own products, with planted faults)
    and the test ranks against f64; timed (the validation pass, the cache
    encode and the ranking, one device batch beside its bound, a profile
    of it).  Returns the launches of the runs together."""
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device, eval_batch_to_arrays

    pre = tag
    total = Counter()
    if validation:
        trainer, cap, launches, row, wall = run_evaluate(torch, config, ckpt, ROOT / ".bench_cache" /
                                                         f"smoke_eval_{pre}valid", True)
        L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
        n_batches = len(trainer.val_builder)
        want = eval_launches(launches, L, dtype, val_batches=n_batches)
        print(f"{pre}validation (batch-shared, {trainer.validation_dataset.min_size_batch_labels} candidates): "
              f"launches {launches} (want {want}: {n_batches} batches x (the candidate and query pass + the "
              f"relation pass) x {forward_launches(L, dtype)})")
        check(launches == want and want["lstm_last_fwd"] > 0, f"{pre}validation launches {launches}, want {want}")
        check_eval_metrics(f"{pre}validation", row, cap.dense,
                           int(trainer.validation_dataset.records.group_offsets[-1]))
        rec = cap.dense[0]
        gi, g_rows, gm, filt, col_valid = host_golds(rec["golds"], rec["col_valid"])
        rows = rec["scores"][torch.from_numpy(g_rows).long().cuda()].cpu().numpy()
        check_ranking(f"{pre}validation batch 0 ([B, N] = {list(rec['scores'].shape)})",
                      [(rows, gm, filt, col_valid, rec["ranks"].cpu().numpy()[gi])])
        timings[pre + "eval_validation_s"] = trainer.last_eval["batches_s"]
        timings[pre + "eval_validation_cli_s"] = wall
        print(f"{pre}validation pass: {trainer.last_eval['batches_s']:.3f} s for {n_batches} batches "
              f"(cli.train --evaluate {wall:.3f} s)")
        total.update(launches)
        del trainer, cap

    trainer, cap, launches, row, wall = run_evaluate(torch, config, ckpt, ROOT / ".bench_cache" /
                                                     f"smoke_eval_{pre}test", False)
    meta = trainer.model.meta
    L, dtype = meta.max_length[0], trainer.model.embedder.dtype
    n_chunks, n_batches = -(-meta.entities_size // 32768), len(trainer.val_builder)
    want = eval_launches(launches, L, dtype, cache_chunks=n_chunks, test_batches=n_batches)
    print(f"{pre}test (full vocabulary, {cap.cache.shape[0]} candidates, batches of {trainer.val_builder.batch_size}"
          f"): launches {launches} (want {want}: {n_chunks} cache chunks + {n_batches} batches x 2 passes, x "
          f"{forward_launches(L, dtype)})")
    check(launches == want and want["lstm_last_fwd"] > 0, f"{pre}test launches {launches}, want {want}")
    check(len(cap.chunked) == n_batches and not cap.dense, f"{pre}test: the batches did not take the chunked branch")
    m32 = check_eval_metrics(f"{pre}test", row, cap.chunked, int(trainer.validation_dataset.records.group_offsets[-1]))
    cases = []
    for rec in cap.chunked[:2]:
        gi, g_rows, gm, filt, col_valid = host_golds(rec["golds"], rec["col_valid"])
        rows = chunk_product_rows(torch, rec["q"][torch.from_numpy(g_rows).long().cuda()], cap.cache)
        cases.append((rows, gm, filt, col_valid, rec["ranks"].cpu().numpy()[gi]))
    check_ranking(f"{pre}test batches 0-1", cases)
    del cases, rows
    check_against_f64(torch, f"{pre}test ranks", cap)
    timings[pre + "eval_test_cache_s"] = trainer.last_eval["cache_s"]
    timings[pre + "eval_test_ranking_s"] = trainer.last_eval["batches_s"]
    timings[pre + "eval_test_cli_s"] = wall

    # one device batch of eval_block_rows prefixes, timed and profiled
    batch = trainer._eval_batches_cache[0]
    arrays = arrays_to_device(eval_batch_to_arrays(batch), trainer.device)
    step = trainer.eval_step
    ms = cuda_ms(lambda: step(trainer.variables, arrays, cap.cache), iters=3, warmup=1)
    N, d = cap.cache.shape
    Gv = int(cap.chunked[0]["gold_valid"].sum())
    bound, by = eval_batch_bound(N, d, cap.cache.element_size(), batch.batch_size, Gv)
    timings[pre + "eval_batch_ms"] = ms
    timings[pre + "eval_batch_bound_ms"] = bound
    print(f"{pre}test eval: cache encode {trainer.last_eval['cache_s']:.3f} s, ranking {trainer.last_eval['batches_s']:.3f}"
          f" s ({n_batches} batches; cli.train --evaluate {wall:.3f} s); one device batch of {batch.batch_size} rows "
          f"({Gv} golds): {ms:.3f} ms, bound {bound:.3f} ms ({by}: the {cap.cache.dtype} cache streamed in 3 product "
          f"passes at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, {2 * d * N * (batch.batch_size + 2 * Gv):.4e} f32 FLOP at "
          f"the FFMA peak {PEAK_FP32_FLOPS / 1e12:.2f} TFLOP/s; {bound / ms:.1%} of it)")
    device_breakdown(torch, f"{pre}full-vocabulary eval batch ({batch.batch_size} rows, {N} candidates)",
                     lambda: step(trainer.variables, arrays, cap.cache))
    total.update(launches)
    del trainer, cap, arrays
    torch.cuda.empty_cache()
    return dict(total), m32


def check_selection(torch, trainer):
    """The model selection of a training run with eval: a validation row
    per pass in results.csv, finite and ordered, and ``model_best-mrr``
    (the first eval with the highest MRR) loading back.  Returns the
    number of validation batches the run evaluated."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint

    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    n_passes = sum(1 for r in trainer.results.to_dicts() if "training_loss" in r)
    check(len(rows) == n_passes > 0, f"{len(rows)} validation rows for {n_passes} passes")
    with open(Path(trainer.save_path) / "results.csv") as f:
        header = next(csv.reader(f))
    check({f"validation_{k}" for k in ("loss", "mrr", "mr", "h1", "h3", "h10", "h50")} <= set(header),
          f"results.csv lacks validation columns: {header}")
    for r in rows:
        check(0 < r["validation_mrr"] <= 1 and np.isfinite(r["validation_loss"])
              and r["validation_h1"] <= r["validation_h3"] <= r["validation_h10"] <= r["validation_h50"],
              f"validation row {r}")
    best = max(rows, key=lambda r: r["validation_mrr"])
    _, _, meta = load_checkpoint(str(Path(trainer.save_path) / "model_best-mrr"),
                                 trainer.model.init(torch.Generator(device=trainer.device).manual_seed(1)), {})
    check(meta["training_steps"] == best["training_steps"],
          f"model_best-mrr is from step {meta['training_steps']}, the best eval from {best['training_steps']}")
    print("model selection: " + "; ".join(f"step {r['training_steps']} validation MRR {r['validation_mrr']:.6f} "
                                         f"h10 {r['validation_h10']:.4f}" for r in rows)
          + f"; model_best-mrr (step {meta['training_steps']}) loads")
    return len(rows) * len(trainer.val_builder)


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
    product must fail it), kernels 7/8 also held to each other (gates
    bitwise) and to f64 on the trained unfused checkpoint, and the
    full-vocabulary test eval of the fused checkpoint (``phase_eval``);
    fills ``by_path`` with the launch counts of its paths and returns the
    six f32 kernel rows."""
    config = write_f32_config()
    rows = [phase_kernels(torch, torch.float32)]
    trainer, capture, by_path["train_f32"], n_steps = phase_train(torch, timings, config=config, tag="f32_")
    check(trainer.model.embedder.dtype == "float32", f"the f32 config built a {trainer.model.embedder.dtype} model")
    ckpt = check_training(torch, trainer, by_path["train_f32"], n_steps)
    time_train_steps(torch, trainer, timings, pre="f32_")
    del trainer
    by_path["eval_f32"], _ = phase_eval(torch, timings, ckpt, config=config, tag="f32_", validation=False)
    row_bwd, fwd_err = check_lstm_backward(torch, capture.bwd)
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], fwd_err, check_lstm_residuals(torch, capture.fwd))
    time_forward_passes(torch, capture.fwd)
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
    ckpt_unfused = check_training(torch, trainer, by_path["train_unfused_f32"], n_steps, unfused=True)
    with unfused_switch():
        time_train_steps(torch, trainer, timings, pre="f32_unfused_")
    del trainer
    rows += time_scan(torch, capture.scan_fwd, capture.scan_bwd, *check_scan(torch, capture.scan_fwd, capture.scan_bwd))
    check_scan_gates(torch, capture.scan_fwd[0][0])
    check_scan_1xtf32_variant(torch, capture.scan_fwd[0][0], capture.scan_bwd[1])
    del capture
    check_trained_scan(torch, *record_scan_encode(torch, config, ckpt_unfused))
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
        check(launches == scan_launches(L, dtype), f"H={H} {dtype}: launches {launches}, want "
              f"{scan_launches(L, dtype)}")
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


# ------------------------------------------------------- the model families

FB_CONFIGS = ROOT / "configs" / "fb15k237"
RELATION_BIAS = ROOT / "configs" / "olpbench" / "wikiopenlink-thorough-relation-bias.yaml"
FB_DATA_DIR = ROOT / ".bench_cache" / "synth_fb15k237_smoke"
# FB15k-237's entity, relation and train-triple counts (its files are not in
# the repository); the valid and test splits cut from 17,535 and 20,466
# triples to 1000 each
FB_DATA_ARGS = ["--mentions", "14541", "--relations", "237", "--triples", "272115", "--ent-tokens", "20000",
                "--rel-tokens", "2000", "--eval-size", "1000", "--seed", str(SEED)]
# the names that take a few steps each train on the first triples of the
# FB15k-shaped split: 3 steps of 4096 or 26 of 512 a pass
FB_HEAD_TRIPLES = 24000


def write_config(name, source, changes, model=None, model_config=None, data=None):
    """A copy of ``source`` under ``.bench_cache/`` (``configs/`` is not
    edited) with the top-level keys ``changes``, the model ``model``, the
    model_config keys ``model_config`` and the data config keys ``data``
    ({config key: {key: value}}) changed."""
    import yaml

    cfg = yaml.safe_load(Path(source).read_text())
    cfg.update(changes)
    if model:
        cfg["model"] = model
    cfg["model_config"] = {**cfg["model_config"], **(model_config or {})}
    for key, kv in (data or {}).items():
        cfg[key] = {**cfg[key], **kv}
    path = ROOT / ".bench_cache" / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def fb_head_file():
    """``train_head.txt`` beside the FB15k-shaped split: its first
    ``FB_HEAD_TRIPLES`` triples."""
    with open(FB_DATA_DIR / "train.txt") as f:
        head = [line for _, line in zip(range(FB_HEAD_TRIPLES), f)]
    (FB_DATA_DIR / "train_head.txt").write_text("".join(head))
    return "train_head.txt"


def family_runs():
    """(tag, config) of every run of the model families: lookup ComplEx on
    the whole FB15k-shaped split with a validation eval after each of two
    passes (the slice's main path); the other seven names a few steps and
    one validation eval each at their configs' widths (bigram and
    LSTM-Tucker3 ship no config: the unigram config with ``normalize:
    batchnorm`` and ``gates: true``, the FB15k-237 LSTM config); and lookup
    ComplEx with row-sparse tables (``sparse: true``, d = 200) on the
    2.47M-mention set with the flagship's batch-shared candidates."""
    fb, head = {"dataset_dir": str(FB_DATA_DIR)}, {"train_data_config": {"input_file": fb_head_file()}}
    # one validation eval, after the second pass; no per-epoch checkpoints
    one_eval = {**fb, "eval_epoch_freq": 2, "save_epoch_freq": 0}
    olp_files = {"train_data_config": {"input_file": "train.txt"}, "val_data_config": {"input_file": "valid.txt"},
                 "test_data_config": {"input_file": "test.txt"}}
    olp = {"dataset_dir": str(DATA_DIR), "eval_epoch_freq": 2, "save_epoch_freq": 0}
    kge = FB_CONFIGS / "fb15k237-complex-kge.yaml"
    unigram = FB_CONFIGS / "fb15k237-complex-unigrampool.yaml"
    return [
        ("fb_lookup_complex", write_config("fb15k237-complex-kge", kge, {**fb, "eval_epoch_freq": 1,
                                                                        "save_epoch_freq": 1})),
        ("fb_lookup_distmult", write_config("fb15k237-distmult-kge", FB_CONFIGS / "fb15k237-distmult-kge.yaml",
                                            one_eval, data=head)),
        ("fb_lookup_tucker3", write_config("fb15k237-tucker3-kge", FB_CONFIGS / "fb15k237-tucker3-kge.yaml",
                                           one_eval, data=head)),
        ("fb_unigram", write_config("fb15k237-complex-unigrampool", unigram, one_eval, data=head)),
        ("fb_bigram", write_config("fb15k237-complex-bigrampool", unigram, one_eval, "BigramPoolingComplexRelationModel",
                                   {"normalize": "batchnorm", "gates": True}, data=head)),
        ("fb_lstm_tucker3", write_config("fb15k237-tucker3-lstm", FB_CONFIGS / "fb15k237-complex-lstm.yaml", one_eval,
                                         "LSTMTucker3RelationModel", data=head)),
        ("olp_entity_bias", write_config("synth-entity-bias", RELATION_BIAS, olp, "DataBiasOnlyEntityModel",
                                         data=olp_files)),
        ("olp_relation_bias", write_config("synth-relation-bias", RELATION_BIAS, olp, data=olp_files)),
        ("olp_lookup_sparse", write_config(
            "synth-lookup-complex-sparse", FLAGSHIP, {"dataset_dir": str(DATA_DIR), "eval_epoch_freq": 0,
                                                      "save_epoch_freq": 0},
            "LookupComplexRelationModel", {"entity_slot_size": 200, "input_dropout": 0.4, "init_std": 0.1,
                                           "sparse": True, "normalize": "", "dropout": 0.0, "dtype": "float32"})),
    ]


def lstm_pass_launches(B, L, dtype, backward):
    """Kernel launches of one LSTM pass over B rows: fused (kernels 1 and 2)
    where the JAX package's rule takes it at this B (B % 8 == 0 at the
    families' widths, D = H = 512), else unfused (kernels 7 and 8)."""
    if B % 8 == 0:
        return {"lstm_last_fwd": forward_launches(L, dtype), "lstm_last_bwd": backward_launches(L, dtype) * backward}
    fwd, bwd = scan_launches(L, dtype)
    return {"lstm_scan_fwd": fwd, "lstm_scan_bwd": bwd * backward}


def family_launches(names, trainer, val_batches, cache_chunks, test_batches):
    """The launches a family's cli.train run must count: per step one dense
    Adagrad launch when a dense leaf is left and one row launch when a table
    took the row-sparse update (one regime group); for the LSTM families
    per step the entity side (with batch-shared candidates one pass over
    candidates and query entities; over the full vocabulary a candidate
    pass over every entity and a query pass), and the relation pass, each
    with its backward when the scorer reads it (the entity-bias model reads
    no relation, the relation-bias model no query entity); the evals'
    kernel 1 passes (``eval_launches``)."""
    from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    model = trainer.model
    n_leaves = sum(1 for _ in leaves(trainer.variables["params"]))
    log = counted_steps(trainer.step_log)
    want = Counter({name: 0 for name in names})
    want["adagrad_update"] = sum(1 for s in log if n_leaves > len(s["sparse_tables"]))
    want["scatter_adagrad"] = sum(1 for s in log if s["sparse_tables"])
    if isinstance(model.embedder, LSTMEmbedder):
        L, dtype, meta = model.meta.max_length[0], model.embedder.dtype, model.meta
        check(L == model.meta.max_length[1], "entity and relation lengths differ")
        ds = trainer.train_dataset
        B = ds.batch_size
        if ds.use_batch_shared_entities:
            passes = [(B + ds.min_size_batch_labels, True)]
        else:
            passes = [(meta.entities_size - meta.min_entities_size, True), (B, model.scorer != "bias_relation")]
        passes.append((B, model.scorer != "bias_entity"))
        for rows, backward in passes:
            want.update({k: v * len(log) for k, v in lstm_pass_launches(rows, L, dtype, backward).items()})
        want.update(eval_launches(names, L, dtype, val_batches, cache_chunks, test_batches))
    return dict(want)


def run_family(torch, tag, config, extra=()):
    """``cli.train`` on ``config`` (two passes), with every kernel's launch
    count set to 0 just before and read just after -> (trainer, capture,
    launches, wall s)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train

    out_dir = ROOT / ".bench_cache" / f"smoke_{tag}"
    shutil.rmtree(out_dir, ignore_errors=True)
    args = [str(config), "--epochs", "2", "--experiment_dir", str(out_dir), *extra, "--device", "cuda"]
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Capture() as capture:
        trainer = cli_train.cli_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return trainer, capture, {name: fn.launches for name, fn in counters.items()}, wall


def check_family_run(torch, tag, trainer, launches, wall, falling=False):
    """A family's training run: two passes of steps, every loss finite (and
    falling over the run with ``falling``), its validation evals' rows
    finite and ordered, the launches exactly ``family_launches``'."""
    log = trainer.step_log
    per_pass = len(trainer.train_builder)
    check(len(log) == 2 * per_pass > 0, f"{tag}: {len(log)} steps, want 2 passes of {per_pass}")
    losses = np.array([float(s["loss"]) for s in log])
    check(np.isfinite(losses).all(), f"{tag}: non-finite training loss {losses}")
    k = max(1, min(3, len(losses) // 2))
    first, last = losses[:k].mean(), losses[-k:].mean()
    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    for r in rows:
        check(0 < r["validation_mrr"] <= 1 and np.isfinite(r["validation_loss"])
              and r["validation_h1"] <= r["validation_h3"] <= r["validation_h10"] <= r["validation_h50"],
              f"{tag}: validation row {r}")
    val_batches = cache_chunks = test_batches = 0
    if rows and trainer.validation_dataset.use_batch_shared_entities:
        val_batches = len(rows) * len(trainer.val_builder)
    elif rows:  # full vocabulary: the cache chunks, then the batches
        cache_chunks = len(rows) * -(-trainer.model.meta.entities_size // 32768)
        test_batches = len(rows) * len(trainer.val_builder)
    want = family_launches(launches, trainer, val_batches, cache_chunks, test_batches)
    m = trainer.model
    print(f"{tag}: {type(m).__name__} {m.scorer} x {type(m.embedder).__name__} d={m.embedder.entity_dim} "
          f"relation_dim={m.embedder.relation_dim} {m.embedder.dtype}, {len(log)} steps of "
          f"{trainer.train_dataset.batch_size} in {wall:.2f} s (cli.train), loss first {k} {first:.5f} -> last {k} "
          f"{last:.5f}; " + "; ".join(f"validation MRR {r['validation_mrr']:.6f} h10 {r['validation_h10']:.4f}"
                                      for r in rows))
    print(f"{tag}: launches {launches} (want {want})")
    check(launches == want, f"{tag}: launches {launches}, want {want}")
    check(len(rows) >= 1 or not trainer.args.get("eval_epoch_freq"), f"{tag}: no validation eval")
    if falling:
        check(last < first, f"{tag}: the loss did not fall: first {k} steps {first:.5f}, last {k} {last:.5f}")
    return want


def time_family_steps(torch, trainer, timings, pre, n=8):
    """Dense steps after warm-up with a synchronize around each: median and
    max ms a step, items/s, and a profile of one step (device busy
    share)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device, train_batch_to_arrays

    builder = trainer.train_builder
    order = np.random.default_rng(SEED + 1).permutation(len(builder.rec))
    bs = builder.batch_size
    dev = [arrays_to_device(train_batch_to_arrays(builder.build(order[i * bs : (i + 1) * bs])), trainer.device)
           for i in range(n + 2)]
    step = lambda arrays: trainer.train_step(  # noqa: E731
        trainer.variables, trainer.opt_state, trainer.regimes.hparams(), arrays, trainer.generator)
    trainer.variables, trainer.opt_state, _ = step(dev[n + 1])  # warm-up
    step_ms, positives = [], 0.0
    for arrays in dev[:n]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.variables, trainer.opt_state, stats = step(arrays)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        positives += float(stats["normalizer_metric"])
    timings[pre + "train_step_ms"] = summary(step_ms)
    timings[pre + "train_items_per_s"] = positives / (sum(step_ms) / 1e3)
    timings[pre + "cli_epoch_items_per_s"] = trainer.last_epoch["items_per_s"]
    m = trainer.model
    print(f"{pre}train step (synchronized, after warm-up): median {np.median(step_ms):.3f} ms, max {max(step_ms):.3f}"
          f" ms, {timings[pre + 'train_items_per_s']:.0f} items/s; cli epoch {trainer.last_epoch['items_per_s']:.0f} "
          "items/s")
    device_breakdown(torch, f"{pre}train step ({bs} prefixes x {m.meta.entities_size - m.meta.min_entities_size} "
                            f"candidates, d={m.embedder.entity_dim}, {m.embedder.dtype})",
                     lambda: step(dev[n]), top=12)


def time_adagrad_leaves(torch, captured, timings, pre):
    """Kernel 3 on a run's first recorded group (as the optimizer launched
    it, held bit-equal by ``check_family_kernels``): device ms a launch (the
    profiler, L2 flushed before each: ``cold_kernel_ms``) and from a CUDA
    graph of 50, each under its own key, beside its bytes bound."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak

    gs, ps, accs, steps, hp = captured
    p1, a1 = _clones(ps), _clones(accs)
    run = lambda: ak.adagrad_update_leaves(gs, p1, a1, steps, hp)  # noqa: E731
    ms = cold_kernel_ms(torch, "adagrad_dense_kernel", (gs, p1, a1, steps, hp))
    warm_ms = graph_ms(torch, run)
    plain_ms = cuda_ms(lambda: ak.adagrad_update_leaves_plain(gs, p1, a1, steps, hp), iters=20)
    n = sum(p.numel() for p in ps)
    bytes_ = 5 * 4 * n + 2 * 4 * len(ps)  # read g, p, acc; write p, acc; a step in and out a leaf
    bound = bytes_ / PEAK_BYTES_PER_S * 1e3
    timings[pre + "adagrad_ms"], timings[pre + "adagrad_graph_ms"] = ms, warm_ms
    timings[pre + "adagrad_bound_ms"] = bound
    print(f"{pre}adagrad_update at {[list(p.shape) for p in ps]} ({n} elements): device {ms:.4f} ms a launch "
          f"(profiler, L2 flushed before each), {warm_ms:.4f} ms (CUDA graph of 50), plain twin {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms (bytes: {bytes_:.4e} B at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {bound / ms:.1%} of it)")


def check_dense_ranking(torch, label, cap):
    """The [B, N] ranking of a full-vocabulary eval without a cache (a
    lookup model): the first batch's ranks recounted on the host from its
    recorded scores."""
    rec = cap.dense[0]
    gi, g_rows, gm, filt, col_valid = host_golds(rec["golds"], rec["col_valid"])
    rows = rec["scores"][torch.from_numpy(g_rows).long().to(rec["scores"].device)].cpu().numpy()
    return check_ranking(f"{label} batch 0 ([B, N] = {list(rec['scores'].shape)})",
                         [(rows, gm, filt, col_valid, rec["ranks"].cpu().numpy()[gi])], ties_expected=False)


def serve_lookup(torch, timings, config, ckpt, pre, nq=1024, n_timed=10):
    """The serving path of a lookup checkpoint: ``cli.predict`` text queries
    and ``Predictor`` top-k of 1024-query batches and single queries, with
    the launch counts set to 0 just before and read just after (a lookup
    model launches none of the port's kernels); the top-k against a plain
    CPU Predictor on the same weights (ids equal, scores by the f32 rule).
    Returns the launches."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
    from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32

    args = load_config(str(config))
    data_dir = Path(args["dataset_dir"])
    queries = text_queries(data_dir)
    meta = load_meta(str(data_dir), tuple(args["experiment_settings"]["max_lengths_tuple"]))
    rng = np.random.default_rng(SEED)
    ent_ids = rng.integers(meta.min_entities_size, meta.entities_size, nq)
    rel_ids = rng.integers(meta.min_relations_size, meta.relations_size, nq)

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    cli_lines, timings[pre + "cli_predict_s"] = cli_predict_lines(torch, config, ckpt, data_dir, queries)
    model = build_model(args["model"], meta, **args["model_config"])
    variables, _, _ = load_checkpoint(ckpt, model.init(torch.Generator(device="cuda").manual_seed(SEED)), {})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predictor = Predictor(model, variables)
    torch.cuda.synchronize()
    timings[pre + "cache_encode_s"] = time.perf_counter() - t0
    results, batch_ms, single_ms = {}, [], []
    for direction in ("subj", "obj"):
        kw = {direction: ent_ids, "rel": rel_ids, "k": 10}
        results[direction] = predictor.predict(**kw)
        batch_ms += [wall_ms(lambda: predictor.predict(**kw)) for _ in range(n_timed)]
        single_ms += [wall_ms(lambda: predictor.predict(**{direction: ent_ids[i : i + 1]}, rel=rel_ids[i : i + 1],
                                                        k=10)) for i in range(n_timed)]
    timings[f"{pre}predict_{nq}_ms"], timings[pre + "predict_1_ms"] = summary(batch_ms), summary(single_ms)
    launches = {name: fn.launches for name, fn in counters.items()}

    to_cpu = lambda t: {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()  # noqa: E731
    plain = Predictor(model, to_cpu(variables))
    worst = 0.0
    for direction, (scores, ids) in results.items():
        check(np.isfinite(scores).all() and (np.diff(scores, axis=1) <= 0).all(), f"{pre}{direction} scores")
        want_s, want_i = plain.predict(**{direction: ent_ids[:64]}, rel=rel_ids[:64], k=10)
        check((ids[:64] == want_i).all(), f"{pre}{direction}: top-k ids differ from the plain CPU Predictor")
        worst = max(worst, np.abs(scores[:64] - want_s).max() / np.abs(want_s).max())
    check(worst <= MAX_REL_ERR_F32, f"{pre}top-k scores vs the plain CPU Predictor: {worst:.3e}")
    check(all(v == 0 for v in launches.values()), f"{pre}serving launched a kernel: {launches}")
    print(f"{pre}serving: cli.predict {timings[pre + 'cli_predict_s']:.3f} s ({cli_lines[0]} ...); cache "
          f"{tuple(predictor.cand_emb.shape)} in {timings[pre + 'cache_encode_s'] * 1e3:.3f} ms; {nq} queries "
          f"median {np.median(batch_ms):.3f} ms, 1 query {np.median(single_ms):.3f} ms; top-10 of 128 queries vs "
          f"the plain CPU Predictor: ids equal, scores max rel err {worst:.3e} (tol {MAX_REL_ERR_F32:.0e}); launches "
          f"{launches} (want 0 of each)")
    device_breakdown(torch, f"{pre}predict ({nq} subj queries, k=10)",
                     lambda: predictor.predict(subj=ent_ids, rel=rel_ids, k=10))
    return launches


def check_sparse_lookup(tag, trainer, capture):
    """The row-sparse lookup run: which tables took the row update on how
    many steps (the entity table must), and the first row launch's tables
    (held bit-equal by ``check_family_kernels``)."""
    by_table = Counter(t for s in trainer.step_log for t in s["sparse_tables"])
    check(by_table["entity_embedding"] > 0, f"{tag}: the entity table never took the row update: {by_table}")
    shapes = [list(p.shape) for p in capture.rows[3]]
    print(f"{tag}: row-sparse updates by table {dict(by_table)} of {len(trainer.step_log)} steps; first row launch "
          f"over tables {shapes}, {[int(v.sum()) for v in capture.rows[2]]} valid rows")


#: the kernel rows a family run's recorded launches are held under, by the
#: ``Capture`` record that holds them
FAMILY_RECORDS = {"fwd": "lstm_last_fwd", "bwd": "lstm_last_bwd", "scan_fwd": "lstm_scan_fwd",
                  "scan_bwd": "lstm_scan_bwd", "dense": "adagrad_update", "rows": "scatter_adagrad"}


def check_family_kernels(torch, tag, capture, launches, late=False):
    """Every kernel launch that a family's run recorded (``Capture``) against
    its plain twin on the same inputs, with the flagship's rules: kernel 1's
    training outputs (``residual_agreement``), kernel 2 re-run on its
    recorded inputs (``backward_agreement``), kernels 7 and 8
    (``scan_agreement``), each by the rule of its dtype (bf16 with its
    unequal share, f32 the f32 rule); kernels 3 and 4 bit for bit
    (``check_adagrad_cases``).  A kernel the run launched must have a record.
    With ``late`` (a step far into training) kernels 1 and 2 are held
    against their recurrence in f64 beside the plain version
    (``forward_f64_agreement``, ``backward_f64_agreement``).  Returns
    {kernel row: largest error}."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sak

    for record, name in FAMILY_RECORDS.items():
        check(not launches[name] or getattr(capture, record), f"{tag}: {name} launched, but no launch was recorded")
    errs = Counter()

    def hold(name, label, dtype, ok, text, err):
        row = name + ("_f32" if dtype == torch.float32 else "")
        print(f"{tag} {row} {label}: {text}")
        check(ok, f"{tag}: {row} disagrees with its plain version on the {label}")
        errs[row] = max(errs[row], err)

    for i, (args, got) in enumerate(capture.fwd):
        B = args[0].shape[1]
        agree = forward_f64_agreement if late else residual_agreement
        hold("lstm_last_fwd", f"training pass {i} B={B}", args[0].dtype,
             *agree(torch, args, got, lk.lstm_encode_last_plain(*args, residuals=True)))
    for i, args in enumerate(capture.bwd):
        got, want = lk.lstm_last_backward(*args), lk.lstm_last_backward_plain(*args)
        agree = backward_f64_agreement if late else backward_agreement
        hold("lstm_last_bwd", f"training backward {i} B={args[0].shape[1]}", args[0].dtype,
             *agree(torch, args, got, want))
    for i, (args, got) in enumerate(capture.scan_fwd):
        hold("lstm_scan_fwd", f"pass {i} B={args[0].shape[1]}", args[0].dtype,
             *scan_agreement(torch, got, sk.lstm_scan_forward_plain(*args)))
    for i, args in enumerate(capture.scan_bwd):
        hold("lstm_scan_bwd", f"training backward {i} B={args[0].shape[1]}", args[0].dtype,
             *scan_agreement(torch, sk.lstm_scan_backward(*args), sk.lstm_scan_backward_plain(*args),
                             backward=True))
    if capture.dense is not None:
        errs["adagrad_update"] = check_adagrad_cases(
            torch, "adagrad_update", [(f"{tag} first step's group {[list(p.shape) for p in capture.dense[1]]}",
                                       capture.dense, False)],
            ak.adagrad_update_leaves, ak.adagrad_update_leaves_plain, {})
    if capture.rows is not None:
        errs["scatter_adagrad"] = check_adagrad_cases(
            torch, "scatter_adagrad", [(f"{tag} first step's tables {[list(p.shape) for p in capture.rows[3]]}",
                                        capture.rows, False)],
            sak.scatter_adagrad_tables, sak.scatter_adagrad_tables_plain, {})
    return dict(errs)


def phase_families(torch, timings, by_path, by_path_f32):
    """The eight model families of this slice through ``cli.train``,
    ``--evaluate`` and serving: lookup ComplEx at FB15k-237's widths and
    sizes trained, evaluated, served and timed; the other seven names a few
    steps and one validation eval each; the row-sparse lookup path.  Each
    run's launches go to ``by_path`` (bf16) or ``by_path_f32`` under its
    tag.  Returns the largest error of each kernel row that the runs'
    recorded launches were held under (``check_family_kernels``)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    timings.setdefault("fb_dataset_gen_s", ensure_dataset(FB_DATA_DIR, FB_DATA_ARGS))
    errs = {}
    for tag, config in family_runs():
        trainer, capture, launches, wall = run_family(torch, tag, config)
        main_path = tag == "fb_lookup_complex"
        check_family_run(torch, tag, trainer, launches, wall, falling=main_path)
        (by_path if trainer.model.embedder.dtype == "bfloat16" else by_path_f32)[tag] = launches
        timings[tag + "_cli_train_s"] = wall
        for row, err in check_family_kernels(torch, tag, capture, launches).items():
            errs[row] = max(errs.get(row, 0.0), err)
        if tag == "olp_lookup_sparse":
            check_sparse_lookup(tag, trainer, capture)
        if main_path:
            check(launches["adagrad_update"] == len(trainer.step_log), f"{tag}: kernel 3 not once a step")
            check_selection(torch, trainer)
            ckpt = Path(trainer.last_checkpoint)
            init = trainer.model.init(torch.Generator(device="cuda").manual_seed(1))
            variables, opt, meta = load_checkpoint(str(ckpt), init, trainer.regimes.init_state(init["params"]))
            for got, want in ((variables["params"], trainer.variables["params"]),
                              (variables["state"], trainer.variables["state"]), (opt, trainer.opt_state)):
                g, w = dict(leaves(got)), dict(leaves(want))
                check(set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w), f"{tag}: checkpoint does not "
                                                                                      "load back")
            print(f"{tag}: checkpoint {ckpt.name}: params and {len(dict(leaves(opt)))} optimizer leaves load back "
                  "equal")
            time_family_steps(torch, trainer, timings, tag + "_")
            time_adagrad_leaves(torch, capture.dense, timings, tag + "_")
            trainer = capture = None
            test_trainer, cap, test_launches, row, test_wall = run_evaluate(
                torch, config, str(ckpt), ROOT / ".bench_cache" / f"smoke_eval_{tag}", False, FB_DATA_DIR)
            check(all(v == 0 for v in test_launches.values()) and cap.dense and not cap.chunked,
                  f"{tag} test: launches {test_launches}, the dense [B, N] ranking not taken")
            check_eval_metrics(f"{tag} test", row, cap.dense,
                               int(test_trainer.validation_dataset.records.group_offsets[-1]))
            check_dense_ranking(torch, f"{tag} test", cap)
            timings[tag + "_eval_test_s"] = test_trainer.last_eval["batches_s"]
            print(f"{tag} test eval: {test_trainer.last_eval['batches']} batches of "
                  f"{test_trainer.val_builder.batch_size} against every entity in "
                  f"{test_trainer.last_eval['batches_s']:.3f} s (cli.train --evaluate {test_wall:.3f} s)")
            by_path_f32[tag + "_eval"] = test_launches
            del test_trainer, cap
            by_path_f32[tag + "_serve"] = serve_lookup(torch, timings, config, str(ckpt), tag + "_serve_")
        del trainer, capture
        torch.cuda.empty_cache()
    return errs


# ------------------------------------------------- objectives and optimizers

#: the flagship trained with gradient accumulation over 4 micro-batches
ACCUM_STEPS = 4


def flagship_copy(name, **changes):
    """A copy of the flagship config under ``.bench_cache/`` on the smoke
    set, with the top-level keys ``changes`` (``experiment_settings`` keys
    merged into the flagship's)."""
    import yaml

    es = {**yaml.safe_load(FLAGSHIP.read_text())["experiment_settings"], **changes.pop("experiment_settings", {})}
    return write_config(name, FLAGSHIP, {"dataset_dir": str(DATA_DIR), "experiment_settings": es, **changes})


def window_tables(plan, batches, accum):
    """The accumulation windows of a stream of host batches, as the trainer
    forms them (``accum`` batches a window, the rest carried): per window
    the tables the port's own ``plan_window`` left row-sparse, and the
    number of batches still waiting at the end."""
    windows, buf = [], []
    for b in batches:
        buf.append(b)
        if len(buf) == accum:
            d = plan.plan_window(buf)[0]
            windows.append(tuple(t for t in plan.tables if f"sparse/{t}/uids" in d))
            buf = []
    return windows, len(buf)


def count_windows(config, passes, accum=ACCUM_STEPS):
    """``window_tables`` of ``passes`` passes of the run ``config``
    describes, on the CPU before the card runs it: the trainer's batch
    stream (its builder seed, workers and prefetch) and its plan builder."""
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder

    args = load_config(str(config), [])
    ds = setup_dataset(args)
    model = build_model(args["model"], ds.meta, **args["model_config"])
    plan = SparsePlanBuilder(model.embedder, bool(ds.use_batch_shared_entities),
                             min_rows_ratio=float(args.get("sparse_min_ratio", 12.0)),
                             grad_plan=bool(args.get("sparse_grad_plan", True)))
    builder = BatchBuilder(ds, seed=int(args.get("seed") or 0))
    workers = int(args.get("workers", 8))

    def stream():
        for _ in range(passes):
            yield from builder.batches(shuffle=True, prefetch=max(2, workers), workers=workers)

    windows, carried = window_tables(plan, stream(), accum)
    return windows, carried, len(builder), ds.batch_size, ds.min_size_batch_labels


def lr_scale(cfg, epoch, base_lr):
    """torch's closed form of an epoch-indexed scheduler's lr scale (the
    kinds the optim runs take): StepLR, CosineAnnealingLR."""
    import math

    kind = cfg["lr_scheduler"]
    if kind == "StepLR":
        return cfg.get("gamma", 0.1) ** (epoch // cfg.get("step_size", 1))
    if kind == "CosineAnnealingLR":
        eta_min = cfg.get("eta_min", 0.0)
        return (eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / cfg.get("T_max", 50))) / 2) / base_lr
    raise ValueError(kind)


def phase_lr(phases, phase):
    """A regime's lr at ``phase``: later phases override earlier ones."""
    merged = {}
    for p in phases[: phase + 1]:
        merged.update(p)
    return float(merged["lr"])


def plateau_scales(metrics, factor, patience):
    """ReduceLROnPlateau's scale after each eval of ``metrics`` (greater is
    better), replayed: a fall by ``factor`` after more than ``patience``
    evals without a new best."""
    best, bad, scale, out = None, 0, 1.0, []
    for m in metrics:
        if best is None or m > best:
            best, bad = m, 0
        else:
            bad += 1
            if bad > patience:
                scale, bad = scale * factor, 0
        out.append(scale)
    return out


class HparamLog:
    """Per call of ``OptimizerRegimes.hparams`` while the block runs (the
    trainer calls it once a step, or once an apply): each regime's optimizer
    name, phase and hyperparameters; and the ``lr`` every dense Adagrad
    launch is given."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel
        from open_knowledge_graph_embeddings_tpu_torch.train import optim

        self.mods = (optim.OptimizerRegimes, adagrad_kernel)
        self.calls, self.launch_lrs = [], []

    def __enter__(self):
        cls, ak = self.mods
        self._orig = (cls.hparams, ak._launch)
        orig_hp, orig_launch = self._orig

        def hparams(regimes):
            out = orig_hp(regimes)
            self.calls.append((regimes.opt_names(), list(regimes.current_phase), [dict(h) for h in out]))
            return out

        def launch(gs, ps, accs, steps, clr, hp):
            self.launch_lrs.append(hp["lr"])
            return orig_launch(gs, ps, accs, steps, clr, hp)

        cls.hparams, ak._launch = hparams, launch
        return self

    def __exit__(self, *exc):
        cls, ak = self.mods
        cls.hparams, ak._launch = self._orig


class WindowCapture:
    """The first accumulation window of a run: the parameters at its start
    (copies) and, per micro-batch, the device arrays and the dropout
    generator's state before ``grad_step`` draws from it.  It wraps the
    trainer module's ``make_sparse_accum_steps`` and calls it through."""

    def __init__(self, accum):
        from open_knowledge_graph_embeddings_tpu_torch.train import trainer

        self.mod, self.accum = trainer, accum
        self.params, self.micro, self.recording = None, [], True

    def __enter__(self):
        self._orig = orig = self.mod.make_sparse_accum_steps

        def make(*a, **kw):
            zero, grad_step, apply_step = orig(*a, **kw)

            def recording(variables, acc, arrays, generator=None):
                if self.recording and len(self.micro) < self.accum:
                    if self.params is None:
                        self.params = {k: v.clone() for k, v in variables["params"].items() if not isinstance(v, dict)}
                        self.params.update({k: {n: t.clone() for n, t in v.items()}
                                            for k, v in variables["params"].items() if isinstance(v, dict)})
                    self.micro.append((arrays, generator.get_state()))
                return grad_step(variables, acc, arrays, generator)

            return zero, recording, apply_step

        self.mod.make_sparse_accum_steps = make
        return self

    def __exit__(self, *exc):
        self.mod.make_sparse_accum_steps = self._orig

    def release(self):
        """Drop the copies; the steps built in the block record no more."""
        self.params, self.micro, self.recording = None, [], False


@contextlib.contextmanager
def plain_lstm():
    """Kernels 1 and 2 off while the block runs: the fused LSTM's wrappers
    take their plain versions on CUDA tensors, as they do on CPU ones, and
    count no launch."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    orig = lk._launch_forward, lk._launch_backward

    def forward(emb_tm, w_ih, w_hh, bias, lengths, residuals):
        return lk.lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths, residuals=residuals)

    lk._launch_forward, lk._launch_backward = forward, lk.lstm_last_backward_plain
    try:
        yield
    finally:
        lk._launch_forward, lk._launch_backward = orig


def micro_batch_grads(torch, trainer, wcap, i):
    """Micro-batch ``i`` of the recorded window alone, from the window's
    starting weights and its recorded dropout stream, through the per-batch
    gradient of the sparse step (``train/sparse.py``'s ``_sparse_grads``)
    -> {token table: its row gradient, or its dense one where the window
    left the table dense}."""
    from open_knowledge_graph_embeddings_tpu_torch.train import sparse

    tables = list(trainer._sparse_tables)
    variables = {"params": wcap.params, "state": trainer.variables["state"], "buffers": trainer.variables["buffers"]}
    arrays, state = wcap.micro[i]
    gen = torch.Generator(device=trainer.device)
    gen.set_state(state)
    sparse_tables = tuple(t for t in tables if f"sparse/{t}/uids" in arrays)
    g_dense, g_rows, _, _, _ = sparse._sparse_grads(trainer.model, variables, arrays, sparse_tables,
                                                    trainer.loss_type, trainer.label_smoothing, gen)
    return {**g_rows, **{t: g_dense[t] for t in tables if t in g_dense}}


def window_sums(torch, trainer, wcap):
    """The window's micro-batches recomputed alone (``micro_batch_grads``)
    and summed in f64 -> (the sums, the sums without the last micro-batch:
    the planted fault)."""
    sums, partial = {}, {}
    for i in range(len(wcap.micro)):
        for t, g in micro_batch_grads(torch, trainer, wcap, i).items():
            sums[t] = sums.get(t, 0) + g.double()
            if i < len(wcap.micro) - 1:
                partial[t] = partial.get(t, 0) + g.double()
    return sums, partial


def check_window_gradients(torch, trainer, wcap, rows_capture, dense_capture):
    """The first window's summed row gradients, as kernel 4 was handed them
    (and a token table the window left dense, as kernel 3 was), against the
    sum of its micro-batches' gradients recomputed alone
    (``window_sums``), twice:

    * with kernels 1 and 2 off (``plain_lstm``), the plain path: the
      kernels and their plain versions round to bf16 at other points, so
      this sum is held by the bf16 rule of ``utils/numerics.py`` at
      max|want| (``MAX_ULPS``); its unequal share does not apply to f32
      sums and is printed only;
    * with the kernels on, which isolates the accumulator's adds: the f32
      rule.

    A sum that leaves one micro-batch out must fail both.  Returns the
    largest relative error of the f32 rule."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_ULPS, bf16_agreement, f32_agreement

    tables = list(trainer._sparse_tables)
    by_shape = {tuple(trainer.variables["params"][t].shape): t for t in tables}
    got = {by_shape[tuple(p.shape)]: g for g, p in zip(rows_capture[0], rows_capture[3])}
    row_tables = set(got)
    got.update({by_shape[tuple(p.shape)]: g for g, p in zip(dense_capture[0], dense_capture[1])
                if tuple(p.shape) in by_shape})
    with plain_lstm():
        plain_sums, plain_partial = window_sums(torch, trainer, wcap)
    sums, partial = window_sums(torch, trainer, wcap)
    check(set(got) == set(sums) == set(plain_sums) == set(tables),
          f"window gradients of {set(got)}, recomputed {set(sums)} and {set(plain_sums)}")
    worst = 0.0
    for t in tables:
        kind = "row-sparse" if t in row_tables else "dense fallback"
        b = bf16_agreement(got[t], plain_sums[t].float())
        bfault = bf16_agreement(plain_partial[t].float(), plain_sums[t].float())
        print(f"accum first window {t} ({kind}, {list(got[t].shape)}): summed gradient vs the micro-batches "
              f"recomputed alone on the plain path (kernels 1 and 2 off), f64 sum: {b.ulps:.3f} bf16 ulps at "
              f"max|want| (tol {MAX_ULPS}), max abs err {b.max_abs_err:.3e}, unequal {b.unequal_share:.3%} "
              f"(not held); planted fault (one micro-batch left out): {bfault.ulps:.1f} ulps")
        check(b.ulps <= MAX_ULPS, f"accum: the window's summed gradient of {t} disagrees with the plain path's")
        check(bfault.ulps > MAX_ULPS, f"accum: the bf16 rule passes a window sum without one micro-batch ({t})")
        a = f32_agreement(got[t], sums[t].float())
        fault = f32_agreement(partial[t].float(), sums[t].float())
        print(f"accum first window {t}: summed gradient vs the micro-batches recomputed alone with the kernels on, "
              f"f64 sum: {a}; planted fault (one micro-batch left out): {fault}")
        check(a.ok(), f"accum: the window's summed gradient of {t} disagrees with its micro-batches'")
        check(not fault.ok(), f"accum: the f32 rule passes a window sum without one micro-batch ({t})")
        worst = max(worst, a.rel_err)
    return worst


def repeat_probe(torch, trainer, wcap, bwd_args):
    """Where the recomputed window sum varies from run to run: kernel 2 on
    the window's first recorded backward twice (demb where each row
    reaches, dW and db), and micro-batch 0's
    gradients twice, bit for bit; then micro-batch 0 twice more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
    names each op on the path that has no deterministic CUDA
    implementation.  Kernel 2 promises none of its own (no float atomics):
    held.  The rest is printed."""
    import warnings

    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    act = active_mask(torch, bwd_args)  # demb holds unread garbage past each row's length
    k2 = [lk.lstm_last_backward(*bwd_args) for _ in range(2)]
    same_k2 = dict(zip(("demb", "dW_ih", "dW_hh", "db"),
                       [torch.equal(k2[0][0][act], k2[1][0][act])] + [torch.equal(x, y) for x, y in zip(k2[0][1:],
                                                                                                      k2[1][1:])]))
    print(f"accum: kernel 2 twice on the window's first backward (B={bwd_args[0].shape[1]}): bit-equal {same_k2}")
    check(all(same_k2.values()), "accum: kernel 2 changes from run to run")
    del k2
    runs = [micro_batch_grads(torch, trainer, wcap, 0) for _ in range(2)]
    same = {t: torch.equal(runs[0][t], runs[1][t]) for t in runs[0]}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            det = [micro_batch_grads(torch, trainer, wcap, 0) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    same_det = {t: torch.equal(det[0][t], det[1][t]) for t in det[0]}
    ops = sorted({str(w.message).split(" does not have a deterministic")[0].strip()[:160] for w in caught})
    print(f"accum: micro-batch 0's gradients twice, bit-equal by table {same}; under deterministic algorithms "
          f"{same_det}; ops torch names as nondeterministic on this path: {ops}")
    # one site at a time: only that site's index_add_ made deterministic
    for sites in (("token scatters",), ("bce positives",), ("token scatters", "bce positives")):
        with deterministic_sites(torch, sites):
            runs = [micro_batch_grads(torch, trainer, wcap, 0) for _ in range(2)]
        print(f"accum: micro-batch 0's gradients twice with only {' and '.join(sites)} deterministic: bit-equal by "
              f"table {({t: torch.equal(runs[0][t], runs[1][t]) for t in runs[0]})}")


#: the float index_add_ sites of a training step's backward, by the file and
#: function that call them: the token-table scatters (models/embedders.py's
#: _TokenGatherScatter and _TokenGatherPlan) and the BCE positives' dq and
#: dcand (train/loss.py's _BceOverScores)
ATOMIC_SITES = {"token scatters": ("embedders.py", "backward"), "bce positives": ("loss.py", "backward")}


@contextlib.contextmanager
def deterministic_sites(torch, sites):
    """``Tensor.index_add_`` called from the ``sites`` of ``ATOMIC_SITES``
    runs as a deterministic ``index_put_(accumulate=True)`` (sorted, no
    float atomics) while the block runs; every other caller as before."""
    orig = torch.Tensor.index_add_
    where = [ATOMIC_SITES[s] for s in sites]

    def index_add_(self, dim, index, source, **kw):
        code = sys._getframe(1).f_code
        if dim == 0 and not kw and any(code.co_filename.endswith(f) and code.co_name == fn for f, fn in where):
            prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                return self.index_put_((index,), source, accumulate=True)
            finally:
                torch.use_deterministic_algorithms(prev)
        return orig(self, dim, index, source, **kw)

    torch.Tensor.index_add_ = index_add_
    try:
        yield
    finally:
        torch.Tensor.index_add_ = orig


def time_accum(torch, trainer, timings, n_windows=2):
    """The accumulation path after warm-up: ms per micro-batch (``grad_step``)
    and per apply (``apply_step``), synchronized around each, over
    ``n_windows`` windows of fresh host batches; and, apart, the host's
    ``plan_window`` of each window, which ``cli.train`` runs on its training
    thread between windows (not on the prefetch threads)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device

    builder, plan, k = trainer.train_builder, trainer._sparse_plan, trainer.accum_steps
    order = np.random.default_rng(SEED + 2).permutation(len(builder.rec))
    bs = builder.batch_size
    windows, plan_ms = [], []
    for w in range(n_windows + 1):
        batches = [builder.build(order[(w * k + i) * bs: (w * k + i + 1) * bs]) for i in range(k)]
        t0 = time.perf_counter()
        planned = plan.plan_window(batches)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
        windows.append([arrays_to_device(d, trainer.device) for d in planned])
    micro_ms, apply_ms = [], []
    for w, arrays in enumerate(windows):
        acc = trainer.zero_grads(arrays[0])
        for a in arrays:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.variables, acc, _ = trainer.grad_step(trainer.variables, acc, a, trainer.generator)
            torch.cuda.synchronize()
            if w:
                micro_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        trainer.variables, trainer.opt_state = trainer.apply_step(trainer.variables, trainer.opt_state, acc,
                                                                  arrays[-1], trainer.regimes.hparams())
        torch.cuda.synchronize()
        if w:
            apply_ms.append((time.perf_counter() - t0) * 1e3)
    timings["accum_micro_batch_ms"], timings["accum_apply_ms"] = summary(micro_ms), summary(apply_ms)
    timings["accum_plan_window_ms"] = summary(plan_ms)
    serial = np.median(micro_ms) + (np.median(apply_ms) + np.median(plan_ms)) / k
    print(f"accum timing (synchronized, after a warm-up window): micro-batch median {np.median(micro_ms):.3f} ms, "
          f"max {max(micro_ms):.3f} ms ({len(micro_ms)}); apply median {np.median(apply_ms):.3f} ms, max "
          f"{max(apply_ms):.3f} ms ({len(apply_ms)}); host plan_window of {k} batches median "
          f"{np.median(plan_ms):.3f} ms, max {max(plan_ms):.3f} ms ({len(plan_ms)}, not in the micro-batch time); "
          f"a micro-batch with its share of the apply and the serial plan {serial:.3f} ms")


def run_cli(torch, args):
    """``cli.train`` with ``args``, with every kernel's launch count set to
    0 just before and read just after, every training kernel's first
    launches recorded (``Capture``) -> (trainer, launches, wall s, the
    capture)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Capture() as capture:
        trainer = cli_train.cli_main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return trainer, {name: fn.launches for name, fn in counters.items()}, wall, capture


def fold_errs(errs, new):
    """``errs`` with each kernel row's largest error of ``new`` folded in."""
    for row, err in new.items():
        errs[row] = max(errs.get(row, 0.0), err)
    return errs


def check_losses(tag, trainer):
    """Every step's loss finite, the last steps' mean below the first's."""
    losses = np.array([float(s["loss"]) for s in trainer.step_log])
    check(len(losses) > 0 and np.isfinite(losses).all(), f"{tag}: non-finite training loss {losses}")
    k = max(1, min(3, len(losses) // 4))
    first, last = losses[:k].mean(), losses[-k:].mean()
    check(last < first, f"{tag}: the loss did not fall: first {k} steps {first:.5f}, last {k} {last:.5f}")
    return first, last


def phase_accum(torch, timings, by_path):
    """The flagship with ``batch_size_for_backward`` 16384 (4 micro-batches
    of 4096 a window), two passes: windows counted on the CPU first, then
    the run with exact launch counts, its recorded launches against their
    plain versions (``check_family_kernels``: kernels 1 and 2 on the first
    micro-batch, the first window's apply bit for bit; the planted faults of
    the main path's checks on ragged groups), its summed row gradients
    against its micro-batches' (``check_window_gradients``), the carried
    batches, the loss falling, ``model_best-mrr``
    loading back; timed (micro-batch, apply, kernels 3 and 4 cold at the
    window's shapes).  Returns (the last checkpoint, the largest kernel
    error by row)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sak
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint_meta
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    out_dir = ROOT / ".bench_cache" / "smoke_accum"
    shutil.rmtree(out_dir, ignore_errors=True)
    config = flagship_copy("synth-olpbench-2m47-accum", batch_size_for_backward=ACCUM_STEPS * 4096,
                           experiment_dir=str(out_dir))
    t0 = time.perf_counter()
    windows, carried, per_pass, B, N = count_windows(config, passes=2)
    timings["accum_host_count_s"] = time.perf_counter() - t0
    by_table = Counter(t for w in windows for t in w)
    print(f"accum (counted on the CPU with plan_window, {timings['accum_host_count_s']:.2f} s): 2 passes of "
          f"{per_pass} batches of {B} x {N} -> {len(windows)} windows of {ACCUM_STEPS}, {carried} batches carried; "
          f"row-sparse by table {dict(by_table)} of {len(windows)} windows")
    check(len(windows) == (2 * per_pass) // ACCUM_STEPS and carried == (2 * per_pass) % ACCUM_STEPS,
          f"accum: {len(windows)} windows and {carried} carried from {2 * per_pass} batches")
    with WindowCapture(ACCUM_STEPS) as wcap:
        trainer, launches, wall, capture = run_cli(torch, [str(config), "--epochs", "2"])
    timings["accum_cli_train_s"] = wall
    L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
    log = trainer.step_log
    check(trainer.accum_steps == ACCUM_STEPS, f"accum: accum_steps {trainer.accum_steps}")
    check(len(log) == trainer.training_steps == len(windows) * ACCUM_STEPS,
          f"accum: {len(log)} micro-batches trained, want {len(windows) * ACCUM_STEPS}")
    check([s["sparse_tables"] for s in log] == [w for w in windows for _ in range(ACCUM_STEPS)],
          "accum: the run's row-sparse tables differ from the host count")
    check([s["applied"] for s in log] == [i % ACCUM_STEPS == ACCUM_STEPS - 1 for i in range(len(log))],
          "accum: an apply off its window's last micro-batch")
    check(trainer._accum_i == 0 and len(trainer._window_buf) == carried,
          f"accum: at the end {trainer._accum_i} micro-batches accumulated and {len(trainer._window_buf)} batches "
          f"waiting, want 0 and {carried} (the row-sparse path trains whole windows; the rest waits for the next "
          "pass, as in the JAX package)")
    val_batches = check_selection(torch, trainer)
    # a micro-batch launches what a step does (the window plan does not
    # dedup queries, so the entity pass runs over B + N rows: 8192, fused);
    # per window one dense launch and one row launch if a table is row-sparse
    want = training_launches(launches, L, len(log), len(windows), sum(1 for w in windows if w), dtype,
                             val_batches=val_batches)
    print(f"accum: launches {launches} (want {want}: {len(log)} micro-batches x 2 fused passes (entity pass over "
          f"{B} + {N} rows), {len(windows)} applies, {want['scatter_adagrad']} with a row-sparse table, "
          f"{val_batches} validation batches)")
    check(launches == want, f"accum: launches {launches}, want {want}")
    first, last = check_losses("accum", trainer)
    # the serial plan_window shows in the wait before a window's first micro-batch
    waits = np.array([s["wait_ms"] for s in log]).reshape(-1, ACCUM_STEPS)
    print(f"accum: cli.train {wall:.2f} s, loss first {first:.5f} -> last {last:.5f}; wait for the arrays: median "
          f"{np.median(waits[1:, 0]):.3f} ms before a window's first micro-batch (its plan_window), "
          f"{np.median(waits[1:, 1:]):.3f} ms before the others (windows after the first)")
    timings["accum_wait_first_ms"], timings["accum_wait_rest_ms"] = (summary(waits[1:, 0].tolist()),
                                                                     summary(waits[1:, 1:].ravel().tolist()))
    by_path["accum"] = launches

    # the first window's apply: kernel 3 over the dense leaves (with any
    # table the window left dense), kernel 4 over the row-sparse tables
    params = trainer.variables["params"]
    n_dense = len(list(leaves(params))) - len(windows[0])
    check(capture.dense is not None and len(capture.dense[1]) == n_dense,
          f"accum: the first apply's dense group has {len(capture.dense[1]) if capture.dense else 0} leaves, "
          f"want {n_dense}")
    check(capture.dense[4]["lr"] == 0.2 and (capture.rows is None) == (not windows[0]),
          "accum: the first apply's launches")
    # every recorded launch against its plain version: kernel 1's passes of
    # the first micro-batch (the entity pass over B + N rows), kernel 2 on
    # its backward, and the first window's apply (kernels 3 and 4) bit for bit
    errs = check_family_kernels(torch, "accum", capture, launches)
    if capture.rows is not None:
        print(f"accum first window's union rows: {[int(v.sum()) for v in capture.rows[2]]} of "
              f"{[list(p.shape) for p in capture.rows[3]]}")
    # the planted faults of the main path's checks, on the groups they catch
    fold_errs(errs, {"adagrad_update": check_adagrad_cases(
        torch, "adagrad_update", [("ragged group", ragged_dense_group(torch, [params[t].shape[0] for t in
                                                                              trainer._sparse_tables]), True)],
        ak.adagrad_update_leaves, ak.adagrad_update_leaves_plain, dense_faults(ak)),
        "scatter_adagrad": check_adagrad_cases(
            torch, "scatter_adagrad", [("ragged tables", ragged_row_tables(torch), True)],
            sak.scatter_adagrad_tables, sak.scatter_adagrad_tables_plain, padding_writer(sak))})
    if capture.rows is not None:
        timings["accum_grad_rel_err"] = check_window_gradients(torch, trainer, wcap, capture.rows, capture.dense)
        repeat_probe(torch, trainer, wcap, capture.bwd[0])
    wcap.release()

    jobs = [("adagrad_dense_kernel", cold_args(capture.dense))]
    if capture.rows is not None:
        jobs.append(("adagrad_rows_kernel", cold_args(capture.rows)))
    cold = cold_kernels_ms(torch, jobs)
    gs, ps, accs, steps, hp = capture.dense
    timings["accum_adagrad_cold_ms"] = ms = cold[0]
    n = sum(p.numel() for p in ps)
    bound = (5 * 4 * n + 2 * 4 * len(ps)) / PEAK_BYTES_PER_S * 1e3
    print(f"accum adagrad_update at the window's leaves {[list(p.shape) for p in ps]} ({n} elements): device {ms:.4f} "
          f"ms a launch (profiler, L2 flushed before each), bound {bound:.4f} ms ({bound / ms:.1%} of it)")
    if capture.rows is not None:
        g_rows, uids, valid, ps, accs, steps, hp = capture.rows
        timings["accum_scatter_adagrad_cold_ms"] = ms = cold[1]
        n_valid = [int(v.sum()) for v in valid]
        bytes_ = sum(5 * 4 * k * g.shape[1] + len(u) * (u.element_size() + 1) + 8
                     for k, g, u in zip(n_valid, g_rows, uids))
        bound = bytes_ / PEAK_BYTES_PER_S * 1e3
        print(f"accum scatter_adagrad at the window's union rows {n_valid} of {[list(p.shape) for p in ps]}: device "
              f"{ms:.4f} ms a launch (profiler, L2 flushed before each), bound {bound:.4f} ms ({bound / ms:.1%} of it)")
    del capture
    time_accum(torch, trainer, timings)
    ckpt = trainer.last_checkpoint
    check(load_checkpoint_meta(ckpt)["training_steps"] == len(log), f"accum: the last checkpoint {ckpt}")
    del trainer
    torch.cuda.empty_cache()
    return ckpt, errs


def check_kl_eval_loss(torch, rec, cache):
    """A full-vocabulary test batch's KL loss (the chunked online
    logsumexp) against a plain dense f32 ``log_softmax`` over every
    candidate column of its [B, N] scores: relative 1e-4.  Returns the
    relative difference."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates

    pos_rows, pos_cols, row_valid = rec["pos"]
    scores = score_against_candidates(rec["q"], cache)  # [B, N] f32
    if rec["col_valid"] is not None:
        scores.masked_fill_(~rec["col_valid"][None, :], float("-inf"))
    logp = torch.log_softmax(scores, dim=1)
    ok = (pos_rows >= 0) & row_valid[pos_rows.clamp(min=0).long()]
    want = -logp[pos_rows.clamp(min=0).long(), pos_cols.clamp(min=0).long()][ok].double().sum().item()
    got = rec["loss"].item()
    rel = abs(got - want) / abs(want)
    print(f"kl test batch 0: loss {got:.6f} (chunked online logsumexp) vs {want:.6f} (dense f32 log_softmax over "
          f"{list(scores.shape)}), relative {rel:.3e} (tol 1e-4)")
    check(rel <= 1e-4, f"kl: the chunked test loss is {rel:.3e} off the dense log_softmax")
    del scores, logp
    return rel


def phase_kl(torch, timings, by_path):
    """The flagship with ``loss: kl``, two passes (kernels 1-4 as on the BCE
    path, the same counts), then ``--evaluate`` on the validation and the
    full-vocabulary test split (the chunked online logsumexp): exact
    launches, the training run's recorded launches against their plain
    versions (``check_family_kernels``: kernel 2 takes the KL loss's
    dlast), the test batch 0 loss against a dense f32 log_softmax, its
    ranks recounted on the host; the KL step timed beside the BCE step and
    the KL test batch beside the BCE one, in turns.  Returns the largest
    error by kernel row."""
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import make_sparse_train_step
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device, eval_batch_to_arrays, make_eval_step

    out_dir = ROOT / ".bench_cache" / "smoke_kl"
    shutil.rmtree(out_dir, ignore_errors=True)
    config = flagship_copy("synth-olpbench-2m47-kl", experiment_settings={"loss": "kl"}, eval_epoch_freq=0,
                           save_epoch_freq=0, experiment_dir=str(out_dir))
    trainer, launches, wall, capture = run_cli(torch, [str(config), "--epochs", "2"])
    log = trainer.step_log
    L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
    check(trainer.loss_type == "kl" and len(log) == 2 * len(trainer.train_builder), f"kl: {len(log)} steps")
    steps = counted_steps(log)
    want = training_launches(launches, L, len(steps), len(steps), sum(1 for s in steps if s["sparse_tables"]), dtype)
    print(f"kl: launches {launches} (want {want}: as the BCE path)")
    check(launches == want, f"kl: launches {launches}, want {want}")
    first, last = check_losses("kl", trainer)
    print(f"kl: cli.train {wall:.2f} s, {len(log)} steps, loss first {first:.5f} -> last {last:.5f}")
    timings["kl_cli_train_s"] = wall
    by_path["kl"] = launches
    errs = check_family_kernels(torch, "kl", capture, launches)  # kernel 2 on the KL loss's dlast
    del capture

    # the KL step beside the BCE step: same weights, same planned batches, in turns
    builder = trainer.train_builder
    order = np.random.default_rng(SEED + 3).permutation(len(builder.rec))
    bs = builder.batch_size
    dev = [trainer._to_device(builder.build(order[i * bs: (i + 1) * bs]))[1] for i in range(9)]
    steps = {lt: make_sparse_train_step(trainer.model, trainer.regimes, trainer.variables["params"], True, loss_type=lt)
             for lt in ("kl", "bce")}
    ms = {lt: [] for lt in steps}
    for i, arrays in enumerate(dev):
        for lt, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.variables, trainer.opt_state, _ = step(trainer.variables, trainer.opt_state,
                                                           trainer.regimes.hparams(), arrays, trainer.generator)
            torch.cuda.synchronize()
            if i:
                ms[lt].append((time.perf_counter() - t0) * 1e3)
    timings["kl_step_ms"], timings["bce_step_ms_beside_kl"] = summary(ms["kl"]), summary(ms["bce"])
    print(f"kl step (synchronized, in turns with BCE on the same batches): median {np.median(ms['kl']):.3f} ms, max "
          f"{max(ms['kl']):.3f}; BCE median {np.median(ms['bce']):.3f} ms, max {max(ms['bce']):.3f}")
    ckpt = trainer.last_checkpoint
    del trainer, dev, steps

    total = Counter()
    for on_validation in (True, False):
        split = "validation" if on_validation else "test"
        etrainer, cap, elaunches, row, ewall = run_evaluate(torch, config, ckpt,
                                                            ROOT / ".bench_cache" / f"smoke_eval_kl_{split}",
                                                            on_validation)
        check(etrainer.loss_type == "kl", f"kl {split}: loss {etrainer.loss_type}")
        meta = etrainer.model.meta
        if on_validation:
            want = eval_launches(elaunches, L, dtype, val_batches=len(etrainer.val_builder))
            recs = cap.dense
        else:
            want = eval_launches(elaunches, L, dtype, cache_chunks=-(-meta.entities_size // 32768),
                                 test_batches=len(etrainer.val_builder))
            recs = cap.chunked
            check(len(cap.chunked) == len(etrainer.val_builder) and not cap.dense, "kl test: not chunked")
        print(f"kl {split}: launches {elaunches} (want {want}), cli.train --evaluate {ewall:.2f} s")
        check(elaunches == want, f"kl {split}: launches {elaunches}, want {want}")
        check_eval_metrics(f"kl {split}", row, recs, int(etrainer.validation_dataset.records.group_offsets[-1]))
        total.update(elaunches)
        if not on_validation:
            rec = cap.chunked[0]
            timings["kl_test_loss_rel_err"] = check_kl_eval_loss(torch, rec, cap.cache)
            gi, g_rows, gm, filt, col_valid = host_golds(rec["golds"], rec["col_valid"])
            rows = chunk_product_rows(torch, rec["q"][torch.from_numpy(g_rows).long().cuda()], cap.cache)
            check_ranking("kl test batch 0", [(rows, gm, filt, col_valid, rec["ranks"].cpu().numpy()[gi])])
            del rows
            batch = etrainer._eval_batches_cache[0]
            arrays = arrays_to_device(eval_batch_to_arrays(batch), etrainer.device)
            fns = {lt: make_eval_step(etrainer.model, lt) for lt in ("kl", "bce")}
            bms = {lt: [] for lt in fns}
            for _ in range(3):
                for lt, fn in fns.items():
                    bms[lt].append(cuda_ms(lambda: fn(etrainer.variables, arrays, cap.cache), iters=1, warmup=1))
            timings["kl_eval_batch_ms"], timings["bce_eval_batch_ms_beside_kl"] = summary(bms["kl"]), summary(bms["bce"])
            print(f"kl full-vocabulary test batch ({batch.batch_size} rows x {cap.cache.shape[0]} candidates, CUDA "
                  f"events, in turns): KL median {np.median(bms['kl']):.3f} ms, BCE median {np.median(bms['bce']):.3f} ms")
            del arrays, fns
        del etrainer, cap
        torch.cuda.empty_cache()
    by_path["kl_eval"] = dict(total)
    return errs


def optim_runs():
    """(tag, config changes, what the run checks) of the optimizer runs:
    lookup ComplEx at FB15k-237's widths, two passes over the first 24,000
    triples with a validation eval after each (and in (b) every 10 steps)."""
    plateau = {"lr_scheduler": "ReduceLROnPlateau", "factor": 0.5, "patience": 0}
    return [
        ("optim_a", {"optimization_config": {"optimizer": "Adam", "lr": 0.003},
                     "lr_scheduler_config": {"lr_scheduler": "StepLR", "step_size": 1, "gamma": 0.5}}),
        ("optim_b", {"optimization_config": [{"optimizer": "RMSprop", "lr": 0.001, "momentum": 0.9, "match": "relation"},
                                             {"optimizer": "Adagrad", "lr": 0.3}],
                     "lr_scheduler_config": [plateau, plateau], "eval_freq": 10}),
        ("optim_c", {"optimization_config": [[{"optimizer": "Adagrad", "lr": 0.3},
                                              {"step": 20, "optimizer": "Adadelta", "lr": 1.0}]],
                     "lr_scheduler_config": {"lr_scheduler": "CosineAnnealingLR", "T_max": 4, "eta_min": 0.1}}),
    ]


def phase_optim(torch, timings, by_path_f32):
    """The optimizer runs (``optim_runs``) through ``cli.train``: exact
    launches (kernel 3 once a step while an Adagrad group exists, never
    after the switch in (c)), the state keys JAX's, every step's lr the
    scheduler's closed form (the plateau replayed from the run's validation
    MRRs), the scaled lr the one kernel 3 was handed, its first launch
    bit-equal to its plain version (``check_family_kernels``: the RMSprop
    split's Adagrad group in (b), the group before the switch in (c)), the
    loss falling.  Returns the largest error by kernel row."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    kge = FB_CONFIGS / "fb15k237-complex-kge.yaml"
    head = {"train_data_config": {"input_file": fb_head_file()}}
    errs = {}
    for tag, changes in optim_runs():
        out_dir = ROOT / ".bench_cache" / f"smoke_{tag}"
        shutil.rmtree(out_dir, ignore_errors=True)
        config = write_config(f"fb15k237-complex-kge-{tag}", kge, {
            "dataset_dir": str(FB_DATA_DIR), "eval_epoch_freq": 1, "save_epoch_freq": 0, "eval_freq": 0,
            "experiment_dir": str(out_dir), **changes}, data=head)
        with HparamLog() as hlog:
            trainer, launches, wall, capture = run_cli(torch, [str(config), "--epochs", "2"])
        log, reg = trainer.step_log, trainer.regimes
        n = len(log)
        check(n == 2 * len(trainer.train_builder) == len(hlog.calls), f"{tag}: {n} steps, {len(hlog.calls)} hparams")
        rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
        check(rows, f"{tag}: no validation eval")
        # (training step, epoch, MRR) of each eval; it runs after its step
        evals = [(int(r["training_steps"]), int(r["epoch"]), r["validation_mrr"]) for r in rows]
        adagrad_lrs = []
        for step, (names, phases, hps) in enumerate(hlog.calls, start=1):
            done = [e for e in evals if e[0] < step]
            for ri, hp in enumerate(hps):
                cfg = reg.lr_scheduler_config[ri] if ri < len(reg.lr_scheduler_config) else None
                base = phase_lr(reg.regimes[ri], phases[ri])
                if not cfg or not done:
                    scale = 1.0
                elif cfg["lr_scheduler"] == "ReduceLROnPlateau":
                    scale = plateau_scales([e[2] for e in done], cfg["factor"], cfg["patience"])[-1]
                else:  # the scale the last eval set, from the lr of the phase at that eval
                    scale = lr_scale(cfg, done[-1][1], phase_lr(reg.regimes[ri], hlog.calls[done[-1][0] - 1][1][ri]))
                check(hp["lr"] == base * scale, f"{tag}: step {step} regime {ri} lr {hp['lr']}, want {base} x {scale}")
                if names[ri] == "Adagrad":
                    adagrad_lrs.append(hp["lr"])
        want = {name: 0 for name in launches}
        want["adagrad_update"] = len(adagrad_lrs)  # one regime group: one launch a step
        print(f"{tag}: {reg.opt_names()} {n} steps, lr scales {reg.lr_scale}, launches {launches} (want {want}), "
              f"cli.train {wall:.2f} s; validation MRR after steps " + ", ".join(f"{e[0]}: {e[2]:.4f}" for e in evals))
        check(launches == want, f"{tag}: launches {launches}, want {want}")
        check(hlog.launch_lrs == adagrad_lrs, f"{tag}: kernel 3 was handed lrs {hlog.launch_lrs}, the steps' "
                                              f"{adagrad_lrs}")
        state_keys = {tuple(sorted(s)) for s in trainer.opt_state.values()}  # a lookup model's leaves are flat
        want_keys = {"Adam": ("m", "step", "v"), "RMSprop": ("momentum", "sq", "step"), "Adagrad": ("step", "sum"),
                     "Adadelta": ("acc_delta", "sq", "step")}
        check(state_keys == {want_keys[nm] for nm in reg.opt_names()}, f"{tag}: state keys {state_keys}")
        first, last = check_losses(tag, trainer)
        print(f"{tag}: state keys {sorted(state_keys)}, loss first {first:.5f} -> last {last:.5f}, "
              f"{len(list(leaves(trainer.variables['params'])))} leaves")
        timings[tag + "_cli_train_s"] = wall
        by_path_f32[tag] = launches
        fold_errs(errs, check_family_kernels(torch, tag, capture, launches))
        del trainer, capture
        torch.cuda.empty_cache()
    return errs


class RunStart:
    """Copies of the parameters when ``Trainer.run`` starts (after a
    resume's load, before the first step)."""

    def __init__(self):
        from open_knowledge_graph_embeddings_tpu_torch.train import trainer

        self.cls, self.params = trainer.Trainer, None

    def __enter__(self):
        self._orig = orig = self.cls.run

        def run(trainer):
            from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays

            self.params = flatten_arrays(trainer.variables["params"], "params")
            return orig(trainer)

        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self._orig


def phase_resume(torch, timings, by_path, ckpt):
    """``cli.train --resume`` from the accumulation run's checkpoint with
    ``resume_filter: [lstm]`` and one more pass: before the first step the
    LSTM leaves equal the checkpoint's and every other leaf the seeded
    init; exact launches (the pass's windows counted on the CPU); the
    recorded launches against their plain versions
    (``check_family_kernels``).  Returns the largest error by kernel row."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, load_checkpoint_meta

    out_dir = ROOT / ".bench_cache" / "smoke_resume"
    shutil.rmtree(out_dir, ignore_errors=True)
    config = flagship_copy("synth-olpbench-2m47-resume", batch_size_for_backward=ACCUM_STEPS * 4096,
                           resume_filter=["lstm"], experiment_dir=str(out_dir))
    windows, _, _, _, _ = count_windows(config, passes=1)
    start_steps = load_checkpoint_meta(ckpt)["training_steps"]
    with RunStart() as start:
        trainer, launches, wall, capture = run_cli(torch, [str(config), "--resume", ckpt, "--epochs", "3"])
    check(trainer.args.get("resume_filter") == ["lstm"], f"resume: resume_filter {trainer.args.get('resume_filter')}")
    init = flatten_arrays(trainer.model.init(torch.Generator(device="cuda").manual_seed(SEED))["params"], "params")
    with np.load(Path(ckpt) / "arrays.npz") as z:
        loaded = []
        for k, v in start.params.items():
            from_ckpt = "lstm" in k.split("/", 1)[1]
            check(np.array_equal(v, z[k]) == from_ckpt and np.array_equal(v, init[k]) != from_ckpt,
                  f"resume: {k} at the first step is not the {'checkpoint' if from_ckpt else 'seeded init'}")
            loaded += [k] if from_ckpt else []
    L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
    val_batches = len([r for r in trainer.results.to_dicts() if "validation_mrr" in r
                       and r["training_steps"] > start_steps]) * len(trainer.val_builder)
    want = training_launches(launches, L, len(windows) * ACCUM_STEPS, len(windows), sum(1 for w in windows if w),
                             dtype, val_batches=val_batches)
    print(f"resume: {len(loaded)} LSTM leaves from the checkpoint, {len(start.params) - len(loaded)} others the seeded "
          f"init at the first step; {len(trainer.step_log)} micro-batches; launches {launches} (want {want}); "
          f"cli.train {wall:.2f} s")
    check(launches == want, f"resume: launches {launches}, want {want}")
    check_losses("resume", trainer)
    by_path["resume"] = launches
    errs = check_family_kernels(torch, "resume", capture, launches)
    del trainer, capture
    torch.cuda.empty_cache()
    return errs


def phase_objectives(torch, timings, by_path, by_path_f32):
    """Gradient accumulation (``accum``), the KL loss (``kl``, ``kl_eval``),
    the optimizers and schedulers (``optim_a/b/c``) and ``resume_filter``
    (``resume``) through ``cli.train``, each run's launches exact.  Returns
    the largest error of each kernel row its checks held."""
    t0 = time.perf_counter()
    ckpt, errs = phase_accum(torch, timings, by_path)
    fold_errs(errs, phase_resume(torch, timings, by_path, ckpt))
    fold_errs(errs, phase_kl(torch, timings, by_path))
    fold_errs(errs, phase_optim(torch, timings, by_path_f32))
    timings["objectives_s"] = time.perf_counter() - t0
    print(f"objectives phase: {timings['objectives_s']:.1f} s")
    return errs


# ----------------------------------------------------- benchmark creation

CREATE_DATA_DIR = ROOT / ".bench_cache" / "smoke_create_data"
# the full-scale OLPBench creation settings (eval_data_size 10000, min_count
# 3, vocabularies 200000 / 50000, seed 0), of which only work_dir and
# corpus_files are set here
PIPELINE_SETTINGS = ROOT / "configs" / "preprocessing" / "acl2020.yaml"
# The OPIEC-shaped corpus: 500,000 records halved once, the only cut
# (cli.create_data took 250.6 s on an 8-core CPU at 500,000, over the 180 s
# allowed, and 110.9 s at 250,000), in 8 avro files read by 8 workers
CORPUS_RECORDS = 250_000
# The corpus's entity token table (~68,000 rows) is ~4.2x a batch's 16,384
# bucketed touched rows, under the default ratio of 12 (its 200,000-token
# cap is OLPBench's), so at 12 no step would update rows (kernel 4); at 2
# every step updates that table's rows and the relation token table
# (~9,500 rows) stays dense (kernel 3)
CREATE_DATA_SPARSE_RATIO = 2.0
CORPUS_FILES = 8
CORPUS_ENTITIES, CORPUS_UNLINKED, CORPUS_RELATIONS = 50_000, 30_000, 5_000
# OPIEC-Clean's record shape, the fields the corpus extractor reads
# (reference: preprocessing/process_avro.py:16-195)
CORPUS_TOKEN = {"type": "record", "name": "TokenLinked", "fields": [
    {"name": "word", "type": "string"}, {"name": "pos", "type": ["null", "string"]},
    {"name": "index", "type": "long"},
    {"name": "w_link", "type": {"type": "record", "name": "WikiLink",
                                "fields": [{"name": "wiki_link", "type": ["null", "string"]}]}}]}
CORPUS_SCHEMA = {"type": "record", "name": "TripleLinked", "namespace": "de.uni_mannheim.opiec", "fields": [
    {"name": "triple_id", "type": "string"}, {"name": "article_id", "type": "string"},
    {"name": "confidence_score", "type": "double"},
    {"name": "polarity", "type": {"type": "enum", "name": "Polarity", "symbols": ["POSITIVE", "NEGATIVE"]}},
    {"name": "subject", "type": {"type": "array", "items": CORPUS_TOKEN}},
    {"name": "relation", "type": {"type": "array", "items": "TokenLinked"}},
    {"name": "object", "type": {"type": "array", "items": "TokenLinked"}},
    {"name": "dropped_words_subject", "type": {"type": "array", "items": "TokenLinked"}},
    {"name": "dropped_words_relation", "type": {"type": "array", "items": "TokenLinked"}},
    {"name": "dropped_words_object", "type": {"type": "array", "items": "TokenLinked"}},
    {"name": "quantities", "type": {"type": "map", "values": "string"}},
    {"name": "sentence_linked", "type": ["null", {"type": "record", "name": "Sentence", "fields": [
        {"name": "tokens", "type": {"type": "array", "items": "TokenLinked"}}]}]}]}


def zipf_p(n, s):
    """Probabilities of ranks 1..n proportional to rank^-s."""
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def corpus_world(seed):
    """The corpus's vocabulary, from ``seed``: ``CORPUS_ENTITIES`` linked
    entities, each with 1-3 surface forms (a name of 1-3 tokens drawn from
    200,000 name tokens; its last token alone or with one more; a title
    token before it), ``CORPUS_UNLINKED`` unlinked noun phrases (a common
    word, Zipf over 20,000, and a name token) and ``CORPUS_RELATIONS``
    relation phrases of 1-5 tokens (Zipf 0.5 over 20,000 tokens)."""
    rng = np.random.default_rng(seed)
    names = rng.integers(0, 200_000, (CORPUS_ENTITIES, 3))
    n_forms = rng.choice([1, 2, 3], CORPUS_ENTITIES, p=[0.5, 0.3, 0.2])
    name_len = rng.choice([1, 2, 3], CORPUS_ENTITIES, p=[0.3, 0.5, 0.2])
    titles = rng.integers(0, 50, CORPUS_ENTITIES)
    entities = []
    for e in range(CORPUS_ENTITIES):
        name = [f"n{t}" for t in names[e, :name_len[e]]]
        short = name[-1:] if len(name) > 1 else name + [f"n{names[e, 2]}"]
        entities.append([name, short, [f"c{titles[e]}", *name]][:n_forms[e]])
    common = rng.choice(20_000, CORPUS_UNLINKED, p=zipf_p(20_000, 1.0))
    unlinked = [[f"c{c}", f"n{t}"] for c, t in zip(common, rng.integers(0, 200_000, CORPUS_UNLINKED))]
    lens = rng.choice([1, 2, 3, 4, 5], CORPUS_RELATIONS, p=[0.1, 0.2, 0.35, 0.25, 0.1])
    toks = rng.choice(20_000, int(lens.sum()), p=zipf_p(20_000, 0.5))
    relations = [[f"r{t}" for t in p] for p in np.split(toks, np.cumsum(lens)[:-1])]
    return entities, unlinked, relations


def _corpus_part(job):
    """One avro file of the corpus (a worker of ``write_opiec_corpus``):
    ``n`` records drawn from ``seed``.  Each slot is linked with
    probability 0.75 to an entity drawn Zipf-like (0.6) and shows one of
    its forms (the first the most often), else an unlinked phrase (Zipf
    0.6); the relation is drawn Zipf-like (0.6); the confidence is uniform
    in [0.2, 1) and 3 % of records are NEGATIVE (both dropped by the
    extractor's filters)."""
    from open_knowledge_graph_embeddings_tpu_torch.preprocessing import avro

    path, seed, n, (entities, unlinked, relations) = job
    rng = np.random.default_rng(seed)
    linked = rng.random((2, n)) < 0.75
    ents = rng.choice(len(entities), (2, n), p=zipf_p(len(entities), 0.6))
    unl = rng.choice(len(unlinked), (2, n), p=zipf_p(len(unlinked), 0.6))
    form = rng.random((2, n))
    rels = rng.choice(len(relations), n, p=zipf_p(len(relations), 0.6))
    confidence = rng.uniform(0.2, 1.0, n)
    negative = rng.random(n) < 0.03

    def tokens(words, start, pos, link=None):
        return [{"word": w, "pos": pos(i), "index": start + i, "w_link": {"wiki_link": link}}
                for i, w in enumerate(words)]

    def argument(k, i, start):
        if linked[k, i]:
            forms = entities[ents[k, i]]
            words = forms[min(int(form[k, i] ** 2 * len(forms)), len(forms) - 1)]
            return tokens(words, start, lambda j: "NNP", f"Entity_{ents[k, i]}")
        return tokens(unlinked[unl[k, i]], start, lambda j: "NN")

    records = []
    for i in range(n):
        s = argument(0, i, 0)
        r = tokens(relations[rels[i]], len(s), lambda j: "VBZ" if j == 0 else "IN")
        o = argument(1, i, len(s) + len(r))
        records.append({"triple_id": f"{seed}-{i}", "article_id": f"{seed}-{i // 20}",
                        "confidence_score": float(confidence[i]), "polarity": "NEGATIVE" if negative[i] else "POSITIVE",
                        "subject": s, "relation": r, "object": o, "dropped_words_subject": [],
                        "dropped_words_relation": [], "dropped_words_object": [], "quantities": {},
                        "sentence_linked": None})
    with open(path, "wb") as f:
        avro.writer(f, CORPUS_SCHEMA, records, sync_marker=bytes(range(16)))
    return path


def write_opiec_corpus(out_dir, n_records=CORPUS_RECORDS, seed=SEED, n_files=CORPUS_FILES, workers=CORPUS_FILES):
    """An OPIEC-shaped corpus of ``n_records`` records in ``n_files`` avro
    files under ``out_dir``, written by the port's avro writer; the same
    bytes for the same arguments.  Returns the files' paths."""
    import multiprocessing

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    world = corpus_world(seed)
    sizes = [n_records // n_files + (i < n_records % n_files) for i in range(n_files)]
    jobs = [(str(out_dir / f"opiec_part{i}.avro"), seed * 1000 + i + 1, n, world) for i, n in enumerate(sizes)]
    if workers <= 1:
        return [_corpus_part(job) for job in jobs]
    with multiprocessing.get_context("spawn").Pool(min(workers, n_files)) as pool:
        return pool.map(_corpus_part, jobs)


def pipeline_config(work_dir, corpus_files, workers=CORPUS_FILES):
    """``PIPELINE_SETTINGS`` with ``work_dir``, ``corpus_files`` and the
    extraction's ``workers`` set, written beside ``work_dir``."""
    import yaml

    cfg = yaml.safe_load(PIPELINE_SETTINGS.read_text())
    cfg.update(work_dir=str(work_dir), corpus_files=[str(p) for p in corpus_files], workers=workers)
    path = Path(work_dir).parent / "pipeline.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def run_create_data(config):
    """``python -m ...cli.create_data -c CONFIG`` in a subprocess -> (wall
    s, {job: its logged seconds}, {job: logged it ran or it skipped})."""
    import os
    import re

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"{PKG}.cli.create_data", "-c", str(config)], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"cli.create_data exited {res.returncode}: {res.stderr[-3000:]}")
    secs = {m[0]: float(m[1]) for m in re.findall(r"(\w+): done in ([\d.]+)s", res.stderr)}
    state = {m[0]: m[1] for m in re.findall(r"(\w+): (running|all outputs exist, skipping)", res.stderr)}
    return wall, secs, state


def test_pairs_in_thorough(work_dir):
    """(the test split's subject/object mention pairs in either order, with
    every mention alternative, and how many of them a thorough-train triple
    has)."""
    work_dir = Path(work_dir)
    pairs = set()
    with open(work_dir / "test_data.txt", encoding="utf-8") as f:
        for line in f:
            _, _, _, s_alts, o_alts = line.rstrip("\n").split("\t")
            for sa in s_alts.split("|||"):
                for oa in o_alts.split("|||"):
                    pairs |= {(sa, oa), (oa, sa)}
    with open(work_dir / "train_data_thorough.txt", encoding="utf-8") as f:
        met = sum(1 for line in f if tuple(line.split("\t")[0:3:2]) in pairs)
    return len(pairs), met


def line_counts(directory, names):
    out = {}
    for name in names:
        with open(Path(directory) / name, "rb") as f:
            out[name] = sum(1 for _ in f)
    return out


def trace_kernel_names(path):
    """The names of the device kernels in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


# kernel 1's and kernel 2's CUDA functions in bf16, as a trace names them
TRACE_KERNELS = {"lstm_last_fwd": "lstm_last_step_kernel", "lstm_last_bwd": "lstm_bwd_gate_kernel_bf16"}


def cli_predict_lines(torch, config, ckpt, data_dir, queries):
    """``cli.predict`` with ``queries`` on its standard input -> (its
    printed lines split in rank, score, name; wall s)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import predict as cli_predict

    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(queries) + "\n")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli_predict.main([str(config), "--resume", str(ckpt), "--dataset_dir", str(data_dir), "-k", "10",
                              "--device", "cuda"])
    finally:
        sys.stdin = stdin
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check("!!" not in err.getvalue(), f"cli.predict rejected a query: {err.getvalue()[-500:]}")
    lines = [ln.split(None, 2) for ln in out.getvalue().splitlines() if ln.strip()]
    check(len(lines) == 10 * len(queries), f"cli.predict printed {len(lines)} lines for {len(queries)} queries")
    for qi in range(len(queries)):
        s = np.array([float(x[1]) for x in lines[qi * 10: (qi + 1) * 10]])
        check(np.isfinite(s).all() and (np.diff(s) <= 0).all(), f"cli.predict scores not sorted: {s}")
    return lines, wall


def text_queries(data_dir):
    """4 queries of surface forms from the id maps: two of each direction."""
    ents = first_names(Path(data_dir) / "entity_id_map.txt", 2, skip=10)
    rels = first_names(Path(data_dir) / "relation_id_map.txt", 2, skip=5)
    return [f"{ents[0]}|{rels[0]}|?", f"{ents[1]}|{rels[1]}|?", f"?|{rels[0]}|{ents[1]}", f"?|{rels[1]}|{ents[0]}"]


def predict_with_counts(torch, config, ckpt, data_dir, tag):
    """``cli.predict`` of 4 text queries with the launch counts set to 0
    just before and read just after and held exactly: the candidate cache
    in fused chunks of 32768 (kernel 1), each query's two encodes at B = 1
    unfused (kernel 7) -> (lines, launches)."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta

    queries = text_queries(data_dir)
    args = load_config(str(config), ["--dataset_dir", str(data_dir)])
    meta = load_meta(str(data_dir), tuple(args["experiment_settings"]["max_lengths_tuple"]))
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    lines, wall = cli_predict_lines(torch, config, ckpt, data_dir, queries)
    launches = {name: fn.launches for name, fn in counters.items()}
    L = meta.max_length[0]
    n_chunks = -(-meta.entities_size // 32768)
    want = serving_launches(counters, L, n_chunks, 2 * len(queries), args["model_config"].get("dtype", "float32"))
    print(f"{tag} cli.predict: {len(queries)} text queries in {wall:.2f} s; launches {launches} (want {want}: "
          f"{n_chunks} cache chunks fused, 2 unfused encodes at B = 1 a query); first answer: "
          f"{' '.join(lines[0])}")
    check(launches == want, f"{tag} cli.predict launches {launches}, want {want}")
    return lines, launches


def phase_create_data(torch, timings, by_path):
    """The OLPBench creation pipeline of the port, then its output trained,
    evaluated and served on the card: an OPIEC-shaped corpus
    (``write_opiec_corpus``), ``cli.create_data -c`` under acl2020's
    settings in a subprocess (each job's seconds, each split's lines; no
    thorough-train pair meets a test pair, every mapped_to_ids file there,
    a second run skips every job); then on
    ``mapped_to_ids/train_data_thorough.txt`` the flagship's widths
    through ``cli.train`` (two passes, ``sparse_min_ratio``
    ``CREATE_DATA_SPARSE_RATIO``, ``profile_steps: 2``: the trace
    under the experiment's ``profile/`` must name kernel 1's and kernel 2's
    CUDA functions), ``--evaluate`` on the test split and ``cli.predict``
    of 4 text queries, each with exact launches, the training run's
    recorded launches against their plain versions
    (``check_family_kernels``).  Returns the largest error by kernel row."""
    from open_knowledge_graph_embeddings_tpu_torch.preprocessing.jobs import ALL_JOBS, CreateTrainingData, MapToIds

    t_phase = time.perf_counter()
    shutil.rmtree(CREATE_DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    files = write_opiec_corpus(CREATE_DATA_DIR / "corpus", CORPUS_RECORDS)
    timings["corpus_gen_s"] = time.perf_counter() - t0
    size = sum(Path(p).stat().st_size for p in files)
    print(f"create_data: an OPIEC-shaped corpus of {CORPUS_RECORDS} records in {len(files)} avro files "
          f"({size / 2 ** 20:.1f} MiB; {CORPUS_ENTITIES} entities, {CORPUS_RELATIONS} relation phrases) in "
          f"{timings['corpus_gen_s']:.1f} s")
    work = CREATE_DATA_DIR / "work"
    config = pipeline_config(work, files)
    wall, secs, state = run_create_data(config)
    jobs = [job.__name__ for job in ALL_JOBS]
    check(set(secs) == set(jobs) and all(state[j] == "running" for j in jobs), f"create_data ran {state}")
    timings["create_data_s"] = wall
    timings["create_data_jobs_s"] = secs
    print(f"create_data: cli.create_data -c {config.name} {wall:.1f} s; jobs (s): "
          + ", ".join(f"{j} {secs[j]:.1f}" for j in jobs))
    mapped = work / "mapped_to_ids"
    opts = {"work_dir": str(work)}
    splits = [Path(p).name for p in CreateTrainingData(opts=opts).provides]
    provided = [Path(p) for p in MapToIds(opts=opts).provides]
    texts, ids = line_counts(work, splits), line_counts(mapped, [p.name for p in provided if p.name in splits])
    print("create_data: lines of each split (text / mapped_to_ids): "
          + ", ".join(f"{n} {texts[n]}/{ids.get(n, '-')}" for n in splits))
    check(all(texts[n] > 0 for n in splits), f"an empty split: {texts}")
    n_pairs, met = test_pairs_in_thorough(work)
    print(f"create_data: {n_pairs} test mention pairs, {met} of them in train_data_thorough.txt")
    check(n_pairs > 0 and met == 0, f"{met} thorough-train triples meet a test pair")
    maps = [mapped / f"{k}_{m}.txt" for k in ("entity", "relation") for m in ("id_map", "token_id_map",
                                                                          "id_tokens_ids_map")]
    missing = [str(p) for p in [*provided, *maps] if not p.exists()]
    check(not missing, f"mapped_to_ids files missing: {missing}")
    wall2, secs2, state2 = run_create_data(config)
    check(not secs2 and set(state2) == set(jobs) and all(v != "running" for v in state2.values()),
          f"the second run did not skip every job: {state2}")
    print(f"create_data: a second run skipped all {len(jobs)} jobs ({wall2:.1f} s)")

    out_dir = CREATE_DATA_DIR / "train"
    train_cfg = write_config("synth-olpbench-create-data", FLAGSHIP, {
        "dataset_dir": str(mapped), "eval_epoch_freq": 0, "save_epoch_freq": 0, "profile_steps": 2,
        "sparse_min_ratio": CREATE_DATA_SPARSE_RATIO, "experiment_dir": str(out_dir)}, data={"train_data_config": {"input_file": "train_data_thorough.txt"},
                                               "val_data_config": {"input_file": "validation_data_linked.txt"},
                                               "test_data_config": {"input_file": "test_data.txt"}})
    trainer, launches, wall, capture = run_cli(torch, [str(train_cfg), "--epochs", "2"])
    log = trainer.step_log
    L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
    check(len(log) == 2 * len(trainer.train_builder), f"create_data: {len(log)} steps")
    steps = counted_steps(log)
    want = training_launches(launches, L, len(steps), len(steps), sum(1 for s in steps if s["sparse_tables"]), dtype)
    print(f"create_data cli.train: {len(trainer.train_dataset)} prefixes, {len(log)} steps (two passes) in "
          f"{wall:.1f} s; launches {launches} (want {want})")
    check(launches == want, f"create_data training launches {launches}, want {want}")
    check(all(launches[k] for k in ("lstm_last_fwd", "lstm_last_bwd", "adagrad_update", "scatter_adagrad")),
          f"create_data: a training kernel was never launched: {launches}")
    first, last = check_losses("create_data", trainer)
    print(f"create_data: loss first {first:.5f} -> last {last:.5f}")
    timings["create_data_cli_train_s"] = wall
    total = Counter(launches)
    errs = check_family_kernels(torch, "create_data", capture, launches)
    del capture
    trace = out_dir / "profile" / "trace.json"
    check(trainer.profile_trace == str(trace) and trace.exists(), f"no profiler trace at {trace}")
    names = trace_kernel_names(trace)
    found = {row: sorted({n for n in names if fn in n})[:1] for row, fn in TRACE_KERNELS.items()}
    print(f"create_data: profile_steps 2 wrote {trace} ({trace.stat().st_size / 2 ** 20:.1f} MiB, "
          f"{len(names)} kernel names; kernel 1 {found['lstm_last_fwd']}, kernel 2 {found['lstm_last_bwd']})")
    check(all(found.values()), f"the trace names no {[TRACE_KERNELS[r] for r, f in found.items() if not f]}")
    ckpt = trainer.last_checkpoint
    del trainer

    etrainer, cap, elaunches, row, ewall = run_evaluate(torch, train_cfg, ckpt, CREATE_DATA_DIR / "eval_test", False,
                                                        data_dir=mapped)
    meta = etrainer.model.meta
    want = eval_launches(elaunches, L, dtype, cache_chunks=-(-meta.entities_size // 32768),
                         test_batches=len(etrainer.val_builder))
    print(f"create_data test eval ({meta.entities_size} candidates): launches {elaunches} (want {want}), "
          f"cli.train --evaluate {ewall:.2f} s")
    check(elaunches == want and want["lstm_last_fwd"] > 0, f"create_data test launches {elaunches}, want {want}")
    check_eval_metrics("create_data test", row, cap.chunked or cap.dense,
                       int(etrainer.validation_dataset.records.group_offsets[-1]))
    timings["create_data_eval_test_s"] = ewall
    total.update(elaunches)
    del etrainer, cap
    _, plaunches = predict_with_counts(torch, train_cfg, ckpt, mapped, "create_data")
    total.update(plaunches)
    by_path["create_data"] = dict(total)
    timings["create_data_phase_s"] = time.perf_counter() - t_phase
    print(f"create_data phase: {timings['create_data_phase_s']:.1f} s")
    torch.cuda.empty_cache()
    return errs


def split_checkpoint(src, dst, ranks=2):
    """The single-file checkpoint ``src`` as ``ranks`` rank slabs in the
    per-shard layout of the JAX package (``train/checkpoint.py:14-24``,
    ``write_shard_slab`` :191-195): every leaf with at least ``ranks`` rows
    cut along axis 0 into one chunk per rank, entries numbered per rank (so
    every slab holds ``key::0``), the others whole in rank 0's slab;
    ``arrays.p{rank}.npz`` and ``index.p{rank}.json`` per rank, then
    ``meta.json`` last."""
    src, dst = Path(src), Path(dst)
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    slabs = [({}, {}) for _ in range(ranks)]
    with np.load(src / "arrays.npz") as z:
        for key in z.files:
            arr = z[key]
            if arr.ndim and arr.shape[0] >= ranks:
                cuts = [arr.shape[0] * r // ranks for r in range(ranks + 1)]
                parts = [(r, cuts[r], cuts[r + 1]) for r in range(ranks)]
            else:
                parts = [(0, 0, arr.shape[0] if arr.ndim else None)]
            for rank, a, b in parts:
                chunks, index = slabs[rank]
                entry = f"{key}::0"
                chunks[entry] = arr[a:b] if arr.ndim else arr
                stop = [b, *arr.shape[1:]] if arr.ndim else []
                index[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                              "chunks": [{"entry": entry, "start": [a] + [0] * (arr.ndim - 1) if arr.ndim else [],
                                          "stop": stop}]}
    for rank, (chunks, index) in enumerate(slabs):
        np.savez(dst / f"arrays.p{rank}.npz", **chunks)
        with open(dst / f"index.p{rank}.json", "w") as f:
            json.dump(index, f)
    shutil.copy(src / "meta.json", dst / "meta.json")
    return str(dst)


def phase_shard_ckpt(torch, timings, by_path, ckpt):
    """The bf16 flagship checkpoint ``ckpt`` cut into two rank slabs
    (``split_checkpoint``) against itself: ``cli.train --evaluate`` on the
    full-vocabulary test split exactly equal (MRR, MR, hits and loss),
    ``cli.predict`` the same lines, and ``Trainer.load`` (``cli.train
    --resume`` with ``train: false``) every parameter, batch-norm and
    Adagrad leaf bit-equal; every run's launches exact."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    t_phase = time.perf_counter()
    shard_dir = split_checkpoint(ckpt, ROOT / ".bench_cache" / "smoke_shard_ckpt")
    with open(Path(shard_dir) / "index.p1.json") as f:
        split_keys = len(json.load(f))
    check(not (Path(shard_dir) / "arrays.npz").exists(), "the slab directory holds arrays.npz")
    print(f"shard_ckpt: {Path(ckpt).name} cut into 2 rank slabs ({split_keys} leaves split along axis 0)")
    total = Counter()
    rows, lines, loaded = {}, {}, {}
    for name, path in (("original", ckpt), ("slabs", shard_dir)):
        trainer, cap, launches, row, wall = run_evaluate(torch, FLAGSHIP, path,
                                                         ROOT / ".bench_cache" / f"smoke_shard_eval_{name}", False)
        meta = trainer.model.meta
        L, dtype = meta.max_length[0], trainer.model.embedder.dtype
        want = eval_launches(launches, L, dtype, cache_chunks=-(-meta.entities_size // 32768),
                             test_batches=len(trainer.val_builder))
        check(launches == want, f"shard_ckpt {name} eval launches {launches}, want {want}")
        rows[name] = check_eval_metrics(f"shard_ckpt {name} test", row, cap.chunked or cap.dense,
                                        int(trainer.validation_dataset.records.group_offsets[-1]))
        timings[f"shard_ckpt_eval_{name}_s"] = wall
        del trainer, cap
        lines[name], plaunches = predict_with_counts(torch, FLAGSHIP, path, DATA_DIR, f"shard_ckpt {name}")
        if name == "slabs":
            total.update(launches)
            total.update(plaunches)
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = cli_train.cli_main([str(FLAGSHIP), "--dataset_dir", str(DATA_DIR), "--resume", str(path),
                                      "--train", "False", "--experiment_dir",
                                      str(ROOT / ".bench_cache" / f"smoke_shard_load_{name}"), "--device", "cuda"])
        timings[f"shard_ckpt_load_{name}_s"] = time.perf_counter() - t0
        check(all(fn.launches == 0 for fn in counters.values()), "Trainer.load launched a kernel")
        loaded[name] = {**{f"params/{k}": v for k, v in leaves(trainer.variables["params"])},
                        **{f"state/{k}": v for k, v in leaves(trainer.variables["state"])},
                        **{f"opt/{k}": v for k, v in leaves(trainer.opt_state)}, "steps": trainer.training_steps}
        del trainer
    check(rows["slabs"] == rows["original"], f"shard_ckpt: the slabs evaluate to {rows['slabs']}, the original to "
          f"{rows['original']}")
    print(f"shard_ckpt: --evaluate on the slabs equals the original exactly: {rows['slabs']}")
    check(lines["slabs"] == lines["original"], "shard_ckpt: cli.predict answers differ between slabs and original")
    print(f"shard_ckpt: cli.predict printed the same {len(lines['slabs'])} lines (ids, scores) from both")
    a, b = loaded["original"], loaded["slabs"]
    check(set(a) == set(b) and a["steps"] == b["steps"], "shard_ckpt: Trainer.load restored other leaves or steps")
    unequal = [k for k in a if k != "steps" and not torch.equal(a[k], b[k])]
    check(not unequal, f"shard_ckpt: Trainer.load leaves not bit-equal: {unequal}")
    n_opt = sum(1 for k in a if k.startswith("opt/"))
    print(f"shard_ckpt: Trainer.load from the slabs: {len(a) - 1} leaves ({n_opt} Adagrad) bit-equal to the "
          f"arrays.npz load, training_steps {a['steps']}")
    del loaded, a, b
    by_path["shard_ckpt"] = dict(total)
    timings["shard_ckpt_phase_s"] = time.perf_counter() - t_phase
    print(f"shard_ckpt phase: {timings['shard_ckpt_phase_s']:.1f} s")
    torch.cuda.empty_cache()


# ------------------------------------------------- the native host helpers

NATIVE_PLAN_BATCHES = 4


def median_ms(fn, n):
    """Median host ms of ``n`` calls of ``fn``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


@contextlib.contextmanager
def native_off():
    """``OKET_DISABLE_NATIVE=1`` in this process while the block runs (the
    host helpers read it at every call)."""
    import os

    os.environ["OKET_DISABLE_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("OKET_DISABLE_NATIVE", None)


def phase_native(torch, timings, host_wait_ms):
    """The C++ host helpers (``native/``) on the card's host: the library
    builds and loads (fail if not); on flagship batches of the 2.47M set the
    plans (unique-and-remap, gather-sum, dedup) equal the numpy branch's
    array for array, timed both ways on one thread; the reader equals the
    python reader on the train file, timed both ways; beside the flagship
    training run's host wait per step (``Trainer.step_log``, the native
    branch)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import read_triple_file
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.native import loader, native_available
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder

    t0 = time.perf_counter()
    check(native_available(), f"native: {loader.library_path()} did not build or load on the card's host")
    timings["native_build_s"] = time.perf_counter() - t0
    print(f"native: {loader.library_path().name} loaded ({timings['native_build_s']:.2f} s, g++ "
          f"{' '.join(loader.CXX_FLAGS)})")
    args = load_config(str(FLAGSHIP), ["--dataset_dir", str(DATA_DIR)])
    ds = setup_dataset(args)
    model = build_model(args["model"], ds.meta, **args["model_config"])
    plan = SparsePlanBuilder(model.embedder, True, min_rows_ratio=float(args.get("sparse_min_ratio", 12.0)))
    builder = BatchBuilder(ds, seed=SEED)
    order = np.random.default_rng(SEED + 2).permutation(len(builder.rec))
    batches = [builder.build(order[i * builder.batch_size : (i + 1) * builder.batch_size])
               for i in range(NATIVE_PLAN_BATCHES)]
    check(plan.plan_path == "native", "native: the plan builder takes the numpy branch")
    ms_native = [median_ms(lambda b=b: plan(b), 3) for b in batches]
    got = [plan(b) for b in batches]
    with native_off():
        check(plan.plan_path == "numpy", "native: OKET_DISABLE_NATIVE did not select the numpy branch")
        ms_numpy = [median_ms(lambda b=b: plan(b), 3) for b in batches]
        want = [plan(b) for b in batches]
    for i, (g, w) in enumerate(zip(got, want)):
        check(set(g) == set(w), f"native: batch {i} plan keys differ: {sorted(set(g) ^ set(w))}")
        bad = [k for k in w if not np.array_equal(g[k], w[k])]
        check(not bad, f"native: batch {i}: native and numpy plans differ in {bad}")
    plans = sorted(k for k in got[0] if k.startswith("sparse/plan/"))
    timings["native_plan_ms_per_batch"] = float(np.median(ms_native))
    timings["numpy_plan_ms_per_batch"] = float(np.median(ms_numpy))
    print(f"native: {NATIVE_PLAN_BATCHES} flagship batches (4096 x 4096): plans equal array for array to the numpy "
          f"branch ({len(got[0])} arrays, {plans}); SparsePlanBuilder median {timings['native_plan_ms_per_batch']:.3f} "
          f"ms/batch native, {timings['numpy_plan_ms_per_batch']:.3f} numpy (one thread, median of 3 per batch)")
    path = str(DATA_DIR / "train.txt")
    t0 = time.perf_counter()
    g = read_triple_file(path)
    timings["native_read_s"] = time.perf_counter() - t0
    with native_off():
        t0 = time.perf_counter()
        w = read_triple_file(path)
        timings["python_read_s"] = time.perf_counter() - t0
    check(all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(g, w)),
          "native: the native reader differs from the python reader")
    timings["train_host_wait_ms_per_step"] = host_wait_ms
    print(f"native: read_triple_file on train.txt ({len(g[0])} triples): native {timings['native_read_s']:.3f} s, "
          f"python {timings['python_read_s']:.3f} s, equal; the flagship cli.train's host wait per step (step_log, "
          f"native plans on {int(args.get('workers', 8))} prefetch threads): median "
          f"{host_wait_ms['median']:.3f} ms, max {host_wait_ms['max']:.3f}")


# ------------------------------------------------ data parallelism (ranks)

DP_HEAD_TRIPLES = 20000
DP_TIMEOUT_S = 600
#: the script each rank of ``run_ranks`` runs (``--dp-rank``): this one
RANK_SCRIPT = Path(__file__).resolve()


def dp_head_file():
    """``train_dp_head.txt`` beside the flagship smoke split: its first
    ``DP_HEAD_TRIPLES`` triples (a few steps a pass)."""
    with open(DATA_DIR / "train.txt") as f:
        head = [line for _, line in zip(range(DP_HEAD_TRIPLES), f)]
    (DATA_DIR / "train_dp_head.txt").write_text("".join(head))
    return "train_dp_head.txt"


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


#: the rendezvous ports ``start_ranks`` gave out
PORTS_GIVEN = set()


def note_exit(proc, ends):
    proc.wait()
    ends.append(time.perf_counter())


def start_ranks(tag, config, world, extra=(), mode="--dp-rank"):
    """Start ``run_ranks``' processes -> the job ``run_side_by_side`` waits
    for."""
    out = ROOT / ".bench_cache" / f"smoke_dp_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    import threading

    job = {"tag": tag, "out": out, "world": world, "procs": [], "t0": time.perf_counter(), "end": None, "ends": []}
    port = free_port()
    while port in PORTS_GIVEN:  # jobs run side by side: each its own rendezvous
        port = free_port()
    PORTS_GIVEN.add(port)
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        cli = ["--experiment_dir", str(out / "exp")] if mode == "--dp-rank" else []
        cmd = [sys.executable, str(RANK_SCRIPT), mode, str(r), str(world), str(port),
               str(out / f"rank{r}.json"), str(config), *cli, *extra]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
        job["procs"].append((proc, log))
        # the exit time, whatever this process is doing then (``run_side_by_side``'s beside)
        threading.Thread(target=note_exit, args=(proc, job["ends"]), daemon=True).start()
    return job


def run_side_by_side(specs, beside=None):
    """The runs of ``specs`` (each the arguments of ``start_ranks``) at
    once, sharing the card, with ``beside()`` run in this process
    meanwhile; a rank that fails ends every run (its peers would wait in a
    collective) -> (each run's (rank results, seconds from spawn to exit),
    what ``beside`` returned)."""
    jobs = []
    try:
        for spec in specs:
            jobs.append(start_ranks(*spec))
        got = beside() if beside is not None else None
        while True:
            now = time.perf_counter()
            for job in jobs:
                if job["end"] is None and len(job["ends"]) == job["world"]:
                    job["end"] = max(job["ends"])
            running = [job for job in jobs if job["end"] is None]
            failed = any(p.poll() not in (None, 0) for job in jobs for p, _ in job["procs"])
            if not running or failed or any(now - job["t0"] > DP_TIMEOUT_S for job in running):
                break
            time.sleep(0.2)
    finally:
        killed = set()
        for job in jobs:
            for p, log in job["procs"]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                    killed.add(p)
                log.close()
    ranks = [(job["tag"], r, p, Path(log.name).read_text()) for job in jobs for r, (p, log) in enumerate(job["procs"])]
    for tag, r, p, text in ranks:
        for line in text.splitlines():
            if line.startswith(f"dp rank {r}"):
                print(line)
    # a rank that failed by itself first, then those stopped for it
    for tag, r, p, text in sorted(ranks, key=lambda x: x[2] in killed):
        check(p.returncode == 0, f"dp {tag}: rank {r} exited {p.returncode}:\n{text[-3000:]}")
    out = []
    for job in jobs:
        tag, world = job["tag"], job["world"]
        results = [json.loads((job["out"] / f"rank{r}.json").read_text()) for r in range(world)]
        for r in results:
            check(r["launches"] == r["want"], f"dp {tag} rank {r['rank']}: launches {r['launches']}, want {r['want']}")
        if "all_gather_on_cuda" in results[0]:
            print(f"dp {tag}: {results[0]['backend']} all_gather on CUDA tensors: {results[0]['all_gather_on_cuda']}")
        wall = (job["end"] or time.perf_counter()) - job["t0"]
        beside_note = f", beside {len(jobs) - 1} other run(s)" if len(jobs) > 1 else ""
        print(f"dp {tag}: {world} rank(s), {wall:.1f} s from spawn to exit{beside_note}")
        out.append((results, wall))
    return out, got


def run_ranks(tag, config, world, extra=(), mode="--dp-rank"):
    """``cli.train`` on ``config`` with ``world`` ranks (or with ``mode``
    ``--mp-shard-map`` one step of ``shard_map_score``'s), each a process of
    this script on the card, its output in a file (a full pipe would block a
    rank inside a collective) -> (each rank's result, seconds)."""
    return run_side_by_side([(tag, config, world, extra, mode)])[0][0]


def leaf_fingerprints(torch, trees):
    """One int64 per leaf: the sum of its bits read as integers (equal bits,
    equal sums), on the device."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import tensors_of

    views = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return torch.stack([t.detach().reshape(-1).view(views[t.element_size()]).to(torch.int64).sum()
                        for t in tensors_of(trees)])


def dp_launches(names, trainer, val_batches):
    """The launches a rank of a data-parallel ``cli.train`` run must count:
    per step the candidate, query-entity and relation LSTM blocks of the
    mesh branch (kernels 1 and 2 fused at every block of the flagship,
    B % 8 == 0), or nothing for lookup models; one dense Adagrad launch a
    step and one row update a step with a row-sparse table; the evals'
    kernel 1 launches over this rank's slice (``eval_launches``)."""
    from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder

    log = trainer.step_log
    want = {name: 0 for name in names}
    if isinstance(trainer.model.embedder, LSTMEmbedder):
        L, dtype = trainer.model.meta.max_length[0], trainer.model.embedder.dtype
        want = eval_launches(names, L, dtype, val_batches=val_batches)
        want["lstm_last_fwd"] += 3 * len(log) * forward_launches(L, dtype)
        want["lstm_last_bwd"] = 3 * len(log) * backward_launches(L, dtype)
    want["adagrad_update"] = len(log)
    want["scatter_adagrad"] = sum(1 for s in log if s["sparse_tables"])
    return want


def mp_launches(names, trainer, val_batches, evaluate=False):
    """The launches a rank of a model-axis ``cli.train`` run must count: per
    step the candidate block and the query-entity and relation passes
    (kernels 1 and 2, fused), one dense Adagrad launch a step and one row
    update a step with a row-sparse table; per batch-shared validation batch
    three kernel 1 passes (the candidate block, then the queries: no pair
    encode on a mesh).  With ``evaluate`` (a ``--evaluate`` run on the test
    split) the cache chunks of this rank's slab and two passes a batch."""
    from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_bounds

    log = trainer.step_log
    want = {name: 0 for name in names}
    if isinstance(trainer.model.embedder, LSTMEmbedder):
        meta = trainer.model.meta
        L, dtype = meta.max_length[0], trainer.model.embedder.dtype
        chunks = test = 0
        if evaluate:
            lo, hi = slab_bounds(meta.entities_size, trainer.mesh.model, trainer.mesh.index("model"))
            chunks, test = -(-(hi - lo) // 32768), len(trainer.val_builder)
        want = eval_launches(names, L, dtype, cache_chunks=chunks, test_batches=test)
        want["lstm_last_fwd"] += 3 * (len(log) + val_batches) * forward_launches(L, dtype)
        want["lstm_last_bwd"] = 3 * len(log) * backward_launches(L, dtype)
    want["adagrad_update"] = len(log)
    want["scatter_adagrad"] = sum(1 for s in log if s["sparse_tables"])
    return want


def replicated_trees(trainer, variables, opt_state):
    """The trees of a rank's replicated leaves: every leaf but the slabs of a
    model axis (and their optimizer state)."""
    slabs = variables.get("slabs") or {}
    return [{k: v for k, v in variables["params"].items() if k not in slabs}, variables["state"],
            {k: v for k, v in opt_state.items() if k not in slabs}]


def dp_rank_main(torch, argv):
    """One rank of ``run_ranks``: join the world through the ``OKET_*``
    variables, run ``cli.train`` on the card with the counts set to 0 just
    before and read just after, each step timed and its replicated leaves
    fingerprinted, the collectives timed (synchronized); hold the rank's
    recorded kernel launches to their plain versions; write the result as
    JSON, the first step's gradients (``.grads.npz``, ``.rows.npz``) and
    the ranks of every full-vocabulary batch (``.ranks.npz``)."""
    import os

    rank, world, port, result = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3])
    cli_args = argv[4:]
    os.environ.update(OKET_COORDINATOR=f"localhost:{port}", OKET_NUM_PROCESSES=str(world),
                      OKET_PROCESS_ID=str(rank))
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train
    from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist
    from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer

    rec = {"step_ms": [], "fingerprints": [], "collective_s": []}
    rebuild = Trainer._rebuild_steps

    def rebuilt(self):
        rebuild(self)
        step = self.train_step

        def timed(variables, opt_state, hparams, arrays, generator=None):
            torch.cuda.synchronize()
            c0, t0 = rec["collective_total_s"], time.perf_counter()
            out = step(variables, opt_state, hparams, arrays, generator)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["collective_s"].append(rec["collective_total_s"] - c0)
            rec["fingerprints"].append(leaf_fingerprints(torch, replicated_trees(self, out[0], out[1])))
            return out

        self.train_step = timed

    Trainer._rebuild_steps = rebuilt
    all_reduce = dist._all_reduce

    def timed_all_reduce(t, *args, **kw):  # every collective of the port, synchronized and timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_reduce(t, *args, **kw)
        torch.cuda.synchronize()
        rec["collective_total_s"] += time.perf_counter() - t0
        return out

    rec["collective_total_s"] = 0.0
    dist._all_reduce = timed_all_reduce
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Capture() as capture, EvalCapture() as ecap:
        trainer = cli_train.cli_main(["--device", "cuda", *cli_args])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    evaluate = "--evaluate" in cli_args
    # an eval run's results rows are the resumed checkpoint's: it ran no validation
    val_batches = 0 if evaluate else len(rows) * len(trainer.val_builder)
    if trainer.mesh is not None and trainer.mesh.model > 1:
        want = mp_launches(launches, trainer, val_batches, evaluate)
    elif evaluate:
        meta = trainer.model.meta
        want = eval_launches(launches, meta.max_length[0], trainer.model.embedder.dtype,
                             cache_chunks=-(-meta.entities_size // 32768), test_batches=len(trainer.val_builder))
    else:
        want = dp_launches(launches, trainer, val_batches)
    tag = f"dp rank {rank}"
    # an eval run records no kernel (Capture takes the training launches);
    # its ranks are held to a world of one's instead
    errs = check_family_kernels(torch, tag, capture, launches) if any(launches.values()) and not evaluate else {}
    losses = [float(s["loss"]) for s in trainer.step_log]
    # which collectives this torch's backend takes on CUDA tensors (the port
    # routes every one through all_reduce and broadcast)
    import torch.distributed as tdist

    probe = torch.ones(1, device=trainer.device)
    try:
        tdist.all_gather([torch.empty_like(probe) for _ in range(world)], probe)
        all_gather = "accepted"
    except (RuntimeError, ValueError) as e:
        all_gather = f"refused: {str(e).splitlines()[0][:120]}"
    out = {"rank": rank, "all_gather_on_cuda": all_gather, "world": world, "backend": dist.backend(), "device": str(trainer.device),
           "steps": len(trainer.step_log), "launches": launches, "want": want, "errs": errs, "losses": losses,
           "step_ms": rec["step_ms"], "collective_ms": [s * 1e3 for s in rec["collective_s"]],
           "fingerprints": [f.cpu().tolist() for f in rec["fingerprints"]], "peak_gib": peak_gib, "wall_s": wall,
           "wait_ms": [s["wait_ms"] for s in trainer.step_log], "rows": rows, "eval_batches": len(trainer.val_builder),
           "host_shard": list(trainer.val_builder.host_shard or ()), "checkpoint": trainer.last_checkpoint,
           "last_eval": trainer.last_eval, "plan_path": trainer._sparse_plan.plan_path if trainer.sparse else None,
           "save_path": trainer.save_path, "mesh": None if trainer.mesh is None else [trainer.mesh.data,
                                                                                     trainer.mesh.model],
           "slabs": {k: list(v) for k, v in (trainer.variables.get("slabs") or {}).items()},
           "entities": trainer.model.meta.entities_size,
           "eval_ranked": [int(r["gold_valid"].sum()) for r in ecap.chunked]}
    result.write_text(json.dumps(out))
    if capture.dense is not None:  # the first step's gradients, summed over the ranks, as kernel 3 took them
        np.savez(result.with_suffix(".grads.npz"), *[g.float().cpu().numpy() for g in capture.dense[0]])
    if capture.rows is not None:  # and the row gradients of the row update (kernel 4)
        np.savez(result.with_suffix(".rows.npz"), *[g.float().cpu().numpy() for g in capture.rows[0]])
    if ecap.chunked:  # every full-vocabulary batch's ranks of its valid golds, in batch order
        np.savez(result.with_suffix(".ranks.npz"), *[r["ranks"][r["gold_valid"]].cpu().numpy() for r in ecap.chunked])
    print(f"{tag}: {out['backend']} on {out['device']}, {out['steps']} steps, median {np.median(rec['step_ms']):.3f} "
          f"ms/step (collectives synchronized and timed: median {np.median(out['collective_ms']):.3f} ms/step), "
          f"peak {peak_gib:.2f} GiB, launches {launches} (want {want})")
    dist.barrier()
    dist.destroy()
    return 0


def sms_rank_main(torch, argv):
    """One rank of ``run_ranks(..., mode="--mp-shard-map")``: join the world
    (more than one rank) and take one step of ``shard_map_score``'s lookup
    step on the config's model and first training batch, random weights
    from ``SEED``, on a 1 x world mesh, with the counts set to 0 just before
    and read just after; write the loss, the launches and the gradients that
    kernel 3 took (``.grads.npz``)."""
    import os

    rank, world, port, result, config = int(argv[0]), int(argv[1]), int(argv[2]), Path(argv[3]), argv[4]
    os.environ.update(OKET_COORDINATOR=f"localhost:{port}", OKET_NUM_PROCESSES=str(world),
                      OKET_PROCESS_ID=str(rank))
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import setup_dataset
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import make_mesh
    from open_knowledge_graph_embeddings_tpu_torch.parallel.shard_map_score import make_sharded_lookup_train_step
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
    from open_knowledge_graph_embeddings_tpu_torch.train.step import train_batch_to_arrays

    if world > 1:
        dist.maybe_initialize_distributed(None, "cuda")
    device = dist.rank_device("cuda")
    args = load_config(config, [])
    ds = setup_dataset(args)
    model = build_model(args["model"], ds.meta, **dict(args.get("model_config") or {}))
    variables = model.init(torch.Generator(device=device).manual_seed(SEED))
    batch = train_batch_to_arrays(next(iter(BatchBuilder(ds, seed=SEED).batches(shuffle=True))))
    regimes = OptimizerRegimes(args["optimization_config"])
    regimes.update(1, 0)
    mesh = make_mesh(data=1, model=world, rank=rank)
    step, prepare, prepare_batch = make_sharded_lookup_train_step(model, mesh)
    params, opt = prepare(variables)
    local = prepare_batch(batch)
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Capture() as capture:
        params, opt, loss = step(params, opt, regimes.hparams()[0], local)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: int(name == "adagrad_update") for name in launches}
    errs = check_family_kernels(torch, f"mp shard_map rank {rank}", capture, launches)
    np.savez(result.with_suffix(".grads.npz"), *[g.float().cpu().numpy() for g in capture.dense[0]])
    out = {"rank": rank, "world": world, "backend": dist.backend(), "loss": float(loss), "launches": launches,
           "want": want, "errs": errs, "step_ms": step_ms, "rows": int(params["entity_embedding"].shape[0]),
           "batch_rows": int(len(batch["ent_ids"]))}
    result.write_text(json.dumps(out))
    print(f"dp rank {rank}: shard_map_score step, world {world} ({out['backend']}), {out['rows']} table rows a rank, "
          f"{step_ms:.3f} ms (cold), loss {out['loss']:.6f}, launches {launches}")
    if world > 1:
        dist.barrier()
        dist.destroy()
    return 0


def check_replicas(tag, results):
    """The ranks' replicated params, batchnorm state and optimizer state
    bit-equal after every step (their fingerprints; a model axis's slabs
    are not replicas), the same losses."""
    steps = {r["steps"] for r in results}
    check(len(steps) == 1, f"dp {tag}: ranks ran {steps} steps")
    for r in results[1:]:
        diff = [i for i, (a, b) in enumerate(zip(results[0]["fingerprints"], r["fingerprints"])) if a != b]
        check(not diff, f"dp {tag}: rank {r['rank']}'s replica differs from rank 0's after steps {diff[:5]}")
        check(r["losses"] == results[0]["losses"], f"dp {tag}: rank {r['rank']} logged other losses")
    print(f"dp {tag}: params, batchnorm state and optimizer state bit-equal on every rank after each of the "
          f"{results[0]['steps']} steps ({len(results[0]['fingerprints'][0])} leaves fingerprinted)")


def merge_checkpoint(src, dst):
    """The per-shard checkpoint ``src`` as one ``arrays.npz`` (the same params
    saved the single-file way)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import open_checkpoint_reader

    src, dst = Path(src), Path(dst)
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    reader = open_checkpoint_reader(str(src))
    np.savez(dst / "arrays.npz", **{k: reader.read_full(k) for k in reader.keys()})
    reader.close()
    shutil.copy(src / "meta.json", dst / "meta.json")
    return str(dst)


def phase_data_parallel(torch, timings, by_path):
    """Data parallelism over ranks (``parallel/``): the flagship at full width
    with 2 ranks sharing the card through ``gloo`` (``cli.train``, two
    passes over the first ``DP_HEAD_TRIPLES`` triples, a host-sharded
    validation eval after each, the end-of-run per-shard save): replicas
    bit-equal after every step, the loss finite and falling, each rank's
    launches exact and its recorded kernels held to their plain versions,
    the first step against a world of one (in f32 by the f32 rule; in bf16
    the loss by ``MP_LOSS_REL`` and the gradients by ``bf16_against_f32``)
    and both runs' validation MRRs printed; the slabs evaluated (``--evaluate``, test) and served (``cli.predict``)
    in one process equal to a single-file save of the same params; lookup
    ComplEx on the FB15k-shaped set with 2 ranks against a world of one on
    ``nccl`` (the f32 rule of ``utils/numerics.py`` on every parameter).
    Returns the largest kernel error by row."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import open_checkpoint_reader
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32

    t_phase = time.perf_counter()
    errs = {}
    config = write_config("synth-olpbench-2m47-dp", FLAGSHIP, {"dataset_dir": str(DATA_DIR), "save_epoch_freq": 0},
                          data={"train_data_config": {"input_file": dp_head_file()}})
    timings.setdefault("fb_dataset_gen_s", ensure_dataset(FB_DATA_DIR, FB_DATA_ARGS))
    fb = write_config("fb15k237-complex-kge-dp", FB_CONFIGS / "fb15k237-complex-kge.yaml",
                      {"dataset_dir": str(FB_DATA_DIR), "eval_epoch_freq": 2, "save_epoch_freq": 0},
                      data={"train_data_config": {"input_file": fb_head_file()}})
    f32 = write_config("synth-olpbench-2m47-dp-f32", write_f32_config(),
                       {"dataset_dir": str(DATA_DIR), "save_epoch_freq": 0}, data={"train_data_config": {
                           "input_file": dp_head_file()}})
    no_eval = ["--epochs", "2", "--eval_epoch_freq", "0"]
    # the runs side by side: ranks sharing the card measure correctness, not speed
    ((results, wall), (flagship_one, _), (f32_two, _), _), _ = run_side_by_side(
        [("flagship", config, 2, ["--epochs", "2"]), ("flagship_one", config, 1, ["--epochs", "2"]),
         ("flagship_f32", f32, 2, no_eval), ("flagship_one_f32", f32, 1, no_eval)])
    timings["dp_flagship_s"] = wall
    check_replicas("flagship", results)
    for r in results:
        check(r["backend"] == "gloo" and r["host_shard"] == [r["rank"], 2] and r["plan_path"] == "native",
              f"dp flagship rank {r['rank']}: backend {r['backend']}, host shard {r['host_shard']}, plans "
              f"{r['plan_path']}")
        by_path[f"dp_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
        timings[f"dp_r{r['rank']}_step_ms"] = summary(r["step_ms"][1:])
        timings[f"dp_r{r['rank']}_collective_ms"] = summary(r["collective_ms"][1:])
        timings[f"dp_r{r['rank']}_peak_gib"] = r["peak_gib"]
        print(f"dp flagship rank {r['rank']}: {r['steps']} steps, step median {np.median(r['step_ms'][1:]):.3f} ms "
              f"(max {max(r['step_ms'][1:]):.3f}), collectives median {np.median(r['collective_ms'][1:]):.3f} "
              f"ms/step, peak {r['peak_gib']:.2f} GiB, {r['eval_batches']} validation batches a pass (of "
              f"{sum(x['eval_batches'] for x in results)})")
    losses = np.array(results[0]["losses"])
    check(np.isfinite(losses).all() and losses[-2:].mean() < losses[:2].mean(),
          f"dp flagship: the loss is not finite and falling: {losses}")
    rows = results[0]["rows"]
    check(len(rows) == 2 and all(0 < x["validation_mrr"] <= 1 for x in rows), f"dp flagship: validation rows {rows}")
    # the first step against a world of one: in f32 by the f32 rule (the
    # layout's math), in bf16 no further from the f32 world of one's than
    # DP_BF16_FACTOR x the bf16 world of one is; both runs' validation MRRs
    cache = ROOT / ".bench_cache"
    f32_worst = 0.0
    for suffix in (".grads.npz", ".rows.npz"):
        f32_worst = max(f32_worst, grads_against(
            f"dp flagship f32 {suffix}", [first_step_grads(cache / "smoke_dp_flagship_f32", suffix, r) for r in range(2)],
            first_step_grads(cache / "smoke_dp_flagship_one_f32", suffix), 1, MAX_REL_ERR_F32)[0])
    for r in f32_two:
        fold_errs(errs, r["errs"])
    ratio = bf16_against_f32(cache / "smoke_dp_flagship", cache / "smoke_dp_flagship_one",
                             cache / "smoke_dp_flagship_one_f32")
    loss_rel = abs(results[0]["losses"][0] - flagship_one[0]["losses"][0]) / abs(flagship_one[0]["losses"][0])
    check(loss_rel <= MP_LOSS_REL, f"dp flagship: the first loss {loss_rel:.3g} from a world of one's")
    timings["dp_f32_first_grad_rel"], timings["dp_bf16_first_grad_ratio"] = f32_worst, ratio
    print(f"dp flagship: loss per step {np.array2string(losses, precision=5)}; validation MRR "
          f"{[round(x['validation_mrr'], 6) for x in rows]}, a world of one's (same seed) "
          f"{[round(x['validation_mrr'], 6) for x in flagship_one[0]['rows']]}; the first step against a world of "
          f"one: f32 gradients {f32_worst:.3g} of max|want| (<= {MAX_REL_ERR_F32}); bf16 loss {loss_rel:.3g} (<= "
          f"{MP_LOSS_REL}), gradients' distance to the f32 world of one's at most {ratio:.3g} x the bf16 world of "
          f"one's (<= {DP_BF16_FACTOR})")
    # the slabs against a single-file save of the same params, in one
    # process, beside the FB15k-shaped runs

    def slab_evals():
        slabs = results[0]["checkpoint"]
        names = sorted(p.name for p in Path(slabs).iterdir())
        check(names == ["arrays.p0.npz", "arrays.p1.npz", "index.p0.json", "index.p1.json", "meta.json"],
              f"dp flagship: the end-of-run checkpoint holds {names}")
        single = merge_checkpoint(slabs, ROOT / ".bench_cache" / "smoke_dp_single")
        reader = open_checkpoint_reader(slabs)
        n_leaves = len(reader.keys())
        reader.close()
        evals, lines = {}, {}
        for name, path in (("slabs", slabs), ("single", single)):
            trainer, cap, launches, row, _ = run_evaluate(torch, config, path,
                                                          ROOT / ".bench_cache" / f"smoke_dp_eval_{name}", False)
            meta = trainer.model.meta
            want = eval_launches(launches, meta.max_length[0], trainer.model.embedder.dtype,
                                 cache_chunks=-(-meta.entities_size // 32768), test_batches=len(trainer.val_builder))
            check(launches == want, f"dp {name} eval launches {launches}, want {want}")
            evals[name] = {k: row[k] for k in ("loss", "mrr", "mr", "h1", "h3", "h10", "h50")}
            del trainer, cap
            lines[name], plaunches = predict_with_counts(torch, config, path, DATA_DIR, f"dp {name}")
            if name == "slabs":
                by_path["dp_slabs"] = {k: launches[k] + plaunches[k] for k in launches}
        check(evals["slabs"] == evals["single"], f"dp: the slabs evaluate to {evals['slabs']}, the single file to "
              f"{evals['single']}")
        check(lines["slabs"] == lines["single"], "dp: cli.predict answers differ between the slabs and the single file")
        print(f"dp: the end-of-run slabs ({n_leaves} leaves, all in rank 0's slab) evaluate on test exactly as the "
              f"single-file save ({evals['slabs']}) and serve the same "
              f"{len(lines['slabs'])} cli.predict lines")

    ((one, _), (two, fb_wall)), _ = run_side_by_side(
        [("fb_one", fb, 1, ["--epochs", "2"]), ("fb_two", fb, 2, ["--epochs", "2"])], beside=slab_evals)
    # lookup ComplEx, FB15k-shaped: 2 ranks (gloo) against a world of one (nccl)
    timings["dp_fb_two_s"] = fb_wall
    check(one[0]["backend"] == "nccl" and one[0]["steps"] > 0, f"dp fb: the world of one ran {one[0]['backend']}, "
          f"{one[0]['steps']} steps")
    check_replicas("fb_two", two)
    by_path["dp_fb_one"] = one[0]["launches"]
    for r in two:
        by_path[f"dp_fb_r{r['rank']}"] = r["launches"]
        timings[f"dp_fb_r{r['rank']}_step_ms"] = summary(r["step_ms"][1:])
        timings[f"dp_fb_r{r['rank']}_collective_ms"] = summary(r["collective_ms"][1:])
    timings["dp_fb_one_step_ms"] = summary(one[0]["step_ms"][1:])
    # the first step's summed gradient of every leaf (kernel 3's input) and
    # loss by the f32 rule: what the ranks compute is the one process's step
    # up to the order of its sums.  Later parameters are printed, not held:
    # Adagrad's step lr g / (sqrt(sum) + 1e-10) turns that order's noise
    # into lr-sized moves where a gradient is near 1e-10 (weight decay 1e-10
    # alone, on the rows input dropout masked), and training carries them.
    with np.load(f"{ROOT}/.bench_cache/smoke_dp_fb_one/rank0.grads.npz") as za, \
            np.load(f"{ROOT}/.bench_cache/smoke_dp_fb_two/rank0.grads.npz") as zb:
        grads = [(za[k].astype(np.float64), zb[k].astype(np.float64)) for k in za.files]
    check(len(grads) > 0, "dp fb: no first-step gradients recorded")
    worst = max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)) for w, g in grads)
    loss_rel = abs(two[0]["losses"][0] - one[0]["losses"][0]) / abs(one[0]["losses"][0])
    check(worst <= MAX_REL_ERR_F32 and loss_rel <= MAX_REL_ERR_F32,
          f"dp fb: 2 ranks against 1 on the first step: gradients {worst:.3g}, loss {loss_rel:.3g} of max|want| > "
          f"{MAX_REL_ERR_F32}")
    a, b = open_checkpoint_reader(one[0]["checkpoint"]), open_checkpoint_reader(two[0]["checkpoint"])
    final = {k: float(np.abs(b.read_full(k).astype(np.float64) - a.read_full(k)).max() / np.abs(a.read_full(k)).max())
             for k in a.keys() if k.startswith("params/")}
    a.close()
    b.close()
    ra, rb = one[0]["rows"], two[0]["rows"]
    check(len(ra) == len(rb) == 1, f"dp fb: validation rows {ra} {rb}")
    losses = np.abs(np.array(two[0]["losses"]) - np.array(one[0]["losses"])) / np.abs(np.array(one[0]["losses"]))
    timings["dp_fb_first_grad_rel"], timings["dp_fb_final_param_rel"] = worst, final
    print(f"dp fb (lookup ComplEx d=200, {two[0]['steps']} steps of 512): 2 ranks (gloo, one card) against a world "
          f"of one (nccl): the first step's gradients of {len(grads)} leaves within the f32 rule (largest "
          f"difference / max|want| {worst:.3g}, loss {loss_rel:.3g}; <= {MAX_REL_ERR_F32}); after every step the "
          f"loss within {losses.max():.3g}, the final parameters within {final} of max|want|; validation MRR "
          f"{ra[0]['validation_mrr']:.6f} vs {rb[0]['validation_mrr']:.6f}; step median "
          f"{np.median(one[0]['step_ms'][1:]):.3f} ms (one) vs {np.median(two[0]['step_ms'][1:]):.3f} (two)")
    timings["dp_phase_s"] = time.perf_counter() - t_phase
    print(f"data parallel phase: {timings['dp_phase_s']:.1f} s")
    return errs


#: the flagship's first-step gradients on the model axis against a world of
#: one, bf16: every leaf's ||got - want|| / ||want|| (stated before the first
#: card run).  The candidate blocks reorder f32 sums (the score products'
#: dq, the batchnorm statistics), which moves bf16 roundings of the LSTM
#: backward by an ulp; an elementwise rule fails on the cancelling sums of
#: the LSTM biases (a CPU rehearsal at d = 32: 4.4 % of max|want| in bf16,
#: 8.2e-5 in f32), while a wrong reduction moves a whole leaf by tens of %.
#: The largest elementwise difference / max|want| is printed beside it.
MP_GRAD_REL = 2.0 ** -4
MP_LOSS_REL = 1e-5
#: the data-parallel flagship's first-step gradients in bf16: each leaf's
#: distance to the f32 world of one's (the math), ||two - ref||, at most
#: this many times the bf16 world of one's, ||one - ref||, plus the f32 rule
#: of ||ref||.  In bf16 the LSTMs' cancelling sums are far from the f32 ones
#: in either layout, and the ranks' blocks round elsewhere, so a rule
#: against the world of one itself fails at tens of % (0.277 of ||want||
#: on an NVIDIA H100 80GB HBM3, where this ratio read 1.46), while the
#: f32 runs agree by the f32 rule.
DP_BF16_FACTOR = 2.0


def bf16_against_f32(two_dir, one_dir, ref_dir):
    """Rank 0's first-step gradients (dense leaves and rows) of a bf16 run
    on ranks (``two_dir``) held to ``DP_BF16_FACTOR``: their distance to an
    f32 world of one's (``ref_dir``) against a bf16 world of one's
    (``one_dir``) -> the largest ratio of the two distances."""
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32

    worst = 0.0
    for suffix in (".grads.npz", ".rows.npz"):
        two, one, ref = (first_step_grads(d, suffix) for d in (two_dir, one_dir, ref_dir))
        check(len(two) == len(one) == len(ref), f"{two_dir.name}: {len(two)}, {len(one)}, {len(ref)} {suffix} leaves")
        for i, (t, o, w) in enumerate(zip(two, one, ref)):
            check(t.shape == o.shape == w.shape, f"{two_dir.name} {suffix} leaf {i}: shapes {t.shape} {o.shape} "
                  f"{w.shape}")
            d_two, d_one, scale = (np.linalg.norm(t - w), np.linalg.norm(o - w), np.linalg.norm(w))
            check(d_two <= DP_BF16_FACTOR * d_one + MAX_REL_ERR_F32 * scale,
                  f"{two_dir.name} {suffix} leaf {i} {w.shape}: {d_two / max(scale, 1e-30):.3g} of ||want|| from the "
                  f"f32 world of one's, the bf16 world of one {d_one / max(scale, 1e-30):.3g}")
            worst = max(worst, d_two / max(d_one, MAX_REL_ERR_F32 * scale, 1e-30))
    return worst


def first_step_grads(out_dir, suffix, rank=0):
    """A rank's first-step gradients (``.grads.npz`` or ``.rows.npz``) from a
    ``run_ranks`` directory, in leaf order."""
    with np.load(out_dir / f"rank{rank}{suffix}") as z:
        return [z[k].astype(np.float64) for k in z.files]


def grads_against(tag, got_by_rank, want, model, rel, l2=False):
    """Each rank's first-step gradients against a world of one's: a leaf the
    ranks hold whole compares as it is, a slab with its rows of the whole
    leaf (``slab_bounds``).  Holds every leaf's largest difference /
    max|want| (or with ``l2`` its ||got - want|| / ||want||) to ``rel`` ->
    (the largest of the held measure, the largest elementwise one)."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_bounds

    worst = worst_max = 0.0
    for r, got in enumerate(got_by_rank):
        check(len(got) == len(want), f"{tag} rank {r}: {len(got)} gradient leaves, want {len(want)}")
        for g, w in zip(got, want):
            if g.shape != w.shape:
                lo, hi = slab_bounds(w.shape[0], model, r % model)
                w = w[lo:hi]
            check(g.shape == w.shape, f"{tag} rank {r}: a gradient of shape {g.shape}, want {w.shape}")
            if not g.size:
                continue
            elem = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            worst_max = max(worst_max, elem)
            worst = max(worst, float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)) if l2 else elem)
    check(worst <= rel, f"{tag}: the first step's gradients {worst:.3g} ({'relative norm' if l2 else 'of max|want|'}) "
          f"from a world of one's > {rel}")
    return worst, worst_max


def phase_model_parallel(torch, timings, by_path, by_path_f32):
    """The model axis (``model_parallel: 2``: row-sharded entity tables and
    their Adagrad state, the candidates split over the model group,
    ``parallel/shard_map_score.py``).  The flagship at full width on 2 ranks
    sharing the card through ``gloo`` (``cli.train``, two passes over the
    first ``DP_HEAD_TRIPLES`` triples, a batch-shared validation after
    each, the end-of-run per-shard save): the first step's loss and
    gradients against a world of one (``MP_GRAD_REL``; the same in f32, the
    config's dtype line removed, by the f32 rule), the loss falling,
    each rank's launches exact and its recorded kernels held to their plain
    versions, the slabs the halves of the entity token table; the test eval
    on the sharded cache against a world of one's ranks (0 may differ), and
    the slabs evaluated and served in one process as a single-file save of
    the same params.  Lookup ComplEx at FB15k-237's widths (14,541 entities,
    odd) through the trainer and through ``shard_map_score``'s step, 2 ranks
    against a world of one on ``nccl``, held at the first step's gradients
    by the f32 rule.  Returns the largest kernel error by row."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import slab_bounds
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_REL_ERR_F32

    t_phase = time.perf_counter()
    errs = {}
    cache = ROOT / ".bench_cache"
    config = write_config("synth-olpbench-2m47-dp", FLAGSHIP, {"dataset_dir": str(DATA_DIR), "save_epoch_freq": 0},
                          data={"train_data_config": {"input_file": dp_head_file()}})
    # the same first step in f32 (the math, by the f32 rule), its run beside
    import yaml

    cfg = yaml.safe_load(Path(config).read_text())
    cfg["model_config"].pop("dtype")
    f32 = Path(config).with_name("synth-olpbench-2m47-mp-f32.yaml")
    f32.write_text(yaml.safe_dump(cfg, sort_keys=False))
    f32_args = ["--epochs", "2", "--eval_epoch_freq", "0"]
    one_dir, one_f32 = cache / "smoke_dp_flagship_one", cache / "smoke_dp_flagship_one_f32"
    runs = [("mp", config, 2, ["--epochs", "2", "--model_parallel", "2"]),
            ("mp_f32", f32, 2, [*f32_args, "--model_parallel", "2"])]
    # phase_data_parallel's worlds of one, or new ones
    if not (one_dir / "rank0.grads.npz").exists():
        runs.append(("flagship_one", config, 1, ["--epochs", "2"]))
    if not (one_f32 / "rank0.grads.npz").exists():
        runs.append(("flagship_one_f32", f32, 1, f32_args))
    ((two, wall), (f32_two, _), *_), _ = run_side_by_side(runs)
    one = [json.loads((one_dir / "rank0.json").read_text())]
    f32_one = [json.loads((one_f32 / "rank0.json").read_text())]
    timings["mp_flagship_s"] = wall
    check_replicas("mp", two)
    height = None
    for r in two:
        height = r["slabs"]["entity_token_embedding"][2]
        check(r["backend"] == "gloo" and r["mesh"] == [1, 2] and r["host_shard"] == []
              and r["slabs"]["entity_token_embedding"] == [*slab_bounds(height, 2, r["rank"]), height],
              f"mp rank {r['rank']}: backend {r['backend']}, mesh {r['mesh']}, host shard {r['host_shard']}, "
              f"slabs {r['slabs']}")
        by_path[f"mp_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
        timings[f"mp_r{r['rank']}_step_ms"] = summary(r["step_ms"][1:])
        timings[f"mp_r{r['rank']}_collective_ms"] = summary(r["collective_ms"][1:])
        timings[f"mp_r{r['rank']}_peak_gib"] = r["peak_gib"]
        print(f"mp flagship rank {r['rank']}: slab rows {r['slabs']['entity_token_embedding'][:2]} of {height} "
              f"(entity token table), {r['steps']} steps, step median {np.median(r['step_ms'][1:]):.3f} ms (max "
              f"{max(r['step_ms'][1:]):.3f}), collectives median {np.median(r['collective_ms'][1:]):.3f} ms/step, "
              f"peak {r['peak_gib']:.2f} GiB")
    losses = np.array(two[0]["losses"])
    check(np.isfinite(losses).all() and losses[-2:].mean() < losses[:2].mean(),
          f"mp flagship: the loss is not finite and falling: {losses}")
    rows = two[0]["rows"]
    check(len(rows) == 2 and all(0 < x["validation_mrr"] <= 1 for x in rows), f"mp flagship: validation rows {rows}")
    loss_rel = abs(two[0]["losses"][0] - one[0]["losses"][0]) / abs(one[0]["losses"][0])
    check(loss_rel <= MP_LOSS_REL, f"mp flagship: the first loss {loss_rel:.3g} from a world of one's")
    grads = {}
    for suffix in (".grads.npz", ".rows.npz"):  # kernel 3's leaves, kernel 4's rows
        exist = [(cache / d / f"rank0{suffix}").exists() for d in ("smoke_dp_mp", "smoke_dp_flagship_one")]
        check(exist[0] == exist[1], f"mp flagship: first-step {suffix} recorded by {exist} (mp, world of one)")
        grads[suffix] = grads_against(f"mp flagship {suffix}", [first_step_grads(cache / "smoke_dp_mp", suffix)],
                                      first_step_grads(one_dir, suffix), 2, MP_GRAD_REL,
                                      l2=True) if exist[0] else (0.0, 0.0)
    timings["mp_first_grad_rel_l2"] = max(g[0] for g in grads.values())
    timings["mp_first_grad_rel_max"] = max(g[1] for g in grads.values())
    f32_worst = 0.0
    for suffix in (".grads.npz", ".rows.npz"):
        f32_worst = max(f32_worst, grads_against(f"mp flagship f32 {suffix}",
                                                 [first_step_grads(cache / "smoke_dp_mp_f32", suffix, r)
                                                  for r in range(2)],
                                                 first_step_grads(one_f32, suffix), 2,
                                                 MAX_REL_ERR_F32)[0])
    f32_loss = abs(f32_two[0]["losses"][0] - f32_one[0]["losses"][0]) / abs(f32_one[0]["losses"][0])
    check(f32_loss <= MAX_REL_ERR_F32, f"mp flagship f32: the first loss {f32_loss:.3g} from a world of one's")
    for r in f32_two:
        by_path_f32[f"mp_f32_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
    timings["mp_f32_first_grad_rel"] = f32_worst
    print(f"mp flagship f32: the first step against a world of one: loss {f32_loss:.3g}, gradients {f32_worst:.3g} "
          f"of max|want| (<= {MAX_REL_ERR_F32})")
    print(f"mp flagship: loss per step {np.array2string(losses, precision=5)}; validation MRR "
          f"{[round(x['validation_mrr'], 6) for x in rows]}; the first step against a world of one: loss "
          f"{loss_rel:.3g}; gradients ||got - want|| / ||want|| dense leaves {grads['.grads.npz'][0]:.3g}, rows "
          f"{grads['.rows.npz'][0]:.3g} (<= {MP_GRAD_REL:.4g}); largest difference / max|want| "
          f"{grads['.grads.npz'][1]:.3g} and {grads['.rows.npz'][1]:.3g}")
    # the test eval on the sharded cache, 2 ranks, against a world of one
    slabs = two[0]["checkpoint"]
    names = sorted(p.name for p in Path(slabs).iterdir())
    check(names == ["arrays.p0.npz", "arrays.p1.npz", "index.p0.json", "index.p1.json", "meta.json"],
          f"mp flagship: the end-of-run checkpoint holds {names}")
    ev = ["--resume", slabs, "--evaluate", "True", "--evaluate_on_validation", "False"]
    ((ev_two, ev_wall),), (trainer, cap, launches, row_slabs, _) = run_side_by_side(
        [("mp_eval", config, 2, [*ev, "--model_parallel", "2"])],
        beside=lambda: run_evaluate(torch, config, slabs, cache / "smoke_mp_eval_one", False))
    timings["mp_eval_s"] = ev_wall
    # a cache above CHUNKED_ABOVE rows is ranked chunk by chunk, a smaller one from [B, N] scores
    want_ranks = [r["ranks"][r["gold_valid"]].cpu().numpy() for r in cap.chunked or cap.dense]
    del trainer, cap
    for r in ev_two:
        by_path[f"mp_eval_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
        with np.load(cache / "smoke_dp_mp_eval" / f"rank{r['rank']}.ranks.npz") as z:
            got = [z[k] for k in z.files]
        check(len(got) == len(want_ranks), f"mp eval rank {r['rank']}: {len(got)} batches, want {len(want_ranks)}")
        differ = sum(int((g != w).sum()) for g, w in zip(got, want_ranks))
        n = sum(len(w) for w in want_ranks)
        check(differ == 0, f"mp eval rank {r['rank']}: {differ} of {n} test ranks differ from a world of one's")
        lo, hi = slab_bounds(r["entities"], 2, r["rank"])
        print(f"mp eval rank {r['rank']}: the sharded cache ({hi - lo} rows: entities {lo}:{hi}), "
              f"{len(got)} test batches, {n} golds ranked, 0 differ from a world of one's; launches {r['launches']}")
    # the slabs against a single-file save of the same params, in one process
    single = merge_checkpoint(slabs, cache / "smoke_mp_single")
    _, _, _, row_single, _ = run_evaluate(torch, config, single, cache / "smoke_mp_eval_single", False)
    keys = ("loss", "mrr", "mr", "h1", "h3", "h10", "h50")
    check({k: row_slabs[k] for k in keys} == {k: row_single[k] for k in keys},
          f"mp: the slabs evaluate to {row_slabs}, the single file to {row_single}")
    lines_slabs, _ = predict_with_counts(torch, config, slabs, DATA_DIR, "mp slabs")
    lines_single, _ = predict_with_counts(torch, config, single, DATA_DIR, "mp single")
    check(lines_slabs == lines_single, "mp: cli.predict answers differ between the slabs and the single file")
    print(f"mp: the model-axis slabs evaluate on test exactly as the single-file save "
          f"({ {k: row_slabs[k] for k in keys} }) and serve the same {len(lines_slabs)} cli.predict lines")
    # lookup ComplEx, FB15k-shaped: the trainer and shard_map_score's step,
    # 2 ranks (gloo) against a world of one (nccl)
    timings.setdefault("fb_dataset_gen_s", ensure_dataset(FB_DATA_DIR, FB_DATA_ARGS))
    fb = write_config("fb15k237-complex-kge-dp", FB_CONFIGS / "fb15k237-complex-kge.yaml",
                      {"dataset_dir": str(FB_DATA_DIR), "eval_epoch_freq": 2, "save_epoch_freq": 0},
                      data={"train_data_config": {"input_file": fb_head_file()}})
    fb_one = cache / "smoke_dp_fb_one"
    if not (fb_one / "rank0.grads.npz").exists():  # phase_data_parallel's world of one, or a new one
        run_ranks("fb_one", fb, 1, ["--epochs", "2"])
    fb_one_res = json.loads((fb_one / "rank0.json").read_text())
    ((fb_two, wall), (sms_one, _), (sms_two, _)), _ = run_side_by_side([
        ("mp_fb", fb, 2, ["--epochs", "2", "--model_parallel", "2"]),
        ("mp_sms_one", fb, 1, (), "--mp-shard-map"), ("mp_sms", fb, 2, (), "--mp-shard-map")])
    timings["mp_fb_s"] = wall
    check_replicas("mp_fb", fb_two)
    worst_fb, _ = grads_against("mp fb", [first_step_grads(cache / "smoke_dp_mp_fb", ".grads.npz", r) for r in range(2)],
                                first_step_grads(fb_one, ".grads.npz"), 2, MAX_REL_ERR_F32)
    fb_loss_rel = abs(fb_two[0]["losses"][0] - fb_one_res["losses"][0]) / abs(fb_one_res["losses"][0])
    check(fb_loss_rel <= MAX_REL_ERR_F32, f"mp fb: the first loss {fb_loss_rel:.3g} from a world of one's")
    for r in fb_two:
        by_path[f"mp_fb_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
        timings[f"mp_fb_r{r['rank']}_step_ms"] = summary(r["step_ms"][1:])
        timings[f"mp_fb_r{r['rank']}_collective_ms"] = summary(r["collective_ms"][1:])
    print(f"mp fb (lookup ComplEx d=200, entity slabs {fb_two[0]['slabs']['entity_embedding']} and "
          f"{fb_two[1]['slabs']['entity_embedding']}, {fb_two[0]['steps']} steps of 512): the first step's gradients "
          f"within {worst_fb:.3g} of max|want| of a world of one's, loss {fb_loss_rel:.3g} (<= {MAX_REL_ERR_F32}); "
          f"validation MRR {fb_two[0]['rows'][0]['validation_mrr']:.6f} vs {fb_one_res['rows'][0]['validation_mrr']:.6f}"
          f"; step median {np.median(fb_two[0]['step_ms'][1:]):.3f} ms")
    want = first_step_grads(cache / "smoke_dp_mp_sms_one", ".grads.npz")
    # the entity table padded to a multiple of the model ranks: the padding
    # rows' gradient is zero (their columns are masked)
    want[0] = np.concatenate([want[0], np.zeros((sms_two[0]["rows"] * 2 - len(want[0]), want[0].shape[1]))])
    worst_sms, _ = grads_against("mp shard_map", [first_step_grads(cache / "smoke_dp_mp_sms", ".grads.npz", r) for r in range(2)],
                                 want, 2, MAX_REL_ERR_F32)
    sms_loss_rel = abs(sms_two[0]["loss"] - sms_one[0]["loss"]) / abs(sms_one[0]["loss"])
    check(sms_loss_rel <= MAX_REL_ERR_F32 and sms_two[0]["loss"] == sms_two[1]["loss"],
          f"mp shard_map: losses {[r['loss'] for r in sms_two]} against {sms_one[0]['loss']}")
    for r in sms_two:
        by_path[f"mp_sms_r{r['rank']}"] = r["launches"]
        fold_errs(errs, r["errs"])
    print(f"mp shard_map_score (FB15k-237 widths, {sms_two[0]['rows']} padded table rows a rank, a batch of "
          f"{sms_two[0]['batch_rows']}): 2 ranks against a world of one, the first step's gradients "
          f"{worst_sms:.3g} of max|want|, loss {sms_loss_rel:.3g} (<= {MAX_REL_ERR_F32})")
    timings["mp_fb_first_grad_rel"], timings["mp_sms_first_grad_rel"] = worst_fb, worst_sms
    timings["mp_phase_s"] = time.perf_counter() - t_phase
    print(f"model parallel phase: {timings['mp_phase_s']:.1f} s")
    return errs


# ------------------------------------------------- multi-step dispatch (phase_scan)

SCAN_DATA_DIR = ROOT / ".bench_cache" / "synth_olp_2m47_scan"
# the flagship's vocabulary sizes at 500,000 triples (OLPBench has ~30M):
# about 131 steps of 4096 a pass, so that the config's windows of 64 can
# fill twice a pass
_TRIPLES = DATA_ARGS.index("--triples") + 1
SCAN_DATA_ARGS = [*DATA_ARGS[:_TRIPLES], "500000", *DATA_ARGS[_TRIPLES + 1:]]
SCAN_F32_K = 8
# FB15k-237 lookup ComplEx's positives' bucket changes on 26 of 552 batches
# of two passes (the card's data), so a window of 64 fills only in passes
# 2 and 4: four passes give a signature its eager and its captured window
SCAN_FB_PASSES = 4
# graph against eager: a window's largest leaf gap, max|got - want| /
# max|want| over the state's leaves, at most this many times the gap of
# two eager runs of the same steps from the same state
SCAN_RULE_FACTOR = 8.0
# replays of the probed window timed after a run
SCAN_TIMED_REPLAYS = 5
# the CUDA functions of kernels 1 and 2 on the fused training path, as the
# profiler names them (the f32 weight split is one function for both)
SCAN_FUNCTIONS = {
    "bf16": ("lstm_last_step_kernel", "lstm_bwd_gate_kernel_bf16", "lstm_bwd_product_kernel_bf16",
             "lstm_bwd_dw_kernel_bf16"),
    "f32": ("lstm_split_kernel_tf32", "lstm_fwd_step_kernel_tf32", "lstm_bwd_gate_kernel_tf32",
            "lstm_bwd_product_kernel_tf32", "lstm_bwd_dw_kernel_tf32"),
}


class GraphCapture(Capture):
    """``Capture``'s records, taken only while a CUDA graph is being
    captured: the clones join the graph, so after each replay they hold the
    operands that replay gave the first captured step's launches."""

    def __init__(self):
        import torch

        super().__init__()

        def gated(record, orig):
            return lambda *args: record(*args) if torch.cuda.is_current_stream_capturing() else orig(*args)

        self._patches = [(mod, name, gated(fn, orig)) for (mod, name, fn), orig in zip(self._patches, self._orig)]


def flat_state(variables, opt_state):
    """Parameters, batchnorm state and optimizer state, flat."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    return {**{"params/" + k: v for k, v in leaves(variables["params"])},
            **{"state/" + k: v for k, v in leaves(variables["state"])},
            **{"opt/" + k: v for k, v in leaves(opt_state)}}


def state_of(trainer):
    return flat_state(trainer.variables, trainer.opt_state)


def state_gap(got, want):
    """(the largest leaf gap max|got - want| / max|want|, its leaf)."""
    worst = (0.0, "")
    for k, w in want.items():
        if w.numel():
            w64 = w.double()
            gap = (got[k].double() - w64).abs().max().item() / max(w64.abs().max().item(), 1e-30)
            worst = max(worst, (gap, k))
    return worst


class WindowProbe:
    """Every window call of a run: its kind (``ScannedStep.last_kind``) and
    synchronized ms a step; the kernel counters' ticks of each capture, and
    for each later replay of that graph the same ticks again in
    ``replayed`` (what the replay launched through no wrapper); around the
    first capture, the state, the generator's state, the batch and the
    hyperparameters before it and the graph's stacked stats and the state
    after its first replay; with ``save`` the trainer (``trainer``, set by
    ``run_scan``) saves right after that replay, in the background
    (``Trainer.save(wait=False)``), and ``saved`` keeps (training steps,
    the checkpoint's path, the arrays fetched from the same state)."""

    def __init__(self, torch, save=False):
        self.torch, self.save = torch, save
        self.before = self.after = self.stats = self.window = self.trainer = self.saved = None
        self.pending = False
        self.kinds, self.ms = [], {"eager": [], "capture": [], "replay": []}
        self.capture_ticks, self.replayed = {}, Counter()

    def __enter__(self):
        from open_knowledge_graph_embeddings_tpu_torch.train.step import ScannedStep

        torch, probe, counters = self.torch, self, kernel_counters()
        self._orig = (ScannedStep._capture, ScannedStep.__call__)

        def capture(s, w, variables, opt_state, hparams, generator):
            if probe.before is None:
                probe.before = {k: t.clone() for k, t in flat_state(variables, opt_state).items()}
                probe.generator = None if generator is None else generator.get_state()
                probe.views = {n: v.clone() for n, v in w.views.items()}
                probe.hparams, probe.pending = hparams, True
            return probe._orig[0](s, w, variables, opt_state, hparams, generator)

        def call(s, variables, opt_state, hparams, batches, generator=None):
            ticks = {n: fn.launches for n, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = probe._orig[1](s, variables, opt_state, hparams, batches, generator)
            torch.cuda.synchronize()
            kind, sig = s.last_kind, getattr(batches, "signature", None)
            probe.kinds.append(kind)
            probe.ms[kind].append((time.perf_counter() - t0) * 1e3 / s.k)
            if kind == "capture":
                probe.capture_ticks[sig] = {n: fn.launches - ticks[n] for n, fn in counters.items()}
            elif kind == "replay" and sig in probe.capture_ticks:
                probe.replayed.update(probe.capture_ticks[sig])
            if probe.pending:
                probe.after = {k: t.clone() for k, t in flat_state(variables, opt_state).items()}
                probe.stats = {n: t.clone() for n, t in out[2].items()}
                probe.window, probe.pending = batches, False
                if probe.save:
                    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import checkpoint_arrays

                    trainer = probe.trainer
                    path = trainer.save(wait=False)
                    probe.saved = (trainer.training_steps, path, checkpoint_arrays(variables, opt_state))
            return out

        ScannedStep._capture, ScannedStep.__call__ = capture, call
        return self

    def __exit__(self, *exc):
        from open_knowledge_graph_embeddings_tpu_torch.train.step import ScannedStep

        ScannedStep._capture, ScannedStep.__call__ = self._orig


def scan_weights(torch, config, data_dir, name):
    """One weight file for the runs of a comparison: the config's seeded
    init as a checkpoint of step 0 (no optimizer state: a run keeps its
    zero init)."""
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import save_checkpoint

    args = load_config(str(config), ["--dataset_dir", str(data_dir)])
    meta = load_meta(args["dataset_dir"], tuple(args["experiment_settings"]["max_lengths_tuple"]))
    model = build_model(args["model"], meta, **args["model_config"])
    variables = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    return save_checkpoint(str(ROOT / ".bench_cache"), name, variables, {"training_steps": 0})


def run_scan(torch, tag, config, extra, save=False, passes=2):
    """``cli.train`` on ``config`` with ``extra`` (``passes`` passes), the
    counts set to 0 just before and read just after, every single step of a
    run without windows timed synchronized, the windows probed
    (``WindowProbe``; with ``save`` a background save right after the first
    captured window) and the first captured launches recorded
    (``GraphCapture``)."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as cli_train
    from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer

    out_dir = ROOT / ".bench_cache" / f"smoke_{tag}"
    shutil.rmtree(out_dir, ignore_errors=True)
    step_ms, rebuild, probe = [], Trainer._rebuild_steps, WindowProbe(torch, save)

    def rebuilt(self):
        rebuild(self)
        probe.trainer, step = self, self.train_step

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        if self.train_step_scan is None:  # a capture may not synchronize
            self.train_step = timed

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    Trainer._rebuild_steps = rebuilt
    t0 = time.perf_counter()
    try:
        with GraphCapture() as capture, probe:
            trainer = cli_train.cli_main([str(config), "--epochs", str(passes), "--experiment_dir", str(out_dir),
                                          *extra, "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        Trainer._rebuild_steps = rebuild
    return {"trainer": trainer, "capture": capture, "probe": probe, "wall": time.perf_counter() - t0,
            "launches": {name: fn.launches for name, fn in counters.items()}, "step_ms": step_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def report_scan_run(torch, tag, run, timings, eager=None):
    """A window run: steps inside windows by how they ran, single steps;
    the kernel counters and, with the replays' launches added, against an
    eager run of the same batches (``eager``): every launch the eager run
    counted; the first captured launches of kernels 1-4 held to their plain
    versions on the graph's operands (``check_family_kernels``); capture,
    instantiate, host wait and peak memory.  Returns (the kernel errors,
    the launches with the replays')."""
    trainer, probe = run["trainer"], run["probe"]
    s, log = trainer.train_step_scan, trainer.step_log
    by_kind = Counter(r["window"] for r in log)
    inside = len(log) - by_kind[None]
    print(f"{tag}: {len(log)} steps in {run['wall']:.2f} s (cli.train), {inside} inside {s.windows} windows of "
          f"{s.k} ({inside / len(log):.1%}: eagerly {by_kind['eager']}, captured {by_kind['capture']}, replayed "
          f"{by_kind['replay']}), {by_kind[None]} single steps (flushed at signature changes and tails); "
          f"{s.captures} captures, {s.replays} replays")
    check(inside == s.windows * s.k and inside > 0 and s.captures > 0, f"{tag}: no window ran as a graph")
    with_replays = {k: v + probe.replayed[k] for k, v in run["launches"].items()}
    line = (f"{tag}: the port's counters {run['launches']} (they tick when a wrapper launches, eagerly or into a "
            f"graph being captured); with the replays' launches {with_replays}")
    if eager is not None:
        print(f"{line}; the eager run's {eager['launches']}")
        check(with_replays == eager["launches"], f"{tag}: launches with the replays' {with_replays}, the eager "
              f"run's {eager['launches']}")
    else:
        print(line)
    # the captured step is a late one (the first window of a signature runs
    # eagerly): kernels 1 and 2 are held against f64 beside the plain version
    errs = check_family_kernels(torch, tag, run["capture"], run["launches"], late=True)
    timings[f"{tag}_capture_s"], timings[f"{tag}_instantiate_s"] = s.capture_s, s.instantiate_s
    timings[f"{tag}_peak_gib"] = run["peak_gib"]
    waits = [r["wait_ms"] for r in log[1:]]
    timings[f"{tag}_host_wait_ms"] = summary(waits)
    print(f"{tag}: capture {s.capture_s:.3f} s, instantiate {s.instantiate_s:.3f} s; host wait median "
          f"{np.median(waits):.3f} ms a step (max {max(waits):.3f}); peak {run['peak_gib']:.2f} GiB")
    return errs, with_replays


def moved_leaves(state, before):
    """The leaves that moved from ``before`` (any element)."""
    return {k for k, t in state.items() if not t.equal(before[k])}


def movement_gap(got, want, before):
    """(the largest leaf gap ||got - want|| / ||want - before||, the gap
    relative to the window's own movement, its leaf) over the leaves that
    moved."""
    worst = (0.0, "")
    for k, w in want.items():
        w64 = w.double()
        moved = (w64 - before[k].double()).norm().item()
        if moved > 0:
            worst = max(worst, ((got[k].double() - w64).norm().item() / moved, k))
    return worst


def window_rule(got, want, before, spread):
    """The state after a window held to ``want``, an eager run of the same
    steps from ``before``: every optimizer step counter equal, the same
    leaves moved (neither depends on the order of atomic sums; which rows
    of a leaf move does, in bf16: an Adagrad sum row whose every square
    falls below its half-ulp stays put in one run and not in another), and
    the largest leaf gap (``state_gap``) within ``SCAN_RULE_FACTOR`` x
    ``spread``, two eager runs' gap -> why it fails (empty when it holds)."""
    fails = []
    counters = [k for k in want if k.endswith("/step") and not got[k].equal(want[k])]
    if counters:
        fails.append(f"{len(counters)} step counters differ ({counters[0]}: {got[counters[0]].max().item()!r}, want "
                     f"{want[counters[0]].max().item()!r})")
    moved = moved_leaves(got, before) ^ moved_leaves(want, before)
    if moved:
        fails.append(f"{len(moved)} leaves moved in one run only ({sorted(moved)[0]})")
    gap, leaf = state_gap(got, want)
    if gap > SCAN_RULE_FACTOR * spread:
        fails.append(f"the largest leaf gap {gap:.3e} ({leaf}) is above {SCAN_RULE_FACTOR} x {spread:.3e}")
    return fails


def largest_table_reverted(state, before):
    """``state`` with its largest parameter and that parameter's optimizer
    leaves as in ``before``: a window that skipped one table's update."""
    name = max((k for k in state if k.startswith("params/")), key=lambda k: state[k].numel())[len("params/"):]
    return {k: before[k] if k == "params/" + name or k.startswith(f"opt/{name}/") else t for k, t in state.items()}


def check_probed_window(torch, tag, trainer, probe):
    """The first captured window run again three times, eagerly, from the
    state and the generator's state it started from, on its own batch: the
    graph's first loss bit-equal to the eager one (the forward has no
    atomics); its later losses within ``SCAN_RULE_FACTOR`` times the eager
    runs' gap: the median of the graph's gaps to the three eager runs
    against the median of the three eager pairs' gaps (both sides are
    draws of the token scatters' atomics; with one of each, the f32
    window's read 3.0e-4 / 4.6e-4, 8.1e-4 / 6.7e-4, 1.4e-3 / 1.3e-3, 2.8e-5
    / 1.3e-5 and 5.9e-3 / 3.6e-4 in five calls on an H100); the state after
    it by ``window_rule``, which the second eager run must pass and three
    controls must fail: the state left as it was before the window, the
    state one step short (the window's first K - 1 steps run eagerly) and
    the window with its largest table's update left out.  Leaves the
    trainer holding the first eager run's state -> (that state, the
    numbers)."""
    scanned, state = trainer.train_step_scan, state_of(trainer)

    def eager(n):
        for k, t in state.items():
            t.copy_(probe.before[k])
        if probe.generator is not None:
            trainer.generator.set_state(probe.generator)
        stats = [scanned.single(trainer.variables, trainer.opt_state, probe.hparams,
                                {name: v[i] for name, v in probe.views.items()}, trainer.generator)[2]
                 for i in range(n)]
        return ({name: torch.stack([s[name] for s in stats]) for name in stats[0]},
                {k: t.clone() for k, t in state.items()})

    (s1, e1), (s2, e2), (s3, _), (_, short) = (eager(scanned.k), eager(scanned.k), eager(scanned.k),
                                                eager(scanned.k - 1))
    for k, t in state.items():
        t.copy_(e1[k])
    g_loss, e_loss, e2_loss, e3_loss = probe.stats["loss_sum"], s1["loss_sum"], s2["loss_sum"], s3["loss_sum"]
    rel = lambda a, b: ((a.double() - b.double()).abs() / b.double().abs()).max().item()  # noqa: E731
    before, spread, (gap, leaf) = probe.before, state_gap(e2, e1)[0], state_gap(probe.after, e1)
    gaps = [rel(g_loss, e) for e in (e_loss, e2_loss, e3_loss)]
    spreads = [rel(a, b) for a, b in ((e2_loss, e_loss), (e3_loss, e_loss), (e3_loss, e2_loss))]
    out = {"first_loss_equal": bool(g_loss[0] == e_loss[0]), "loss_gap": float(np.median(gaps)),
           "loss_spread": float(np.median(spreads)), "state_gap": gap, "state_spread": spread, "leaf": leaf,
           "movement_gap": movement_gap(probe.after, e1, before)[0], "movement_spread": movement_gap(e2, e1, before)[0]}
    controls = {"unchanged": before, "one step short": short, "largest table left out":
                largest_table_reverted(e1, before)}
    verdicts = {name: window_rule(c, e1, before, spread) for name, c in controls.items()}
    print(f"{tag}: the first captured window ({scanned.k} steps) again eagerly, twice, from its state: first loss "
          f"graph {g_loss[0].item()!r} eager {e_loss[0].item()!r} (bit-equal: {out['first_loss_equal']}); later "
          f"losses graph vs eager {out['loss_gap']:.3e} relative, the median of {[f'{x:.3e}' for x in gaps]} (eager "
          f"vs eager {out['loss_spread']:.3e}, of {[f'{x:.3e}' for x in spreads]}); state "
          f"after the window graph vs eager {gap:.3e} of max|want| ({leaf}), eager vs eager {spread:.3e}; "
          f"relative to the window's movement graph {out['movement_gap']:.3e}, eager {out['movement_spread']:.3e}")
    print(f"{tag}: the state rule (step counters equal, the same leaves moved, the largest leaf gap within "
          f"{SCAN_RULE_FACTOR} x eager's) fails the controls: " + "; ".join(
              f"{name}: {v[0] if v else 'PASSES'}" for name, v in verdicts.items()))
    check(out["first_loss_equal"], f"{tag}: the graph's first loss {g_loss[0].item()!r} differs from eager "
          f"{e_loss[0].item()!r}")
    fails = window_rule(e2, e1, before, spread)
    check(not fails, f"{tag}: the second eager run fails the state rule: {fails}")
    passed = [name for name, v in verdicts.items() if not v]
    check(not passed, f"{tag}: the state rule cannot tell these controls from the window: {passed}")
    fails = window_rule(probe.after, e1, before, spread)
    check(not fails, f"{tag}: the state after the graph's window fails the rule: {fails}")
    check(out["loss_gap"] <= SCAN_RULE_FACTOR * out["loss_spread"], f"{tag}: the window's losses are "
          f"{out['loss_gap']:.3e} from eager's, above {SCAN_RULE_FACTOR} x the eager runs' {out['loss_spread']:.3e}")
    return e1, out


def compare_runs(tag, win, eager):
    """The window run and the eager run from one weight file and one seed:
    the first loss (an eager step in both) bit-equal; the final state's gap
    and every step's loss gap printed (the state after a window is held by
    ``check_probed_window``'s rule)."""
    w, e = state_of(win["trainer"]), state_of(eager["trainer"])
    gap, leaf = state_gap(w, e)
    losses = [np.array([float(s["loss"]) for s in r["trainer"].step_log]) for r in (win, eager)]
    check(len(losses[0]) == len(losses[1]), f"{tag}: the runs took {[len(x) for x in losses]} steps")
    lg = np.abs(losses[0] - losses[1]) / np.abs(losses[1])
    print(f"{tag}: the window run against the eager run after {len(losses[0])} steps: state {gap:.3e} of max|want| "
          f"({leaf}); losses largest relative gap {lg.max():.3e}; first loss {losses[0][0]!r} vs {losses[1][0]!r}")
    check(losses[0][0] == losses[1][0], f"{tag}: the runs' first losses differ (one weight file, one seed)")


def time_window(torch, tag, trainer, probe, timings, eager_ms=None):
    """The probed window's graph replayed ``SCAN_TIMED_REPLAYS`` times, and
    its K steps run eagerly twice, each call synchronized -> ms a step
    inside a window against eager on the same batches with no batch being
    built beside them (``eager_ms``: the eager run's own steps, each
    synchronized, while its prefetch threads built the next batches); then
    torch.profiler over one replay and over the same steps eagerly: the
    device's busy share of each."""
    scanned, gen = trainer.train_step_scan, trainer.generator

    def per_step(fn, n):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / scanned.k)
        return ms

    graph = per_step(lambda: scanned(trainer.variables, trainer.opt_state, probe.hparams, probe.window, gen),
                     SCAN_TIMED_REPLAYS)
    check(scanned.last_kind == "replay", f"{tag}: the timed window did not replay ({scanned.last_kind})")
    eager = per_step(lambda: scanned._steps(probe.views, trainer.variables, trainer.opt_state, probe.hparams, gen), 2)
    timings[f"{tag}_window_ms_per_step"] = summary(graph)
    timings[f"{tag}_eager_window_ms_per_step"] = summary(eager)
    line = (f"{tag}: a step inside a window {np.median(graph):.3f} ms median (max {max(graph):.3f}) over "
            f"{len(graph)} replays; the same steps eagerly {np.median(eager):.3f} (max {max(eager):.3f}) over "
            f"{len(eager)} windows")
    if eager_ms:
        timings[f"{tag}_eager_ms_per_step"] = summary(eager_ms)
        line += (f"; the eager run's steps {np.median(eager_ms):.3f} (max {max(eager_ms):.3f}) over "
                 f"{len(eager_ms)} steps, beside its prefetch threads")
    print(line + " (each call synchronized)")
    device_breakdown(torch, f"{tag} one window replayed ({scanned.k} steps)", lambda: scanned(
        trainer.variables, trainer.opt_state, probe.hparams, probe.window, gen), top=6)
    device_breakdown(torch, f"{tag} the same {scanned.k} steps eagerly", lambda: scanned._steps(
        probe.views, trainer.variables, trainer.opt_state, probe.hparams, gen), top=6)


def check_window_checkpoint(torch, tag, run, eager_state):
    """The window run's save right after its first captured window (written
    in the background while the steps after it ran, ``WindowProbe(save=
    True)``): every array equal to those fetched from the same state in
    memory; loaded back (``Trainer.load``) it evaluates on the validation
    split (``Trainer.evaluate``, a new builder each: the same negatives)
    exactly as that state does in memory; the same window run eagerly
    (``check_probed_window``'s state) evaluated beside them.  Drops the
    trainer's graphs (a load does)."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder

    check(run["probe"].saved is not None, f"{tag}: no save after the captured window")
    steps, path, arrays = run["probe"].saved
    with np.load(Path(path) / "arrays.npz") as z:
        check(sorted(z.files) == sorted(arrays) and all(np.array_equal(z[k], arrays[k]) for k in z.files),
              f"{tag}: the background save at step {steps} differs from the state it was taken from")
    trainer = run["trainer"]
    rows = {}

    def evaluate(name):
        rows[name] = trainer.evaluate(BatchBuilder(trainer.validation_dataset)).averages_dict

    trainer.load(path)
    check(trainer.training_steps == steps, f"{tag}: the checkpoint loads step {trainer.training_steps}, want {steps}")
    evaluate("loaded")
    state = state_of(trainer)
    for k, t in state.items():
        t.copy_(torch.from_numpy(arrays[k]))
    evaluate("in memory")
    for k, t in state.items():
        t.copy_(eager_state[k])
    evaluate("eager")
    check(rows["loaded"] == rows["in memory"], f"{tag}: the background save evaluates to {rows['loaded']}, the "
          f"state it was taken from to {rows['in memory']}")
    print(f"{tag}: the save right after the captured window at step {steps} (written in the background while the "
          f"steps after it ran) holds the {len(arrays)} arrays of that state bit for bit, loads back and evaluates "
          f"exactly as it on validation {rows['loaded']}; the same window run eagerly evaluates to {rows['eager']}")
    return rows


def phase_scan(torch, timings, by_path, by_path_f32):
    """Multi-step dispatch (``train_scan_steps``): (a) the flagship, bf16, at
    its config's windows of 64 on the 500,000-triple cut, run with single
    steps and with windows from one weight file and one seed;
    (b) the flagship in f32 with windows of 8 in a new process under
    torch.profiler (``--scan-profile``), every launch of kernels 1-4
    counted from the device records; (c) FB15k-237 lookup ComplEx (d = 200,
    batch 512, dense step, autograd's backward inside the graph) with
    windows of 64, ``SCAN_FB_PASSES`` passes.  Each window run: steps
    inside windows, singles, captures and replays counted; the counters
    with the replays' launches exactly (a) the eager run's, (b) the device
    records', (c) one dense Adagrad launch a step; the first captured
    launches of kernels 1-4 held to
    their plain versions on the graph's own operands; the first captured
    window again eagerly, twice, from its state (first loss bit-equal, the
    rest within ``SCAN_RULE_FACTOR`` x the two eager runs' gap, the state by
    ``window_rule``, which three controls must fail); (a) the
    runs' first losses equal and a background save right after the captured
    window against the state it was taken from, loaded back and evaluated;
    ms a step inside a window against eager.  Returns the largest kernel
    error by row."""
    import yaml

    t_phase = time.perf_counter()
    errs = {}
    timings.setdefault("scan_dataset_gen_s", ensure_dataset(SCAN_DATA_DIR, SCAN_DATA_ARGS))
    K = int(yaml.safe_load(FLAGSHIP.read_text())["train_scan_steps"])
    check(K == 64, f"the flagship config's train_scan_steps is {K}")
    no_eval = {"eval_epoch_freq": 0, "save_epoch_freq": 0}
    # (a) the flagship in bf16
    config = write_config("synth-olpbench-2m47-scan", FLAGSHIP, {"dataset_dir": str(SCAN_DATA_DIR), **no_eval})
    common = ["--resume", scan_weights(torch, config, SCAN_DATA_DIR, "scan_weights")]
    eager = run_scan(torch, "scan_bf16_eager", config, [*common, "--train_scan_steps", "1"])
    win = run_scan(torch, "scan_bf16", config, common, save=True)
    print(f"phase_scan: (a)'s two runs by {time.perf_counter() - t_phase:.1f} s")
    fold_errs(errs, report_scan_run(torch, "scan_bf16", win, timings, eager)[0])
    by_path["scan_bf16"] = win["launches"]
    compare_runs("scan_bf16", win, eager)
    eager_state, _ = check_probed_window(torch, "scan_bf16", win["trainer"], win["probe"])
    time_window(torch, "scan_bf16", win["trainer"], win["probe"], timings, eager["step_ms"])
    check_window_checkpoint(torch, "scan_bf16", win, eager_state)
    del eager, win, eager_state
    torch.cuda.empty_cache()
    print(f"phase_scan: (a) by {time.perf_counter() - t_phase:.1f} s")
    # (b) f32, windows of 8, in a new process: device records
    f32 = write_config("synth-olpbench-2m47-scan-f32", write_f32_config(), {"dataset_dir": str(SCAN_DATA_DIR),
                                                                            **no_eval})
    res = scan_profile(torch, f32, ["--train_scan_steps", str(SCAN_F32_K)])
    by_path_f32["scan_f32"] = res["launches"]
    fold_errs(errs, res["errs"])
    timings.update(res["timings"])
    print(f"phase_scan: (b) by {time.perf_counter() - t_phase:.1f} s")
    # (c) FB15k-237 lookup ComplEx, dense
    timings.setdefault("fb_dataset_gen_s", ensure_dataset(FB_DATA_DIR, FB_DATA_ARGS))
    fb = write_config("fb15k237-complex-kge-scan", FB_CONFIGS / "fb15k237-complex-kge.yaml",
                      {"dataset_dir": str(FB_DATA_DIR), **no_eval})
    win = run_scan(torch, "scan_fb", fb, ["--train_scan_steps", str(K)], passes=SCAN_FB_PASSES)
    run_errs, with_replays = report_scan_run(torch, "scan_fb", win, timings)
    fold_errs(errs, run_errs)
    want = {**{k: 0 for k in with_replays}, "adagrad_update": len(win["trainer"].step_log)}
    check(with_replays == want, f"scan_fb: launches with the replays' {with_replays}, want {want}")
    by_path["scan_fb"] = win["launches"]
    check_probed_window(torch, "scan_fb", win["trainer"], win["probe"])
    time_window(torch, "scan_fb", win["trainer"], win["probe"], timings)
    del win
    torch.cuda.empty_cache()
    timings["phase_scan_s"] = time.perf_counter() - t_phase
    print(f"phase_scan: {timings['phase_scan_s']:.1f} s")
    return errs


SCAN_PROFILE_TIMEOUT_S = 600


def scan_profile(torch, config, extra):
    """``--scan-profile``'s run in a new process (there each profiler record
    is kept; minutes into this process the first ones are lost):
    ``cli.train`` on ``config`` under torch.profiler -> its result."""
    out = ROOT / ".bench_cache" / "smoke_scan_profile"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    result = out / "result.json"
    with open(out / "run.log", "w") as log:
        proc = subprocess.run([sys.executable, str(RANK_SCRIPT), "--scan-profile", str(result), str(config), *extra],
                              stdout=log, stderr=subprocess.STDOUT, timeout=SCAN_PROFILE_TIMEOUT_S)
    text = (out / "run.log").read_text()
    for line in text.splitlines():
        if line.startswith(("scan_f32", "profile scan_f32", "  ")):
            print(line)
    check(proc.returncode == 0, f"the profiled window run exited {proc.returncode}:\n{text[-3000:]}")
    return json.loads(result.read_text())


def scan_device_want(dtype, L, rows):
    """Each CUDA function of kernels 1-4 and how often the launches ``rows``
    (by kernel row, counted as the wrappers count them) launch at ``dtype``
    ("bfloat16"/"float32", or a torch dtype): kernel
    1 L a call in bf16, L + 1 in f32 (the weight split); kernel 2 2L + 1 a
    call in bf16 (gate, product, dW), 2L + 2 in f32 (and the split)."""
    f32 = str(dtype).removeprefix("torch.") == "float32"
    fwd, bwd = rows["lstm_last_fwd"], rows["lstm_last_bwd"]
    f_calls, b_calls = (fwd // (L + 1), bwd // (2 * L + 2)) if f32 else (fwd // L, bwd // (2 * L + 1))
    check(f_calls * (L + f32) == fwd and b_calls * (2 * L + 1 + f32) == bwd,
          f"launches {rows} are no whole number of LSTM calls at L = {L}")
    want = {"adagrad_dense_kernel": rows["adagrad_update"], "adagrad_rows_kernel": rows["scatter_adagrad"]}
    names = SCAN_FUNCTIONS["f32" if f32 else "bf16"]
    if f32:
        want.update(zip(names, (f_calls + b_calls, L * f_calls, L * b_calls, L * b_calls, b_calls)))
    else:
        want.update(zip(names, (L * f_calls, L * b_calls, L * b_calls, b_calls)))
    return want


def device_function_counts(torch, prof, names):
    """Launches of each CUDA function in ``names`` in a profile's device
    records (its name followed by ``<`` or ``(``)."""
    counts = Counter({n: 0 for n in names})
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n + "<" in e.name or n + "(" in e.name:
                    counts[n] += 1
    return dict(counts)


def scan_profile_main(torch, argv):
    """The process of ``scan_profile``: the window run (``run_scan``) under
    torch.profiler; each launch of kernels 1-4 counted from the device
    records of the whole run against the port's counters with the replays'
    launches added; the recorded launches held to their plain versions,
    the probed window checked and timed; the result as JSON."""
    from torch.profiler import ProfilerActivity, profile

    result, config, extra = Path(argv[0]), argv[1], argv[2:]
    timings = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = run_scan(torch, "scan_f32", config, extra)
    trainer = run["trainer"]
    errs, with_replays = report_scan_run(torch, "scan_f32", run, timings)
    dtype, L = str(trainer.model.embedder.dtype), trainer.model.meta.max_length[0]
    want = scan_device_want(dtype, L, with_replays)
    got = device_function_counts(torch, prof, list(want))
    print(f"scan_f32: kernels 1-4 by CUDA function in the device records of the run: {got} (want {want}, from the "
          f"counters with the replays' launches)")
    check(got == want, f"scan_f32: device launches {got}, want {want}")
    eager_state, _ = check_probed_window(torch, "scan_f32", trainer, run["probe"])
    time_window(torch, "scan_f32", trainer, run["probe"], timings)
    result.write_text(json.dumps({"launches": run["launches"], "device": got, "errs": errs, "timings": timings}))
    return 0


MRR_SEEDS = (0, 1, 2)


def mrr_spread_main(torch):
    """``--mrr-spread``: the flagship on ``phase_data_parallel``'s cut (the
    smoke set's first ``DP_HEAD_TRIPLES`` triples, two passes, a
    batch-shared validation after each) for each seed of ``MRR_SEEDS``, in
    bf16 and in f32: a world of one (``cli.train`` in this process, no
    mesh), the data-parallel (2 ranks) and the model-axis
    (``model_parallel: 2``) layouts sharing the card through ``gloo``;
    prints each run's validation MRRs and their spread over the seeds."""
    timings = {}
    build_kernels(torch, timings)
    ensure_dataset()
    head = {"train_data_config": {"input_file": dp_head_file()}}
    keys = {"dataset_dir": str(DATA_DIR), "save_epoch_freq": 0}
    bf16 = write_config("synth-olpbench-2m47-dp", FLAGSHIP, keys, data=head)
    f32 = write_config("synth-olpbench-2m47-dp-f32", write_f32_config(), keys, data=head)
    mrr, layouts = {}, []
    for seed in MRR_SEEDS:
        for dtype, cfg in (("bf16", bf16), ("f32", f32)):
            layout = f"one_{dtype}"
            out = ROOT / ".bench_cache" / f"smoke_mrr_{layout}_{seed}"
            shutil.rmtree(out, ignore_errors=True)
            trainer, _, wall, _ = run_cli(torch, [str(cfg), "--epochs", "2", "--seed", str(seed),
                                                  "--experiment_dir", str(out)])
            mrr[(layout, seed)] = [float(r["validation_mrr"]) for r in trainer.results.to_dicts()
                                   if "validation_mrr" in r]
            print(f"mrr {layout} seed {seed}: {len(trainer.step_log)} steps, validation MRR {mrr[(layout, seed)]}")
            del trainer
            torch.cuda.empty_cache()
            for layout, extra in ((f"dp_{dtype}", []), (f"mp_{dtype}", ["--model_parallel", "2"])):
                results, _ = run_ranks(f"mrr_{layout}_{seed}", cfg, 2, ["--epochs", "2", "--seed", str(seed), *extra])
                mrr[(layout, seed)] = [r["validation_mrr"] for r in results[0]["rows"]]
                print(f"mrr {layout} seed {seed}: {results[0]['steps']} steps, validation MRR {mrr[(layout, seed)]}")
    print("validation MRR after pass 1 and pass 2, by layout, seeds " + ", ".join(map(str, MRR_SEEDS)) + ":")
    for layout in ("one_bf16", "dp_bf16", "mp_bf16", "one_f32", "dp_f32", "mp_f32"):
        runs = np.array([mrr[(layout, seed)] for seed in MRR_SEEDS])
        print(f"  {layout:9s} " + "  ".join(f"[{a:.6f} {b:.6f}]" for a, b in runs)
              + f"  pass 1 spread {runs[:, 0].min():.6f}-{runs[:, 0].max():.6f}, pass 2 "
              f"{runs[:, 1].min():.6f}-{runs[:, 1].max():.6f}")
    print(json.dumps({"mrr": {f"{layout}/{seed}": v for (layout, seed), v in mrr.items()}}))
    return 0


def mark(t_start, phase):
    """One line of the run's timeline: the seconds since it started, at the
    end of ``phase``."""
    print(f"timeline: {time.perf_counter() - t_start:.1f} s at the end of {phase}")


def build_kernels(torch, timings):
    """nvcc for every CUDA source, started together."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(CUDA_SOURCES)
    timings["build_cuda_s"] = time.perf_counter() - t0
    for name, log in cuda_build.BUILD_LOGS.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln or "wgmma" in ln]
        print(f"nvcc {name}: " + " | ".join(info))
    print(f"build: nvcc {timings['build_cuda_s']:.2f} s ({len(CUDA_SOURCES)} sources in parallel)")


def main(argv) -> int:
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[:1] == ["--launch-cost"]:
        # the Adagrads' host cost alone, of the port in the checkout at argv[1]
        # (this one by default): two trees in one call, in turns
        tree = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
        check((tree / PKG).is_dir(), f"no {PKG}/ under {tree}")
        sys.path.insert(0, str(tree))
        print(f"launch cost of the port at {tree}")
        launch_cost(torch)
        return 0
    if argv[:1] == ["--backward-split"]:
        # the bf16 and f32 backwards' launches of the port in the checkout at
        # argv[1] (this one by default): two trees in one call, in turns
        tree = Path(argv[1]).resolve() if len(argv) > 1 else ROOT
        check((tree / PKG).is_dir(), f"no {PKG}/ under {tree}")
        sys.path.insert(0, str(tree))
        print(f"backward split of the port at {tree}")
        read_peaks(torch)
        build_kernels(torch, {})
        backward_split(torch)
        return 0
    sys.path.insert(0, str(ROOT))
    if argv[:1] in (["--dp-rank"], ["--mp-shard-map"], ["--scan-profile"]):
        # one rank of phase_data_parallel's or phase_model_parallel's runs
        # (run_ranks starts them), or phase_scan's profiled run
        mains = {"--dp-rank": dp_rank_main, "--mp-shard-map": sms_rank_main, "--scan-profile": scan_profile_main}
        try:
            return mains[argv[0]](torch, argv[1:])
        except (SmokeFailure, RuntimeError, subprocess.SubprocessError, OSError) as e:
            print(f"{argv[0][2:]} FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
    if argv[:1] == ["--mrr-spread"]:
        try:
            return mrr_spread_main(torch)
        except (SmokeFailure, RuntimeError, subprocess.SubprocessError, OSError) as e:
            print(f"mrr-spread FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return 1

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    timings, t_start = {}, time.perf_counter()
    try:
        sms, mhz = read_peaks(torch)
        print(f"peaks at {sms} SMs x {mhz:.0f} MHz (max SM clock): bf16 tensor cores x 4096 FLOP = "
              f"{PEAK_BF16_FLOPS / 1e12:.2f} TFLOP/s (published: 989 at 1830 MHz); 3xTF32 (the f32 kernels' bound) "
              f"a sixth of it, {PEAK_3XTF32_FLOPS / 1e12:.2f} TFLOP/s; FP32 FFMA x 128 lanes x 2 FLOP = "
              f"{PEAK_FP32_FLOPS / 1e12:.2f} TFLOP/s")
        # every dataset the phases read is generated while nvcc builds
        sets = {"dataset_gen_s": (DATA_DIR, DATA_ARGS), "scan_dataset_gen_s": (SCAN_DATA_DIR, SCAN_DATA_ARGS),
                "fb_dataset_gen_s": (FB_DATA_DIR, FB_DATA_ARGS)}
        gens = start_datasets(sets.values())
        build_kernels(torch, timings)
        took = finish_datasets(gens)
        for key, (data_dir, _) in sets.items():
            timings[key] = took.get(data_dir, 0.0)
        print("datasets beside the build: " + ", ".join(f"{d.name} {took[d]:.1f} s" for d in took))
        row_fwd = phase_kernels(torch)
        mark(t_start, "kernels")
        by_path = {}
        trainer, capture, by_path["train"], n_steps = phase_train(torch, timings, evaluate=True)
        ckpt = check_training(torch, trainer, by_path["train"], n_steps)
        time_train_steps(torch, trainer, timings)
        host_wait_ms = timings["cli_epoch_host_wait_ms"]
        table_heights = [trainer.variables["params"][t].shape[0]
                         for t in ("entity_token_embedding", "relation_token_embedding")]
        del trainer
        row_bwd, fwd_err = check_lstm_backward(torch, capture.bwd)
        fwd_err = max(fwd_err, check_lstm_residuals(torch, capture.fwd))
        time_forward_passes(torch, capture.fwd)
        row_fwd["max_abs_err"] = max(row_fwd["max_abs_err"], fwd_err)
        cold = cold_kernels_ms(torch, [("adagrad_dense_kernel", cold_args(capture.dense)),
                                       ("adagrad_rows_kernel", cold_args(capture.rows))])
        rows = [row_fwd, row_bwd,
                check_adagrad(torch, capture.dense, table_heights, cold[0]),
                check_row_adagrad(torch, capture.rows, cold[1])]
        fused_entity_pass = capture.fwd[0][0]
        del capture
        rows += time_every_state(torch, fused_entity_pass, *check_every_state(torch, fused_entity_pass))
        check_one_row_backward(torch)
        by_path["op"] = phase_every_state_op(torch, fused_entity_pass)
        del fused_entity_pass
        torch.cuda.empty_cache()
        by_path["eval"], _ = phase_eval(torch, timings, ckpt)
        mark(t_start, "train and eval")

        trainer, capture, by_path["train_unfused"], n_steps = phase_train(torch, timings, unfused=True)
        check(not (capture.fwd or capture.bwd) and len(capture.scan_fwd) == len(capture.scan_bwd) == 2,
              "the unfused run recorded fused launches or missed the recurrence's")
        ckpt_unfused = check_training(torch, trainer, by_path["train_unfused"], n_steps, unfused=True)
        with unfused_switch():
            time_train_steps(torch, trainer, timings, pre="unfused_")
        del trainer
        rows += time_scan(torch, capture.scan_fwd, capture.scan_bwd,
                          *check_scan(torch, capture.scan_fwd, capture.scan_bwd))
        check_scan_gates(torch, capture.scan_fwd[0][0])
        del capture
        torch.cuda.empty_cache()

        by_path["serve"] = phase_main_path(torch, timings, ckpt=ckpt)
        with unfused_switch():
            by_path["serve_unfused"] = phase_main_path(torch, timings, ckpt=ckpt_unfused, unfused=True)
        mark(t_start, "unfused and serve")
        torch.cuda.empty_cache()

        by_path_f32 = {}
        rows += phase_f32(torch, timings, by_path_f32)
        phase_any_h(torch)
        mark(t_start, "f32")
        family_errs = phase_families(torch, timings, by_path, by_path_f32)
        mark(t_start, "families")
        objective_errs = phase_objectives(torch, timings, by_path, by_path_f32)
        mark(t_start, "objectives")
        create_errs = phase_create_data(torch, timings, by_path)
        mark(t_start, "create_data")
        phase_shard_ckpt(torch, timings, by_path, ckpt)
        mark(t_start, "shard_ckpt")
        phase_native(torch, timings, host_wait_ms)
        mark(t_start, "native")
        dp_errs = phase_data_parallel(torch, timings, by_path)
        mark(t_start, "data parallel")
        mp_errs = phase_model_parallel(torch, timings, by_path, by_path_f32)
        mark(t_start, "model parallel")
        scan_errs = phase_scan(torch, timings, by_path, by_path_f32)
        mark(t_start, "scan")
        for row in rows:
            row["max_abs_err"] = max(row["max_abs_err"], *(errs.get(row["name"], 0.0) for errs in (
                family_errs, objective_errs, create_errs, dp_errs, mp_errs, scan_errs)))
        timings["launch_cost"] = launch_cost(torch)
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
    sys.exit(main(sys.argv[1:]))
