"""Tests that need a CUDA card: the port's hand-written kernels against their
plain PyTorch versions on the card, and the serving path on the card against
the same path on the CPU.

They skip without a card (a CUDA kernel has no CPU or interpret mode) and
import no JAX, so they also run where JAX is not installed:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_UNEQUAL_SHARE_BWD,
    assert_bf16_close,
    assert_f32_close,
    f32_agreement,
)

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Kernel against plain version, and the card's cache against the CPU's: the
# same bf16 products accumulated in f32 in another order, held to
# utils/numerics.py's rule (at most 4 bf16 ulps of max|want| and 2 % of
# elements not bit-equal).  Top-k scores: the query vectors differ in a few
# elements by one bf16 ulp, so a score moves by well under one bf16 ulp
# (2^-8) of the largest score.
SCORE_RTOL = 2 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(B, D, L=10, seed=0):
    """Seeded inputs on the CPU: lengths 0..L sorted descending, bf16
    embeddings and gate-major weights, f32 bias."""
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy()
    k = 1.0 / np.sqrt(D)
    emb = torch.from_numpy((rng.standard_normal((L, B, D)) * 0.5).astype(np.float32))
    w_ih = torch.from_numpy(rng.uniform(-k, k, (4 * D, D)).astype(np.float32))
    w_hh = torch.from_numpy(rng.uniform(-k, k, (4 * D, D)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-2 * k, 2 * k, 4 * D).astype(np.float32))
    bf = torch.bfloat16
    return emb.to(bf), w_ih.to(bf), w_hh.to(bf), bias, torch.from_numpy(lens)


@pytest.mark.parametrize(
    "B,D",
    [(333, 128), (1, 512), (37, 512), (4099, 64), (37, 40)],
    ids=["ragged-333", "one-row", "ragged-37-d512", "ragged-4099", "d40-unit-tail"],
)
def test_kernel_matches_plain_on_card(cuda, B, D):
    args = [x.to(cuda) for x in _inputs(B, D, seed=B)]
    before = lstm_kernel.lstm_encode_last_fused.launches
    got = lstm_kernel.lstm_encode_last_fused(*args)
    want = lstm_kernel.lstm_encode_last_plain(*args)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_encode_last_fused.launches == before + args[0].shape[0]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, D)
    assert_bf16_close(got, want)


@pytest.mark.parametrize(
    "B,D",
    [(1, 512), (37, 40), (129, 64), (4099, 128), (5632, 512), (3072, 512), (129, 200)],
    ids=["one-row", "d40-unit-and-k-tail", "row-tile-edge", "ragged-4099", "entity-pass", "relation-pass",
         "d200-unit-tail"],
)
def test_forward_modes_across_tile_edges_on_card(cuda, B, D):
    """Kernel 1 across the edges of its 128-row and 32-unit tiles and of its
    64-wide K stages, with one tile per block and several (the two consumer
    warpgroups taking turns), in its three modes: serving (last), training
    (last, hs, cs) and every state (kernel 5: hs, cs), each against the plain
    version at the positions the rows reach."""
    args = [x.to(cuda) for x in _inputs(B, D, seed=B + D)]
    L = args[0].shape[0]
    want_last, want_hs, want_cs = lstm_kernel.lstm_encode_last_plain(*args, residuals=True)
    act = torch.from_numpy(_active(args[4].cpu().numpy(), L)).to(cuda)
    count = lstm_kernel.lstm_encode_last_fused
    serve, _, _ = lstm_kernel._launch_steps(*args, False, True, count)
    last, hs, cs = lstm_kernel._launch_steps(*args, True, True, count)
    _, all_hs, all_cs = lstm_kernel._launch_steps(*args, True, False, count)
    torch.cuda.synchronize()
    assert_bf16_close(serve, want_last)
    assert torch.equal(serve, last)
    assert_bf16_close(last, want_last)
    for got_hs, got_cs in ((hs, cs), (all_hs, all_cs)):
        assert_bf16_close(got_hs[act], want_hs[act])
        assert_bf16_close(got_cs[act], want_cs[act])


def test_kernel_refuses_what_it_does_not_take(cuda):
    """f32 is taken (the JAX package's default compute dtype); what is
    refused: another dtype, a strided or misplaced input, and at the fused
    kernels a D or H that is not whole 16-byte rows (the model sends them D
    and H divisible by 128 only, as the JAX package does its fused kernel).
    The unfused path takes any H (test_scan_kernels_take_any_h_on_card)."""
    emb, w_ih, w_hh, bias, lens = (x.to(cuda) for x in _inputs(8, 64))
    f32 = (emb.float(), w_ih.float(), w_hh.float(), bias, lens)
    assert_f32_close(lstm_kernel.lstm_encode_last_fused(*f32), lstm_kernel.lstm_encode_last_plain(*f32))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        lstm_kernel.lstm_encode_last_fused(emb.half(), w_ih.half(), w_hh.half(), bias, lens)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_kernel.lstm_encode_last_fused(emb.transpose(0, 1).contiguous().transpose(0, 1),
                                           w_ih, w_hh, bias, lens)
    with pytest.raises(ValueError, match="one device"):
        lstm_kernel.lstm_encode_last_fused(emb, w_ih, w_hh, bias, lens.cpu())
    e, wi, wh, b, ln = (x.to(cuda) for x in _inputs(8, 100))
    with pytest.raises(ValueError, match="divisible by 8"):
        lstm_kernel.lstm_encode_last_fused(e, wi, wh, b, ln)
    e, wi, wh, b, ln = (x.to(cuda) for x in _inputs(8, 102))
    with pytest.raises(ValueError, match="divisible by 4"):
        lstm_kernel.lstm_encode_last_fused(e.float(), wi.float(), wh.float(), b, ln)


def test_serving_on_card_matches_cpu(cuda, tmp_path):
    """LSTM-ComplEx d=128 bf16: the candidate cache and the top-k of the card
    (kernel) against the CPU (plain version), same weights."""
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(tmp_path),
         "--mentions", "600", "--relations", "40", "--triples", "300",
         "--eval-size", "20", "--ent-tokens", "150", "--rel-tokens", "30", "--seed", "6"],
        check=True, capture_output=True, timeout=120,
    )
    meta = load_meta(str(tmp_path), (10, 10))
    model = build_model("LSTMComplexRelationModel", meta, entity_slot_size=128,
                        normalize="batchnorm", dtype="bfloat16", sparse=True, init_std=0.1)
    cpu_vars = model.init(torch.Generator().manual_seed(0))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    before = lstm_kernel.lstm_encode_last_fused.launches
    on_card = Predictor(model, to(cpu_vars, cuda))
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_encode_last_fused.launches > before
    on_cpu = Predictor(model, cpu_vars)
    assert_bf16_close(on_card.cand_emb.cpu(), on_cpu.cand_emb)

    rng = np.random.default_rng(1)
    ents = rng.integers(2, meta.entities_size, 32)
    rels = rng.integers(2, meta.relations_size, 32)
    got_s, got_i = on_card.predict(subj=ents, rel=rels, k=10)
    want_s, _ = on_cpu.predict(subj=ents, rel=rels, k=10)
    assert ((got_i >= meta.min_entities_size) & (got_i < meta.entities_size)).all()
    assert (np.diff(got_s, axis=1) <= 0).all()
    assert np.abs(got_s - want_s).max() <= SCORE_RTOL * np.abs(want_s).max()


# ---------------------------------------------------------------- training kernels

# db sums the unrounded f32 dgates over every active (row, step) in another
# order than the plain version: held to 1e-4 of max|db| (measured ~1e-5 on
# an H100 at d=512; a dropped dc*f carry or a skipped dlast injection moves
# db by tens of percent).  demb and dW: the bf16 rule with the backward's
# share of unequal elements (utils/numerics.py MAX_UNEQUAL_SHARE_BWD).
DB_RTOL = 1e-4


def _train_inputs(B, D, L=10, seed=0):
    emb, w_ih, w_hh, bias, lens = _inputs(B, D, L, seed)
    rng = np.random.default_rng(seed + 100)
    dlast = torch.from_numpy((rng.standard_normal((B, D)) * 0.5).astype(np.float32)).to(torch.bfloat16)
    return emb, w_ih, w_hh, bias, lens, dlast


def _active(lens, L):
    return (np.arange(L)[:, None] < np.maximum(lens, 1)[None, :])


@pytest.mark.parametrize("B,D", [(333, 128), (1, 512), (37, 512), (4099, 64), (37, 40)],
                         ids=["ragged-333", "one-row", "ragged-37-d512", "ragged-4099", "d40-unit-tail"])
def test_lstm_backward_matches_plain_on_card(cuda, B, D):
    emb, w_ih, w_hh, bias, lens, dlast = (x.to(cuda) for x in _train_inputs(B, D, seed=B))
    L = emb.shape[0]
    last, hs, cs = lstm_kernel._forward(emb, w_ih, w_hh, bias, lens, residuals=True)
    want_last, want_hs, want_cs = lstm_kernel.lstm_encode_last_plain(emb, w_ih, w_hh, bias, lens, residuals=True)
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    assert_bf16_close(last, want_last)
    assert_bf16_close(hs[act], want_hs[act])
    assert_bf16_close(cs[act], want_cs[act])

    before = lstm_kernel.lstm_last_backward.launches
    demb, dw_ih, dw_hh, db = lstm_kernel.lstm_last_backward(emb, w_ih, w_hh, bias, lens, hs, cs, dlast)
    want = lstm_kernel.lstm_last_backward_plain(emb, w_ih, w_hh, bias, lens, hs, cs, dlast)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_last_backward.launches == before + 2 * L + 1
    assert demb.dtype == dw_ih.dtype == dw_hh.dtype == torch.bfloat16 and db.dtype == torch.float32
    assert_bf16_close(demb[act], want[0][act], MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(dw_ih, want[1], MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(dw_hh, want[2], MAX_UNEQUAL_SHARE_BWD)
    assert (db - want[3]).abs().max().item() <= DB_RTOL * want[3].abs().max().item()


def test_lstm_autograd_on_card_matches_cpu(cuda):
    """The autograd Function on the card (both kernels) against the CPU
    (both plain versions), through the f32 -> bf16 weight cast."""
    emb, w_ih, w_hh, bias, lens, dlast = _train_inputs(96, 64, seed=3)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.float().to(dev).requires_grad_() for x in (emb, w_ih, w_hh)]
        b = bias.to(dev).requires_grad_()
        last = lstm_kernel.lstm_encode_last_fused(
            leaves[0].to(torch.bfloat16), leaves[1].to(torch.bfloat16), leaves[2].to(torch.bfloat16),
            b, lens.to(dev))
        (last.float() * dlast.float().to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in (*leaves, b)])
    act = torch.from_numpy(_active(lens.numpy(), emb.shape[0]))
    (gx, gwi, gwh, gb), (cx, cwi, cwh, cb) = grads
    assert_bf16_close(gx[act], cx[act], MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(gwi, cwi, MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(gwh, cwh, MAX_UNEQUAL_SHARE_BWD)
    assert (gb - cb).abs().max().item() <= DB_RTOL * cb.abs().max().item()


# The bf16 backward (kernels 2 and 6: the gate launch on kernel 1's loop, the
# dh/demb product with wgmma's transposed B) across its tile edges: 128-row
# tiles, 32-unit gate tiles, 64-wide K stages, 128-column product tiles
# counted apart for dh and demb (H = 40 and 136: column and unit tails; D =
# 40: a K tail of the x part and a demb tail), lengths 0..10 with 0s and 1s.
# demb and dW by the bf16 rule with the backward's share; below
# SHARE_MIN_ROWS rows the share of unequal elements is a statistic of too
# few rows (one flipped dgate of a long row moves every earlier step of it:
# one row of kernel 6 read 12 % on an H100), so only the ulp bound holds.
BF16_BWD_SHAPES = [(b, d, h) for b in (1, 37, 129, 4099) for d in (40, 512) for h in (40, 136, 512)]
SHARE_MIN_ROWS = 32


def _bf16_inputs(B, D, H, L=10, seed=0):
    """_f32_inputs in bf16 (the bias stays f32)."""
    emb, w_ih, w_hh, bias, lens, dhs, dlast = _f32_inputs(B, D, H, L, seed)
    bf = torch.bfloat16
    return emb.to(bf), w_ih.to(bf), w_hh.to(bf), bias, lens, dhs.to(bf), dlast.to(bf)


@pytest.mark.parametrize("B,D,H", BF16_BWD_SHAPES, ids=[f"B{b}-D{d}-H{h}" for b, d, h in BF16_BWD_SHAPES])
def test_bf16_backward_modes_across_tile_edges_on_card(cuda, B, D, H):
    emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _bf16_inputs(B, D, H, seed=B + D + H))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    _, hs, cs = lstm_kernel._forward(*args, residuals=True)
    before = (lstm_kernel.lstm_last_backward.launches, lstm_kernel.lstm_all_backward.launches)
    got = {"last": lstm_kernel.lstm_last_backward(*args, hs, cs, dlast),
           "every": lstm_kernel.lstm_all_backward(*args, hs, cs, dhs)}
    want = {"last": lstm_kernel.lstm_last_backward_plain(*args, hs, cs, dlast),
            "every": lstm_kernel.lstm_all_backward_plain(*args, hs, cs, dhs)}
    torch.cuda.synchronize()
    assert (lstm_kernel.lstm_last_backward.launches, lstm_kernel.lstm_all_backward.launches) == (
        before[0] + 2 * L + 1, before[1] + 2 * L + 1)
    share = MAX_UNEQUAL_SHARE_BWD if B >= SHARE_MIN_ROWS else 1.0
    for mode in got:
        (demb, dw_ih, dw_hh, db), w = got[mode], want[mode]
        assert demb.dtype == dw_ih.dtype == dw_hh.dtype == torch.bfloat16 and db.dtype == torch.float32
        assert torch.isfinite(demb[act].float()).all()
        assert_bf16_close(demb[act], w[0][act], share)
        assert_bf16_close(dw_ih, w[1], share)
        assert_bf16_close(dw_hh, w[2], share)
        assert (db - w[3]).abs().max().item() <= DB_RTOL * w[3].abs().max().item(), mode


@pytest.mark.parametrize("D,H", [(128, 128), (64, 40)], ids=["two-full-tiles", "one-box-tails"])
def test_bf16_backward_product_is_a_transposed_b_wgmma_on_card(cuda, D, H):
    """The bf16 product launch alone, one row tile: [dh | demb] = dg[t] .
    [W_hh | W_ih] with the gate-major weights read as they are (wgmma's
    transposed B from two 64-column TMA boxes a stage), against torch.matmul
    in f32 on the same bf16 values; dh in f32 (bf16 products are exact in
    f32, so only the sum order differs: the f32 rule), demb rounded to bf16.
    At H = 40 the second box of each tile is past the columns and not
    loaded, and K = 160 ends in half a stage."""
    rng = np.random.default_rng(7)
    L, B, t = 2, 128, 1
    bf = torch.bfloat16
    dg = torch.from_numpy(rng.standard_normal((L, B, 4 * H)).astype(np.float32)).to(bf).to(cuda)
    w_ih = torch.from_numpy(rng.uniform(-0.1, 0.1, (4 * H, D)).astype(np.float32)).to(bf).to(cuda)
    w_hh = torch.from_numpy(rng.uniform(-0.1, 0.1, (4 * H, H)).astype(np.float32)).to(bf).to(cuda)
    lens = torch.full((B,), L, dtype=torch.int32, device=cuda)
    dh = torch.full((B, H), float("nan"), device=cuda)
    demb = torch.zeros(B, D, dtype=bf, device=cuda)
    _, prod, _ = lstm_kernel._bwd_fns()
    grid = lstm_kernel.backward_product_grid_bf16(B, H, D, lstm_kernel._sm_count(cuda.index or 0))
    err = prod(dg.data_ptr(), w_hh.data_ptr(), w_ih.data_ptr(), lens.data_ptr(), dh.data_ptr(), demb.data_ptr(),
               L, B, D, H, t, grid, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert_f32_close(dh, torch.matmul(dg[t].float(), w_hh.float()))
    assert_bf16_close(demb, torch.matmul(dg[t].float(), w_ih.float()).to(bf))


@pytest.mark.parametrize("B,D,H", [(37, 512, 512), (129, 40, 136), (4099, 128, 64)],
                         ids=["B37-d512", "B129-D40-H136", "B4099"])
def test_bf16_backward_gates_are_kernel_1s_bitwise_on_card(cuda, B, D, H):
    """The backward's gate launch recomputes kernel 1's f32 pre-activation
    gates bit for bit at every position a row reaches (both run the loop of
    csrc/lstm_bf16.cuh on the same tiles and tensor maps): the measuring
    stores of the two are equal as integers."""
    emb, w_ih, w_hh, bias, lens, _, dlast = (x.to(cuda) for x in _bf16_inputs(B, D, H, seed=5))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]

    class Uncounted:
        launches = 0

    stored = [torch.zeros(L, B, 4 * H, device=cuda) for _ in range(2)]
    _, hs, cs = lstm_kernel._launch_steps(*args, True, True, Uncounted, gates=stored[0])
    lstm_kernel._launch_bwd_steps(*args, hs, cs, dlast, False, Uncounted, gates=stored[1])
    torch.cuda.synchronize()
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    fwd, bwd = (x[act] for x in stored)
    assert torch.isfinite(fwd).all() and fwd.abs().max().item() > 0
    assert torch.equal(fwd.view(torch.int32), bwd.view(torch.int32))


# The bf16 dW launch (csrc/lstm_last_bwd.cu: wgmma with A and B transposed,
# a block walking every active row of its dW tile) at the flagship's
# widths: B = 1, 37, 4099 and 5632 (the entity pass's rows), lengths
# 0..10, so most steps' active prefixes end inside a 64-row chunk.  dW and
# db by the backward's rules, both modes.
DW_BATCHES = (1, 37, 4099, 5632)


@pytest.mark.parametrize("B", DW_BATCHES, ids=[f"B{b}" for b in DW_BATCHES])
def test_bf16_backward_at_training_widths_on_card(cuda, B):
    emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _bf16_inputs(B, 512, 512, seed=B + 11))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    _, hs, cs = lstm_kernel._forward(*args, residuals=True)
    got = {"last": lstm_kernel.lstm_last_backward(*args, hs, cs, dlast),
           "every": lstm_kernel.lstm_all_backward(*args, hs, cs, dhs)}
    want = {"last": lstm_kernel.lstm_last_backward_plain(*args, hs, cs, dlast),
            "every": lstm_kernel.lstm_all_backward_plain(*args, hs, cs, dhs)}
    torch.cuda.synchronize()
    share = MAX_UNEQUAL_SHARE_BWD if B >= SHARE_MIN_ROWS else 1.0
    for mode in got:
        (demb, dw_ih, dw_hh, db), w = got[mode], want[mode]
        assert torch.isfinite(dw_ih.float()).all() and torch.isfinite(dw_hh.float()).all(), mode
        assert_bf16_close(demb[act], w[0][act], share)
        assert_bf16_close(dw_ih, w[1], share)
        assert_bf16_close(dw_hh, w[2], share)
        assert (db - w[3]).abs().max().item() <= DB_RTOL * w[3].abs().max().item(), mode


def _dw_operands(B, D, H, L, seed, cuda, dtype=torch.bfloat16):
    """Seeded inputs of the dW launch alone: lengths 0..L sorted descending,
    dg [L, B, 4H], x [L, B, D], hs [L, B, H] (``dtype``) and db_part [L,
    ceil(B / 128), 4H] (f32), with masks of what the launch must not read:
    the rows of dg and x past step t's active prefix, those of hs[t] past
    step t + 1's (hs[L - 1] whole), db_part's row tiles whose first row is
    past it."""
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy()
    nrows = _active(lens, L).sum(1)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))  # noqa: E731
    dg, x, hs = (f(L, B, n).to(dtype).to(cuda) for n in (4 * H, D, H))
    nrb = -(-B // 128)
    db_part = f(L, nrb, 4 * H).to(cuda)
    rows = torch.arange(B, device=cuda)
    past = torch.stack([rows >= int(n) for n in nrows])
    past_h = torch.ones_like(past)
    past_h[:-1] = past[1:]
    tile_past = torch.stack([torch.arange(nrb, device=cuda) * 128 >= int(n) for n in nrows])
    return torch.from_numpy(lens).to(cuda), (dg, x, hs, db_part), (past, past, past_h, tile_past)


# (L, B, D, H); L = 1100: the walk is not bounded by shared memory
DW_ALONE = [(10, 37, 512, 512), (10, 129, 40, 136), (10, 4099, 64, 40), (10, 5632, 512, 512), (1100, 37, 64, 64)]


@pytest.mark.parametrize("L,B,D,H", DW_ALONE, ids=[f"L{n}-B{b}-D{d}-H{h}" for n, b, d, h in DW_ALONE])
def test_bf16_dw_launch_ignores_rows_past_the_active_prefix_on_card(cuda, L, B, D, H):
    """The dW launch alone (``lstm_kernel._launch_dw``, the dW entry of
    ``_bwd_fns()``) with the rows it must not read zero and then NaN (dg and
    hs come from ``torch.empty`` in a backward, so those rows may hold
    anything): the same bits; and dW against f32 products of the active
    rows by the bf16 rule, db against the sum of the active tiles.  The
    narrow widths leave most blocks to db alone; D = 40, H = 136 has tails
    of gate and output columns."""
    lens, ops, masks = _dw_operands(B, D, H, L, B + D + H, cuda)
    n_sm = lstm_kernel._sm_count(cuda.index or 0)
    outs = []
    for fill in (0.0, float("nan")):
        dg, x, hs, db_part = (o.masked_fill(m[..., None], fill) for o, m in zip(ops, masks))
        out = (torch.empty(4 * H, D, dtype=torch.bfloat16, device=cuda),
               torch.empty(4 * H, H, dtype=torch.bfloat16, device=cuda), torch.empty(4 * H, device=cuda))
        lstm_kernel._launch_dw(dg, x, hs, lens, db_part, *out, n_sm, torch.cuda.current_stream().cuda_stream)
        outs.append(out)
    torch.cuda.synchronize()
    for name, a, b in zip(("dW_ih", "dW_hh", "db"), *outs):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits)), name
    dg, x, hs, db_part = (o.masked_fill(m[..., None], 0.0).float() for o, m in zip(ops, masks))
    want_ih = torch.einsum("lbg,lbd->gd", dg, x)
    want_hh = torch.einsum("lbg,lbh->gh", dg[1:], hs[:-1])
    assert_bf16_close(outs[0][0], want_ih.to(torch.bfloat16))
    assert_bf16_close(outs[0][1], want_hh.to(torch.bfloat16))
    want_db = db_part.sum((0, 1))
    assert (outs[0][2] - want_db).abs().max().item() <= DB_RTOL * want_db.abs().max().item()


@pytest.mark.parametrize("every", [False, True], ids=["last-state", "every-state"])
def test_bf16_backward_is_deterministic_on_card(cuda, every):
    """Kernels 2 and 6 (bf16) twice on the same inputs at B = 4099, D = H =
    128, where the dW launch's 8 tiles leave 32 of its blocks to db alone:
    the same bits."""
    B, D = 4099, 128
    emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _bf16_inputs(B, D, D, seed=17))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    _, hs, cs = lstm_kernel._forward(*args, residuals=True)
    fn = lstm_kernel.lstm_all_backward if every else lstm_kernel.lstm_last_backward
    first, second = (fn(*args, hs, cs, dhs if every else dlast) for _ in range(2))
    torch.cuda.synchronize()
    first, second = (first[0][act], *first[1:]), (second[0][act], *second[1:])
    for name, a, b in zip(("demb", "dW_ih", "dW_hh", "db"), first, second):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits)), name


# (L, B, D, H) of the f32 dW launch alone: B < 64, B % 64 != 0 and B > 128,
# D != H both ways, and D = H = 100 (multiples of 4, not of 128: boxes of
# gate and output columns past the edge, and a tile's last box wholly
# past it); L = 1100: a long walk.
F32_DW_ALONE = [(10, 37, 512, 512), (10, 129, 40, 136), (10, 4099, 136, 40), (10, 333, 100, 100),
                (10, 5632, 512, 512), (3, 4099, 100, 100), (1100, 37, 64, 64)]


@pytest.mark.parametrize("L,B,D,H", F32_DW_ALONE, ids=[f"L{n}-B{b}-D{d}-H{h}" for n, b, d, h in F32_DW_ALONE])
def test_f32_dw_launch_ignores_rows_past_the_active_prefix_on_card(cuda, L, B, D, H):
    """The f32 dW launch alone (``lstm_kernel._launch_dw`` on f32 operands:
    3xTF32 wgmma, both operands transposed and split into K-major hi / lo
    tiles in shared memory) with the rows it must not read zero and then
    NaN (dg and hs come from ``torch.empty`` in a backward): the same bits;
    dW against f32 products of the active rows by the f32 rule, db against
    the sum of the active tiles."""
    lens, ops, masks = _dw_operands(B, D, H, L, B + D + H + 1, cuda, torch.float32)
    n_sm = lstm_kernel._sm_count(cuda.index or 0)
    outs = []
    for fill in (0.0, float("nan")):
        dg, x, hs, db_part = (o.masked_fill(m[..., None], fill) for o, m in zip(ops, masks))
        out = (torch.empty(4 * H, D, device=cuda), torch.empty(4 * H, H, device=cuda), torch.empty(4 * H, device=cuda))
        lstm_kernel._launch_dw(dg, x, hs, lens, db_part, *out, n_sm, torch.cuda.current_stream().cuda_stream)
        outs.append(out)
    torch.cuda.synchronize()
    for name, a, b in zip(("dW_ih", "dW_hh", "db"), *outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    dg, x, hs, db_part = (o.masked_fill(m[..., None], 0.0) for o, m in zip(ops, masks))
    assert_f32_close(outs[0][0], torch.einsum("lbg,lbd->gd", dg, x))
    assert_f32_close(outs[0][1], torch.einsum("lbg,lbh->gh", dg[1:], hs[:-1]))
    want_db = db_part.sum((0, 1))
    assert (outs[0][2] - want_db).abs().max().item() <= DB_RTOL * want_db.abs().max().item()


@pytest.mark.parametrize("every", [False, True], ids=["last-state", "every-state"])
def test_f32_backward_is_deterministic_on_card(cuda, every):
    """Kernels 2 and 6 in f32 twice on the same inputs at B = 4099, D = H =
    128 (the dW launch's 8 tiles leave most of its blocks to db alone) and
    at the flagship's D = H = 512 (128 tiles): the same bits."""
    for B, D in ((4099, 128), (5632, 512)):
        emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _f32_inputs(B, D, D, seed=19))
        args = (emb, w_ih, w_hh, bias, lens)
        act = torch.from_numpy(_active(lens.cpu().numpy(), emb.shape[0])).to(cuda)
        _, hs, cs = lstm_kernel._forward(*args, residuals=True)
        fn = lstm_kernel.lstm_all_backward if every else lstm_kernel.lstm_last_backward
        first, second = (fn(*args, hs, cs, dhs if every else dlast) for _ in range(2))
        torch.cuda.synchronize()
        first, second = (first[0][act], *first[1:]), (second[0][act], *second[1:])
        for name, a, b in zip(("demb", "dW_ih", "dW_hh", "db"), first, second):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (B, name)


def _adagrad_state(V, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return f(V, d) * 0.1, f(V, d) * 0.1, f(V, d).abs()


@pytest.mark.parametrize("shape", [(2048, 512), (1234, 512), (2048,), (3, 5)],
                         ids=["lstm-weight", "ragged-1234", "bias", "tiny"])
def test_adagrad_kernel_bit_equal_on_card(cuda, shape):
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak

    V, d = (shape[0], 1) if len(shape) == 1 else shape
    g, p, acc = (x.reshape(shape).to(cuda) for x in _adagrad_state(V, d, seed=V))
    clr = torch.tensor(0.2 / 1.5, device=cuda)
    p2, acc2 = p.clone(), acc.clone()
    before = ak.adagrad_update.launches
    ak.adagrad_update(g, p, acc, clr, 1e-3, 1e-10)
    ak.adagrad_update_plain(g, p2, acc2, clr, 1e-3, 1e-10)
    torch.cuda.synchronize()
    assert ak.adagrad_update.launches == before + 1
    assert torch.equal(acc, acc2) and torch.equal(p, p2)


@pytest.mark.parametrize("V,U,n_valid", [(2048, 512, 300), (1234, 256, 256), (50000, 4096, 3000)],
                         ids=["pad-rows", "all-valid", "relation-table"])
def test_scatter_adagrad_kernel_bit_equal_on_card(cuda, V, U, n_valid):
    """Padding entries duplicate row 0, a real entry, with weight decay on:
    the kernel must leave them out entirely."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sk

    rng = np.random.default_rng(U)
    g_rows, p, acc = _adagrad_state(V, 512, seed=U)
    uids = np.zeros(U, np.int64)
    uids[:n_valid] = np.sort(rng.choice(np.arange(1, V), n_valid - 1, replace=False).tolist() + [0])
    valid = torch.zeros(U, dtype=torch.bool)
    valid[:n_valid] = True
    g_rows, p, acc = g_rows[:U].to(cuda), p.to(cuda), acc.to(cuda)
    uids, valid = torch.from_numpy(uids).to(cuda), valid.to(cuda)
    clr = torch.tensor(0.2, device=cuda)
    p2, acc2 = p.clone(), acc.clone()
    before = sk.scatter_adagrad.launches
    sk.scatter_adagrad(g_rows, uids, valid, p, acc, clr, 1e-2, 1e-10)
    sk.scatter_adagrad_plain(g_rows, uids, valid, p2, acc2, clr, 1e-2, 1e-10)
    torch.cuda.synchronize()
    assert sk.scatter_adagrad.launches == before + 1
    assert torch.equal(acc, acc2) and torch.equal(p, p2)
    assert not torch.equal(p[0], _adagrad_state(V, 512, seed=U)[1][0].to(cuda))  # row 0 was updated


def _unaligned(x):
    """A contiguous copy of ``x`` whose data pointer is 4 bytes past a
    16-byte boundary (the kernels' scalar path)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


# the flagship's dense Adagrad group: per LSTM (entity, relation) W_ih and
# W_hh [2048, 512] and the bias [2048] twice, and the two batchnorms'
# scale and offset [512]
FLAGSHIP_LEAVES = [(2048, 512)] * 4 + [(2048,)] * 4 + [(512,)] * 4


def _dense_group(case, cuda):
    rng = np.random.default_rng(len(case))
    f = lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    if case == "flagship-group":
        shapes, hp = FLAGSHIP_LEAVES, dict(lr=0.2, lr_decay=0.0, weight_decay=1e-10, eps=1e-10)
    elif case == "ragged":
        shapes, hp = [(1234, 512), (7,), (3, 5), (0,), (2048,), (64, 33)], dict(lr=0.2, lr_decay=0.01,
                                                                               weight_decay=1e-2, eps=1e-10)
    else:  # more leaves than one launch takes
        shapes, hp = [(37,)] * 40, dict(lr=0.3, lr_decay=0.01, weight_decay=0.0, eps=1e-10)
    gs, ps, accs = [f(s) * 0.1 for s in shapes], [f(s) * 0.1 for s in shapes], [f(s).abs() for s in shapes]
    if case == "ragged":  # one leaf whose three tensors are not 16-byte aligned
        gs[4], ps[4], accs[4] = (_unaligned(x) for x in (gs[4], ps[4], accs[4]))
    steps = [torch.tensor(float(0 if case == "flagship-group" else 7 * i), device=cuda) for i in range(len(shapes))]
    return gs, ps, accs, steps, hp


@pytest.mark.parametrize("case", ["flagship-group", "ragged", "forty-leaves"])
def test_adagrad_leaves_kernel_bit_equal_on_card(cuda, case):
    """The dense kernel on a whole regime group against its plain twin: p,
    acc and the new steps bit for bit; the given steps unchanged; one launch
    for up to 32 leaves."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak

    gs, ps, accs, steps, hp = _dense_group(case, cuda)
    ps2, accs2 = [p.clone() for p in ps], [a.clone() for a in accs]
    steps0 = [s.clone() for s in steps]
    before = ak.adagrad_update.launches
    new = ak.adagrad_update_leaves(gs, ps, accs, steps, hp)
    want = ak.adagrad_update_leaves_plain(gs, ps2, accs2, steps, hp)
    torch.cuda.synchronize()
    assert ak.adagrad_update.launches == before + -(-len(ps) // ak.MAX_LEAVES)
    for i in range(len(ps)):
        assert torch.equal(ps[i], ps2[i]) and torch.equal(accs[i], accs2[i]), i
        assert torch.equal(new[i], want[i]) and torch.equal(steps[i], steps0[i]), i


def _row_tables(case, cuda):
    rng = np.random.default_rng(len(case))
    if case == "flagship-tables":  # the token tables at OLPBench's vocabulary, d = 512, U = 4096
        spec, hp, uid_dtype = [(200002, 512, 4096, 3900), (50002, 512, 4096, 2100)], dict(
            lr=0.2, lr_decay=0.0, weight_decay=1e-10, eps=1e-10), np.int64
    else:  # a scalar-path width, an unaligned table, int32 uids, weight decay on padding row 0
        spec, hp, uid_dtype = [(1234, 100, 512, 300), (999, 512, 256, 256), (3000, 512, 512, 41)], dict(
            lr=0.2, lr_decay=0.01, weight_decay=1e-2, eps=1e-10), np.int32
    tables = []
    for i, (V, d, U, n) in enumerate(spec):
        g, p, acc = _adagrad_state(V, d, seed=V)
        uids = np.zeros(U, uid_dtype)
        uids[:n] = np.sort(np.concatenate([[0], rng.choice(np.arange(1, V), n - 1, replace=False)]))
        valid = torch.from_numpy(np.arange(U) < n)
        p, acc = p.to(cuda), acc.to(cuda)
        if case == "ragged" and i == 1:
            p, acc = _unaligned(p), _unaligned(acc)
        tables.append((g[:U].contiguous().to(cuda), torch.from_numpy(uids).to(cuda), valid.to(cuda), p, acc,
                       torch.tensor(float(0 if case == "flagship-tables" else 5 * i), device=cuda)))
    return [list(x) for x in zip(*tables)], hp


@pytest.mark.parametrize("case", ["flagship-tables", "ragged"])
def test_scatter_adagrad_tables_kernel_bit_equal_on_card(cuda, case):
    """The row kernel on every table of a group in one launch against its
    plain twin: p, acc and the new steps bit for bit, padding entries (row 0)
    left out, the given steps unchanged."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sk

    (g_rows, uids, valid, ps, accs, steps), hp = _row_tables(case, cuda)
    ps2, accs2 = [p.clone() for p in ps], [a.clone() for a in accs]
    steps0 = [s.clone() for s in steps]
    before = sk.scatter_adagrad.launches
    new = sk.scatter_adagrad_tables(g_rows, uids, valid, ps, accs, steps, hp)
    want = sk.scatter_adagrad_tables_plain(g_rows, uids, valid, ps2, accs2, steps, hp)
    torch.cuda.synchronize()
    assert sk.scatter_adagrad.launches == before + 1
    for i in range(len(ps)):
        assert torch.equal(ps[i], ps2[i]) and torch.equal(accs[i], accs2[i]), i
        assert torch.equal(new[i], want[i]) and torch.equal(steps[i], steps0[i]), i


# ------------------------------------------------ the unfused path and kernels 5-8


def _scan_inputs(B, H, L=10, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))  # noqa: E731
    w_hh = torch.from_numpy(rng.uniform(-1 / np.sqrt(H), 1 / np.sqrt(H), (4 * H, H)).astype(np.float32))
    return f(L, B, 4 * H).to(torch.bfloat16), w_hh.to(torch.bfloat16), f(L, B, H).to(torch.bfloat16)


@pytest.mark.parametrize("B,H", [(333, 128), (1, 512), (37, 512), (4099, 64), (37, 40)],
                         ids=["ragged-333", "one-row", "ragged-37-d512", "ragged-4099", "h40-unit-tail"])
def test_scan_kernels_match_plain_on_card(cuda, B, H):
    """Kernels 7 and 8 (csrc/lstm_scan.cu) against their plain versions:
    hs and cs by the forward's rule, dx_proj by the backward's share; one
    forward launch per step, a gate launch per step and a product launch
    from step 1 on."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.to(cuda) for x in _scan_inputs(B, H, seed=B))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (before[0] + L, before[1] + 2 * L - 1)
    assert_bf16_close(hs, want_hs)
    assert_bf16_close(cs, want_cs)
    assert_bf16_close(dxp, want_dxp, MAX_UNEQUAL_SHARE_BWD)


@pytest.mark.parametrize("H", [104, 512, 520], ids=["H104", "H512", "H520"])
@pytest.mark.parametrize("B", [1, 37, 129, 4099], ids=["B1", "B37", "B129", "B4099"])
def test_bf16_scan_kernels_match_plain_across_tile_edges_on_card(cuda, B, H):
    """Kernels 7 and 8 in bf16 (kernel 1's wgmma loop with D = 0) at the
    edges of their tiles, L = 10: one row (one row tile: 16 unit tiles at
    H = 512), a partial row tile (37), one row past a tile (129), many row
    tiles (4099); H = 104 (a partial 32-unit tile, a 40-wide K tail), 512,
    520 (an 8-unit tile, an 8-wide K tail; and a 128-column product tile of
    8 columns).  Against the plain versions by the bf16 rule, with exact
    launch counts: L forward, 2L - 1 backward."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.to(cuda) for x in _scan_inputs(B, H, seed=B + H))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (before[0] + L, before[1] + 2 * L - 1)
    assert_bf16_close(hs, want_hs)
    assert_bf16_close(cs, want_cs)
    assert_bf16_close(dxp, want_dxp, MAX_UNEQUAL_SHARE_BWD)


@pytest.mark.parametrize("B,H", [(37, 512), (129, 104), (4099, 520), (1, 512)],
                         ids=["B37-H512", "B129-H104", "B4099-H520", "B1-H512"])
def test_bf16_scan_gates_are_kernel_7s_bitwise_on_card(cuda, B, H):
    """Kernel 8's gate launch recomputes kernel 7's f32 pre-activation gates
    bit for bit at every (row, step): both run one function
    (csrc/lstm_scan.cu::scan_gate_tiles: the x_proj seed and kernel 1's
    wgmma loop) on the same tiles and tensor maps; the measuring stores of
    the two are equal as integers."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.to(cuda) for x in _scan_inputs(B, H, seed=H))
    L = x_proj.shape[0]

    class Uncounted:
        launches = 0

    stored = [torch.zeros(L, B, 4 * H, device=cuda) for _ in range(2)]
    hs, cs = sk._launch_forward(x_proj, w_hh, Uncounted, gates=stored[0])
    sk._launch_backward(x_proj, w_hh, hs, cs, dhs, Uncounted, gates=stored[1])
    torch.cuda.synchronize()
    fwd, bwd = stored
    assert Uncounted.launches == 3 * L - 1
    assert torch.isfinite(fwd).all() and fwd.abs().max().item() > 0
    assert torch.equal(fwd.view(torch.int32), bwd.view(torch.int32))
    # at step 0 the gates are x_proj[0] itself (h_0 = 0: no products)
    assert torch.equal(fwd[0], x_proj[0].float())


def _every_state_cotangent(L, B, D, seed):
    """The cotangent of every state, [L, B, D] f32, from the file's seed
    convention (``_train_inputs``: ``seed`` plus a fixed offset)."""
    rng = np.random.default_rng(seed + 200)
    return torch.from_numpy((rng.standard_normal((L, B, D)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("B,D", [(333, 128), (1, 512), (37, 512), (4099, 64), (37, 40)],
                         ids=["ragged-333", "one-row", "ragged-37-d512", "ragged-4099", "d40-unit-tail"])
def test_every_state_kernels_match_plain_on_card(cuda, B, D):
    """Kernels 5 and 6 (the every-state modes of csrc/lstm_last_{fwd,bwd}.cu)
    against their plain versions at the positions each row reaches."""
    emb, w_ih, w_hh, bias, lens, _ = (x.to(cuda) for x in _train_inputs(B, D, seed=B))
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    dhs = (_every_state_cotangent(L, B, D, seed=B).to(cuda) * act[..., None]).to(torch.bfloat16)
    before = (lstm_kernel.lstm_all_forward.launches, lstm_kernel.lstm_all_backward.launches)
    hs, cs = lstm_kernel.lstm_all_forward(emb, w_ih, w_hh, bias, lens)
    got = lstm_kernel.lstm_all_backward(emb, w_ih, w_hh, bias, lens, hs, cs, dhs)
    want_hs, want_cs = lstm_kernel.lstm_all_forward_plain(emb, w_ih, w_hh, bias, lens)
    want = lstm_kernel.lstm_all_backward_plain(emb, w_ih, w_hh, bias, lens, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (lstm_kernel.lstm_all_forward.launches, lstm_kernel.lstm_all_backward.launches) == (
        before[0] + L, before[1] + 2 * L + 1)
    assert_bf16_close(hs[act], want_hs[act])
    assert_bf16_close(cs[act], want_cs[act])
    assert_bf16_close(got[0][act], want[0][act], MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(got[1], want[1], MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(got[2], want[2], MAX_UNEQUAL_SHARE_BWD)
    assert (got[3] - want[3]).abs().max().item() <= DB_RTOL * want[3].abs().max().item()


def test_every_state_backward_is_deterministic_on_card(cuda):
    """Kernel 6 (bf16, every-step mode) twice on the same B = 1, D = 512
    inputs: the same bits each time."""
    B, D = 1, 512
    emb, w_ih, w_hh, bias, lens, _ = (x.to(cuda) for x in _train_inputs(B, D, seed=B))
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    dhs = (_every_state_cotangent(L, B, D, seed=B).to(cuda) * act[..., None]).to(torch.bfloat16)
    hs, cs = lstm_kernel.lstm_all_forward(emb, w_ih, w_hh, bias, lens)
    first = lstm_kernel.lstm_all_backward(emb, w_ih, w_hh, bias, lens, hs, cs, dhs)
    second = lstm_kernel.lstm_all_backward(emb, w_ih, w_hh, bias, lens, hs, cs, dhs)
    torch.cuda.synchronize()
    # demb is defined only at the positions the row reaches
    first, second = (first[0][act], *first[1:]), (second[0][act], *second[1:])
    for name, a, b in zip(("demb", "dW_ih", "dW_hh", "db"), first, second):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits)), name


def test_matmul_f32_on_card(cuda):
    """The unfused path's projection product: bf16 operands, f32 output,
    against the same product of the f32-widened operands."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_scan_kernel import matmul_f32

    rng = np.random.default_rng(1000)
    a = torch.from_numpy(rng.standard_normal((1000, 512)).astype(np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((512, 2048)).astype(np.float32)).to(cuda, torch.bfloat16)
    got = matmul_f32(a, b)
    assert got.dtype == torch.float32
    want = torch.matmul(a.float(), b.float())
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_unfused_autograd_on_card_matches_cpu(cuda):
    """``ops/lstm.py::lstm_forward_tm`` (projection, kernels 7 and 8, dW_hh)
    on the card against the CPU, through the f32 -> bf16 weight cast."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm

    emb, w_ih, w_hh, bias, lens, _ = _train_inputs(96, 64, seed=5)
    dhs = torch.randn(emb.shape[0], 96, 64, generator=torch.Generator().manual_seed(5))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        params = {"w_ih": w_ih.float().to(dev).requires_grad_(), "w_hh": w_hh.float().to(dev).requires_grad_(),
                  "b_ih": bias.to(dev).requires_grad_(), "b_hh": torch.zeros_like(bias).to(dev).requires_grad_()}
        x = emb.float().to(dev).requires_grad_()
        out = port_lstm.lstm_forward_tm(params, x.to(torch.bfloat16))
        (out.float() * dhs.to(dev)).sum().backward()
        grads.append([g.cpu() for g in (out, x.grad, params["w_ih"].grad, params["w_hh"].grad, params["b_ih"].grad)])
    (go, gx, gwi, gwh, gb), (co, cx, cwi, cwh, cb) = grads
    assert_bf16_close(go, co)
    assert_bf16_close(gx, cx, MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(gwi, cwi, MAX_UNEQUAL_SHARE_BWD)
    assert_bf16_close(gwh, cwh, MAX_UNEQUAL_SHARE_BWD)
    assert (gb - cb).abs().max().item() <= DB_RTOL * cb.abs().max().item()


def test_unfused_serving_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """With OKET_DISABLE_LSTM_FUSED set every encode takes the unfused path:
    the cache is encoded through kernel 7, and matches the CPU's."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    monkeypatch.setenv("OKET_DISABLE_LSTM_FUSED", "1")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(tmp_path),
         "--mentions", "600", "--relations", "40", "--triples", "300",
         "--eval-size", "20", "--ent-tokens", "150", "--rel-tokens", "30", "--seed", "6"],
        check=True, capture_output=True, timeout=120,
    )
    meta = load_meta(str(tmp_path), (10, 10))
    model = build_model("LSTMComplexRelationModel", meta, entity_slot_size=128,
                        normalize="batchnorm", dtype="bfloat16", sparse=True, init_std=0.1)
    cpu_vars = model.init(torch.Generator().manual_seed(0))
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}  # noqa: E731
    before = (lstm_kernel.lstm_encode_last_fused.launches, sk.lstm_scan_forward.launches)
    on_card = Predictor(model, to(cpu_vars, cuda))
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_encode_last_fused.launches == before[0]
    assert sk.lstm_scan_forward.launches == before[1] + 10 * -(-meta.entities_size // 32768)
    assert_bf16_close(on_card.cand_emb.cpu(), Predictor(model, cpu_vars).cand_emb)


# ------------------------------------------------------------------ f32 modes

# Every f32 mode against its plain version across the tile edges: 128-row
# and 32-unit gate tiles, 16-wide K tiles (the forward) and 32-wide K stages
# (the 3xTF32 backward), 128-column product and dW tiles, with D != H both
# ways, and D = 132, H = 100 (multiples of 4, not of 32: the backward's unit
# tile and its K tails are crossed).  Held to utils/numerics.py's f32 rule
# (largest difference relative to max|want|).
F32_SHAPES = [(b, d, h) for b in (1, 37, 128, 129, 4099) for d, h in ((128, 256), (256, 128), (132, 100))]
F32_IDS = [f"B{b}-D{d}-H{h}" for b, d, h in F32_SHAPES]


def _f32_inputs(B, D, H, L=10, seed=0):
    """Seeded f32 inputs on the CPU: lengths 0..L sorted descending,
    embeddings, gate-major weights, bias, and a cotangent of every state
    (zero where a row never reaches) and of the last state."""
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(0, L + 1, B).astype(np.int32))[::-1].copy()
    f = lambda *s, sc=0.5: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    u = lambda *s, k: torch.from_numpy(rng.uniform(-k, k, s).astype(np.float32))  # noqa: E731
    act = torch.from_numpy(_active(lens, L))
    emb, w_ih, w_hh = f(L, B, D), u(4 * H, D, k=1 / np.sqrt(D)), u(4 * H, H, k=1 / np.sqrt(H))
    return emb, w_ih, w_hh, u(4 * H, k=2 / np.sqrt(H)), torch.from_numpy(lens), f(L, B, H) * act[..., None], f(B, H)


@pytest.mark.parametrize("B,D,H", F32_SHAPES, ids=F32_IDS)
def test_f32_forward_modes_across_tile_edges_on_card(cuda, B, D, H):
    """Kernels 1 and 5 in f32 (csrc/lstm_last_fwd_f32.cu, 3xTF32): serving
    (last), training (last, hs, cs) and every state (hs, cs); a call is the
    weight split and one launch per step."""
    emb, w_ih, w_hh, bias, lens, _, _ = (x.to(cuda) for x in _f32_inputs(B, D, H, seed=B + D))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    want_last, want_hs, want_cs = lstm_kernel.lstm_encode_last_plain(*args, residuals=True)
    count = lstm_kernel.lstm_encode_last_fused
    before = count.launches
    serve, _, _ = lstm_kernel._launch_steps(*args, False, True, count)
    last, hs, cs = lstm_kernel._launch_steps(*args, True, True, count)
    _, all_hs, all_cs = lstm_kernel._launch_steps(*args, True, False, count)
    torch.cuda.synchronize()
    assert count.launches == before + 3 * (L + 1)
    assert serve.dtype == hs.dtype == torch.float32 and torch.equal(serve, last)
    assert_f32_close(last, want_last)
    for got_hs, got_cs in ((hs, cs), (all_hs, all_cs)):
        assert_f32_close(got_hs[act], want_hs[act])
        assert_f32_close(got_cs[act], want_cs[act])


@pytest.mark.parametrize("mode", ["kernel1", "kernel5"])
def test_f32_forward_1xtf32_variant_fails_the_f32_rule_on_card(cuda, mode):
    """The f32 forward's planted 1xTF32 variant (hi·hi' alone, one TF32
    product per product) must fail the f32 rule on some output at D = H =
    512 where the kernel (3xTF32) passes it, in the training mode of kernel
    1 (last, hs, cs) and the every-state mode of kernel 5 (hs, cs)."""
    emb, w_ih, w_hh, bias, lens, _, _ = (x.to(cuda) for x in _f32_inputs(512, 512, 512, seed=13))
    args = (emb, w_ih, w_hh, bias, lens)
    act = torch.from_numpy(_active(lens.cpu().numpy(), emb.shape[0])).to(cuda)
    want = lstm_kernel.lstm_encode_last_plain(*args, residuals=True)
    with_last = mode == "kernel1"

    class Uncounted:
        launches = 0

    ok = {}
    for v in ("kernel", "1xTF32"):
        last, hs, cs = lstm_kernel._launch_steps(*args, True, with_last, Uncounted, variant=v)
        got = ([(last, want[0])] if with_last else []) + [(hs[act], want[1][act]), (cs[act], want[2][act])]
        ok[v] = [f32_agreement(g, w).ok() for g, w in got]
    torch.cuda.synchronize()
    assert Uncounted.launches == 2 * (emb.shape[0] + 1)
    assert all(ok["kernel"]) and not all(ok["1xTF32"]), ok


def test_f32_forward_serving_and_training_paths_give_equal_last_on_card(cuda):
    """Serving's two-slot h buffer (fresh each call, its tensor maps looked up
    by base) and training's hs residual as the h buffer give the same last
    state bit for bit at B = 4099, call after call; each public call is
    L + 1 launches (the weight split, then one per step)."""
    emb, w_ih, w_hh, bias, lens, _, _ = (x.to(cuda) for x in _f32_inputs(4099, 512, 512, seed=17))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    count = lstm_kernel.lstm_encode_last_fused
    before = count.launches
    serve = [lstm_kernel.lstm_encode_last_fused(*args) for _ in range(2)]
    assert count.launches == before + 2 * (L + 1)
    train, _, _ = lstm_kernel._forward(*args, residuals=True)
    every = lstm_kernel.lstm_all_forward
    before_all = every.launches
    hs, _ = every(*args)
    torch.cuda.synchronize()
    assert every.launches == before_all + L + 1
    assert torch.equal(serve[0], serve[1]) and torch.equal(serve[0], train)
    rows = torch.arange(emb.shape[1], device=cuda)
    assert torch.equal(hs[lens.clamp(min=1).long() - 1, rows], train)
    assert_f32_close(train, lstm_kernel.lstm_encode_last_plain(*args))


@pytest.mark.parametrize("B,D,H", F32_SHAPES, ids=F32_IDS)
def test_f32_backward_modes_across_tile_edges_on_card(cuda, B, D, H):
    """Kernels 2 and 6 in f32 (the 3xTF32 *_f32 entries of
    csrc/lstm_last_bwd.cu) on kernel 1's f32 residuals: demb at the
    positions each row reaches, dW, db; 2L + 2 launches each (the weight
    split, a gate and a product launch per step, dW and db)."""
    emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _f32_inputs(B, D, H, seed=B + H))
    args = (emb, w_ih, w_hh, bias, lens)
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    _, hs, cs = lstm_kernel._forward(*args, residuals=True)
    before = (lstm_kernel.lstm_last_backward.launches, lstm_kernel.lstm_all_backward.launches)
    got = {"last": lstm_kernel.lstm_last_backward(*args, hs, cs, dlast),
           "every": lstm_kernel.lstm_all_backward(*args, hs, cs, dhs)}
    want = {"last": lstm_kernel.lstm_last_backward_plain(*args, hs, cs, dlast),
            "every": lstm_kernel.lstm_all_backward_plain(*args, hs, cs, dhs)}
    torch.cuda.synchronize()
    assert (lstm_kernel.lstm_last_backward.launches, lstm_kernel.lstm_all_backward.launches) == (
        before[0] + 2 * L + 2, before[1] + 2 * L + 2)
    for mode in got:
        g, w = got[mode], want[mode]
        assert all(x.dtype == torch.float32 for x in g)
        assert_f32_close(g[0][act], w[0][act])
        for i in (1, 2, 3):
            assert_f32_close(g[i], w[i])


@pytest.mark.parametrize("every_step", [False, True], ids=["kernel2", "kernel6"])
def test_f32_backward_1xtf32_variant_fails_the_f32_rule_on_card(cuda, every_step):
    """The backward's planted 1xTF32 variant (hi·hi' alone, one TF32
    product per product) must fail the f32 rule on some output where the
    kernel (3xTF32) passes it: the rule sees the correction products."""
    emb, w_ih, w_hh, bias, lens, dhs, dlast = (x.to(cuda) for x in _f32_inputs(512, 512, 512, seed=11))
    args = (emb, w_ih, w_hh, bias, lens)
    act = torch.from_numpy(_active(lens.cpu().numpy(), emb.shape[0])).to(cuda)
    _, hs, cs = lstm_kernel._forward(*args, residuals=True)
    cot = dhs if every_step else dlast
    plain = lstm_kernel.lstm_all_backward_plain if every_step else lstm_kernel.lstm_last_backward_plain
    want = plain(*args, hs, cs, cot)

    class Uncounted:
        launches = 0

    run = {v: lstm_kernel._launch_bwd_steps(*args, hs, cs, cot, every_step, Uncounted, variant=v)
           for v in ("kernel", "1xTF32")}
    torch.cuda.synchronize()
    assert Uncounted.launches == 2 * (2 * emb.shape[0] + 2)
    ok = {}
    for v, got in run.items():
        ok[v] = [f32_agreement(g[act] if i == 0 else g, w[act] if i == 0 else w).ok()
                 for i, (g, w) in enumerate(zip(got, want))]
    assert all(ok["kernel"]) and not all(ok["1xTF32"]), ok


@pytest.mark.parametrize("B,H", [(b, h) for b in (1, 37, 128, 129, 4099) for h in (128, 256)],
                         ids=[f"B{b}-H{h}" for b in (1, 37, 128, 129, 4099) for h in (128, 256)])
def test_f32_scan_kernels_across_tile_edges_on_card(cuda, B, H):
    """Kernels 7 and 8 in f32 (the 3xTF32 *_f32 entries of
    csrc/lstm_scan.cu): L + 1 forward launches, 2L backward launches (the
    weight split, then L steps; the split, L gate and L - 1 product
    launches)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(cuda) for x in _scan_inputs(B, H, seed=B + H))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (before[0] + L + 1, before[1] + 2 * L)
    assert hs.dtype == dxp.dtype == torch.float32
    assert_f32_close(hs, want_hs)
    assert_f32_close(cs, want_cs)
    assert_f32_close(dxp, want_dxp)


@pytest.mark.parametrize("B,H", [(37, 512), (129, 100), (4099, 256), (1, 512)],
                         ids=["B37-H512", "B129-H100", "B4099-H256", "B1-H512"])
def test_f32_scan_gates_are_kernel_7s_bitwise_on_card(cuda, B, H):
    """At f32 too, kernel 8's gate launch recomputes kernel 7's f32
    pre-activation gates bit for bit at every (row, step): both run one
    function (the tf32:: scan_gate_tiles of csrc/lstm_scan.cu: the 3xTF32
    loop from zero, then x_proj) on the same tiles and tensor maps; each
    call is 3L + 1 launches with its two weight splits."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(cuda) for x in _scan_inputs(B, H, seed=H + 1))
    L = x_proj.shape[0]

    class Uncounted:
        launches = 0

    stored = [torch.zeros(L, B, 4 * H, device=cuda) for _ in range(2)]
    hs, cs = sk._launch_forward(x_proj, w_hh, Uncounted, gates=stored[0])
    dxp = sk._launch_backward(x_proj, w_hh, hs, cs, dhs, Uncounted, gates=stored[1])
    torch.cuda.synchronize()
    fwd, bwd = stored
    assert Uncounted.launches == 3 * L + 1
    assert torch.isfinite(fwd).all() and fwd.abs().max().item() > 0
    assert torch.equal(fwd.view(torch.int32), bwd.view(torch.int32))
    # at step 0 the gates are x_proj[0] itself (h_0 = 0: no products)
    assert torch.equal(fwd[0], x_proj[0])
    # the storing launches compute the recurrence
    assert_f32_close(hs, sk.lstm_scan_forward_plain(x_proj, w_hh)[0])
    assert_f32_close(dxp, sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs))


@pytest.mark.parametrize("B", [5632, 4099])
def test_f32_scan_1xtf32_variant_fails_the_f32_rule_on_card(cuda, B):
    """The planted 1xTF32 variant of kernels 7 and 8 (hi·hi' alone, one TF32
    product per product), run as the unfused LSTM runs the pair (kernel 8's
    variant on kernel 7's variant's residuals, with a cotangent of the last
    state, as the unfused path's last-state select sends it), fails the f32
    rule at H = 512 where the kernels (3xTF32) pass it: on hs or cs.  Kernel
    8's variant alone, on the plain residuals, reads at least ten times the
    kernel's error on dx_proj (within the rule at these weights)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(cuda) for x in _scan_inputs(B, 512, seed=B))
    dhs[:-1] = 0.0
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)

    class Uncounted:
        launches = 0

    ok, alone = {}, {}
    for v in ("kernel", "1xTF32"):
        got_hs, got_cs = sk._launch_forward(x_proj, w_hh, Uncounted, variant=v)
        pair = sk._launch_backward(x_proj, w_hh, got_hs, got_cs, dhs, Uncounted, variant=v)
        ok[v] = (f32_agreement(got_hs, hs).ok() and f32_agreement(got_cs, cs).ok(),
                 f32_agreement(pair, want_dxp).ok())
        alone[v] = f32_agreement(sk._launch_backward(x_proj, w_hh, hs, cs, dhs, Uncounted, variant=v), want_dxp)
    torch.cuda.synchronize()
    assert Uncounted.launches == 2 * (11 + 2 * 20)
    assert ok["kernel"] == (True, True) and not ok["1xTF32"][0], ok
    assert alone["kernel"].ok() and alone["1xTF32"].rel_err >= 10 * alone["kernel"].rel_err, alone


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [100, 37])
def test_scan_kernels_take_any_h_on_card(cuda, dtype, H):
    """Kernels 7 and 8 at an H the kernels' tiles do not divide: the
    wrappers pad H per gate block and launch the kernels (no plain
    fallback), against the plain version at the same H; L and 2L - 1
    launches in bf16, L + 1 and 2L in f32 (the weight split)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(dtype).to(cuda) for x in _scan_inputs(37, H, seed=H))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    split = 1 if dtype == torch.float32 else 0
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (
        before[0] + L + split, before[1] + 2 * L - 1 + split)
    assert tuple(hs.shape) == (L, 37, H) and tuple(dxp.shape) == (L, 37, 4 * H)
    if dtype == torch.bfloat16:
        assert_bf16_close(hs, want_hs)
        assert_bf16_close(cs, want_cs)
        assert_bf16_close(dxp, want_dxp, MAX_UNEQUAL_SHARE_BWD)
    else:
        for got, want in ((hs, want_hs), (cs, want_cs), (dxp, want_dxp)):
            assert_f32_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_unfused_any_h_autograd_on_card_matches_cpu(cuda, dtype):
    """``ops/lstm.py::lstm_forward_tm`` at H = 100 (D = 64) on the card
    (projection, kernels 7 and 8 through the padded route) against the CPU,
    value and every gradient."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm

    rng = np.random.default_rng(7)
    D, H, L, B = 64, 100, 10, 37
    init = {"w_ih": (4 * H, D), "w_hh": (4 * H, H), "b_ih": (4 * H,), "b_hh": (4 * H,)}
    params = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32) for n, s in init.items()}
    x = (rng.standard_normal((L, B, D)) * 0.5).astype(np.float32)
    dhs = (rng.standard_normal((L, B, H)) * 0.5).astype(np.float32)
    res = []
    for dev in (cuda, torch.device("cpu")):
        p = {n: torch.from_numpy(v).to(dev).requires_grad_() for n, v in params.items()}
        px = torch.from_numpy(x).to(dev).requires_grad_()
        out = port_lstm.lstm_forward_tm(p, px.to(dtype))
        (out.float() * torch.from_numpy(dhs).to(dev)).sum().backward()
        res.append([t.detach().cpu() for t in (out, px.grad, *(p[n].grad for n in init))])
    for i, (got, want) in enumerate(zip(*res)):
        if dtype == torch.float32:
            assert_f32_close(got, want)
        elif i == 0:
            assert_bf16_close(got, want)
        else:
            # the unfused db is an f32 sum of the bf16 dx_proj, so a dgate
            # flipped by one bf16 ulp moves it by that ulp (2^-9 at max|db|
            # 14.8 on an H100): held by the bf16 rule like dx and dW
            assert_bf16_close(got.to(dtype), want.to(dtype), MAX_UNEQUAL_SHARE_BWD)


def test_f32_autograd_on_card_matches_cpu(cuda):
    """The fused autograd Function at f32 on the card (kernels 1 and 2)
    against the CPU (plain versions)."""
    emb, w_ih, w_hh, bias, lens, _, dlast = _f32_inputs(96, 128, 128, seed=3)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_() for x in (emb, w_ih, w_hh, bias)]
        last = lstm_kernel.lstm_encode_last_fused(*leaves, lens.to(dev))
        (last * dlast.to(dev)).sum().backward()
        grads.append([last.detach().cpu()] + [x.grad.cpu() for x in leaves])
    act = torch.from_numpy(_active(lens.numpy(), emb.shape[0]))
    (g_last, gx, gwi, gwh, gb), (c_last, cx, cwi, cwh, cb) = grads
    assert_f32_close(g_last, c_last)
    assert_f32_close(gx[act], cx[act])
    for got, want in ((gwi, cwi), (gwh, cwh), (gb, cb)):
        assert_f32_close(got, want)


def _eval_case(seed, B, N, d, exact):
    """An eval batch on the CPU: q [B, d] and candidates [N, d] (multiples
    of 1/8, so every f32 score is exact in any order, or standard normal),
    candidate 3 duplicated at 7, 11 and N - 1 (exact ties, the last in
    another chunk), 1-2 golds a row with 1-2 mention columns, a gold on
    column 3, 5 % filter cells, every gold's mentions filtered."""
    rng = np.random.default_rng(seed)
    draw = (lambda s: rng.integers(-16, 17, s).astype(np.float32) / 8) if exact else (
        lambda s: rng.standard_normal(s).astype(np.float32))
    q, cand = draw((B, d)), draw((N, d))
    cand[[7, 11, N - 1]] = cand[3]
    fmask = rng.random((B, N)) < 0.05
    g_rows, g_ments = [0], [np.array([3])]
    for b in range(B):
        for _ in range(int(rng.integers(1, 3))):
            g_rows.append(b)
            g_ments.append(rng.choice(N, int(rng.integers(1, 3)), replace=False))
    for r, m in zip(g_rows, g_ments):
        fmask[r, m] = True
    fr, fc = np.nonzero(fmask)
    gm = np.full((len(g_rows), 2), -1, np.int32)
    for i, m in enumerate(g_ments):
        gm[i, : len(m)] = m
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    golds = (t(fr.astype(np.int32)), t(fc.astype(np.int32)), t(np.array(g_rows, np.int32)), t(gm))
    pos = (t(np.zeros(1, np.int32)), t(np.array([3], np.int32)), t(np.ones(B, bool)))
    return t(q), t(cand), pos, golds


@pytest.mark.parametrize("exact", [True, False], ids=["engineered-ties", "inexact-ties"])
@pytest.mark.parametrize("chunk", [512, 700])
def test_chunked_eval_ranks_equal_dense_on_card(cuda, exact, chunk):
    """eval_stats_chunked on the card (the [Gv, C] gold-row products of
    chunks that do and do not divide N) against the dense formulation (one
    [B, N] product, ranks_from_scores): equal ranks.  Exact inputs at
    d = 512 show that the two formulations count the same cells; inexact
    ones (d = 64, N = 2048: ~1e-6 between two products of one score, far
    below the gaps between distinct candidates) that exact ties, duplicated
    rows as identical mentions make them, stay ties in each."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates
    from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import eval_stats_chunked, ranks_from_scores

    d = 512 if exact else 64
    q, cand, pos, golds = _eval_case(11, 48, 2048, d, exact)
    q, cand = q.to(cuda), cand.to(cuda)
    pos, golds = [x.to(cuda) for x in pos], [x.to(cuda) for x in golds]
    n_real = torch.tensor(2048.0, device=cuda)
    dense, valid = ranks_from_scores(score_against_candidates(q, cand), *golds, None)
    _, ranks, valid_c = eval_stats_chunked(q, cand, *pos, None, n_real, *golds, chunk=chunk)
    assert torch.equal(valid_c, valid) and bool(valid.all())
    assert torch.equal(ranks, dense)


# ------------------------------------------------------------- model families

FAMILY_CONFIGS = {
    "LookupComplexRelationModel": dict(batch_norm=True),
    "LookupDistmultRelationModel": dict(normalize="norm"),
    "LookupTucker3RelationModel": dict(entity_slot_size=32, relation_slot_size=64),
    "UnigramPoolingComplexRelationModel": dict(normalize="batchnorm"),
    "BigramPoolingComplexRelationModel": dict(normalize="batchnorm", gates=True),
    "LSTMComplexRelationModel": dict(normalize="batchnorm"),
    "LSTMDistmultRelationModel": dict(normalize="batchnorm"),
    "LSTMTucker3RelationModel": dict(normalize="batchnorm"),
    "DataBiasOnlyEntityModel": dict(normalize="batchnorm"),
    "DataBiasOnlyRelationModel": dict(normalize="batchnorm"),
}


@pytest.mark.parametrize("name", sorted(FAMILY_CONFIGS))
def test_family_steps_on_card_match_cpu(cuda, tmp_path, name):
    """Each registry name, f32 at d = 128 (the LSTM's fused kernels): three
    dense SGD steps (lr 0.1, no Adagrad sign flips of f32 noise) on the card
    against the same steps on the CPU from the same weights, full-vocabulary
    batches of 64: the losses (rtol 1e-4); the first step's update of every
    parameter (-lr g) to 1e-4 of the leaf's largest (a gradient through the
    LSTM sums every row and step) plus 1e-6 of the model's largest update
    (a Tucker3 relation's first batchnorm bias has a zero gradient in exact
    arithmetic: f32 noise) plus one f32 ulp of the new parameter (p - lr g
    rounds to the parameter's ulp: a 2^-30 flip at |p| ~ 0.01 is 1.9e-4 of
    a 4.9e-6 update); the running variances by the f32 rule and the running
    means to 1e-5 of their batchnorm's largest standard deviation (a mean
    of batchnormed inputs is zero up to f32 noise); then the eval-mode
    queries of the trained weights by the f32 rule."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes, leaves
    from open_knowledge_graph_embeddings_tpu_torch.train.step import (
        arrays_to_device,
        make_train_step,
        train_batch_to_arrays,
    )

    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(tmp_path),
         "--mentions", "600", "--relations", "40", "--triples", "300",
         "--eval-size", "20", "--ent-tokens", "150", "--rel-tokens", "30", "--seed", "7"],
        check=True, capture_output=True, timeout=120,
    )
    ds = OneToNMentionRelationDataset(dataset_dir=str(tmp_path), input_file="train.txt", is_training_data=True,
                                      batch_size=64, use_batch_shared_entities=False)
    model = build_model(name, ds.meta, **{"entity_slot_size": 128, "init_std": 0.1, **FAMILY_CONFIGS[name]})
    init = model.init(torch.Generator().manual_seed(0))
    to = lambda tree, dev: {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}  # noqa: E731
    batches = list(BatchBuilder(ds, seed=1).batches(shuffle=True))[:3]
    assert len(batches) == 3
    runs = []
    init_flat = dict(leaves({"p": init["params"], "s": init["state"]}))
    for dev in (cuda, torch.device("cpu")):
        v = to(init, dev)
        v = {**v, "params": {k: _clone(x) for k, x in v["params"].items()}}
        reg = OptimizerRegimes({"optimizer": "SGD", "lr": 0.1})
        reg.update(1, 0)
        step = make_train_step(model, reg, v["params"])
        opt = reg.init_state(v["params"])
        losses, first = [], None
        for b in batches:
            v, opt, stats = step(v, opt, reg.hparams(), arrays_to_device(train_batch_to_arrays(b), dev))
            losses.append(float(stats["loss_sum"]))
            if first is None:
                first = {k: x.detach().cpu().clone() for k, x in leaves({"p": v["params"], "s": v["state"]})}
        runs.append((losses, first, v))
    card, cpu = runs
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
    update = {k: cpu[1][k] - init_flat[k] for k in cpu[1] if k.startswith("p/")}
    top = max(float(u.abs().max()) for u in update.values())
    for k, want in update.items():
        got, m = card[1][k] - init_flat[k], float(want.abs().max())
        ulp = torch.from_numpy(np.spacing(cpu[1][k].abs().numpy()))
        excess = (got - want).abs() - (1e-4 * m + 1e-6 * top + ulp)
        assert float(excess.max()) <= 0, (k, float((got - want).abs().max()), float(excess.max()))
    for k, want in cpu[1].items():
        if k.endswith("/mean"):
            std = float(cpu[1][k.removesuffix("mean") + "var"].max()) ** 0.5
            assert float((card[1][k] - want).abs().max()) <= 1e-5 * std, k
        elif k.startswith("s/"):
            assert f32_agreement(card[1][k], want).ok(), (k, f32_agreement(card[1][k], want))
    rng = np.random.default_rng(2)
    ids = [torch.from_numpy(rng.integers(2, n, 64)) for n in (ds.meta.entities_size, ds.meta.relations_size)]
    is_sp = torch.from_numpy(rng.integers(0, 2, 64).astype(bool))
    q_card = model.queries(card[2], ids[0].to(cuda), ids[1].to(cuda), is_sp.to(cuda))[0]
    q_cpu = model.queries(cpu[2], *ids, is_sp)[0]
    assert_f32_close(q_card.cpu(), q_cpu)


def _clone(x):
    return {k: _clone(v) for k, v in x.items()} if isinstance(x, dict) else x.clone()


# ---------------------------------------------------------- multi-step dispatch

SCAN_CASES = {
    # (model, its config, dtype, batch-shared candidates, sparse tables)
    "lookup-dense-f32": ("LookupComplexRelationModel", dict(batch_norm=True), "float32", False),
    "lstm-sparse-bf16": ("LSTMComplexRelationModel", dict(normalize="batchnorm", dropout=0.1, sparse=True),
                         "bfloat16", True),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_graphed_window_equals_eager_steps_on_card(cuda, tmp_path, case):
    """``make_scanned_step`` on the card: a window's first call runs its K
    steps eagerly, its second captures them into one CUDA graph and replays
    it.  From the same state and generator state, the replayed window and
    the K steps run eagerly: the first loss bit for bit (the forward has no
    atomics; dropout draws the same masks), every loss within 1e-3, the
    state after the window within 2^-6 of each leaf's largest (the
    backward's atomic adds differ run to run), the generator in the same
    state; and the graph wrote the caller's own tensors."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes, leaves
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
    from open_knowledge_graph_embeddings_tpu_torch.train.step import (
        PackedWindow,
        make_scanned_step,
        make_train_step,
        train_batch_to_arrays,
        window_views,
    )

    name, cfg, dtype, shared = SCAN_CASES[case]
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(tmp_path),
         "--mentions", "600", "--relations", "40", "--triples", "600",
         "--eval-size", "20", "--ent-tokens", "150", "--rel-tokens", "30", "--seed", "7"],
        check=True, capture_output=True, timeout=120,
    )
    ds = OneToNMentionRelationDataset(dataset_dir=str(tmp_path), input_file="train.txt", is_training_data=True,
                                      batch_size=64, use_batch_shared_entities=shared, min_size_batch_labels=128)
    model = build_model(name, ds.meta, **{"entity_slot_size": 128, "init_std": 0.1, "dtype": dtype, **cfg})
    v = model.init(torch.Generator(device=cuda).manual_seed(0))
    reg = OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.2})
    reg.update(1, 0)
    opt = reg.init_state(v["params"])
    if shared:
        plan = SparsePlanBuilder(model.embedder, True, min_rows_ratio=0.0)
        step, to_arrays = make_sparse_train_step(model, reg, v["params"], True), plan
    else:
        step, to_arrays = make_train_step(model, reg, v["params"]), train_batch_to_arrays
    arrays = [to_arrays(b) for b in BatchBuilder(ds, seed=1).batches(shuffle=True)]
    K = 3
    sig = lambda a: sorted((n, np.shape(x)) for n, x in a.items())  # noqa: E731
    window = [a for a in arrays if sig(a) == sig(arrays[0])][:K]
    assert len(window) == K
    packed = PackedWindow(window, pin=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    scanned = make_scanned_step(step, K)
    scanned(v, opt, reg.hparams(), packed, gen)  # a signature's first window: eager
    state = dict(leaves({"v": {"p": v["params"], "s": v["state"]}, "o": opt}))
    before = {k: t.clone() for k, t in state.items()}
    gen_before = gen.get_state()
    out_v, out_o, stats = scanned(v, opt, reg.hparams(), packed, gen)  # captured and replayed
    assert scanned.captures == 1 and scanned.replays == 1 and out_v is v and out_o is opt
    graphed = {k: t.clone() for k, t in state.items()}
    gen_after = gen.get_state()
    for k, t in state.items():
        t.copy_(before[k])
    gen.set_state(gen_before)
    views = window_views(packed.host.to(cuda), packed.layout)
    eager = [scanned.single(v, opt, reg.hparams(), {n: x[i] for n, x in views.items()}, gen)[2]["loss_sum"]
             for i in range(K)]
    assert torch.equal(gen.get_state(), gen_after)
    assert stats["loss_sum"][0].item() == eager[0].item()
    np.testing.assert_allclose(stats["loss_sum"].cpu().numpy(), torch.stack(eager).cpu().numpy(), rtol=1e-3)
    for k, t in state.items():
        top = float(t.abs().max()) if t.numel() else 0.0
        assert float((graphed[k] - t).abs().max() if t.numel() else 0.0) <= 2 ** -6 * top + 1e-30, k
