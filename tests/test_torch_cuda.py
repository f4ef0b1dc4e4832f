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


@pytest.mark.parametrize("B,D", [(333, 128), (1, 512), (37, 512), (4099, 64), (37, 40)],
                         ids=["ragged-333", "one-row", "ragged-37-d512", "ragged-4099", "d40-unit-tail"])
def test_every_state_kernels_match_plain_on_card(cuda, B, D):
    """Kernels 5 and 6 (the every-state modes of csrc/lstm_last_{fwd,bwd}.cu)
    against their plain versions at the positions each row reaches."""
    emb, w_ih, w_hh, bias, lens, _ = (x.to(cuda) for x in _train_inputs(B, D, seed=B))
    L = emb.shape[0]
    act = torch.from_numpy(_active(lens.cpu().numpy(), L)).to(cuda)
    dhs = (torch.randn(L, B, D, device=cuda) * 0.5 * act[..., None]).to(torch.bfloat16)
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


def test_matmul_f32_on_card(cuda):
    """The unfused path's projection product: bf16 operands, f32 output,
    against the same product of the f32-widened operands."""
    from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_scan_kernel import matmul_f32

    a = torch.randn(1000, 512, device=cuda).to(torch.bfloat16)
    b = torch.randn(512, 2048, device=cuda).to(torch.bfloat16)
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
    """Kernels 1 and 5 in f32 (csrc/lstm_last_fwd_f32.cu): serving (last),
    training (last, hs, cs) and every state (hs, cs), one launch per step."""
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
    assert count.launches == before + 3 * L
    assert serve.dtype == hs.dtype == torch.float32 and torch.equal(serve, last)
    assert_f32_close(last, want_last)
    for got_hs, got_cs in ((hs, cs), (all_hs, all_cs)):
        assert_f32_close(got_hs[act], want_hs[act])
        assert_f32_close(got_cs[act], want_cs[act])


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
    """Kernels 7 and 8 in f32 (the *_f32 entries of csrc/lstm_scan.cu):
    L forward launches, 2L - 1 backward launches."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(cuda) for x in _scan_inputs(B, H, seed=B + H))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (before[0] + L, before[1] + 2 * L - 1)
    assert hs.dtype == dxp.dtype == torch.float32
    assert_f32_close(hs, want_hs)
    assert_f32_close(cs, want_cs)
    assert_f32_close(dxp, want_dxp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [100, 37])
def test_scan_kernels_take_any_h_on_card(cuda, dtype, H):
    """Kernels 7 and 8 at an H the kernels' tiles do not divide: the
    wrappers pad H per gate block and launch the kernels (no plain
    fallback), against the plain version at the same H."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh, dhs = (x.float().to(dtype).to(cuda) for x in _scan_inputs(37, H, seed=H))
    L = x_proj.shape[0]
    before = (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches)
    hs, cs = sk.lstm_scan_forward(x_proj, w_hh)
    dxp = sk.lstm_scan_backward(x_proj, w_hh, hs, cs, dhs)
    want_hs, want_cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    want_dxp = sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs)
    torch.cuda.synchronize()
    assert (sk.lstm_scan_forward.launches, sk.lstm_scan_backward.launches) == (before[0] + L, before[1] + 2 * L - 1)
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
