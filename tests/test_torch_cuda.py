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
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE_BWD, assert_bf16_close

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


def test_kernel_refuses_what_it_does_not_take(cuda):
    emb, w_ih, w_hh, bias, lens = (x.to(cuda) for x in _inputs(8, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_kernel.lstm_encode_last_fused(emb.float(), w_ih.float(), w_hh.float(), bias, lens)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_kernel.lstm_encode_last_fused(emb.transpose(0, 1).contiguous().transpose(0, 1),
                                           w_ih, w_hh, bias, lens)
    with pytest.raises(ValueError, match="one device"):
        lstm_kernel.lstm_encode_last_fused(emb, w_ih, w_hh, bias, lens.cpu())
    e, wi, wh, b, ln = (x.to(cuda) for x in _inputs(8, 100))
    with pytest.raises(ValueError, match="divisible by 8"):
        lstm_kernel.lstm_encode_last_fused(e, wi, wh, b, ln)


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
