"""The port's choice between the fused and the unfused LSTM, and its unfused
path, against the JAX package on the CPU.

The JAX package runs the fused length-aware kernels only on a TPU and only
where ``ops/lstm.py::lstm_fused_supported`` allows (D, H % 128 == 0, B % 8
== 0, neither ``OKET_DISABLE_LSTM_FUSED`` nor ``OKET_DISABLE_PALLAS`` set);
elsewhere it projects the inputs, rounds the projection to the compute dtype
and runs the recurrence over every step.  The port applies that rule on
every device.  Single queries (B = 1), ragged batches and the
``OKET_DISABLE_LSTM_FUSED`` switch therefore take the unfused path, whose
bf16 results differ from the fused path's in tens of percent of the
elements.

Tolerances: bf16 results by utils/numerics.py's rule, at most 4 bf16 ulps of
max|want| and at most 2 % of elements not bit-equal (measured: bit-equal at
B = 1, <= 0.08 % at B = 37 and for the cache; the fused path in their place
reads 43-50 % of the query vectors' elements unequal).  f32
steps: as tests/test_torch_train_step.py, the losses to rtol 1e-5 and every
parameter, batchnorm statistic and optimizer leaf after SGD to rtol 2e-5 and
atol 2e-5 after one step, 1e-4 after three (measured 2.5e-5 on one of the
128 batchnorm momentum entries: the unfused path needs d=128, where the same
steps amplify f32 summation noise more than at tests/test_torch_train_step.py's
d=32).  The bf16 steps are not compared at d=128: there even the fused path,
which tests/test_torch_train_step.py holds at d=32 (<= 0.8 % unequal), reads
27-75 % of the first updates unequal (at most 2 bf16 ulps) against the JAX
package, so a whole bf16 step at that width is no test of either path; the
unfused path's bf16 gradients are held kernel by kernel in
tests/test_torch_lstm_scan.py.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import open_knowledge_graph_embeddings_tpu.ops.pallas.lstm_kernel as jax_kernels
import open_knowledge_graph_embeddings_tpu_torch.models.embedders as port_embedders
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.ops import lstm as jax_lstm
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.ops import lstm as port_lstm
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import MAX_UNEQUAL_SHARE, bf16_agreement

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

ROOT = pathlib.Path(__file__).resolve().parents[1]
D = 128
SWITCHES = ("OKET_DISABLE_LSTM_FUSED", "OKET_DISABLE_PALLAS")


def _shape_rule(B, L, H):
    """``pallas_supported`` as on a TPU: its shape test alone."""
    return H % 128 == 0 and jax_kernels._pick_tile(B) >= 8


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_unfused")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d),
         "--mentions", "300", "--relations", "30", "--triples", "400",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "2"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------------- the choice


@pytest.mark.parametrize("switch", [None, *SWITCHES])
def test_path_choice_matches_jax(monkeypatch, switch):
    """``lstm_fused_supported`` of both packages, the JAX package's as it
    decides on a TPU, over widths and batch sizes, with each switch."""
    if switch:
        monkeypatch.setenv(switch, "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    seen = set()
    for B in (1, 7, 8, 37, 96, 100, 304, 4096, 5632, 32768):
        for D_, H in ((128, 128), (512, 512), (32, 32), (128, 64), (100, 128), (384, 256)):
            want = jax_lstm.lstm_fused_supported(B, 10, D_, H)
            assert port_lstm.lstm_fused_supported(B, 10, D_, H) == want, (B, D_, H)
            seen.add(want)
    assert seen == ({False} if switch else {True, False})


# ------------------------------------------------------------- serving


def _models(dataset_dir, dtype="bfloat16"):
    cfg = dict(entity_slot_size=D, normalize="batchnorm", dtype=dtype, sparse=True, init_std=0.1)
    jmeta = jax_load_meta(dataset_dir, (10, 10), cache_dir=dataset_dir + "/jax_cache")
    jmodel = jax_build_model("LSTMComplexRelationModel", jmeta, **cfg)
    jv = jmodel.init(jax.random.key(0))
    arrays = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}
    meta = load_meta(dataset_dir, (10, 10), cache_dir=dataset_dir + "/port_cache")
    model = build_model("LSTMComplexRelationModel", meta, **cfg)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays(arrays))
    return jmodel, jv, model, pv


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


class _Paths:
    """Counts the port's encodes by path."""

    def __init__(self, monkeypatch):
        self.fused, self.unfused = [], []
        fused, unfused = port_embedders.lstm_last_fused, port_embedders.lstm_forward_tm
        monkeypatch.setattr(port_embedders, "lstm_last_fused",
                            lambda p, e, n: self.fused.append(e.shape[1]) or fused(p, e, n))
        monkeypatch.setattr(port_embedders, "lstm_forward_tm",
                            lambda p, e: self.unfused.append(e.shape[1]) or unfused(p, e))


@pytest.mark.parametrize("B", [1, 37])
def test_queries_match_jax_unfused(synth_dir, monkeypatch, B):
    """Query vectors of a single query and of a ragged batch: the JAX
    package's unfused path (its CPU path, and its TPU path at this B) against
    the port, which takes the unfused path by the rule.  The fused path in
    its place fails the rule (the fault this slice repaired)."""
    jmodel, jv, model, pv = _models(synth_dir)
    rng = np.random.default_rng(B)
    ent = rng.integers(2, model.meta.entities_size, B)
    rel = rng.integers(2, model.meta.relations_size, B)
    is_sp = rng.integers(0, 2, B).astype(bool)
    want, _, _ = jmodel.queries(jv, jnp.asarray(ent, jnp.int32), jnp.asarray(rel, jnp.int32), jnp.asarray(is_sp))
    args = (pv, torch.from_numpy(ent), torch.from_numpy(rel), torch.from_numpy(is_sp))
    paths = _Paths(monkeypatch)
    got, _, _ = model.queries(*args)
    assert paths.unfused == [B, B] and not paths.fused
    agree = bf16_agreement(_np(got), _np(want))
    assert agree.ok(MAX_UNEQUAL_SHARE), agree
    monkeypatch.setattr(port_embedders, "lstm_fused_supported", lambda *a: True)
    fused, _, _ = model.queries(*args)
    fused_agree = bf16_agreement(_np(fused), _np(want))
    print(f"queries B={B}: unfused {agree}; the fused path in its place {fused_agree}")
    assert not fused_agree.ok(MAX_UNEQUAL_SHARE)


@pytest.mark.parametrize("B", [1, 37])
def test_encode_candidates_match_jax_unfused(synth_dir, monkeypatch, B):
    jmodel, jv, model, pv = _models(synth_dir)
    ids = np.random.default_rng(B + 1).integers(2, model.meta.entities_size, B)
    want, _, _ = jmodel.encode_candidates(jv, jnp.asarray(ids, jnp.int32))
    paths = _Paths(monkeypatch)
    got, _, _ = model.encode_candidates(pv, torch.from_numpy(ids))
    assert paths.unfused == [B] and tuple(got.shape) == (B, D)
    agree = bf16_agreement(_np(got), _np(want))
    assert agree.ok(MAX_UNEQUAL_SHARE), agree


def test_encode_all_entities_pads_the_last_chunk(synth_dir, monkeypatch):
    """Chunks of 100 rows over 302 entities: the last chunk is padded to
    100 rows (ids clipped to E - 1) as in the JAX package, so every chunk
    takes the same path (unfused: 100 % 8 != 0), and the cache equals
    JAX's."""
    jmodel, jv, model, pv = _models(synth_dir)
    E = model.meta.entities_size
    assert E % 100
    want = jmodel.encode_all_entities(jv, chunk_size=100)
    paths = _Paths(monkeypatch)
    got = model.encode_all_entities(pv, chunk_size=100)
    assert paths.unfused == [100] * -(-E // 100) and not paths.fused
    assert tuple(got.shape) == (E, D)
    agree = bf16_agreement(_np(got), _np(want))
    assert agree.ok(MAX_UNEQUAL_SHARE), agree


def test_switch_sends_every_encode_unfused(synth_dir, monkeypatch):
    """``OKET_DISABLE_LSTM_FUSED`` is read at call time: a batch of 96 (fused
    by the shape rule) goes unfused while it is set."""
    _, _, model, pv = _models(synth_dir)
    ids = torch.arange(2, 98)
    paths = _Paths(monkeypatch)
    model.encode_candidates(pv, ids)
    monkeypatch.setenv("OKET_DISABLE_LSTM_FUSED", "1")
    model.encode_candidates(pv, ids)
    assert paths.fused == [96] and paths.unfused == [96]


# ------------------------------------------------------------- training


@pytest.mark.parametrize("n_steps", [1, 3])
def test_unfused_sparse_sgd_steps_match_jax(synth_dir, monkeypatch, n_steps):
    """f32 sparse steps (query dedup and the gather-sum plan engaged) with
    ``OKET_DISABLE_LSTM_FUSED=1`` in both packages, SGD lr 0.5, d=128: the
    JAX package's recurrence runs its Pallas kernels 7 and 8
    (``lstm_scan_pallas``, interpret mode) as on a TPU, the port's the plain
    versions of its kernels 7 and 8."""
    from test_torch_train_step import _steps

    monkeypatch.setenv("OKET_DISABLE_LSTM_FUSED", "1")
    monkeypatch.setattr(jax_kernels, "pallas_supported", _shape_rule)
    traced = []
    fwd = jax_kernels._lstm_fwd_pallas
    monkeypatch.setattr(jax_kernels, "_lstm_fwd_pallas", lambda xp, w: traced.append(xp.shape[1]) or fwd(xp, w))
    paths = _Paths(monkeypatch)
    with pltpu.force_tpu_interpret_mode():
        jl, pl, flats = _steps(synth_dir, "float32", {"optimizer": "SGD", "lr": 0.5}, n_steps, monkeypatch,
                               fused=False, d=D)
    assert traced and all(b % 8 == 0 for b in traced)
    assert len(paths.unfused) == 2 * n_steps and not paths.fused
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jflat, pflat = flats[-1]
    atol = 2e-5 if n_steps == 1 else 1e-4
    for k, want in jflat.items():
        np.testing.assert_allclose(pflat[k], want, rtol=2e-5, atol=atol, err_msg=k)
