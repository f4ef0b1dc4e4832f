"""LSTM-ComplEx / LSTM-DistMult serving forward of the torch port against the
JAX package, with the JAX weights converted by ``variables_from_jax_arrays``.

At f32 the port is held against both JAX paths: the JAX package as it runs
on the CPU (the unfused scan path) and as it runs on a TPU (the Pallas
kernels in interpret mode, fused where its shape rule says so: D, H % 128
== 0 and B % 8 == 0).  The port takes the path of that rule on every
device, so at bf16 it is held against the TPU form, which is fused at these
shapes (the unfused path at bf16: tests/test_torch_unfused.py)."""

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
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.models.model import MODELS, build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_UNEQUAL_SHARE_CPU,
    assert_bf16_close,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-5)  # same f32 products, other summation order
# bf16: utils/numerics.py's rule, at most 4 bf16 ulps of max|want| (~0.41
# for the encodes, ~0.09 for the query vectors) and at most 0.5 % of
# elements not bit-equal; measured 0.03 ulps and 0.02 %, the query vectors
# bit-equal.  h not rounded before the recurrent product gives 1.3-2 %.
BF16 = "bf16"


def _assert_close(got, want, tol):
    if tol is BF16:
        assert_bf16_close(_np(got), _np(want), MAX_UNEQUAL_SHARE_CPU)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_model")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d),
         "--mentions", "300", "--relations", "30", "--triples", "200",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "1"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


def _models(dataset_dir, name, dtype):
    cfg = dict(entity_slot_size=128, normalize="batchnorm", dtype=dtype, sparse=True, init_std=0.1)
    jmeta = jax_load_meta(dataset_dir, (10, 10), cache_dir=dataset_dir + "/jax_cache")
    jmodel = jax_build_model(name, jmeta, **cfg)
    jv = jmodel.init(jax.random.key(0))
    # non-trivial running statistics, so eval batchnorm is not near identity
    rng = np.random.default_rng(0)
    for bn in ("entity_bn", "relation_bn"):
        jv["state"][bn] = {
            "mean": jnp.asarray(rng.standard_normal(128).astype(np.float32) * 0.1),
            "var": jnp.asarray(rng.uniform(0.3, 2.0, 128).astype(np.float32)),
            "count": jnp.float32(3),
        }
        jv["params"][bn]["bias"] = jnp.asarray(rng.standard_normal(128).astype(np.float32) * 0.1)
    arrays = {**flatten_arrays(jv["params"], "params"), **flatten_arrays(jv["state"], "state")}

    meta = load_meta(dataset_dir, (10, 10), cache_dir=dataset_dir + "/port_cache")
    model = build_model(name, meta, **cfg)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays(arrays))
    return jmodel, jv, model, pv


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _run_jax(fn, fused, monkeypatch):
    """``fused``: JAX's LSTM paths as on a TPU, the Pallas kernels in
    interpret mode, picked by ``pallas_supported``'s shape rule (the port's
    ``ops/lstm.py::lstm_fused_supported``), so both packages take the fused
    path at the same B; else the JAX package as it runs on the CPU."""
    if not fused:
        return fn()
    monkeypatch.setattr(jax_kernels, "pallas_supported",
                        lambda B, L, H: H % 128 == 0 and jax_kernels._pick_tile(B) >= 8)
    with pltpu.force_tpu_interpret_mode():
        return fn()


CASES = [
    ("LSTMComplexRelationModel", "float32", False, F32_TOL),
    ("LSTMComplexRelationModel", "float32", True, F32_TOL),
    ("LSTMComplexRelationModel", "bfloat16", True, BF16),
    ("LSTMDistmultRelationModel", "bfloat16", True, BF16),
]
IDS = ["complex-f32-scan", "complex-f32-fused", "complex-bf16-fused", "distmult-bf16-fused"]


@pytest.mark.parametrize("name,dtype,fused,tol", CASES, ids=IDS)
def test_encode_all_entities_matches_jax(synth_dir, monkeypatch, name, dtype, fused, tol):
    jmodel, jv, model, pv = _models(synth_dir, name, dtype)
    want = _run_jax(lambda: jmodel.encode_all_entities(jv, chunk_size=64), fused, monkeypatch)
    # other chunking, short last chunk (padded to 96 rows: B % 8 == 0, fused as JAX's 64)
    got = model.encode_all_entities(pv, chunk_size=96)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (model.meta.entities_size, 128)
    _assert_close(got, want, tol)


@pytest.mark.parametrize("name,dtype,fused,tol", CASES, ids=IDS)
def test_queries_match_jax(synth_dir, monkeypatch, name, dtype, fused, tol):
    jmodel, jv, model, pv = _models(synth_dir, name, dtype)
    rng = np.random.default_rng(5)
    ent = rng.integers(2, model.meta.entities_size, 16).astype(np.int32)
    rel = rng.integers(2, model.meta.relations_size, 16).astype(np.int32)
    is_sp = rng.integers(0, 2, 16).astype(bool)
    want, _, _ = _run_jax(
        lambda: jmodel.queries(jv, jnp.asarray(ent), jnp.asarray(rel), jnp.asarray(is_sp)),
        fused, monkeypatch)
    got, _, _ = model.queries(
        pv, torch.from_numpy(ent).long(), torch.from_numpy(rel).long(), torch.from_numpy(is_sp))
    if tol is not BF16:  # q is a product of two encodes: twice the relative tolerance
        tol = dict(tol, rtol=2 * tol["rtol"])
    _assert_close(got, want, tol)


# every candidate (300 rows: the JAX fused kernel takes only B % 8 == 0, so
# the scan path at f32), and 48 given ids through the fused kernel at bf16
@pytest.mark.parametrize(
    "n_ids,dtype,fused,tol",
    [(None, "float32", False, F32_TOL), (48, "bfloat16", True, BF16)],
    ids=["all-f32-scan", "ids-bf16-fused"],
)
def test_encode_candidates_matches_jax(synth_dir, monkeypatch, n_ids, dtype, fused, tol):
    jmodel, jv, model, pv = _models(synth_dir, "LSTMComplexRelationModel", dtype)
    ids = None if n_ids is None else np.random.default_rng(6).integers(2, model.meta.entities_size, n_ids)
    want, _, _ = _run_jax(
        lambda: jmodel.encode_candidates(jv, None if ids is None else jnp.asarray(ids)),
        fused, monkeypatch)
    got, _, _ = model.encode_candidates(pv, None if ids is None else torch.from_numpy(ids))
    n = n_ids or model.meta.entities_size - model.meta.min_entities_size
    assert tuple(got.shape) == (n, 128)
    _assert_close(got, want, tol)


def test_variables_layout_matches_jax(synth_dir):
    """Same parameter and state names and shapes as the JAX package, sparse
    tables padded to a multiple of 8 rows."""
    jmodel, jv, model, pv = _models(synth_dir, "LSTMComplexRelationModel", "bfloat16")
    port = model.init(torch.Generator().manual_seed(1))
    jax_flat = {**flatten_arrays(jv["params"], "params"), **flatten_arrays(jv["state"], "state")}
    port_flat = {
        f"{top}/{k}": v
        for top in ("params", "state")
        for k, v in _flatten(port[top]).items()
    }
    assert set(port_flat) == set(jax_flat)
    for k, v in jax_flat.items():
        assert tuple(port_flat[k].shape) == v.shape, k
    assert port["params"]["entity_token_embedding"].shape[0] % 8 == 0


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_flatten(v, path + "/") if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_every_registry_name_builds(synth_dir, name):
    """Every name of the JAX registry builds in the port (none raises
    NotImplementedError), with JAX's entity and relation widths; the
    Tucker3 names project the relation to d^2."""
    from open_knowledge_graph_embeddings_tpu.models.model import MODELS as JAX_MODELS

    assert set(MODELS) == set(JAX_MODELS)
    cfg = dict(entity_slot_size=16, relation_slot_size=16, normalize="batchnorm")
    model = build_model(name, load_meta(synth_dir, (10, 10), cache_dir=synth_dir + "/port_cache"), **cfg)
    jmodel = JAX_MODELS[name](jax_load_meta(synth_dir, (10, 10), cache_dir=synth_dir + "/jax_cache"), **cfg)
    assert model.scorer == jmodel.scorer
    assert type(model.embedder).__name__ == type(jmodel.embedder).__name__
    assert (model.embedder.entity_dim, model.embedder.relation_dim) == (
        jmodel.embedder.entity_dim, jmodel.embedder.relation_dim)
    assert model.embedder.relation_dim == (256 if "Tucker3" in name else 16)


def test_bigram_refuses_the_relation_projection_as_jax_does(synth_dir):
    """The bigram family never applies its relation projection in the
    reference: both packages refuse ``project_relation``."""
    from open_knowledge_graph_embeddings_tpu.models.embedders import BigramPoolingEmbedder as JaxBigram
    from open_knowledge_graph_embeddings_tpu_torch.models.embedders import BigramPoolingEmbedder

    jmeta = jax_load_meta(synth_dir, (10, 10), cache_dir=synth_dir + "/jax_cache")
    meta = load_meta(synth_dir, (10, 10), cache_dir=synth_dir + "/port_cache")
    with pytest.raises(AssertionError, match="project_relation"):
        JaxBigram(meta=jmeta, entity_slot_size=16, project_relation=True)
    with pytest.raises(ValueError, match="project_relation"):
        BigramPoolingEmbedder(meta=meta, entity_slot_size=16, project_relation=True)
    # the registry passes the key through to the embedder
    with pytest.raises(ValueError, match="project_relation"):
        build_model("BigramPoolingComplexRelationModel", meta, entity_slot_size=16, project_relation=True)
