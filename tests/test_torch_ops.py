"""Eval batchnorm, query folding and the chunked filtered top-k of the torch
port against the JAX package."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.ops import norm as jax_norm
from open_knowledge_graph_embeddings_tpu.ops import scoring as jax_scoring
from open_knowledge_graph_embeddings_tpu.train import evaluate as jax_eval
from open_knowledge_graph_embeddings_tpu_torch.ops import norm, scoring
from open_knowledge_graph_embeddings_tpu_torch.train import evaluate

torch.set_num_threads(1)


def test_eval_batchnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((33, 64)).astype(np.float32) * 3 + 1
    params = {"scale": rng.uniform(0, 1, 64).astype(np.float32),
              "bias": rng.standard_normal(64).astype(np.float32)}
    state = {"mean": rng.standard_normal(64).astype(np.float32),
             "var": rng.uniform(0.5, 2, 64).astype(np.float32),
             "count": np.float32(7)}
    want, _ = jax_norm.apply_batchnorm(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x), train=False)
    got, new_state = norm.apply_batchnorm(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.as_tensor(v) for k, v in state.items()}, torch.from_numpy(x))
    # f32 elementwise; rsqrt may differ in the last ulp between libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(new_state["count"]) == 7.0
    # train mode (batch statistics) is held against JAX in test_torch_train_ops.py;
    # eval mode leaves the running statistics as they are
    assert all(torch.equal(new_state[k], torch.as_tensor(v)) for k, v in state.items())


def test_init_batchnorm_matches_jax_layout():
    p, s = norm.init_batchnorm(16, uniform_weight=True, generator=torch.Generator().manual_seed(0))
    jp, js = jax_norm.init_batchnorm(16, uniform_weight=True, rng=jax.random.key(0))
    for a, b in ((p, jp), (s, js)):
        assert set(a) == set(b)
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), k
    assert float(p["scale"].min()) >= 0 and float(p["scale"].max()) <= 1
    np.testing.assert_array_equal(s["var"].numpy(), np.ones(16, np.float32))


@pytest.mark.parametrize("name", ["complex_query", "distmult_query"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_folding_matches_jax(name, dtype):
    rng = np.random.default_rng(1)
    e = rng.standard_normal((12, 64)).astype(np.float32)
    r = rng.standard_normal((12, 64)).astype(np.float32)
    is_sp = rng.integers(0, 2, 12).astype(bool)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = getattr(jax_scoring, name)(
        jnp.asarray(e).astype(jd), jnp.asarray(r).astype(jd), jnp.asarray(is_sp))
    got = getattr(scoring, name)(
        torch.from_numpy(e).to(td), torch.from_numpy(r).to(td), torch.from_numpy(is_sp))
    assert got.dtype == td
    # bf16: XLA may keep an elementwise chain in f32 where torch rounds each
    # op to bf16, so one bf16 ulp of the result (2^-7 relative) is allowed
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_scores_are_f32_from_bf16_operands():
    """A bf16 product with a bf16 output would round the scores into false
    ties; the port widens and multiplies in f32, like the JAX package."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    c = rng.standard_normal((40, 64)).astype(np.float32)
    qb, cb = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(c).astype(jnp.bfloat16)
    want = np.asarray(jax_scoring.score_against_candidates(qb, cb))
    got = scoring.score_against_candidates(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(c).to(torch.bfloat16))
    assert got.dtype == torch.float32
    # exact products of bf16 values, f32 sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stable_topk_matches_lax_top_k_on_ties():
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (6, 50)).astype(np.float32)  # many exact ties
    x[0, :] = 1.0
    x[1, 5] = -np.inf
    x[2, 7] = np.float32(-0.0)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 12)
    got_v, got_i = evaluate.stable_topk(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _tie_case(B=6, N=700, d=32, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cand = rng.standard_normal((N, d)).astype(np.float32)
    # engineered exact ties across chunk borders: copies of the best rows
    best = np.argsort(-(q[0] @ cand.T))[:3]
    for dst in (1, 129, 250, 256, 511, 699):
        cand[dst] = cand[best[0]]
    cand[300:305] = cand[best[1]]
    return q, cand


@pytest.mark.parametrize("chunk,k", [(128, 10), (256, 7), (1000, 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filtered_topk_chunked_matches_jax(chunk, k, dtype):
    q, cand = _tie_case()
    fr = np.array([0, 0, 2, 3, 5, -1, -1], np.int32)
    fc = np.array([1, 699, 256, 0, 698, -1, -1], np.int32)
    col_valid = np.ones(cand.shape[0], bool)
    col_valid[[3, 400]] = False
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for cv in (None, col_valid):
        want_s, want_c = jax_eval.filtered_topk_chunked(
            jnp.asarray(q).astype(jd), jnp.asarray(cand).astype(jd), jnp.asarray(fr),
            jnp.asarray(fc), None if cv is None else jnp.asarray(cv), k, chunk=chunk)
        got_s, got_c = evaluate.filtered_topk_chunked(
            torch.from_numpy(q).to(td), torch.from_numpy(cand).to(td), torch.from_numpy(fr),
            torch.from_numpy(fc), None if cv is None else torch.from_numpy(cv), k, chunk=chunk)
        assert got_c.dtype == torch.int32 and got_s.dtype == torch.float32
        # the exact ties make the ids a strict test of the tie order
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    assert evaluate.FILTER_VALUE == jax_eval.FILTER_VALUE
