"""The ten model families of the torch port against the JAX package on the
CPU: lookup ComplEx / DistMult / Tucker3, unigram and bigram pooling, the
LSTM families (ComplEx, DistMult, Tucker3) and the two data-bias
diagnostics.

For every registry name: the eval-mode forward (queries, the full candidate
encode, prefix scores against given and against all candidates), one dense
BCE/Adagrad step (loss, every gradient, every updated parameter and Adagrad
sum) and the batchnorm running statistics after three steps.  Then the
lookup embedder's own paths (the table-slice encode, the cubic-abs
regularizer, the subject/object projections), triple scores and the bf16
rounding points.  The row-sparse steps, the trainer's candidate cache,
``cli.train``, eval and serving of the families:
tests/test_torch_families_cli.py.

Data: a small synthetic OLPBench-shaped set (tools/make_synth_olpbench.py)
and the toy set of tests/conftest.py, at d = 8-16.  JAX weights cross over
through ``variables_from_jax_arrays``; dropout is 0 wherever a step is
compared.  Tolerances: f32 values rtol 1e-5 / atol 1e-6 (the same f32
products summed in another order), bf16 values by the rule of
``utils/numerics.py`` with the CPU share.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import open_knowledge_graph_embeddings_tpu.models.embedders as jax_embedders
from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.step import make_train_step as jax_train_step
from open_knowledge_graph_embeddings_tpu.train.step import prefix_loss as jax_prefix_loss
from open_knowledge_graph_embeddings_tpu.train.step import train_batch_to_arrays as jax_train_arrays
import open_knowledge_graph_embeddings_tpu_torch.models.embedders as port_embedders
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models import model as port_model
from open_knowledge_graph_embeddings_tpu_torch.models.model import MODELS, build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    grad_tree,
    leaf_tree,
    make_train_step,
    prefix_loss,
    train_batch_to_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import (
    MAX_REL_ERR_F32,
    MAX_UNEQUAL_SHARE_CPU,
    bf16_agreement,
)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = sorted(MODELS)
OPT = {"optimizer": "Adagrad", "lr": 0.1, "weight_decay": 1e-4}

# small widths of each family; every batchnorm the family has is on
CONFIGS = {
    "LookupComplexRelationModel": dict(entity_slot_size=16, batch_norm=True),
    "LookupDistmultRelationModel": dict(entity_slot_size=16, normalize="norm"),
    "LookupTucker3RelationModel": dict(entity_slot_size=8, relation_slot_size=12, batch_norm=True),
    "UnigramPoolingComplexRelationModel": dict(entity_slot_size=16, normalize="batchnorm"),
    "BigramPoolingComplexRelationModel": dict(entity_slot_size=16, normalize="batchnorm", gates=True),
    "LSTMComplexRelationModel": dict(entity_slot_size=16, normalize="batchnorm"),
    "LSTMDistmultRelationModel": dict(entity_slot_size=16, normalize="batchnorm"),
    "LSTMTucker3RelationModel": dict(entity_slot_size=8, normalize="batchnorm"),
    "DataBiasOnlyEntityModel": dict(entity_slot_size=16, normalize="batchnorm"),
    "DataBiasOnlyRelationModel": dict(entity_slot_size=16, normalize="batchnorm"),
}
FULL_VOCAB = dict(input_file="train.txt", is_training_data=True, batch_size=48, use_batch_shared_entities=False)
SHARED = dict(FULL_VOCAB, use_batch_shared_entities=True, min_size_batch_labels=64, max_size_prefix_label=4)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_families")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d),
         "--mentions", "300", "--relations", "30", "--triples", "400",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "3"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


def _datasets(path, cfg):
    return (JaxDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **cfg),
            OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/port_cache", **cfg))


def _models(path, name, dtype="float32", data=FULL_VOCAB, perturb_state=False, **over):
    """(jax dataset, port dataset, jax model, jax variables, port model, port
    variables): JAX's random weights in both.  ``perturb_state`` sets random
    batchnorm running statistics and biases, so an eval-mode batchnorm is
    no identity."""
    j, p = _datasets(path, data)
    cfg = dict(CONFIGS[name], init_std=0.1, dtype=dtype, **over)
    jmodel = jax_build_model(name, j.meta, **cfg)
    jv = jmodel.init(jax.random.key(0))
    if perturb_state:
        rng = np.random.default_rng(1)
        for key, st in jv["state"].items():
            n = st["mean"].shape[0]
            jv["state"][key] = {"mean": jnp.asarray(rng.standard_normal(n).astype(np.float32) * 0.1),
                                "var": jnp.asarray(rng.uniform(0.3, 2.0, n).astype(np.float32)),
                                "count": jnp.float32(3)}
    model = build_model(name, p.meta, **cfg)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays({**jax_flatten(jv["params"], "params"),
                                         **jax_flatten(jv["state"], "state")}))
    return j, p, jmodel, jv, model, pv


def _np(x):
    if isinstance(x, jax.Array):
        return np.asarray(x.astype(jnp.float32))
    return x.detach().float().numpy()


def _close(got, want, dtype, err_msg=""):
    if dtype == "bfloat16":
        a = bf16_agreement(_np(got), _np(want))
        assert a.ok(MAX_UNEQUAL_SHARE_CPU), f"{err_msg}: {a}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), err_msg=err_msg, **F32_TOL)


def _ids(meta, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(meta.min_entities_size, meta.entities_size, n).astype(np.int32),
            rng.integers(meta.min_relations_size, meta.relations_size, n).astype(np.int32),
            rng.integers(0, 2, n).astype(bool))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)).long() if np.asarray(x).dtype != bool else torch.from_numpy(x)
            for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _flat(tree):
    return {k: np.array(v) for k, v in jax_flatten(tree, "p").items()} if not _is_torch(tree) else {
        k: v.copy() for k, v in flatten_arrays(tree, "p").items()}


def _is_torch(tree):
    while isinstance(tree, dict):
        if not tree:
            return False
        tree = next(iter(tree.values()))
    return isinstance(tree, torch.Tensor)


# ------------------------------------------------------------ registry


def test_every_registry_name_builds_with_the_jax_layout(synth_dir):
    """All 10 names build; their parameters and states have JAX's names and
    shapes (so checkpoints cross key for key)."""
    from open_knowledge_graph_embeddings_tpu.models.model import MODELS as JAX_MODELS

    assert set(MODELS) == set(JAX_MODELS)
    for name in NAMES:
        _, _, _, jv, model, _ = _models(synth_dir, name)
        port = model.init(torch.Generator().manual_seed(1))
        for top in ("params", "state"):
            want = {k: v.shape for k, v in jax_flatten(jv[top], top).items()}
            got = {k: v.shape for k, v in flatten_arrays(port[top], top).items()}
            assert got == want, (name, top)


@pytest.mark.parametrize("name", NAMES)
def test_port_checkpoint_of_each_family_loads_into_jax(synth_dir, tmp_path, name):
    """The port's own random weights and batchnorm state, saved by the port
    with an Adagrad state, load into the JAX package key for key (the
    relation projection and its batchnorm, the convolutions and their
    batchnorms, the subject/object projections, the lookup tables)."""
    from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import save_checkpoint

    over = {"project_entity": True} if name.startswith("Lookup") else {}
    _, _, jmodel, jv, model, _ = _models(synth_dir, name, **over)
    pv = model.init(torch.Generator().manual_seed(5))
    reg = OptimizerRegimes(OPT)
    reg.update(1, 0)
    popt = reg.init_state(pv["params"])
    jreg = JaxRegimes(OPT)
    jreg.update(1, 0)
    path = save_checkpoint(str(tmp_path), "port_ck", pv, {"training_steps": 3}, popt)
    loaded, jopt, meta = jax_ckpt.load_checkpoint(path, jv, jreg.init_state(jv["params"]))
    assert meta["training_steps"] == 3
    want = {**flatten_arrays(pv["params"], "params"), **flatten_arrays(pv["state"], "state"),
            **flatten_arrays(popt, "opt")}
    got = {**jax_flatten(loaded["params"], "params"), **jax_flatten(loaded["state"], "state"),
           **jax_flatten(jopt, "opt")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- forward


FORWARD_CASES = [(n, "float32") for n in NAMES] + [(n, "bfloat16") for n in NAMES]


@pytest.mark.parametrize("name,dtype", FORWARD_CASES, ids=[f"{n}-{d}" for n, d in FORWARD_CASES])
def test_forward_matches_jax(synth_dir, name, dtype):
    """Eval mode, random running statistics: the query vectors of a mixed
    sp/po batch, every candidate (``encode_candidates(None)``: a table
    slice for lookup models) and the prefix scores against 24 given
    candidates and against all of them."""
    _, _, jmodel, jv, model, pv = _models(synth_dir, name, dtype, perturb_state=True)
    ent, rel, is_sp = _ids(model.meta, 16, 5)
    cand = np.random.default_rng(6).integers(2, model.meta.entities_size, 24).astype(np.int32)
    jq, _, _ = jmodel.queries(jv, *_j(ent, rel, is_sp))
    pq, _, _ = model.queries(pv, *_t(ent, rel, is_sp))
    _close(pq, jq, dtype, "queries")
    jc, _, _ = jmodel.encode_candidates(jv, None)
    pc, _, _ = model.encode_candidates(pv, None)
    assert tuple(pc.shape) == (model.meta.entities_size - model.meta.min_entities_size, model.embedder.entity_dim)
    _close(pc, jc, dtype, "candidates")
    for ids in (cand, None):
        js, _, _ = jmodel.prefix_scores(jv, *_j(ent, rel, is_sp), cand_ids=None if ids is None else jnp.asarray(ids))
        ps, _, _ = model.prefix_scores(pv, *_t(ent, rel, is_sp), cand_ids=None if ids is None else _t(ids)[0])
        assert ps.dtype == torch.float32
        if dtype == "bfloat16":  # f32 scores of bf16 operands
            np.testing.assert_allclose(_np(ps), _np(js), rtol=2 ** -7, atol=2 ** -8 * np.abs(_np(js)).max())
        else:
            _close(ps, js, dtype, "scores")


# ------------------------------------------------------ dense steps


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in jax_train_arrays(b).items()}


def _grads(jmodel, jv, model, pv, b):
    """Every gradient of one batch's loss in both packages (train mode,
    dropout 0)."""
    ja = _jax_batch(b)

    def loss_fn(params):
        v = {"params": params, "state": jv["state"], "buffers": jv["buffers"]}
        loss_sum, _, _, reg = jax_prefix_loss(jmodel, v, ja, "bce", 0.0, None)
        return (loss_sum + reg) / ja["normalizer_loss"]

    jg = jax.grad(loss_fn)(jv["params"])
    pa = arrays_to_device(train_batch_to_arrays(b), "cpu")
    leaves = leaf_tree(pv["params"])
    loss_sum, _, _, reg = prefix_loss(model, {**pv, "params": leaves}, pa, "bce", 0.0, None)
    ((loss_sum + reg) / pa["normalizer_loss"]).backward()
    return _flat(jg), _flat(grad_tree(leaves))


def _dense_steps(jmodel, jv, model, pv, batches, opt=OPT):
    jreg, preg = JaxRegimes(opt), OptimizerRegimes(opt)
    jreg.update(1, 0)
    preg.update(1, 0)
    jstep = jax_train_step(jmodel, jreg, jv["params"])
    pstep = make_train_step(model, preg, pv["params"])
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    losses = []
    for b in batches:
        jv, jopt, js = jstep(jv, jopt, jhp, _jax_batch(b), jax.random.key(0))
        pv, popt, ps = pstep(pv, popt, preg.hparams(), arrays_to_device(train_batch_to_arrays(b), "cpu"))
        losses.append((float(js["loss_sum"]), float(ps["loss_sum"])))
    return np.array(losses), jv, jopt, pv, popt


STEP_DATA = {n: FULL_VOCAB for n in NAMES}
# the pair encode (candidates and query entities in one pass) with batch-shared candidates
STEP_DATA.update({n: SHARED for n in ("UnigramPoolingComplexRelationModel", "LSTMComplexRelationModel",
                                      "DataBiasOnlyRelationModel")})


@pytest.mark.parametrize("name", NAMES)
def test_dense_step_matches_jax(synth_dir, name):
    """One dense BCE step, Adagrad lr 0.1 with weight decay 1e-4: the loss
    (rtol 1e-6), every gradient (:func:`_grad_tol`), the new batchnorm
    state (:func:`_assert_state_close`) and every updated parameter and
    Adagrad sum within what the gradient's tolerance allows: the first
    Adagrad step moves an element by ``lr g' / (|g'| + eps)`` (g' = g + wd
    p), ~ +-lr whatever |g'|, so a parameter is held (F32_TOL) where |g'|
    exceeds ten times its tolerance (there the sign is certain), and a sum
    g'^2 to ``2 |g'| tol + tol^2``.  A leaf the loss does not reach (the
    relation encoder of the entity-bias model, the bigram's token-level
    batchnorm) gets JAX's zero gradient and its weight-decay update."""
    j, p, jmodel, jv, model, pv = _models(synth_dir, name, data=STEP_DATA[name])
    b = next(iter(BatchBuilder(p, seed=4).batches(shuffle=True)))
    jg, pg = _grads(jmodel, jv, model, pv, b)
    assert set(pg) == set(jg)
    tols = _grad_tol(jg)
    for k, want in jg.items():
        assert (np.abs(pg[k] - want) <= tols[k]).all(), (k, np.abs(pg[k] - want).max(), tols[k].max())
    p0 = _flat(jv["params"])
    losses, jv, jopt, pv, popt = _dense_steps(jmodel, jv, model, pv, [b])
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-6)
    _assert_state_close(_flat(jv["state"]), _flat(pv["state"]), rtol=1e-5)
    jp, pp, jo, po = _flat(jv["params"]), _flat(pv["params"]), _flat(jopt), _flat(popt)
    held = 0
    for k, g in jg.items():
        g1 = g + OPT["weight_decay"] * p0[k]
        sure = np.abs(g1) > 10 * tols[k]
        np.testing.assert_allclose(pp[k][sure], jp[k][sure], err_msg=k, **F32_TOL)
        held += int(sure.sum())
        bound = 2 * np.abs(g1) * tols[k] + tols[k] ** 2 + 1e-5 * np.abs(jo[k + "/sum"])
        assert (np.abs(po[k + "/sum"] - jo[k + "/sum"]) <= bound).all(), k
        assert float(po[k + "/step"]) == float(jo[k + "/step"]) == 1.0, k
    # the rest: rows the batch leaves untouched (g' = wd p, below the leaf's tolerance)
    assert held > 0.5 * sum(g.size for g in jg.values())


def _grad_tol(grads):
    """Elementwise tolerance of each gradient leaf: rtol 1e-4 and 1e-4 of
    the leaf's largest (gradients through the LSTM sum over every row and
    step of a recurrence: measured up to 3.9e-5 of the leaf's largest).  A
    leaf whose largest is below 1e-6 of the model's largest holds f32 noise
    only (its gradient is zero in exact arithmetic: the first batchnorm's
    bias of a Tucker3 relation, which the projection's batchnorm makes
    shift-invariant): 1e-6 of the model's largest."""
    top = max(np.abs(g).max() for g in grads.values())
    out = {}
    for k, g in grads.items():
        m = np.abs(g).max()
        out[k] = np.full(g.shape, 1e-6 * top) if m < 1e-6 * top else 1e-4 * (np.abs(g) + m)
    return out


def _assert_state_close(jf, pf, rtol):
    """Batchnorm running statistics: counts equal, variances to ``rtol``,
    means to 1e-5 of their batchnorm's largest running standard deviation
    (a mean of batchnormed inputs, as the Tucker3 projection's is, is zero
    up to f32 noise)."""
    assert set(pf) == set(jf)
    for k, want in jf.items():
        if k.endswith("/count"):
            assert float(pf[k]) == float(want), k
        elif k.endswith("/mean"):
            std = np.sqrt(jf[k.removesuffix("mean") + "var"].max())
            np.testing.assert_allclose(pf[k], want, rtol=0, atol=1e-5 * std, err_msg=k)
        else:
            np.testing.assert_allclose(pf[k], want, rtol=rtol, err_msg=k)


def _assert_updates_close(jv, jopt, pv, popt):
    for tree_j, tree_p in ((jv["params"], pv["params"]), (jv["state"], pv["state"]), (jopt, popt)):
        jf, pf = _flat(tree_j), _flat(tree_p)
        assert set(pf) == set(jf)
        for k, want in jf.items():
            if k.endswith("/sum"):
                np.testing.assert_allclose(pf[k], want, rtol=1e-5, atol=2 * MAX_REL_ERR_F32 * np.abs(want).max(),
                                           err_msg=k)
            else:
                np.testing.assert_allclose(pf[k], want, err_msg=k, **F32_TOL)


BN_NAMES = [n for n in NAMES if n != "LookupDistmultRelationModel"]


@pytest.mark.parametrize("name", BN_NAMES)
def test_batchnorm_statistics_after_three_steps_match_jax(synth_dir, name):
    """Three dense steps (SGD lr 0.05: no Adagrad sign flips of f32 noise,
    and steps small enough that the trajectories do not amplify it): every
    running statistic (:func:`_assert_state_close`, variances to rtol 3e-5:
    three steps of f32 drift), the counts (a step per encode, 0 for the
    bigram's unused token batchnorm), the bigram's cumulative (momentum
    None) convolution statistics and the Tucker3 projection's among them;
    and the losses."""
    _, p, jmodel, jv, model, pv = _models(synth_dir, name, data=STEP_DATA[name])
    batches = list(BatchBuilder(p, seed=4).batches(shuffle=True))[:3]
    assert len(batches) == 3
    losses, jv, _, pv, _ = _dense_steps(jmodel, jv, model, pv, batches, {"optimizer": "SGD", "lr": 0.05})
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    jf = _flat(jv["state"])
    assert jf
    _assert_state_close(jf, _flat(pv["state"]), rtol=3e-5)


# ------------------------------------------------------- lookup paths


def test_encode_entity_range_is_the_arange_gather(synth_dir):
    """The table-slice encode equals ``encode_entity(arange)`` forward, and
    its backward (the zero pad) equals the gather's scatter; the encode of
    raw rows (``encode_entity_rows``) gives the same values."""
    _, _, _, _, model, pv = _models(synth_dir, "LookupComplexRelationModel")
    E, lo = model.meta.entities_size, model.meta.min_entities_size
    w = torch.randn(E - lo, 16, generator=torch.Generator().manual_seed(2))
    outs = []
    for use_range in (True, False):
        table = pv["params"]["entity_embedding"].detach().clone().requires_grad_()
        v = {**pv, "params": {**pv["params"], "entity_embedding": table}}
        if use_range:
            x, _, _ = model.embedder.encode_entity_range(v, lo, E)
        else:
            x, _, _ = model.embedder.encode_entity(v, torch.arange(lo, E))
        (x * w).sum().backward()
        outs.append((x.detach(), table.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert float(outs[0][1][:lo].abs().sum()) == 0.0
    rows, _, _ = model.embedder.encode_entity_rows(pv, pv["params"]["entity_embedding"][lo:E])
    assert torch.equal(rows, outs[0][0])


class _SharedDropout:
    """One mask sequence for both packages' ``_dropout``: the k-th call that
    drops (train, rate > 0) draws its mask from numpy seed k."""

    def __init__(self):
        self.calls = 0

    def mask(self, shape, rate):
        self.calls += 1
        return np.random.default_rng(self.calls).random(shape) < 1.0 - rate

    def jax(self, x, rate, train, rng):
        if not train or rate <= 0.0:
            return x
        return jnp.where(jnp.asarray(self.mask(x.shape, rate)), x / (1.0 - rate), 0.0)

    def port(self, x, rate, train, generator, block=None):
        assert block is None  # one process: no candidate block
        if not train or rate <= 0.0:
            return x
        m = torch.from_numpy(self.mask(tuple(x.shape), rate))
        return torch.where(m, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))


@pytest.mark.parametrize("dropout", [0.0, 0.25], ids=["no-dropout", "dropout"])
def test_cubic_abs_regularizer_matches_jax(synth_dir, monkeypatch, dropout):
    """``l2_reg > 0`` in train mode: the regularizer (with the reference's
    ``x / dropout`` quirk), the queries and its gradient, with the same
    dropout masks fed to both packages."""
    _, _, jmodel, jv, model, pv = _models(synth_dir, "LookupComplexRelationModel", l2_reg=0.01, dropout=dropout,
                                          input_dropout=dropout / 2)
    ent, rel, is_sp = _ids(model.meta, 16, 7)
    shared_j, shared_p = _SharedDropout(), _SharedDropout()
    monkeypatch.setattr(jax_embedders, "_dropout", shared_j.jax)
    monkeypatch.setattr(port_embedders, "_dropout", shared_p.port)

    def jloss(params):
        q, _, reg = jmodel.queries({**jv, "params": params}, *_j(ent, rel, is_sp), train=True, rng=jax.random.key(1))
        return reg + jnp.sum(q ** 2), (q, reg)

    (jl, (jq, jreg)), jg = jax.value_and_grad(jloss, has_aux=True)(jv["params"])
    leaves = leaf_tree(pv["params"])
    pq, _, preg = model.queries({**pv, "params": leaves}, *_t(ent, rel, is_sp), train=True,
                                generator=torch.Generator().manual_seed(0))
    (preg + (pq ** 2).sum()).backward()
    assert shared_j.calls == shared_p.calls == (4 if dropout else 0)
    assert float(preg) > 0
    np.testing.assert_allclose(float(preg), float(jreg), rtol=1e-5)
    _close(pq, jq, "float32", "queries")
    jf, pf = _flat(jg), _flat(grad_tree(leaves))
    for k, want in jf.items():
        np.testing.assert_allclose(pf[k], want, rtol=1e-5, atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_entity_projections_on_mixed_directions_match_jax(synth_dir):
    """``project_entity``: subject and object maps chosen per row by
    ``is_sp`` (candidates take the object map), with their activation, in
    eval mode and as one dense step's gradients."""
    over = dict(project_entity=True, project_entity_activation="Tanh")
    _, p, jmodel, jv, model, pv = _models(synth_dir, "LookupComplexRelationModel", **over)
    ent, rel, is_sp = _ids(model.meta, 16, 8)
    assert 0 < is_sp.sum() < 16
    jq, _, _ = jmodel.queries(jv, *_j(ent, rel, is_sp))
    pq, _, _ = model.queries(pv, *_t(ent, rel, is_sp))
    _close(pq, jq, "float32", "queries")
    _close(model.encode_candidates(pv, None)[0], jmodel.encode_candidates(jv, None)[0], "float32", "candidates")
    jg, pg = _grads(jmodel, jv, model, pv, next(iter(BatchBuilder(p, seed=4).batches(shuffle=True))))
    for k in ("p/subj_projection/w", "p/obj_projection/w", "p/entity_embedding"):
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-5, atol=1e-6 * np.abs(jg[k]).max(), err_msg=k)


def test_triple_scores_match_jax(synth_dir):
    """``triple_score`` of the three capable scorers; the bias diagnostics
    raise in both packages."""
    for name in ("LookupComplexRelationModel", "LookupDistmultRelationModel", "LookupTucker3RelationModel"):
        _, _, jmodel, jv, model, pv = _models(synth_dir, name)
        s, r, _ = _ids(model.meta, 12, 9)
        o = np.random.default_rng(10).integers(2, model.meta.entities_size, 12).astype(np.int32)
        want, _, _ = jmodel.triple_score(jv, *_j(s, r, o))
        got, _, _ = model.triple_score(pv, *_t(s, r, o))
        _close(got, want, "float32", name)
    _, _, jmodel, jv, model, pv = _models(synth_dir, "DataBiasOnlyEntityModel")
    with pytest.raises(NotImplementedError):
        jmodel.triple_score(jv, *_j(s, r, o))
    with pytest.raises(NotImplementedError):
        model.triple_score(pv, *_t(s, r, o))


# ---------------------------------------------------- bf16 rounding points


def _round_each_product(x, w):
    """The planted fault: the product rounded to bf16 on its own before it
    is added to anything."""
    return torch.matmul(x.float(), w.float()).to(torch.bfloat16).float()


def _rescal_rounding_each_product(e, r_mat, is_sp):
    prod_sp = (e[:, :, None].float() * r_mat.float()).to(torch.bfloat16).float().sum(1)
    prod_po = (r_mat.float() * e[:, None, :].float()).to(torch.bfloat16).float().sum(2)
    return torch.where(is_sp[:, None], prod_sp, prod_po).to(e.dtype)


@pytest.mark.parametrize("name,what", [
    ("BigramPoolingComplexRelationModel", "candidates"),
    ("LSTMTucker3RelationModel", "queries"),
    ("LookupTucker3RelationModel", "queries"),
], ids=["bigram-conv", "lstm-relation-projection", "rescal"])
def test_bf16_rounds_once_where_jax_does(synth_dir, monkeypatch, name, what):
    """bf16: the bigram's two conv products, the token relation
    projection (product, then batchnorm in f32) and rescal's mat-vecs each
    accumulate in f32 and round once.  The port passes the bf16 rule
    against JAX; a variant that rounds each product on its own fails it."""
    _, _, jmodel, jv, model, pv = _models(synth_dir, name, "bfloat16", perturb_state=True)
    ent, rel, is_sp = _ids(model.meta, 48, 11)

    def run():
        if what == "candidates":
            return model.encode_candidates(pv, None)[0]
        return model.queries(pv, *_t(ent, rel, is_sp))[0]

    want = jmodel.encode_candidates(jv, None)[0] if what == "candidates" else jmodel.queries(
        jv, *_j(ent, rel, is_sp))[0]
    assert bf16_agreement(_np(run()), _np(want)).ok(MAX_UNEQUAL_SHARE_CPU)
    if name == "LookupTucker3RelationModel":
        monkeypatch.setitem(port_model.QUERY_FNS, "rescal", _rescal_rounding_each_product)
    else:
        monkeypatch.setattr(port_embedders, "_product_f32", _round_each_product)
    planted = bf16_agreement(_np(run()), _np(want))
    assert not planted.ok(MAX_UNEQUAL_SHARE_CPU), planted
