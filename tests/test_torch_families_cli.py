"""The model families of the torch port through its training, eval and
serving entry points, against the JAX package on the CPU: the row-sparse
steps of the lookup and unigram families (plans and updates), the
trainer's full-vocabulary candidate cache choice, ``cli.train`` on every
FB15k-237 config, a JAX lookup checkpoint evaluated in both packages, and
the lookup Predictor.  The models and their tolerances are those of
tests/test_torch_families.py."""

import csv
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.dataset import DatasetMeta as JaxMeta
from open_knowledge_graph_embeddings_tpu.inference import Predictor as JaxPredictor
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu.train.trainer import Trainer as JaxTrainer
from open_knowledge_graph_embeddings_tpu_torch import inference
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    arrays_to_device,
    make_train_step,
    train_batch_to_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer
from test_torch_families import (  # noqa: F401  (synth_dir is a fixture)
    OPT,
    ROOT,
    SHARED,
    _assert_updates_close,
    _close,
    _flat,
    _ids,
    _models,
    synth_dir,
)

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)


# ------------------------------------------------------- sparse steps


SPARSE_CASES = ["LookupComplexRelationModel", "UnigramPoolingComplexRelationModel"]


def _sparse_run(synth_dir, name, n_steps=3):
    j, p, jmodel, jv, model, pv = _models(synth_dir, name, data=SHARED, sparse=True)
    jreg, preg = JaxRegimes(OPT), OptimizerRegimes(OPT)
    jreg.update(1, 0)
    preg.update(1, 0)
    kw = dict(min_rows_ratio=0.0, dedup_bucket=8)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", **kw)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, **kw)
    jstep = jax_sparse_step(jmodel, jreg, jv["params"], entity_sparse=True)
    pstep = make_sparse_train_step(model, preg, pv["params"], entity_sparse=True)
    jopt, popt = jreg.init_state(jv["params"]), preg.init_state(pv["params"])
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    batches = list(BatchBuilder(p, seed=4).batches(shuffle=True))[:n_steps]
    plans, losses, first = [], [], None
    for b in batches:
        jd, pd = jplan(b), plan(b)
        plans.append((jd, pd))
        jv, jopt, js = jstep(jv, jopt, jhp, {k: jnp.asarray(v) for k, v in jd.items()}, jax.random.key(0))
        pv, popt, ps = pstep(pv, popt, preg.hparams(), arrays_to_device(pd, "cpu"))
        losses.append((float(js["loss_sum"]), float(ps["loss_sum"])))
        if first is None:  # copies: JAX donates its buffers, the port updates in place
            first = (jax.tree_util.tree_map(np.array, (jv, jopt)), (_clone(pv), _clone(popt)))
    return plans, np.array(losses), first, (jopt, popt), (model, p, batches)


@pytest.mark.parametrize("name", SPARSE_CASES)
def test_sparse_plans_match_jax(synth_dir, name):
    """Every array of the plan equals JAX's ``SparsePlanBuilder``'s (compact
    layout, ``min_rows_ratio`` 0 so the small tables go row-sparse): the
    unique rows of both tables, the remapped ids (lookup) or token matrices
    and the query dedup inverses (unigram; no gather-sum plan: LSTM only)."""
    plans, *_ = _sparse_run(synth_dir, name, n_steps=3)
    for jd, pd in plans:
        assert set(pd) == set(jd)
        for k in jd:
            np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
        assert "sparse/entity_embedding/uids" in pd or "sparse/entity_token_embedding/uids" in pd
        assert not any(k.startswith("sparse/plan/") for k in pd)
    if name.startswith("Unigram"):
        assert any("dedup/ent_inv" in pd for _, pd in plans)


@pytest.mark.parametrize("name", SPARSE_CASES)
def test_sparse_steps_match_jax_and_the_dense_step(synth_dir, name):
    """Row-sparse Adagrad steps (weight decay lazy on the touched rows)
    against JAX's sparse step: after one step every parameter, batchnorm
    statistic and Adagrad leaf (as in ``test_dense_step_matches_jax``);
    over three steps the losses (rtol 1e-5) and the Adagrad sums (rtol
    1e-4, atol 1e-5 x the leaf's largest: Adagrad's steps turn f32 noise on
    near-zero gradient entries into moves of ~lr, which later gradients
    see).  Then the port's sparse step against its own dense step at weight
    decay 0, where the two agree: losses rtol 1e-6, Adagrad sums rtol
    1e-5."""
    _, losses, first, (jopt, popt), (model, p, batches) = _sparse_run(synth_dir, name)
    (jv1, jopt1), (pv1, popt1) = first
    _assert_updates_close(jv1, jopt1, pv1, popt1)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    jf, pf = _flat(jopt), _flat(popt)
    for k, want in jf.items():
        if k.endswith("/sum"):
            np.testing.assert_allclose(pf[k], want, rtol=1e-4, atol=1e-5 * np.abs(want).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(pf[k], want, err_msg=k)

    _, _, _, _, model, pv0 = _models(synth_dir, name, data=SHARED, sparse=True)
    opt = dict(OPT, weight_decay=0.0)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0, dedup_bucket=8)
    out = []
    for sparse in (False, True):
        v = {"params": _clone(pv0["params"]), "state": _clone(pv0["state"]), "buffers": pv0["buffers"]}
        reg = OptimizerRegimes(opt)
        reg.update(1, 0)
        step = (make_sparse_train_step(model, reg, v["params"], entity_sparse=True) if sparse
                else make_train_step(model, reg, v["params"]))
        o = reg.init_state(v["params"])
        ls = []
        for b in batches:
            v, o, stats = step(v, o, reg.hparams(), arrays_to_device(plan(b) if sparse else train_batch_to_arrays(b),
                                                                     "cpu"))
            ls.append(float(stats["loss_sum"]))
        out.append((ls, flatten_arrays(o, "opt")))
    (ld, od), (lsp, osp) = out
    np.testing.assert_allclose(lsp, ld, rtol=1e-6)
    for k in od:
        if k.endswith("/sum"):
            np.testing.assert_allclose(osp[k], od[k], rtol=1e-5, atol=1e-6 * np.abs(od[k]).max(), err_msg=k)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# ---------------------------------------------------- candidate cache


def _meta(entities, cls):
    return cls(entities_size=entities, relations_size=10, min_entities_size=2, min_relations_size=2,
               entity_tokens_size=0, relation_tokens_size=0, max_length=(10, 10))


@pytest.mark.parametrize("entities,shared", [(300, False), (200_010, False), (300, True)],
                         ids=["small-lookup", "large-lookup", "batch-shared"])
def test_candidate_cache_choice_matches_jax(synth_dir, entities, shared):
    """The trainer's full-vocabulary eval cache: None for a small lookup
    model (the eval step encodes the table slice itself) and for
    batch-shared eval, the encoded table slice above 200,000 entities, the
    chunked encode for a token model; as JAX chooses."""
    cfg = dict(entity_slot_size=4, init_std=0.1)
    jmodel = jax_build_model("LookupDistmultRelationModel", _meta(entities, JaxMeta), **cfg)
    model = build_model("LookupDistmultRelationModel", _meta(entities, DatasetMeta), **cfg)
    jv = jmodel.init(jax.random.key(0))
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays(jax_flatten(jv["params"], "params")))
    ds = SimpleNamespace(use_batch_shared_entities=shared)
    want = JaxTrainer._candidate_cache(SimpleNamespace(validation_dataset=ds, model=jmodel), jv, None)
    got = Trainer._candidate_cache(SimpleNamespace(validation_dataset=ds, model=model, variables=pv,
                                                   LOOKUP_CACHE_ABOVE=Trainer.LOOKUP_CACHE_ABOVE))
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a token model always takes the chunked cache in both packages
    _, _, jmodel, jv, model, pv = _models(synth_dir, "UnigramPoolingComplexRelationModel")
    full = SimpleNamespace(use_batch_shared_entities=False)
    want = JaxTrainer._candidate_cache(SimpleNamespace(validation_dataset=full, model=jmodel), jv, None)
    got = Trainer._candidate_cache(SimpleNamespace(validation_dataset=full, model=model, variables=pv))
    _close(got, want, "float32", "token cache")


# ------------------------------------------------------ CLI, eval, serving


FB_CONFIGS = sorted((ROOT / "configs" / "fb15k237").glob("*.yaml"))
# Adagrad's first step moves every weight by +-lr: at the config's lr 0.3 the
# d = 200 Tucker3 core diverges on the toy set's 8 entities, in the JAX
# package as in the port (JAX: pass losses 4.07, 3609, 3283, 912)
TOY_LR = {"fb15k237-tucker3-kge": 0.03}


@pytest.mark.parametrize("config", FB_CONFIGS, ids=[c.stem for c in FB_CONFIGS])
def test_cli_train_on_each_fb15k237_config(toy_dataset_dir, tmp_path, config):
    """``cli.train --device cpu`` on each shipped FB15k-237 config (the
    toy data in place of FB15k-237, which is not in the repository, and
    batches of 4 in place of 512 or 4096 to fit it) at the config's widths:
    ``--epochs 3`` (three passes by the reference's epoch rule), the loss
    finite and falling, and one full-vocabulary validation eval
    (``--eval_epoch_freq 2``: after the second pass; an LSTM eval encodes a
    32768-row cache chunk) with finite, ordered metrics."""
    cfg = yaml.safe_load(config.read_text())
    for key in ("train_data_config", "val_data_config", "test_data_config"):
        cfg[key]["batch_size"] = 4
    cfg["optimization_config"]["lr"] = TOY_LR.get(config.stem, cfg["optimization_config"]["lr"])
    (tmp_path / config.name).write_text(yaml.safe_dump(cfg))
    trainer = port_train.cli_main([
        str(tmp_path / config.name), "--device", "cpu", "--dataset_dir", toy_dataset_dir, "--experiment_dir",
        str(tmp_path / "exp"), "--epochs", "3", "--eval_epoch_freq", "2", "--workers", "1", "--print_freq", "1"])
    rows = trainer.results.to_dicts()
    losses = [r["training_loss"] for r in rows if "training_loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0], losses
    (ev,) = [r for r in rows if "validation_mrr" in r]
    assert 0 < ev["validation_mrr"] <= 1 and np.isfinite(ev["validation_loss"])
    assert ev["validation_h1"] <= ev["validation_h3"] <= ev["validation_h10"]
    assert trainer.last_eval["batches"] >= 1


LOOKUP_RUN = dict(model="LookupComplexRelationModel", model_config={"entity_slot_size": 8, "init_std": 0.1},
                  optimization_config={"optimizer": "Adagrad", "epoch": 0, "lr": 0.3},
                  train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": False},
                  val_data_config={"input_file": "valid.txt", "batch_size": 4, "use_batch_shared_entities": True,
                                   "min_size_batch_labels": 6},
                  test_data_config={"input_file": "test.txt", "batch_size": 4, "use_batch_shared_entities": False},
                  batch_size=4, eval_epoch_freq=0, print_freq=1, workers=2, seed=1)


@pytest.fixture(scope="module")
def jax_lookup_checkpoint(toy_dataset_dir, tmp_path_factory):
    """A JAX cli.train run of lookup ComplEx on the toy set (d = 8, 3 passes)."""
    d = tmp_path_factory.mktemp("jax_lookup_ckpt")
    args = jax_load_config()
    args.update(dict(LOOKUP_RUN, dataset_dir=toy_dataset_dir, experiment_dir=str(d / "exp"), epochs=3))
    return str(jax_main(args).save())


@pytest.mark.parametrize("on_validation", [True, False], ids=["validation", "test"])
def test_jax_lookup_checkpoint_evaluates_alike(toy_dataset_dir, tmp_path, jax_lookup_checkpoint, on_validation):
    """``cli.train --evaluate`` of a JAX lookup ComplEx checkpoint: the same
    filtered MRR (rtol 1e-6), MR and hits in both packages, on the
    batch-shared validation split and on the full-vocabulary test split
    (the dense [B, N] ranking over the encoded table slice)."""
    rows = {}
    for pkg in ("jax", "port"):
        cfg = dict(LOOKUP_RUN, dataset_dir=toy_dataset_dir, experiment_dir=str(tmp_path / pkg),
                   resume=jax_lookup_checkpoint, evaluate=True, evaluate_on_validation=on_validation,
                   evaluate_scores_file=str(tmp_path / f"{pkg}.csv"))
        if pkg == "jax":
            args = jax_load_config()
            args.update(cfg)
            jax_main(args)
        else:
            (tmp_path / "c.yaml").write_text(yaml.safe_dump(cfg))
            trainer = port_train.cli_main([str(tmp_path / "c.yaml"), "--device", "cpu"])
            assert trainer.last_eval["batches"] >= 1
        with open(tmp_path / f"{pkg}.csv") as f:
            (rows[pkg],) = list(csv.DictReader(f))
    want, got = rows["jax"], rows["port"]
    for k in ("mr", "h1", "h3", "h10", "h50", "epoch"):
        assert got[k] == want[k], k
    assert float(got["mrr"]) == pytest.approx(float(want["mrr"]), rel=1e-6)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)


@pytest.mark.parametrize("direction", ["subj", "obj"])
def test_lookup_predictor_matches_jax(synth_dir, direction):
    """The lookup Predictor (no token buffers: the device comes from the
    parameters) on the CPU: JAX's top-k ids and scores."""
    _, _, jmodel, jv, model, pv = _models(synth_dir, "LookupTucker3RelationModel", perturb_state=True)
    ent, rel, _ = _ids(model.meta, 8, 12)
    kw = {direction: ent, "rel": rel, "k": 10}
    want_s, want_i = JaxPredictor(jmodel, jv).predict(**kw)
    predictor = inference.Predictor(model, pv)
    assert predictor.device.type == "cpu" and pv["buffers"] == {}
    got_s, got_i = predictor.predict(**kw)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))
    np.testing.assert_allclose(got_s, np.asarray(want_s), rtol=1e-5, atol=1e-6)
