"""The port's data-parallel step on two ``gloo`` CPU processes against the JAX
package's step on a ``make_mesh(data=2, model=1)`` mesh (2 of the 8 virtual
CPU devices of tests/conftest.py).

JAX's program is written over the global batch and GSPMD splits it: rows
over ``data``, the candidate encode sharded over ``data`` and gathered,
the LSTM's row core per shard (``shard_map``), everything else global.
The port's ranks each score a block of the rows and sum their gradients
(train/step.py, parallel/distributed.py).  Both packages start from the
same weights (JAX's, through ``variables_from_jax_arrays``) and take the
same batches; each plans them on its own mesh.  Dropout is 0 (the random
generators differ).  Tolerance: rtol 1e-5, atol 1e-6 on the loss, every
Adagrad sum and batchnorm statistic, and every parameter, the JAX package's
own mesh tolerance
(tests/test_multichip.py::test_sparse_step_matches_single_device_on_mesh);
the two ranks' replicas must be bit-equal.  Adagrad's step is lr g /
(sqrt(sum) + 1e-10), so where a gradient is at summation-noise level its
relative noise reaches the parameter (one of 4096 LSTM weights has sum
5.6e-16, |g| = 2.4e-8, and moves 4.8e-6): a parameter with an Adagrad sum
below 1e-12 (|g| < 1e-6) but above 0 is held by its sum alone, and such
elements must be under 1 % of their leaf's touched elements.  The LSTM
case takes one step: that weight's 4.8e-6 reaches the second step's
gradients (one of 128 entries of b_ih then differs by 2.2e-6, 6e-5
relative); the lookup case takes three.  Also pinned on the host: the
row blocks against ``train_batch_shardings``, the per-rank plans and the
per-rank query dedup against JAX's."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.parallel import make_mesh as jax_make_mesh
from open_knowledge_graph_embeddings_tpu.parallel import opt_state_shardings, variables_shardings
from open_knowledge_graph_embeddings_tpu.parallel import train_batch_shardings as jax_batch_shardings
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.parallel import DATA_AXIS, block, make_mesh, train_batch_shardings
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
WORKER_TIMEOUT_S = 240

RTOL, ATOL = 1e-5, 1e-6
NOISE_SUM = 1e-12  # an Adagrad sum below it: |g| < 1e-6
LSTM_CFG = dict(entity_slot_size=32, init_std=0.1, sparse=True, dropout=0.0, normalize="batchnorm")
LOOKUP_CFG = dict(entity_slot_size=8, init_std=0.1, sparse=True)
ADAGRAD = {"optimizer": "Adagrad", "lr": 0.2}


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_parallel")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synth_olpbench.py"), str(d),
         "--mentions", "300", "--relations", "30", "--triples", "400",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "2"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _case(path, model_name, model_cfg, batch_size, min_labels, plan_kw, n_batches):
    """JAX's model and variables, the port's batches of that data (both
    packages' batches are equal, tests/test_torch_train_step.py) and the
    plan arguments."""
    cfg = dict(input_file="train.txt", is_training_data=True, batch_size=batch_size,
               use_batch_shared_entities=True, min_size_batch_labels=min_labels, max_size_prefix_label=4)
    jds = JaxDataset(dataset_dir=path, cache_dir=path + "/jax_cache", **cfg)
    pds = OneToNMentionRelationDataset(dataset_dir=path, cache_dir=path + "/port_cache", **cfg)
    jmodel = jax_build_model(model_name, jds.meta, **model_cfg)
    jv = jmodel.init(jax.random.key(0))
    batches = list(BatchBuilder(pds, seed=4).batches(shuffle=True))[:n_batches]
    return jds, pds, jmodel, jv, batches


def _jax_mesh_steps(jmodel, jv, batches, plan_kw):
    """JAX's sparse step on the data = 2 mesh, as its trainer sets it up
    for a pure data-parallel run -> flat params, state and optimizer state,
    and the losses."""
    mesh = jax_make_mesh(data=2, model=1)
    jmodel.set_mesh(mesh)
    jmodel.set_dp_candidate_sharding(mesh)
    try:
        reg = JaxRegimes(ADAGRAD)
        reg.update(1, 0)
        var_sh = variables_shardings(jv, mesh)
        vs = jax.device_put(jv, var_sh)
        opt = reg.init_state(vs["params"])
        opt = jax.device_put(opt, opt_state_shardings(opt, var_sh, mesh))
        step = jax_sparse_step(jmodel, reg, jv["params"], entity_sparse=True)
        plan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", mesh=mesh, **plan_kw)
        hp = [{k: jnp.float32(v) for k, v in h.items()} for h in reg.hparams()]
        losses = []
        for i, b in enumerate(batches):
            arrs = plan(b)
            sh = jax_batch_shardings(arrs, mesh)
            arrs = {k: jax.device_put(np.asarray(v), sh[k]) for k, v in arrs.items()}
            vs, opt, st = step(vs, opt, hp, arrs, jax.random.key(100 + i))
            losses.append(float(st["loss_sum"]))
    finally:
        jmodel.set_mesh(None)
        jmodel.set_dp_candidate_sharding(None)
    flat = {**jax_flatten(vs["params"], "params"), **jax_flatten(vs["state"], "state"), **jax_flatten(opt, "opt")}
    return {k: np.asarray(v) for k, v in flat.items()}, np.asarray(losses)


def _port_ranks(tmp_path, path, model_name, model_cfg, start, batches, plan_kw, world=2):
    """The port's step on ``world`` gloo CPU ranks -> each rank's outputs.
    Workers write to files, never to pipes (a full pipe blocks a rank
    inside a collective while its peer waits)."""
    case = {"dataset_dir": path, "cache_dir": path + "/port_cache", "max_lengths": (10, 10), "model": model_name,
            "model_config": model_cfg, "opt": ADAGRAD, "plan_kw": plan_kw, "batches": batches,
            "variables": start}
    case_path = tmp_path / "case.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    port, prefix = _free_port(), str(tmp_path / "out")
    procs = []
    for r in range(world):
        log = open(tmp_path / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, str(case_path), prefix, str(r), str(world), str(port)],
                                       stdout=log, stderr=subprocess.STDOUT, text=True), log))
    for p, log in procs:
        try:
            p.wait(timeout=WORKER_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
            log.close()
    for r, (p, log) in enumerate(procs):
        text = open(log.name).read()
        assert p.returncode == 0 and "WORKER_OK" in text, text[-4000:]
    return [dict(np.load(f"{prefix}.r{r}.npz")) for r in range(world)]


CASES = {
    # lookup ComplEx on the toy set: both lookup tables row-sparse
    "lookup-complex": ("LookupComplexRelationModel", LOOKUP_CFG, 4, 6, dict(min_rows_ratio=0.0), 3),
    # LSTM ComplEx d = 32 with batchnorm: per-rank gather-sum plans and
    # per-rank query dedup (bucket 8: each 64-row block's unique mentions)
    "lstm-complex-bn-dedup": ("LSTMComplexRelationModel", LSTM_CFG, 128, 128,
                              dict(min_rows_ratio=0.0, dedup_bucket=8), 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_step_matches_jax_mesh(case, tmp_path, synth_dir, toy_dataset_dir):
    name, cfg, bsz, labels, plan_kw, n = CASES[case]
    path = toy_dataset_dir if name.startswith("Lookup") else synth_dir
    _, _, jmodel, jv, batches = _case(path, name, cfg, bsz, labels, plan_kw, n)
    if "dedup_bucket" in plan_kw:  # the per-rank query dedup is engaged
        arrs = SparsePlanBuilder(build_model(name, OneToNMentionRelationDataset(
            dataset_dir=path, cache_dir=path + "/port_cache", input_file="train.txt", is_training_data=True,
            batch_size=bsz).meta, **cfg).embedder, True, mesh=make_mesh(2, 1, 0), **plan_kw)(batches[0])
        assert "dedup/ent_inv" in arrs and "sparse/plan/cand_token/pos" in arrs
    start = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}  # the step donates jv
    want, want_loss = _jax_mesh_steps(jmodel, jv, batches, plan_kw)
    ranks = _port_ranks(tmp_path, path, name, cfg, start, batches, plan_kw)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=f"replicas differ: {k}")
    got = ranks[0]
    np.testing.assert_allclose(got["loss_sum"], want_loss, rtol=RTOL)
    assert set(want) <= set(got)
    for k, w in want.items():
        g = got[k]
        acc = want.get(f"opt/{k.removeprefix('params/')}/sum") if k.startswith("params/") else None
        if acc is not None:  # see the module docstring: gradients at noise level
            noisy = (acc > 0) & (acc < NOISE_SUM)  # a sum of 0: an untouched row, compared
            assert noisy.sum() < 0.01 * max((acc > 0).sum(), 1), (k, noisy.sum())
            g, w = g[~noisy], w[~noisy]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)


def test_row_blocks_match_train_batch_shardings(synth_dir):
    """Which keys split over ``data`` and each rank's contiguous block equal
    JAX's ``train_batch_shardings`` on a data = 2 mesh (its device i's shard
    of each array), for a planned LSTM batch with query dedup."""
    name, cfg, bsz, labels, plan_kw, _ = CASES["lstm-complex-bn-dedup"]
    _, pds, jmodel, _, batches = _case(synth_dir, name, cfg, bsz, labels, plan_kw, 1)
    jmesh = jax_make_mesh(data=2, model=1)
    arrs = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", mesh=jmesh, **plan_kw)(batches[0])
    want = jax_batch_shardings(arrs, jmesh)
    split = 0
    for r in range(2):
        got = train_batch_shardings(arrs, make_mesh(2, 1, r))
        assert set(got) == set(want)
        for k, sh in want.items():
            spec = tuple(sh.spec)
            assert got[k] == (spec[0] if spec else None), k
            if got[k] == DATA_AXIS:
                split += 1
                n = arrs[k].shape[0]
                idx = sh.devices_indices_map((n,))[jmesh.devices.flat[r]][0]
                assert block(n, make_mesh(2, 1, r)) == idx.indices(n)[:2], k
    assert split >= 2 * 4  # ent_ids, rel_ids, is_sp, row_valid (and the dedup inverses)


@pytest.mark.parametrize("ratio,bucket", [(0.0, 8), (12.0, 512)], ids=["sparse-dedup", "flagship-gates"])
def test_mesh_plans_match_jax(synth_dir, ratio, bucket):
    """Every array of the port's plan on a 2 x 1 mesh equals JAX's on its
    data = 2 mesh: the stacked per-rank gather-sum plans (``cand``,
    ``entity``, ``relation``; JAX's native plan kernel and the port's give
    the same arrays) and the per-rank dedup's encode ids and global
    inverses."""
    name, cfg, bsz, labels, _, _ = CASES["lstm-complex-bn-dedup"]
    plan_kw = dict(min_rows_ratio=ratio, dedup_bucket=bucket)
    jds, pds, jmodel, _, batches = _case(synth_dir, name, cfg, bsz, labels, plan_kw, 3)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=True, layout="compact", mesh=jax_make_mesh(2, 1), **plan_kw)
    plan = SparsePlanBuilder(build_model(name, pds.meta, **cfg).embedder, True, mesh=make_mesh(2, 1, 0), **plan_kw)
    for b in batches:
        jd, pd = jplan(b), plan(b)
        assert set(pd) == set(jd)
        for k in jd:
            np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
        if ratio == 0.0:
            assert jd["sparse/plan/cand_token/pos"].ndim == 3 and "dedup/ent_inv" in jd


def test_mesh_of_one_rank_is_the_plain_plan(synth_dir):
    """A 1 x 1 mesh plans like no mesh but for the split encode's separate
    candidate plan."""
    name, cfg, bsz, labels, plan_kw, _ = CASES["lstm-complex-bn-dedup"]
    _, pds, _, _, batches = _case(synth_dir, name, cfg, bsz, labels, plan_kw, 1)
    emb = build_model(name, pds.meta, **cfg).embedder
    one, plain = SparsePlanBuilder(emb, True, mesh=make_mesh(1, 1, 0), **plan_kw)(batches[0]), SparsePlanBuilder(
        emb, True, **plan_kw)(batches[0])
    for k in plain:
        if not k.startswith("sparse/plan/entity_token"):
            np.testing.assert_array_equal(one[k], plain[k], err_msg=k)
    assert one["sparse/plan/cand_token/pos"].ndim == 2
