"""One rank of the port's model axis, for tests/test_torch_model_parallel.py.

Usage: python torch_model_parallel_worker.py CASES.pkl OUT_PREFIX RANK DATA MODEL PORT

The rank joins a ``gloo`` world of DATA x MODEL CPU processes on
localhost:PORT, lays it out as a DATA x MODEL mesh and runs every case of
``CASES.pkl`` (a dict name -> case) in order; each case's outputs go to
``OUT_PREFIX.r{RANK}.npz`` under ``name/key``.  The kinds:

* ``gather``: the boundary gather of a seeded table's rows (uneven slabs)
  and ``shard_map_score.sharded_embedding_lookup`` (equal slabs), each
  forward and its slab's gradient for a per-rank cotangent;
* ``shard_map``: ``make_sharded_lookup_train_step`` for ``steps`` steps
  and ``make_sharded_lookup_score_fn``'s loss;
* ``dense`` / ``sparse``: the trainer's dense step (``make_train_step``) or
  row-sparse step (``make_sparse_train_step`` on ``SparsePlanBuilder``'s
  plans) on slab variables, ``plant: True`` with a mesh whose model group
  is the world (the planted fault);
* ``eval``: ``eval_stats_chunked(block=)`` and ``filtered_topk_block`` on
  the rank's block of a candidate matrix;
* ``cache``: a token model's candidate cache (the rank's block) and the
  eval step's stats of one batch against it, and of a batch-shared batch
  (each rank encoding its block of the batch's candidates);
* ``ckpt``: a per-shard save of slab variables and three loads into slabs
  (the port's slabs, a single-file checkpoint, JAX's slabs);
* ``cli``: ``cli.train`` with ``model_parallel`` = MODEL.

Each worker writes to a file, never to a pipe (a full pipe blocks a rank
inside a collective while its peer waits).
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.parallel import shard_map_score as sms  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh  # noqa
from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import RowBlock, shard_variables, slab_bounds  # noqa
from open_knowledge_graph_embeddings_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import (  # noqa: E402
    eval_stats_chunked,
    filtered_topk_block,
)
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes, leaves  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import (  # noqa: E402
    SparsePlanBuilder,
    make_sparse_train_step,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import (  # noqa: E402
    arrays_to_device,
    make_train_step,
    train_batch_to_arrays,
)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def run_gather(case, mesh):
    table = case["table"]
    ids = _t(case["ids"]).long()
    M, m = mesh.model, mesh.index(MODEL_AXIS)
    ct = _t(np.random.default_rng(100 + mesh.rank).standard_normal((len(ids), table.shape[1])).astype(np.float32))
    lo, hi = slab_bounds(table.shape[0], M, m)
    slab = _t(table[lo:hi]).clone().requires_grad_()
    rows = dist.boundary_gather(slab, ids, lo, mesh.group(MODEL_AXIS))
    (rows * ct).sum().backward()
    rows_per = -(-table.shape[0] // M)
    padded = np.zeros((rows_per * M, table.shape[1]), np.float32)
    padded[: table.shape[0]] = table
    eq = _t(padded[m * rows_per : (m + 1) * rows_per]).clone().requires_grad_()
    rows_eq = sms.sharded_embedding_lookup(eq, ids, mesh)
    (rows_eq * ct).sum().backward()
    return {"rows": rows.detach().numpy(), "grad": slab.grad.numpy(), "ct": ct.numpy(), "lo": np.int64(lo),
            "rows_eq": rows_eq.detach().numpy(), "grad_eq": eq.grad.numpy()}


def _model(case):
    meta = load_meta(case["dataset_dir"], tuple(case.get("max_lengths", (10, 10))), cache_dir=case["cache_dir"])
    model = build_model(case["model"], meta, **case["model_config"])
    variables = model.init(torch.Generator().manual_seed(0))
    variables.update(ckpt.variables_from_jax_arrays(case["variables"]))
    return model, variables


def run_shard_map(case, mesh):
    model, variables = _model(case)
    loss_fn = sms.make_sharded_lookup_score_fn(model, mesh)
    step, prepare, prepare_batch = sms.make_sharded_lookup_train_step(model, mesh)
    params, opt = prepare(variables)
    batch = prepare_batch(case["batch"])
    out = {"fn_loss": loss_fn(variables, case["batch"]).numpy()}
    losses = []
    for _ in range(case["steps"]):
        params, opt, loss = step(params, opt, case["hp"], batch)
        losses.append(float(loss))
    out.update(losses=np.asarray(losses), ent=params["entity_embedding"].numpy(), acc_ent=opt["ent"].numpy(),
               rel=params["relation_embedding"].numpy(), acc_rel=opt["rel"].numpy())
    return out


def _plain_mesh(mesh, plant):
    """The mesh, or with ``plant`` one whose model group is the world."""
    if not plant:
        return mesh
    return Mesh(mesh.data, mesh.model, mesh.rank, {MODEL_AXIS: None, DATA_AXIS: mesh.group(DATA_AXIS)})


def run_step(case, mesh, sparse):
    model, variables = _model(case)
    mesh = _plain_mesh(mesh, case.get("plant"))
    model.set_mesh(mesh)
    variables = shard_variables(variables, mesh)
    regimes = OptimizerRegimes(case["opt"])
    regimes.update(1, 0)
    opt = regimes.init_state(variables["params"])
    if sparse:
        plan = SparsePlanBuilder(model.embedder, entity_sparse=True, mesh=mesh, **case["plan_kw"])
        step = make_sparse_train_step(model, regimes, variables["params"], entity_sparse=True)
    else:
        plan = train_batch_to_arrays
        step = make_train_step(model, regimes, variables["params"], loss_type=case.get("loss_type", "bce"),
                               grad_clip=case.get("grad_clip"))
    losses = []
    for i, b in enumerate(case["batches"]):
        arrays = arrays_to_device(plan(b), "cpu")
        variables, opt, stats = step(variables, opt, regimes.hparams(), arrays, torch.Generator().manual_seed(i))
        losses.append(float(stats["loss_sum"]))
    out = {**ckpt.flatten_arrays(variables["params"], "params"), **ckpt.flatten_arrays(variables["state"], "state"),
           **ckpt.flatten_arrays(opt, "opt"), "loss_sum": np.asarray(losses)}
    for name, (lo, hi, n) in variables.get("slabs", {}).items():
        out[f"slab/{name}"] = np.asarray([lo, hi, n])
    return out


def run_eval(case, mesh):
    c = case["case"]
    N = c["cand"].shape[0]
    M, m = mesh.model, mesh.index(MODEL_AXIS)
    lo, hi = slab_bounds(N, M, m)
    block = RowBlock(lo, hi, N, M, m, mesh.group(MODEL_AXIS))
    cand = _t(c["cand"][lo:hi])
    args = [_t(c[k]) for k in ("pos_rows", "pos_cols", "row_valid")]
    tail = [_t(c[k]) for k in ("filter_rows", "filter_cols", "gold_rows", "gold_mention_cols")]
    out = {}
    for loss_type in ("bce", "kl"):
        loss, ranks, gv = eval_stats_chunked(_t(c["q"]), cand, *args, _t(c["col_valid"]), torch.tensor(c["n_real"]),
                                             *tail, case.get("smoothing", 0.0), chunk=case["chunk"],
                                             loss_type=loss_type, block=block)
        out.update({f"{loss_type}_loss": loss.numpy(), f"{loss_type}_ranks": ranks.numpy(), "gold_valid": gv.numpy()})
    ts, tc = filtered_topk_block(_t(c["q"]), cand, tail[0], tail[1], _t(c["col_valid"]), case["k"], block,
                                 chunk=case["chunk"])
    out.update(top_scores=ts.numpy(), top_cols=tc.numpy())
    return out


def run_cache(case, mesh):
    """The full-vocabulary candidate cache of a token model (this rank's
    block, its token table gathered from the slabs) and the eval step's
    stats of one batch against it."""
    from open_knowledge_graph_embeddings_tpu_torch.train.step import eval_batch_to_arrays, make_eval_step

    model, variables = _model(case)
    model.set_mesh(mesh)
    variables = shard_variables(variables, mesh)
    cache = model.candidate_cache(variables)
    block = model.cand_block(None)
    step = make_eval_step(model)
    packed = step(variables, arrays_to_device(eval_batch_to_arrays(case["batch"]), "cpu"), cache)
    shared = step(variables, arrays_to_device(eval_batch_to_arrays(case["shared_batch"]), "cpu"))
    return {"cache": cache.numpy(), "block": np.asarray([block.lo, block.hi]), "packed": packed.numpy(),
            "shared": shared.numpy()}


def run_ckpt(case, mesh):
    model, variables = _model(case)
    model.set_mesh(mesh)
    variables = shard_variables(variables, mesh)
    regimes = OptimizerRegimes(case["opt"])
    regimes.update(1, 0)
    opt = regimes.init_state(variables["params"])
    rng = np.random.default_rng(7)  # the same draws on every rank: replicated leaves stay equal
    for _, leaf in leaves(opt):
        leaf.copy_(torch.tensor(rng.standard_normal(tuple(leaf.shape)), dtype=torch.float32))
    own = ckpt.checkpoint_arrays(variables, opt)
    path = ckpt.save_checkpoint_sharded(case["dir"], "slabs", variables, {"training_steps": 3}, opt, mesh.rank,
                                        mesh.data * mesh.model, dist.barrier,
                                        writes_slabs=mesh.index(DATA_AXIS) == 0)
    out = {f"own/{k}": v for k, v in own.items()}
    out["path"] = np.asarray(path)
    for name, (lo, hi, n) in variables["slabs"].items():
        out[f"slab/{name}"] = np.asarray([lo, hi, n])
    for tag, src in (("port", path), ("single", case["single"]), ("jax", case["jax_slabs"])):
        fresh = shard_variables(model.init(torch.Generator().manual_seed(1)), mesh)
        fresh_opt = regimes.init_state(fresh["params"])
        v, o, _ = ckpt.load_checkpoint(src, fresh, fresh_opt)
        out.update({f"{tag}/{k}": a for k, a in ckpt.checkpoint_arrays(v, o).items()})
    return out


def run_cli(case, mesh):
    from open_knowledge_graph_embeddings_tpu_torch.cli.train import main
    from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config

    args = load_config()
    args.update(case["args"])
    trainer = main(args, device="cpu")
    assert trainer.mesh.model == mesh.model and trainer.mesh.data == mesh.data, trainer.mesh
    out = {**ckpt.flatten_arrays(trainer.variables["params"], "params"),
           **ckpt.flatten_arrays(trainer.opt_state, "opt"),
           "steps": np.int64(trainer.training_steps), "checkpoint": np.asarray(trainer.last_checkpoint),
           "host_shard": np.asarray(trainer.val_builder.host_shard or (-1, -1))}
    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    out["validation_mrr"] = np.asarray([r["validation_mrr"] for r in rows])
    out["validation_loss"] = np.asarray([r["validation_loss"] for r in rows])
    out["training_loss"] = np.asarray([r["training_loss"] for r in trainer.results.to_dicts() if "training_loss" in r])
    for name, (lo, hi, n) in trainer.variables.get("slabs", {}).items():
        out[f"slab/{name}"] = np.asarray([lo, hi, n])
    return out


RUNNERS = {"gather": run_gather, "shard_map": run_shard_map, "cache": run_cache, "dense": lambda c, m: run_step(c, m, False),
           "sparse": lambda c, m: run_step(c, m, True), "eval": run_eval, "ckpt": run_ckpt, "cli": run_cli}


def main(case_path, out_prefix, rank, data, model, port):
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        cases = pickle.load(f)
    world = data * model
    os.environ.update(OKET_COORDINATOR=f"localhost:{port}", OKET_NUM_PROCESSES=str(world), OKET_PROCESS_ID=str(rank))
    dist.maybe_initialize_distributed(None, "cpu")
    mesh = make_mesh(data=data, model=model, rank=rank)
    out = {}
    for name, case in cases.items():
        for k, v in RUNNERS[case["kind"]](case, mesh).items():
            out[f"{name}/{k}"] = v
        dist.barrier()
    np.savez(f"{out_prefix}.r{rank}.npz", **out)
    dist.destroy()
    print(f"WORKER_OK rank={rank}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *map(int, sys.argv[3:7]))
