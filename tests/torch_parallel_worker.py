"""One rank of the port's data-parallel train step, for tests/test_torch_parallel.py.

Usage: python torch_parallel_worker.py CASE.pkl OUT_PREFIX RANK WORLD PORT

``CASE.pkl`` holds the dataset directory, the model name and config, the
optimizer config, the starting variables as JAX-named flat arrays, the
host batches and the plan builder's keyword arguments.  The rank joins a
``gloo`` world of WORLD CPU processes on localhost:PORT, plans every batch
on a WORLD x 1 mesh, runs the row-sparse step on each and writes its
params, batchnorm state, optimizer state and losses to
``OUT_PREFIX.r{RANK}.npz``.
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
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import (  # noqa: E402
    flatten_arrays,
    variables_from_jax_arrays,
)
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import (  # noqa: E402
    SparsePlanBuilder,
    make_sparse_train_step,
)
from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device  # noqa: E402


def main(case_path, out_prefix, rank, world, port):
    torch.set_num_threads(1)
    with open(case_path, "rb") as f:
        case = pickle.load(f)
    dist.maybe_initialize_distributed(
        {"coordinator_address": f"localhost:{port}", "num_processes": world, "process_id": rank}, "cpu")
    meta = load_meta(case["dataset_dir"], tuple(case["max_lengths"]), cache_dir=case["cache_dir"])
    model = build_model(case["model"], meta, **case["model_config"])
    variables = model.init(torch.Generator().manual_seed(0))
    variables.update(variables_from_jax_arrays(case["variables"]))
    mesh = make_mesh(data=world, model=1, rank=rank)
    model.set_mesh(mesh)
    regimes = OptimizerRegimes(case["opt"])
    regimes.update(1, 0)
    opt_state = regimes.init_state(variables["params"])
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, mesh=mesh, **case["plan_kw"])
    step = make_sparse_train_step(model, regimes, variables["params"], entity_sparse=True)
    losses, norms = [], []
    for b in case["batches"]:
        variables, opt_state, stats = step(variables, opt_state, regimes.hparams(), arrays_to_device(plan(b), "cpu"))
        losses.append(float(stats["loss_sum"]))
        norms.append(float(stats["normalizer_metric"]))
    out = {**flatten_arrays(variables["params"], "params"), **flatten_arrays(variables["state"], "state"),
           **flatten_arrays(opt_state, "opt"), "loss_sum": np.asarray(losses), "normalizer_metric": np.asarray(norms)}
    np.savez(f"{out_prefix}.r{rank}.npz", **out)
    dist.destroy()
    print(f"WORKER_OK rank={rank}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
