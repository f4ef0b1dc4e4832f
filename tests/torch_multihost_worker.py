"""Subprocess worker of tests/test_torch_multihost.py.

Usage: python torch_multihost_worker.py PACKAGE DATASET_DIR EXP_DIR NPROC PID PORT [start=CKPT] [accum=N]

PACKAGE ``port``: the port's ``cli.train`` on the CPU.  With NPROC > 1 the
rank joins a ``gloo`` world through the ``OKET_*`` environment variables
(``cli.train`` reads them) and the ranks train data-parallel, evaluate by
host and write per-shard checkpoints into ONE shared EXP_DIR; then each
rank reloads the end-of-run checkpoint (``Trainer.load``) and checks every
leaf bit-equal.  With NPROC = 1 it is a plain one-process run.

PACKAGE ``jax``: the JAX package's ``cli.train`` in one process on a data =
2 x model = 1 mesh of 2 virtual CPU devices (NPROC must be 1).

Both train lookup ComplEx on the toy set of tests/multihost_worker.py
(batch-shared candidates, eval batch 1), from the checkpoint ``start``
when given, with ``batch_size_for_backward`` ``accum`` x 4 when given.
"""

import os
import sys

package, dataset_dir, exp_dir, nproc, pid, port = sys.argv[1:7]
opts = dict(a.split("=", 1) for a in sys.argv[7:])
start = opts.get("start")
nproc, pid = int(nproc), int(pid)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARGS = dict(
    dataset_dir=dataset_dir, experiment_dir=exp_dir, seed=7, epochs=3, batch_size=4, eval_epoch_freq=2, eval_freq=-1,
    save_epoch_freq=-1, print_freq=1, eval_block_rows=0, workers=2,
    model="LookupComplexRelationModel",
    model_config={"entity_slot_size": 8, "init_std": 0.1},
    optimization_config={"optimizer": "Adagrad", "epoch": 0, "lr": 0.3, "weight_decay": 1e-10},
    train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": True,
                       "min_size_batch_labels": 6},
    val_data_config={"input_file": "valid.txt", "batch_size": 1, "use_batch_shared_entities": False},
    test_data_config={"input_file": "test.txt", "batch_size": 1, "use_batch_shared_entities": False},
)
if start:
    ARGS.update(resume=start, resume_load_args=False)
if "accum" in opts:
    ARGS.update(batch_size_for_backward=4 * int(opts["accum"]))

if package == "jax":
    assert nproc == 1
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
    from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config

    args = jax_load_config()
    args.update(ARGS, use_mesh=True, model_parallel=1, compilation_cache_dir="")
    trainer = jax_main(args)
    assert dict(trainer.mesh.shape) == {"data": 2, "model": 1}, trainer.mesh
    print(f"WORKER_OK jax steps={trainer.training_steps}")
    sys.exit(0)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)
if nproc > 1:
    os.environ["OKET_COORDINATOR"] = f"localhost:{port}"
    os.environ["OKET_NUM_PROCESSES"] = str(nproc)
    os.environ["OKET_PROCESS_ID"] = str(pid)

from open_knowledge_graph_embeddings_tpu_torch.cli.train import main  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist  # noqa: E402
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays  # noqa: E402

args = load_config()
args.update(ARGS)
trainer = main(args, device="cpu")
if nproc > 1:
    assert trainer.world == nproc and trainer.mesh is not None
    assert trainer.val_builder.host_shard == (pid, nproc)
    ck = max((os.path.join(exp_dir, d) for d in os.listdir(exp_dir) if d.startswith("checkpoint")),
             key=os.path.getmtime)
    for r in range(nproc):
        assert os.path.exists(os.path.join(ck, f"arrays.p{r}.npz")), (ck, r)
        assert os.path.exists(os.path.join(ck, f"index.p{r}.json")), (ck, r)
    assert os.path.exists(os.path.join(ck, "meta.json")) and not os.path.exists(os.path.join(ck, "arrays.npz"))
    before = {k: v.copy() for k, v in {**flatten_arrays(trainer.variables["params"], "params"),
                                        **flatten_arrays(trainer.opt_state, "opt")}.items()}
    trainer.load(ck)
    after = {**flatten_arrays(trainer.variables["params"], "params"), **flatten_arrays(trainer.opt_state, "opt")}
    for k, v in before.items():
        assert np.array_equal(v, after[k]), k
    print("CKPT_ROUNDTRIP_OK")
    dist.barrier()
    dist.destroy()
print(f"WORKER_OK port pid={pid} steps={trainer.training_steps} eval_batches_per_pass={len(trainer.val_builder)}")
