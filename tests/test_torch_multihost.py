"""The port's ``cli.train`` on two processes (``gloo``, CPU): the twin of
tests/test_multihost.py.

Two ranks must give what one gives: the same parameters (the end-of-run
checkpoint), the same ``training_loss`` and host-sharded
``validation_mrr`` / ``h10`` / ``loss`` at rtol 1e-5 (only the order of
sums differs), a log per rank, each rank evaluating half the eval batches,
a per-shard checkpoint (``arrays.p{r}.npz`` per rank, no ``arrays.npz``)
that every rank reloads bit-equal, and that the JAX package's
``open_checkpoint_reader`` reads leaf for leaf.  Then the port's two ranks
against the JAX package's one process on a data = 2 mesh, both resuming
from one JAX start checkpoint.

The setup is tests/multihost_worker.py's: lookup ComplEx on the toy set,
batch-shared candidates, eval batch 1, with ``model_parallel: 1``.  Each
worker writes to a file, never to a pipe (a full pipe blocks a rank inside
a collective while its peer waits), and has its own time limit.
"""

import csv
import glob
import os
import re
import socket
import subprocess
import sys

import numpy as np

import jax

from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import open_checkpoint_reader

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")
WORKER_TIMEOUT_S = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(package, dataset_dir, exp_dir, nproc, *opts):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "OKET_COORDINATOR", "OKET_NUM_PROCESSES", "OKET_PROCESS_ID")}
    procs = []
    for pid in range(nproc):
        log = open(f"{exp_dir}-worker{pid}.log", "w")
        cmd = [sys.executable, WORKER, package, dataset_dir, exp_dir, str(nproc), str(pid), str(port)]
        procs.append((subprocess.Popen(cmd + list(opts), stdout=log, stderr=subprocess.STDOUT, env=env, text=True),
                      log))
    return procs


def _join(procs):
    for p, log in procs:
        try:
            p.wait(timeout=WORKER_TIMEOUT_S)
        finally:
            if p.poll() is None:
                p.kill()
            log.close()
    for p, log in procs:
        out = open(log.name).read()
        assert p.returncode == 0 and "WORKER_OK" in out, f"worker failed:\n{out[-4000:]}"
        if len(procs) > 1:
            assert "CKPT_ROUNDTRIP_OK" in out


def _newest_checkpoint(exp_dir):
    ckpts = [os.path.join(exp_dir, d) for d in os.listdir(exp_dir) if d.startswith("checkpoint")]
    assert ckpts, os.listdir(exp_dir)
    return max(ckpts, key=os.path.getmtime)


def _final_params(exp_dir, reader=open_checkpoint_reader):
    r = reader(_newest_checkpoint(exp_dir))
    return {k: np.asarray(r.read_full(k)) for k in r.keys() if k.startswith("params/")}


def _rows(exp_dir):
    with open(os.path.join(exp_dir, "results.csv")) as f:
        return list(csv.DictReader(f))


def _column(rows, key):
    return [float(r[key]) for r in rows if r.get(key)]


def test_two_ranks_match_one_rank(toy_dataset_dir, tmp_path):
    single_dir, multi_dir = str(tmp_path / "single"), str(tmp_path / "multi")
    single = _start("port", toy_dataset_dir, single_dir, 1)
    multi = _start("port", toy_dataset_dir, multi_dir, 2)
    _join(single)
    _join(multi)
    _assert_runs_equal(single_dir, multi_dir)


def test_two_ranks_accumulate_as_one_rank(toy_dataset_dir, tmp_path):
    """Gradient accumulation (``batch_size_for_backward`` 2 x 4) on two
    ranks: each micro-batch's gradients are summed over the ranks, then
    added up over the window, as the JAX package's step on a mesh does."""
    single_dir, multi_dir = str(tmp_path / "single"), str(tmp_path / "multi")
    single = _start("port", toy_dataset_dir, single_dir, 1, "accum=2")
    multi = _start("port", toy_dataset_dir, multi_dir, 2, "accum=2")
    _join(single)
    _join(multi)
    _assert_runs_equal(single_dir, multi_dir)


def _opt_leaves(exp_dir):
    r = open_checkpoint_reader(_newest_checkpoint(exp_dir))
    return {k: np.asarray(r.read_full(k)) for k in r.keys() if k.startswith("opt/")}


def test_two_ranks_train_the_flagship_family_as_one_rank(toy_dataset_dir, tmp_path):
    """The flagship's family on two ranks (LSTM ComplEx: row-sparse token
    tables, dropout 0.1, batchnorm, batch-shared training) against a world
    of one over 3 passes: the first pass's training loss, every validation
    MRR and h10 at rtol 1e-5, every optimizer step counter equal and the
    same rows of every table updated (a row's Adagrad sum leaves 0 when a
    step touches it).  The parameters are held only to 5 % of max|want|:
    Adagrad's first steps move a weight by lr whatever its gradient's size,
    so where a gradient sums to near 0 the order of the sums (one process
    or two ranks, or one process on another thread count) picks the sign,
    and training carries it, while the validation metrics stay equal."""
    single_dir, multi_dir = str(tmp_path / "single"), str(tmp_path / "multi")
    single = _start("port", toy_dataset_dir, single_dir, 1, "model=lstm")
    multi = _start("port", toy_dataset_dir, multi_dir, 2, "model=lstm")
    _join(single)
    _join(multi)
    rows_s, rows_m = _rows(single_dir), _rows(multi_dir)
    np.testing.assert_allclose(_column(rows_m, "training_loss")[0], _column(rows_s, "training_loss")[0], rtol=1e-5)
    for key in ("validation_mrr", "validation_h10"):
        col_s, col_m = _column(rows_s, key), _column(rows_m, key)
        assert len(col_s) == len(col_m) > 0, key
        np.testing.assert_allclose(col_m, col_s, rtol=1e-5, err_msg=key)
    opt_s, opt_m = _opt_leaves(single_dir), _opt_leaves(multi_dir)
    assert set(opt_s) == set(opt_m) and "opt/entity_token_embedding/sum" in opt_s
    for k, w in opt_s.items():
        if k.endswith("/step"):
            np.testing.assert_array_equal(opt_m[k], w, err_msg=k)
        elif w.ndim == 2:
            np.testing.assert_array_equal((opt_m[k] != 0).any(1), (w != 0).any(1), err_msg=k)
    p_s, p_m = _final_params(single_dir), _final_params(multi_dir)
    assert set(p_s) == set(p_m)
    for k, w in p_s.items():
        assert np.abs(p_m[k] - w).max() <= 0.05 * np.abs(w).max(), k


def _assert_runs_equal(single_dir, multi_dir):
    p_single, p_multi = _final_params(single_dir), _final_params(multi_dir)
    assert set(p_single) == set(p_multi)
    for k in p_single:
        np.testing.assert_allclose(p_multi[k], p_single[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # the JAX package's reader takes the port's slabs leaf for leaf
    p_jax = _final_params(multi_dir, jax_ckpt.open_checkpoint_reader)
    assert set(p_jax) == set(p_multi)
    for k in p_multi:
        np.testing.assert_array_equal(p_jax[k], p_multi[k], err_msg=k)
    ck = _newest_checkpoint(multi_dir)
    assert sorted(os.path.basename(f) for f in glob.glob(os.path.join(ck, "*"))) == [
        "arrays.p0.npz", "arrays.p1.npz", "index.p0.json", "index.p1.json", "meta.json"]

    rows_s, rows_m = _rows(single_dir), _rows(multi_dir)
    assert len(rows_s) == len(rows_m) > 0
    losses_s, losses_m = _column(rows_s, "training_loss"), _column(rows_m, "training_loss")
    assert len(losses_s) == len(losses_m) > 0
    np.testing.assert_allclose(losses_m, losses_s, rtol=1e-5)
    for key in ("validation_mrr", "validation_h10", "validation_loss"):
        col_s, col_m = _column(rows_s, key), _column(rows_m, key)
        assert len(col_s) == len(col_m) > 0, key
        np.testing.assert_allclose(col_m, col_s, rtol=1e-5, err_msg=key)

    # a log per rank in the shared directory; each rank ranked half the
    # eval batches (the toy valid split: 4 prefixes at eval batch 1)
    rank_logs = {}
    for path in glob.glob(os.path.join(multi_dir, "log_*.txt")):
        m = re.search(r"\.p(\d+)\.txt$", path)
        rank_logs[int(m.group(1)) if m else -1] = open(path).read()
    assert set(rank_logs) == {0, 1}, sorted(rank_logs)

    def eval_batches(text):
        return [int(m) for m in re.findall(r"local batches:\s*(\d+)", text)]

    counts_single = eval_batches(open(glob.glob(os.path.join(single_dir, "log_*.txt"))[0]).read())
    assert counts_single and all(c == 4 for c in counts_single), counts_single
    for rank, text in rank_logs.items():
        counts = eval_batches(text)
        assert counts and all(c == 2 for c in counts), (rank, counts)
    assert not glob.glob(os.path.join(multi_dir, "results.p*.csv"))


def test_two_ranks_match_jax_data_parallel_mesh(toy_dataset_dir, tmp_path):
    """The port's two ranks and the JAX package's one process on a data = 2
    mesh (2 virtual CPU devices), both resuming from one JAX start
    checkpoint: the final parameters and the results rows."""
    meta = load_meta(toy_dataset_dir)
    model = jax_build_model("LookupComplexRelationModel", meta, entity_slot_size=8, init_std=0.1)
    variables = model.init(jax.random.key(11))
    reg = JaxRegimes({"optimizer": "Adagrad", "epoch": 0, "lr": 0.3, "weight_decay": 1e-10})
    reg.update(1, 0)
    start = jax_ckpt.save_checkpoint(str(tmp_path), "start", variables, reg.init_state(variables["params"]),
                                     {"epoch": 1, "training_steps": 0})
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_run = _start("jax", toy_dataset_dir, jax_dir, 1, f"start={start}")
    port_run = _start("port", toy_dataset_dir, port_dir, 2, f"start={start}")
    _join(jax_run)
    _join(port_run)

    want, got = _final_params(jax_dir, jax_ckpt.open_checkpoint_reader), _final_params(port_dir)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    rows_j, rows_p = _rows(jax_dir), _rows(port_dir)
    assert len(rows_j) == len(rows_p) > 0
    for key in ("training_loss", "validation_mrr", "validation_h10", "validation_loss"):
        col_j, col_p = _column(rows_j, key), _column(rows_p, key)
        assert len(col_j) == len(col_p) > 0, key
        np.testing.assert_allclose(col_p, col_j, rtol=1e-5, err_msg=key)
