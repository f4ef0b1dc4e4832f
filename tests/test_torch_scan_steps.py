"""Multi-step dispatch in the torch port against the JAX package on the CPU:
``train/step.py::make_scanned_step`` (on the CPU the K steps one after
another, the plain version of the card's CUDA graph) against JAX's
``make_scanned_step`` for the dense and the row-sparse step of the toy
lookup ComplEx; the trainer's window path (``train_scan_steps``: one
3-window and a 2-batch tail an epoch) against single steps and against
JAX's trainer from one JAX init; the three gates that turn scan mode off;
the producer thread of the windows; the cadence of print, save and eval at
a window's last step; and the background checkpoint write
(``CheckpointManager``) against a synchronous one and JAX's manager.

Inputs are seeded numpy (JAX's batches and weights, carried across by
``variables_from_jax_arrays``); tolerances are JAX's own test's (atol 1e-6
for the steps, 2e-6 for whole runs)."""

import logging
import os
import re
import threading
import time
import types

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data import BatchBuilder as JaxBatchBuilder
from open_knowledge_graph_embeddings_tpu.data import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu.train import train_batch_to_arrays as jax_train_arrays
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu.train.sparse import SparsePlanBuilder as JaxPlanBuilder
from open_knowledge_graph_embeddings_tpu.train.sparse import make_sparse_train_step as jax_sparse_step
from open_knowledge_graph_embeddings_tpu.train.step import make_scanned_step as jax_scanned_step
from open_knowledge_graph_embeddings_tpu.train.step import make_train_step as jax_train_step
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel, build_model
from open_knowledge_graph_embeddings_tpu_torch.train import checkpoint as port_ckpt
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
from open_knowledge_graph_embeddings_tpu_torch.train.step import (
    PackedWindow,
    arrays_to_device,
    make_scanned_step,
    make_train_step,
    window_views,
)
from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

NAME = "LookupComplexRelationModel"
MODEL_CONFIG = {"entity_slot_size": 8, "init_std": 0.1}
OPT = {"optimizer": "Adagrad", "lr": 0.2}


def _setup(toy_dataset_dir):
    """JAX's toy lookup ComplEx and the port's with JAX's weights."""
    jds = JaxDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True, batch_size=2)
    pds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                       batch_size=2)
    jmodel = jax_build_model(NAME, jds.meta, **MODEL_CONFIG)
    jv = jmodel.init(jax.random.key(0))
    model = build_model(NAME, pds.meta, **MODEL_CONFIG)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays({**jax_ckpt.flatten_arrays(jv["params"], "params"),
                                         **jax_ckpt.flatten_arrays(jv["state"], "state")}))
    jreg, preg = JaxRegimes(OPT), OptimizerRegimes(OPT)
    jreg.update(1, 0)
    preg.update(1, 0)
    return jds, jmodel, jv, jreg, model, pv, preg


def _stack(batches):
    return {n: np.stack([np.asarray(b[n]) for b in batches]) for n in batches[0]}


def _windows(arrays, form):
    """The port's window input: the stacked numpy dict, or a PackedWindow."""
    return _stack(arrays) if form == "dict" else PackedWindow(arrays)


def _assert_close(port_tree, jax_tree, prefix, atol):
    got, want = flatten_arrays(port_tree, prefix), jax_ckpt.flatten_arrays(jax_tree, prefix)
    assert set(got) == set(want) and got
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("form", ["dict", "packed"])
def test_scanned_dense_step_matches_jax(toy_dataset_dir, form):
    """Four dense steps in one window: the per-step losses, every parameter
    and every Adagrad leaf against JAX's ``lax.scan`` window."""
    jds, jmodel, jv, jreg, model, pv, preg = _setup(toy_dataset_dir)
    batches = [jax_train_arrays(b) for b in JaxBatchBuilder(jds, seed=3).batches()][:4]
    assert len(batches) == 4
    keys = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(7), 4)))
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    jstep = jax_scanned_step(jax_train_step(jmodel, jreg, jv["params"]), 4)
    jv2, jopt, jstats = jstep(jv, jreg.init_state(jv["params"]), jhp, _stack(batches), jnp.asarray(keys))

    scanned = make_scanned_step(make_train_step(model, preg, pv["params"]), 4)
    pv2, popt, pstats = scanned(pv, preg.init_state(pv["params"]), preg.hparams(), _windows(batches, form))
    assert pstats["loss_sum"].shape == (4,)
    np.testing.assert_allclose(pstats["loss_sum"].numpy(), np.asarray(jstats["loss_sum"]), rtol=1e-6)
    np.testing.assert_allclose(pstats["normalizer_metric"].numpy(), np.asarray(jstats["normalizer_metric"]),
                               rtol=0)
    _assert_close(pv2["params"], jv2["params"], "params", 1e-6)
    _assert_close(popt, jopt, "opt", 1e-6)


@pytest.mark.parametrize("form", ["dict", "packed"])
def test_scanned_sparse_step_matches_jax(toy_dataset_dir, form):
    """Three row-sparse steps (both lookup tables planned) in one window
    against JAX's window of its sparse step."""
    jds, jmodel, jv, jreg, model, pv, preg = _setup(toy_dataset_dir)
    jplan = JaxPlanBuilder(jmodel.embedder, entity_sparse=False, min_rows_ratio=0.0)
    batches = [jplan(b) for b in JaxBatchBuilder(jds, seed=5).batches()][:3]
    assert len({tuple(sorted(b)) for b in batches}) == 1
    assert any(k.startswith("sparse/") for k in batches[0])
    keys = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(11), 3)))
    jhp = [{k: jnp.float32(v) for k, v in h.items()} for h in jreg.hparams()]
    jstep = jax_scanned_step(jax_sparse_step(jmodel, jreg, jv["params"], entity_sparse=False), 3)
    jv2, jopt, jstats = jstep(jv, jreg.init_state(jv["params"]), jhp, _stack(batches), jnp.asarray(keys))

    step = make_sparse_train_step(model, preg, pv["params"], entity_sparse=False)
    pv2, popt, pstats = make_scanned_step(step, 3)(pv, preg.init_state(pv["params"]), preg.hparams(),
                                                   _windows(batches, form))
    np.testing.assert_allclose(pstats["loss_sum"].numpy(), np.asarray(jstats["loss_sum"]), rtol=1e-6)
    _assert_close(pv2["params"], jv2["params"], "params", 1e-6)
    _assert_close(popt, jopt, "opt", 1e-6)


def test_scanned_lstm_step_draws_dropout_as_single_steps(toy_dataset_dir):
    """A token model with dropout and batchnorm: a window consumes the
    generator exactly as its K single steps do (the same masks), so the
    window equals them bit for bit, and the generator ends in the same
    state."""
    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2, use_batch_shared_entities=True, min_size_batch_labels=6)
    cfg = dict(entity_slot_size=8, init_std=0.1, sparse=True, dropout=0.3, normalize="batchnorm")
    model = build_model("LSTMComplexRelationModel", ds.meta, **cfg)
    reg = OptimizerRegimes(OPT)
    reg.update(1, 0)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0)
    arrays = [plan(b) for b in BatchBuilder(ds, seed=2).batches()]
    assert len(arrays) >= 3
    sig = {tuple(sorted((n, np.shape(a)) for n, a in d.items())) for d in arrays[:3]}
    assert len(sig) == 1, "the toy batches should share one signature"

    def run(window):
        v = model.init(torch.Generator().manual_seed(0))
        opt = reg.init_state(v["params"])
        step = make_sparse_train_step(model, reg, v["params"], entity_sparse=True)
        gen = torch.Generator().manual_seed(5)
        if window:
            v, opt, stats = make_scanned_step(step, 3)(v, opt, reg.hparams(), PackedWindow(arrays[:3]), gen)
            losses = stats["loss_sum"]
        else:
            losses = []
            for a in arrays[:3]:
                v, opt, st = step(v, opt, reg.hparams(), arrays_to_device(a, "cpu"), gen)
                losses.append(st["loss_sum"])
            losses = torch.stack(losses)
        return losses, {**flatten_arrays(v["params"], "p"), **flatten_arrays(v["state"], "s"),
                        **flatten_arrays(opt, "o")}, gen.get_state()

    (l1, t1, g1), (l3, t3, g3) = run(False), run(True)
    assert torch.equal(l1, l3)
    assert set(t1) == set(t3)
    for k in t1:
        np.testing.assert_array_equal(t1[k], t3[k], err_msg=k)
    assert torch.equal(g1, g3)


def test_packed_window_layout():
    """One byte buffer, every leaf 256-byte aligned, int32 stored as int64
    (as a single step's ``arrays_to_device`` gives it), scalars stacked to
    [K]; the views read back what was stacked."""
    rng = np.random.default_rng(0)
    arrays = [{"ids": rng.integers(0, 9, (5, 3)).astype(np.int32), "ok": rng.random(7) < 0.5,
               "norm": np.float32(rng.random()), "empty": np.zeros((0, 4), np.int32)} for _ in range(3)]
    w = PackedWindow(arrays)
    assert [n for n, *_ in w.layout] == ["empty", "ids", "norm", "ok"]
    assert all(off % 256 == 0 for *_, off in w.layout)
    views = window_views(w.host, w.layout)
    assert views["ids"].dtype == torch.int64 and views["ids"].shape == (3, 5, 3)
    assert views["norm"].dtype == torch.float32 and views["norm"].shape == (3,)
    assert views["ok"].dtype == torch.bool and views["empty"].shape == (3, 0, 4)
    for i, a in enumerate(arrays):
        single = arrays_to_device(a, "cpu")
        for n in a:
            assert torch.equal(views[n][i], single[n]), n
    assert w.signature == PackedWindow(arrays[::-1]).signature


# --------------------------------------------------------------- trainer


def _config(toy_dataset_dir, exp_dir, scan_steps, **over):
    """JAX's own trainer test's toy run (tests/test_scan_steps.py): 5
    batches of 2 an epoch, so an epoch is one 3-window and a tail of 2."""
    cfg = dict(dataset_dir=toy_dataset_dir, experiment_dir=str(exp_dir), epochs=3, batch_size=2,
               eval_epoch_freq=0, eval_freq=-1, save_epoch_freq=1, print_freq=100, model=NAME,
               model_config=MODEL_CONFIG, optimization_config={"optimizer": "Adagrad", "lr": 0.3},
               train_data_config={"input_file": "train.txt", "batch_size": 2, "use_batch_shared_entities": False},
               val_data_config={"input_file": "valid.txt", "batch_size": 2, "use_batch_shared_entities": False},
               test_data_config={"input_file": "test.txt", "batch_size": 2, "use_batch_shared_entities": False},
               seed=17, workers=1, train_scan_steps=scan_steps)
    cfg.update(over)
    return cfg


def _port_run(toy_dataset_dir, tmp_path, tag, scan_steps, **over):
    cfg = tmp_path / f"{tag}.yaml"
    cfg.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / tag, scan_steps, **over)))
    return port_train.cli_main([str(cfg), "--device", "cpu"])


def test_trainer_scan_steps_matches_single_steps_and_jax(toy_dataset_dir, tmp_path, monkeypatch):
    """``cli.train`` with ``train_scan_steps: 3`` against ``1`` (every
    epoch one 3-window and a 2-batch tail flushed as single steps) and
    against JAX's trainer with ``train_scan_steps: 3``, all from JAX's
    init: every parameter and Adagrad leaf within 2e-6."""
    from open_knowledge_graph_embeddings_tpu.models.model import KGEModel as JaxKGEModel

    inits = []
    orig = JaxKGEModel.init

    def record_init(self, rng):
        v = orig(self, rng)
        inits.append({n: np.array(a) for k in ("params", "state")
                      for n, a in jax_ckpt.flatten_arrays(v[k], k).items()})
        return v

    monkeypatch.setattr(JaxKGEModel, "init", record_init)
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, tmp_path / "jax", 3, use_mesh=False))
    jtrainer = jax_main(args)
    assert jtrainer.scan_steps == 3
    port_init = KGEModel.init
    monkeypatch.setattr(KGEModel, "init", lambda self, gen: {**port_init(self, gen),
                                                             **variables_from_jax_arrays(inits[0])})
    single = _port_run(toy_dataset_dir, tmp_path, "single", 1)
    window = _port_run(toy_dataset_dir, tmp_path, "window", 3)
    assert window.scan_steps == 3 and single.scan_steps == 1
    assert window.training_steps == single.training_steps == jtrainer.training_steps == 15
    # three passes of 5 batches, each one window and a tail of two single steps
    assert window.train_step_scan.windows == 3 and len(window.step_log) == 15
    want = {**jax_ckpt.flatten_arrays(jtrainer.variables["params"], "params"),
            **jax_ckpt.flatten_arrays(jtrainer.opt_state, "opt")}
    for trainer in (single, window):
        got = {**flatten_arrays(trainer.variables["params"], "params"), **flatten_arrays(trainer.opt_state, "opt")}
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-6, err_msg=k)
    for k in got:
        np.testing.assert_allclose(
            flatten_arrays(window.variables["params"], "params").get(k, got[k]),
            flatten_arrays(single.variables["params"], "params").get(k, got[k]), rtol=0, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("gate", ["accumulation", "mesh", "step-phases"])
def test_gates_turn_scan_mode_off(toy_dataset_dir, tmp_path, gate, caplog, monkeypatch):
    """Gradient accumulation, a mesh of ranks and a step-keyed optimizer
    phase each turn scan mode off with JAX's log line; without them it
    stays on."""
    over = {}
    if gate == "accumulation":
        over = dict(batch_size_for_backward=4)
    elif gate == "step-phases":
        over = dict(optimization_config=[[{"optimizer": "Adagrad", "lr": 0.3},
                                          {"optimizer": "Adagrad", "lr": 0.1, "step": 3}]])
    cfg = _config(toy_dataset_dir, tmp_path / gate, 3, epochs=1, save_epoch_freq=0, **over)
    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2, batch_size_for_backward=cfg.get("batch_size_for_backward"))
    model = build_model(NAME, ds.meta, **MODEL_CONFIG)
    if gate == "mesh":
        # a world of two ranks: the trainer sees a mesh (its collectives are never reached here)
        import open_knowledge_graph_embeddings_tpu_torch.train.trainer as trainer_mod

        mesh = types.SimpleNamespace(shape={"data": 2, "model": 1}, data=2, model=1, index=lambda axis: 0)
        monkeypatch.setattr(trainer_mod.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(trainer_mod.dist, "process_count", lambda: 2)
        monkeypatch.setattr(trainer_mod.dist, "backend", lambda: "gloo")
        monkeypatch.setattr(trainer_mod.dist, "local_eval_mesh", lambda m: m)
        monkeypatch.setattr(trainer_mod, "default_mesh", lambda model_parallel: mesh)
        monkeypatch.setattr(trainer_mod, "shard_variables", lambda v, m: v)
        monkeypatch.setattr(model, "set_mesh", lambda m: None)
    with caplog.at_level(logging.INFO):
        trainer = Trainer(cfg, model, ds, save_path=str(tmp_path / gate), device="cpu")
    reason = {"accumulation": "gradient accumulation", "mesh": "device mesh",
              "step-phases": "step-keyed optimizer phases"}[gate]
    assert trainer.scan_steps == 1 and trainer.train_step_scan is None
    assert f"train_scan_steps=3 disabled ({reason})" in caplog.text
    if gate == "step-phases":  # the same run with an epoch-keyed phase keeps it on
        cfg["optimization_config"] = [[{"optimizer": "Adagrad", "lr": 0.3},
                                       {"optimizer": "Adagrad", "lr": 0.1, "epoch": 2}]]
        on = Trainer(cfg, model, ds, save_path=str(tmp_path / "on"), device="cpu")
        assert on.scan_steps == 3 and on.train_step_scan is not None


def _fake_trainer(k=2):
    return types.SimpleNamespace(scan_steps=k, device=torch.device("cpu"))


def test_window_entries_producer_exits_on_early_consumer_exit():
    """Closing the entry generator (an error, an early stop) releases the
    window producer, which would otherwise block on its full queue."""

    def src():
        i = 0
        while True:  # endless batches of one signature
            i += 1
            yield object(), {"x": np.full((4,), i, np.int32)}, 0.5

    n_before = threading.active_count()
    gen = Trainer._window_entries(_fake_trainer(), src())
    entry = next(gen)
    assert entry.kind == "w" and len(entry.batches) == 2 and isinstance(entry.arrays, PackedWindow)
    assert entry.plan_ms == [0.5, 0.5] and entry.flushed is None
    assert threading.active_count() == n_before + 1
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == n_before, "the window producer did not exit"


def test_window_entries_flush_on_signature_change_and_tail():
    """A batch of another signature flushes the buffer as single steps,
    naming the leaf that differed, the epoch's tail too; a full buffer is
    one window whose stacked leaves are the batches' in order; each entry
    carries its batches' plan ms."""
    shapes = [4, 4, 4, 4, 4, 6, 4, 4, 4, 4]  # a window, a signature change, a window, the tail

    def src():
        for i, n in enumerate(shapes):
            yield i, {"x": np.full((n,), i, np.int32), "s": np.float32(i)}, float(i)

    entries = list(Trainer._window_entries(_fake_trainer(3), src()))
    kinds = [(e.kind, list(e.batches), e.flushed) for e in entries]
    assert kinds == [("w", [0, 1, 2], None), ("s", [3], "signature:x"), ("s", [4], "signature:x"),
                     ("s", [5], "signature:x"), ("w", [6, 7, 8], None), ("s", [9], "tail")]
    assert [e.plan_ms for e in entries] == [[0.0, 1.0, 2.0], [3.0], [4.0], [5.0], [6.0, 7.0, 8.0], [9.0]]
    views = window_views(entries[0].arrays.host, entries[0].arrays.layout)
    assert views["x"].tolist() == [[0] * 4, [1] * 4, [2] * 4] and views["s"].tolist() == [0.0, 1.0, 2.0]
    assert entries[1].arrays["x"].dtype == torch.int64 and entries[3].arrays["x"].shape == (6,)


def test_cadence_fires_at_a_windows_last_step(toy_dataset_dir, tmp_path, monkeypatch):
    """Print, save and eval at every step (frequency 1): single steps fire at
    steps 1-4 of each pass of 5 (step_i > 0); a 3-window crosses once and
    fires at its last step, then each step of the tail fires; the saves and
    evals happen after the window's third training step."""
    fired = {"save": [], "eval": []}
    orig_save, orig_eval = Trainer.save, Trainer.evaluate

    def save(self, *a, **kw):
        fired["save"].append(self.training_steps)
        return orig_save(self, *a, **kw)

    def evaluate(self, *a, **kw):
        fired["eval"].append(self.training_steps)
        return orig_eval(self, *a, **kw)

    monkeypatch.setattr(Trainer, "save", save)
    monkeypatch.setattr(Trainer, "evaluate", evaluate)
    lines = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda record: lines.append(record.getMessage())
    trainer_log = logging.getLogger(Trainer.__module__)
    trainer_log.addHandler(handler)
    out = {}
    try:
        for k in (1, 3):
            fired = {"save": [], "eval": []}
            lines.clear()
            _port_run(toy_dataset_dir, tmp_path, f"k{k}", k, epochs=2, save_epoch_freq=0, print_freq=1,
                      save_freq=1, eval_freq=1)
            printed = [int(m) for ln in lines for m in re.findall(r"TRAINING - EPOCH \[\s*\d+\]\[\s*(\d+)/5\]", ln)]
            out[k] = (printed, fired["save"], fired["eval"])
    finally:
        trainer_log.removeHandler(handler)
    # two passes of 5 steps (step_i 0-4); the last save is the run's end
    assert out[1] == ([1, 2, 3, 4] * 2, [2, 3, 4, 5, 7, 8, 9, 10, 10], [2, 3, 4, 5, 7, 8, 9, 10])
    assert out[3] == ([2, 3, 4] * 2, [3, 4, 5, 8, 9, 10, 10], [3, 4, 5, 8, 9, 10])


# ----------------------------------------------------------- checkpoints


def _tree(seed):
    rng = np.random.default_rng(seed)
    params = {"a": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)),
              "b": {"w": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}}
    opt = {"a": {"sum": torch.from_numpy(rng.random((5, 3)).astype(np.float32)), "step": torch.tensor(float(seed))},
           "b": {"w": {}}}
    return {"params": params, "state": {}}, opt


# (meta epoch, is_best, tags, save_all) of the saves the manager makes in turn
SAVES = [(1, False, None, False), (1, True, ["mrr"], True), (2, True, ["mrr", "h1"], False),
         (2, False, None, True), (3, True, None, False), (3, True, ["mrr"], True)]


def _listing(d):
    out = {}
    for name in sorted(os.listdir(d)):
        meta = port_ckpt.load_checkpoint_meta(os.path.join(d, name))
        with np.load(os.path.join(d, name, "arrays.npz")) as z:
            out[name] = (meta["training_steps"], {k: z[k].tolist() for k in z.files})
    return out


def test_background_checkpoint_write_rotates_as_synchronous(tmp_path):
    """The background write gives the rotation order, ``model_best-*`` and
    ``checkpoint_epoch_*`` copies of a synchronous save, and JAX's
    manager's names; the snapshot is taken at ``save`` (a parameter updated
    in place right after does not reach the file); a save, ``wait`` and
    ``load_checkpoint`` read the saved step."""
    dirs = {}
    for mode in ("async", "sync", "jax"):
        d = str(tmp_path / mode)
        mgr = (jax_ckpt.CheckpointManager(d, keep_checkpoints=3, async_write=False) if mode == "jax" else
               port_ckpt.CheckpointManager(d, keep_checkpoints=3))
        for i, (epoch, is_best, tags, save_all) in enumerate(SAVES):
            v, opt = _tree(i)
            meta = {"epoch": epoch, "training_steps": i}
            if mode == "jax":
                jv = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), v)
                jopt = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), opt)
                mgr.save(jv, jopt, meta, is_best=is_best, tags=tags, save_all=save_all)
            else:
                path = mgr.save(v, opt, meta, is_best=is_best, tags=tags, save_all=save_all)
                if mode == "sync":
                    mgr.wait()  # a synchronous save: the write is done before the next step
                v["params"]["a"].add_(100.0)  # the next step, in place: not in the snapshot
                assert path == os.path.join(d, f"checkpoint{i % 3}")
        mgr.wait()
        dirs[mode] = _listing(d)
    assert dirs["async"] == dirs["sync"]
    assert list(dirs["async"]) == list(dirs["jax"])
    assert {n: s for n, (s, _) in dirs["async"].items()} == {n: s for n, (s, _) in dirs["jax"].items()}
    assert "model_best-mrr-checkpoint2" in dirs["async"] and "checkpoint_epoch_3" in dirs["async"]
    assert dirs["async"]["checkpoint2"][1]["params/a"] == _tree(5)[0]["params"]["a"].tolist()

    mgr = port_ckpt.CheckpointManager(str(tmp_path / "load"), keep_checkpoints=2)
    v, opt = _tree(7)
    path = mgr.save(v, opt, {"training_steps": 7})
    mgr.wait()
    got_v, got_opt, meta = port_ckpt.load_checkpoint(path, *_tree(0))
    assert meta["training_steps"] == 7 and torch.equal(got_v["params"]["a"], v["params"]["a"])
    assert torch.equal(got_opt["a"]["sum"], opt["a"]["sum"])


def test_background_write_error_is_raised_by_wait(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path / "err"), keep_checkpoints=2)
    v, opt = _tree(1)
    meta = {"training_steps": 1}
    meta["self"] = meta  # json refuses a circular reference, on the writer's thread
    mgr.save(v, opt, meta)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()


def test_background_sharded_save_matches_synchronous(tmp_path):
    """Two ranks (threads, a shared barrier) through ``save_sharded``: the
    slabs' directory as the synchronous ``save_checkpoint_sharded`` writes
    it, visible to both ranks after ``wait_finalized``, loading to the
    same arrays; a second save into the same slot replaces it."""
    barrier = threading.Barrier(2)
    v, opt = _tree(3)
    for mode in ("sync", "async"):
        d = str(tmp_path / mode)
        mgrs = [port_ckpt.CheckpointManager(d, keep_checkpoints=1) for _ in range(2)]
        errors = []

        def rank(r):
            try:
                for step in (3, 4):
                    meta = {"epoch": 1, "training_steps": step}
                    if mode == "sync":
                        port_ckpt.save_checkpoint_sharded(d, "checkpoint0", v, meta, opt, r, 2, barrier.wait)
                    else:
                        mgrs[r].save_sharded(v, opt, meta, r, 2, barrier.wait, save_all=step == 4)
                mgrs[r].wait_finalized(timeout=30)
                assert port_ckpt.load_checkpoint_meta(os.path.join(d, "checkpoint0"))["training_steps"] == 4
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        got_v, got_opt, meta = port_ckpt.load_checkpoint(os.path.join(d, "checkpoint0"), *_tree(0))
        assert meta["training_steps"] == 4
        for k, want in flatten_arrays(v["params"], "p").items():
            np.testing.assert_array_equal(flatten_arrays(got_v["params"], "p")[k], want)
        assert sorted(os.listdir(os.path.join(d, "checkpoint0"))) == [
            "arrays.p0.npz", "arrays.p1.npz", "index.p0.json", "index.p1.json", "meta.json"]
    assert os.path.isdir(tmp_path / "async" / "checkpoint_epoch_1")


def test_trainer_save_then_load_reads_the_saved_step(toy_dataset_dir, tmp_path):
    """An in-loop save (``wait=False``) followed by ``load`` reads the saved
    step: ``load`` waits for the write in flight."""
    trainer = _port_run(toy_dataset_dir, tmp_path, "run", 1, epochs=2, save_epoch_freq=0)
    steps = trainer.training_steps
    path = trainer.save(wait=False)
    trainer.training_steps = 0
    meta = trainer.load(path)
    assert meta["training_steps"] == steps == trainer.training_steps


def test_profile_steps_across_windows(toy_dataset_dir, tmp_path):
    """``profile_steps`` with windows: the trace starts before the first
    entry after training step 1 (a window may jump past it) and is written
    at the first entry ``profile_steps`` steps later; it holds the steps'
    operators."""
    import json

    trainer = _port_run(toy_dataset_dir, tmp_path, "prof", 3, epochs=2, save_epoch_freq=0, profile_steps=2)
    assert trainer.training_steps == 10 and trainer.train_step_scan.windows == 2
    assert trainer.profile_trace == str(tmp_path / "prof" / "profile" / "trace.json")
    with open(trainer.profile_trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names or "aten::bmm" in names, sorted(n for n in names if n)[:20]


def test_cadence_of_a_window_at_a_pass_start(toy_dataset_dir, tmp_path, monkeypatch):
    """A frequency above the window size: the window at a pass's start
    holds step 0, on which no single step fires, so it fires nothing (the
    JAX package's rule, against prev_step_i = -1, fires there: an extra
    save and eval a pass); the saves and evals fall on the steps of single
    steps."""
    fired = {"save": [], "eval": []}
    orig_save, orig_eval = Trainer.save, Trainer.evaluate

    def save(self, *a, **kw):
        fired["save"].append(self.training_steps)
        return orig_save(self, *a, **kw)

    def evaluate(self, *a, **kw):
        fired["eval"].append(self.training_steps)
        return orig_eval(self, *a, **kw)

    monkeypatch.setattr(Trainer, "save", save)
    monkeypatch.setattr(Trainer, "evaluate", evaluate)
    out = {}
    for k in (1, 3):
        fired = {"save": [], "eval": []}
        _port_run(toy_dataset_dir, tmp_path, f"start{k}", k, epochs=2, save_epoch_freq=0, save_freq=4, eval_freq=4)
        out[k] = (fired["save"], fired["eval"])
    # step_i 4 of each pass of 5 (training steps 5 and 10); the last save is the run's end
    assert out[1] == out[3] == ([5, 10, 10], [5, 10])
