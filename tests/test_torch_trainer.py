"""The torch port's trainer and train CLI on the CPU, and checkpoints with
optimizer state crossing between the packages both ways."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from open_knowledge_graph_embeddings_tpu.train.optim import OptimizerRegimes as JaxRegimes
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import flatten_arrays

torch.set_num_threads(1)

MODEL_CONFIG = {"entity_slot_size": 8, "init_std": 0.1, "sparse": True, "dropout": 0.0}
OPT = {"optimizer": "Adagrad", "epoch": 0, "lr": 0.3, "weight_decay": 1e-10}
TRAIN_DATA = {"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": True,
              "min_size_batch_labels": 6}


def _config(toy_dataset_dir, exp_dir, **over):
    cfg = dict(
        dataset_dir=toy_dataset_dir, experiment_dir=str(exp_dir), model="LSTMComplexRelationModel",
        model_config=MODEL_CONFIG, optimization_config=OPT, train_data_config=TRAIN_DATA,
        batch_size=4, epochs=2, eval_epoch_freq=0, print_freq=1, sparse_min_ratio=0.0, workers=2, seed=1,
    )
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def port_run(toy_dataset_dir, tmp_path_factory):
    """``cli.train --device cpu`` on the toy set: two epochs, row-sparse
    token tables."""
    d = tmp_path_factory.mktemp("port_run")
    path = d / "toy.yaml"
    path.write_text(yaml.safe_dump(_config(toy_dataset_dir, d / "exp")))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])
    return trainer, d / "exp" / "checkpoint0"


def test_cli_train_on_cpu_trains_and_learns(port_run):
    trainer, ckpt = port_run
    assert trainer.sparse and trainer.device.type == "cpu"
    losses = [r["training_loss"] for r in trainer.results.to_dicts()]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert trainer.training_steps == 4
    assert all(s["sparse_tables"] == ("entity_token_embedding", "relation_token_embedding")
               for s in trainer.step_log)
    assert (ckpt / "arrays.npz").exists() and (ckpt / "meta.json").exists()


def test_cli_train_defaults_to_cuda_and_runs_eval(toy_dataset_dir, tmp_path):
    """``--device`` defaults to cuda and raises without a card; on the CPU
    ``--evaluate`` ranks the validation split and the eval cadence
    (``eval_epoch_freq``) evaluates after every pass."""
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / "exp")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_train.cli_main([str(path)])
    trainer = port_train.cli_main([str(path), "--device", "cpu", "--evaluate", "true"])
    assert trainer.training_steps == 0 and trainer.last_eval["batches"] >= 1
    path.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / "exp2", eval_epoch_freq=1,
                                           val_data_config={"input_file": "valid.txt"})))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])
    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    assert len(rows) == 2 and all(0 < r["validation_mrr"] <= 1 for r in rows)


def _jax_templates(toy_dataset_dir):
    meta = jax_load_meta(toy_dataset_dir, (10, 10), cache_dir=toy_dataset_dir + "/jax_ckpt_cache")
    model = jax_build_model("LSTMComplexRelationModel", meta, **MODEL_CONFIG)
    variables = model.init(jax.random.key(3))
    regimes = JaxRegimes(OPT)
    regimes.update(1, 0)
    return variables, regimes.init_state(variables["params"])


def test_port_checkpoint_loads_into_jax_with_optimizer_state(port_run, toy_dataset_dir):
    trainer, ckpt = port_run
    variables, opt_state = _jax_templates(toy_dataset_dir)
    jv, jopt, meta = jax_load_checkpoint(str(ckpt), variables, opt_state)
    want = {**flatten_arrays(trainer.variables["params"], "params"),
            **flatten_arrays(trainer.variables["state"], "state"), **flatten_arrays(trainer.opt_state, "opt")}
    got = {**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state"), **jax_flatten(jopt, "opt")}
    assert set(got) == set(want) and any(k.startswith("opt/") and k.endswith("/sum") for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert meta["training_steps"] == 4
    assert meta["optimizer_host_state"]["current_phase"] == [0]


def test_jax_checkpoint_resumes_in_port(toy_dataset_dir, tmp_path):
    """A JAX cli.train run's last checkpoint (params, BN state, Adagrad
    accumulators and steps, host state, step count) resumes in the port's
    cli.train, which then trains on."""
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, tmp_path / "jax_exp", eval_freq=-1,
                        val_data_config={"input_file": "valid.txt", "batch_size": 4,
                                         "use_batch_shared_entities": False},
                        test_data_config={"input_file": "test.txt", "batch_size": 4,
                                          "use_batch_shared_entities": False}))
    jtrainer = jax_main(args)
    ckpt = tmp_path / "jax_exp" / "checkpoint0"
    with np.load(ckpt / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}

    path = tmp_path / "resume.yaml"
    path.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / "port_exp", resume=str(ckpt), train=False)))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])
    got = {**flatten_arrays(trainer.variables["params"], "params"),
           **flatten_arrays(trainer.variables["state"], "state"), **flatten_arrays(trainer.opt_state, "opt")}
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert trainer.training_steps == jtrainer.training_steps == 4

    trainer.args["epochs"] = 3
    trainer.run()
    assert trainer.training_steps == 6
    assert float(trainer.opt_state["entity_lstm"]["w_ih"]["step"]) == 6.0
    assert np.isfinite(trainer.results.to_dicts()[-1]["training_loss"])


def test_profile_steps_writes_a_trace(toy_dataset_dir, tmp_path):
    """``profile_steps: 2`` writes a torch.profiler Chrome trace under
    ``<experiment_dir>/profile``, as the JAX trainer writes its trace there:
    the trace starts before the step after training step 1 and holds two
    steps' operator events."""
    import json

    args = jax_load_config()
    args.update(_config(toy_dataset_dir, tmp_path / "jax_exp", profile_steps=2, epochs=3))
    jax_main(args)
    assert any(files for _, _, files in os.walk(tmp_path / "jax_exp" / "profile"))

    path = tmp_path / "p.yaml"
    path.write_text(yaml.safe_dump(_config(toy_dataset_dir, tmp_path / "exp", profile_steps=2, epochs=3)))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])
    assert trainer.training_steps == 6
    assert trainer.profile_trace == str(tmp_path / "exp" / "profile" / "trace.json")
    with open(trainer.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::addmm" in names, sorted(n for n in names if n)[:20]
