"""Train and evaluate entry point.

Usage (the JAX package's config keys)::

    python -m open_knowledge_graph_embeddings_tpu_torch.cli.train CONFIG.yaml \
        [--device cuda|cpu] [--key value ...]
    python -m open_knowledge_graph_embeddings_tpu_torch.cli.train CONFIG.yaml \
        --resume CKPT --evaluate True [--evaluate_on_validation False]

Orchestration: config -> results directory, logging, seeds -> the three
datasets -> the filter index of the evaluation split (all splits' known
answers) -> model build (dataset meta injected) -> :class:`Trainer` -> the
epoch loop with its eval cadence, model selection and early stopping, or
evaluate only (on the validation split, or with ``evaluate_on_validation
False`` the test split), with a score row appended to
``evaluate_scores_file``.  ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the plain PyTorch versions of the
kernels.

Several processes: start one per rank with the config keys
``coordinator_address`` (``host:port``), ``num_processes`` and
``process_id`` (or ``OKET_COORDINATOR`` / ``OKET_NUM_PROCESSES`` /
``OKET_PROCESS_ID``, or ``torchrun`` with ``OKET_AUTO_DISTRIBUTED=1``).
The ranks share one experiment directory: each writes its own log
(``log_*.p{rank}.txt``), rank 0 writes ``results.csv``, and together they
write per-shard checkpoints (``parallel/distributed.py``).
"""

from __future__ import annotations

import argparse
import csv
import logging
import os
import sys
from datetime import datetime
from typing import Any, Dict, Optional

from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint_meta
from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves
from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer
from open_knowledge_graph_embeddings_tpu_torch.utils.device import resolve_device
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import setup_logging
from open_knowledge_graph_embeddings_tpu_torch.utils.misc import set_global_seeds

logger = logging.getLogger(__name__)

# run-control keys a resumed run keeps from its own command line
_RUN_KEYS = {
    "resume", "resume_filter", "resume_freeze", "resume_load_args", "reset_optimizer",
    "train", "evaluate", "evaluate_on_validation", "evaluate_scores_file",
    "devices", "no_cuda", "results_dir", "experiment_dir", "epochs",
}


def merge_resume_config(args: Dict[str, Any], ckpt_config: Dict[str, Any]) -> Dict[str, Any]:
    """Adopt the checkpoint's config except the run-control keys."""
    merged = dict(ckpt_config)
    merged.update({k: args[k] for k in _RUN_KEYS if k in args})
    return merged


def setup_dirs(args: Dict[str, Any], time_stamp: str) -> str:
    if args.get("experiment_dir"):
        save_path = args["experiment_dir"]
    else:
        config_name = os.path.splitext(os.path.basename(args.get("config_file") or "default"))[0]
        save_path = os.path.join(args.get("results_dir") or "experiments", f"{config_name}-{time_stamp}")
    os.makedirs(save_path, exist_ok=True)
    return save_path


_CLASS_KEYS = {"train_data_config": "training_dataset_class", "val_data_config": "validation_dataset_class",
               "test_data_config": "test_dataset_class"}


def setup_dataset(args: Dict[str, Any], config_key: str = "train_data_config"
                  ) -> Optional[OneToNMentionRelationDataset]:
    """The split that ``args[config_key]`` describes (a training split for
    ``train_data_config``), or None when the config names none."""
    if not args.get(config_key):
        return None
    cls_name = args.get(_CLASS_KEYS[config_key]) or args.get("dataset_class")
    if cls_name != "OneToNMentionRelationDataset":
        raise ValueError(f"unknown dataset class {cls_name!r}: the dataset registry holds one class, "
                         "OneToNMentionRelationDataset")
    cfg = dict(args[config_key])
    es = args.get("experiment_settings", {})
    cfg.setdefault("batch_size", args.get("batch_size", 512))
    cfg.setdefault("loss", es.get("loss", "bce"))
    cfg.setdefault("max_lengths_tuple", tuple(es.get("max_lengths_tuple", (10, 10))))
    for k in ("replace_entities_by_tokens", "replace_relations_by_tokens"):
        cfg.setdefault(k, es.get(k, False))
    return OneToNMentionRelationDataset(dataset_dir=args["dataset_dir"],
                                        is_training_data=config_key == "train_data_config", **cfg)


def main(args: Dict[str, Any], device="cuda") -> Trainer:
    device = resolve_device(device)
    # several processes: join the world before any device work; each rank
    # runs on its own card (or the CPU)
    rank, world = maybe_initialize_distributed(args, device)
    device = rank_device(device)
    time_stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if args.get("resume"):
        ckpt_meta = load_checkpoint_meta(args["resume"])
        if args.get("resume_load_args", True) and "config" in ckpt_meta:
            args = merge_resume_config(args, ckpt_meta["config"])
    save_path = setup_dirs(args, time_stamp)
    # the ranks share the directory: each its own log, rank 0 the plain name
    setup_logging(os.path.join(save_path, f"log_{time_stamp}{f'.p{rank}' if world > 1 else ''}.txt"))
    logger.info("saving to %s (device %s)", save_path, device)
    seed = int(args.get("seed") or 0)
    if seed > 0:
        set_global_seeds(seed)

    train_data = setup_dataset(args)
    valid_data = setup_dataset(args, "val_data_config")
    test_data = setup_dataset(args, "test_data_config")
    if args.get("evaluate"):
        args["train"] = False
    evaluation_data = valid_data if args.get("evaluate_on_validation", True) else test_data
    if evaluation_data is not None:
        evaluation_data.attach_filter_index(*(d.input_file_name if d is not None else "" for d in
                                              (train_data, valid_data, test_data)))

    model = build_model(args["model"], train_data.meta, **dict(args.get("model_config") or {}))
    logger.info("model: %s | embedder: %s", args["model"], type(model.embedder).__name__)
    trainer = Trainer(args, model, train_data, evaluation_data, save_path=save_path, device=device)
    n_params = sum(p.numel() for _, p in leaves(trainer.variables["params"]))
    logger.info("number of parameters: %d", n_params)
    if args.get("resume"):
        trainer.load(args["resume"], reset_optimizer=bool(args.get("reset_optimizer", False)),
                     resume_filter=args.get("resume_filter"), freeze_param=args.get("resume_freeze"),
                     dont_load_optimizer=bool(args.get("evaluate")))
    if args.get("train", True):
        trainer.run()
    elif args.get("evaluate"):
        results = trainer.evaluate()
        logger.info("TEST RESULTS: %s", results.averages)
        if args.get("evaluate_scores_file"):
            write_scores_row(args, trainer, results)
    return trainer


def write_scores_row(args: Dict[str, Any], trainer: Trainer, results) -> None:
    """Append the evaluation's row to ``evaluate_scores_file``, with the JAX
    package's columns (the reference's sweep schema): the run's settings,
    then every metric."""
    mc = dict(args.get("model_config") or {})
    oc = args.get("optimization_config") or {}
    oc0 = oc[0] if isinstance(oc, list) and oc else (oc if isinstance(oc, dict) else {})
    resume = args.get("resume") or ""
    row = {
        "config": args.get("config_file"),
        "checkpoint_path": os.path.basename(os.path.dirname(resume)) if resume else "-",
        "checkpoint": os.path.basename(resume) if resume else "-",
        "batch_size": args.get("batch_size", "-"),
        "entity_slot_size": mc.get("entity_slot_size", "-"),
        "relation_slot_size": mc.get("relation_slot_size", "-"),
        "dropout": mc.get("dropout", "-"),
        "input_dropout": mc.get("input_dropout", "-"),
        "relation_dropout": mc.get("relation_dropout", "-"),
        "relation_input_dropout": mc.get("relation_input_dropout", "-"),
        "model": args.get("model"),
        "train_data": (args.get("train_data_config") or {}).get("input_file", "-"),
        "valid_data": (args.get("val_data_config") or {}).get("input_file", "-"),
        "sparse": mc.get("sparse", "-"),
        "lr": oc0.get("lr", "-"),
        "weight_decay": oc0.get("weight_decay", "-"),
        "epoch": trainer.epoch,
        "resume": resume,
        **results.averages_dict,
    }
    scores_file = args["evaluate_scores_file"]
    exists = os.path.exists(scores_file)
    with open(scores_file, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow(row)


def cli_main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description="train a model with the torch port")
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    known, overrides = parser.parse_known_args(argv)
    return main(load_config(known.config, overrides), device=known.device)


if __name__ == "__main__":
    cli_main(sys.argv[1:])
