"""Train entry point.

Usage (the JAX package's config keys)::

    python -m open_knowledge_graph_embeddings_tpu_torch.cli.train CONFIG.yaml \
        [--device cuda|cpu] [--key value ...]

Orchestration: config -> results directory, logging, seeds -> the training
dataset -> model build (dataset meta injected) -> :class:`Trainer` -> epoch
loop, with a checkpoint at the end.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the plain PyTorch versions of
the kernels.  Evaluation (``--evaluate``, and the eval cadence of a config
with a validation set) comes with ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from datetime import datetime
from typing import Any, Dict

from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
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


def setup_dataset(args: Dict[str, Any]) -> OneToNMentionRelationDataset:
    cls_name = args.get("training_dataset_class") or args.get("dataset_class")
    if cls_name != "OneToNMentionRelationDataset":
        raise NotImplementedError(f"dataset class {cls_name!r} is not ported: ROADMAP Queue 1 item 1")
    cfg = dict(args["train_data_config"])
    es = args.get("experiment_settings", {})
    cfg.setdefault("batch_size", args.get("batch_size", 512))
    cfg.setdefault("loss", es.get("loss", "bce"))
    cfg.setdefault("max_lengths_tuple", tuple(es.get("max_lengths_tuple", (10, 10))))
    for k in ("replace_entities_by_tokens", "replace_relations_by_tokens"):
        cfg.setdefault(k, es.get(k, False))
    return OneToNMentionRelationDataset(dataset_dir=args["dataset_dir"], is_training_data=True, **cfg)


def main(args: Dict[str, Any], device="cuda") -> Trainer:
    device = resolve_device(device)
    if args.get("evaluate"):
        raise NotImplementedError("--evaluate comes with eval: ROADMAP Queue 1 item 8")
    for key in ("resume_filter", "weight_map"):
        if args.get(key):
            raise NotImplementedError(f"{key} is not ported yet: ROADMAP Queue 1 item 9")
    time_stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    if args.get("resume"):
        ckpt_meta = load_checkpoint_meta(args["resume"])
        if args.get("resume_load_args", True) and "config" in ckpt_meta:
            args = merge_resume_config(args, ckpt_meta["config"])
    save_path = setup_dirs(args, time_stamp)
    setup_logging(os.path.join(save_path, f"log_{time_stamp}.txt"))
    logger.info("saving to %s (device %s)", save_path, device)
    seed = int(args.get("seed") or 0)
    if seed > 0:
        set_global_seeds(seed)

    train_data = setup_dataset(args)
    model = build_model(args["model"], train_data.meta, **dict(args.get("model_config") or {}))
    logger.info("model: %s | embedder: %s", args["model"], type(model.embedder).__name__)
    trainer = Trainer(args, model, train_data, save_path=save_path, device=device,
                      has_validation=bool(args.get("val_data_config")))
    n_params = sum(p.numel() for _, p in leaves(trainer.variables["params"]))
    logger.info("number of parameters: %d", n_params)
    if args.get("resume"):
        trainer.load(args["resume"], reset_optimizer=bool(args.get("reset_optimizer", False)))
    if args.get("train", True):
        trainer.run()
    return trainer


def cli_main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser(description="train a model with the torch port")
    parser.add_argument("config")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    known, overrides = parser.parse_known_args(argv)
    return main(load_config(known.config, overrides), device=known.device)


if __name__ == "__main__":
    cli_main(sys.argv[1:])
