"""Interactive / one-shot top-k link prediction from a checkpoint.

Usage::

    python -m open_knowledge_graph_embeddings_tpu_torch.cli.predict CONFIG.yaml \
        --resume experiments/.../checkpoint0 --query "S|R|?" [-k 10] [--device cuda]

Queries: ``"S|R|?"`` predicts objects, ``"?|R|O"`` predicts subjects, using
the surface forms from the dataset's id maps.  Without --query, reads
queries from stdin (one per line).  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import sys

import torch

from open_knowledge_graph_embeddings_tpu_torch.config.options import load_config
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.inference import Predictor
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint
from open_knowledge_graph_embeddings_tpu_torch.utils.device import resolve_device
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="top-k link prediction")
    parser.add_argument("config")
    parser.add_argument("--resume", required=True, help="checkpoint directory")
    parser.add_argument(
        "--query", default=None,
        help='pipe-separated: "S|R|?" or "?|R|O" (surface forms may contain spaces); '
             "whitespace split is used when the query has exactly three tokens",
    )
    parser.add_argument("-k", type=int, default=10)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    known, overrides = parser.parse_known_args(argv)
    args = load_config(known.config, overrides)
    setup_logging()
    device = resolve_device(known.device)

    # only vocabulary metadata is needed — skip the full dataset indexing
    meta = load_meta(
        args["dataset_dir"],
        tuple(args.get("experiment_settings", {}).get("max_lengths_tuple", (10, 10))),
    )
    model = build_model(args["model"], meta, **(args.get("model_config") or {}))
    variables = model.init(torch.Generator(device=device).manual_seed(int(args.get("seed") or 0)))
    variables, _, _ = load_checkpoint(known.resume, variables, {}, load_optimizer=False)
    predictor = Predictor(model, variables, dataset_dir=args["dataset_dir"])

    def answer(line: str):
        line = line.strip()
        parts = [p.strip() for p in line.split("|")] if "|" in line else line.split()
        if len(parts) != 3:
            print(f"!! expected 'S|R|?' or '?|R|O', got {line!r}", file=sys.stderr)
            return
        s, r, o = parts
        try:
            if o == "?":
                results = predictor.predict_text(s, r, None, k=known.k)
            elif s == "?":
                results = predictor.predict_text(None, r, o, k=known.k)
            else:
                print("!! one slot must be '?'", file=sys.stderr)
                return
        except KeyError as e:
            print(f"!! {e}", file=sys.stderr)
            return
        for rank, (name, score) in enumerate(results, 1):
            print(f"{rank:3d}  {score:10.4f}  {name}")

    if known.query:
        answer(known.query)
    else:
        for line in sys.stdin:
            if line.strip():
                answer(line)


if __name__ == "__main__":
    main(sys.argv[1:])
