"""Benchmark-creation entry point (the port's copy of
``open_knowledge_graph_embeddings_tpu/cli/create_data.py``; it runs on the
host alone, and its output trains with ``cli.train``).

Usage (mirrors the reference, reference: scripts/create_data.py)::

    python -m open_knowledge_graph_embeddings_tpu_torch.cli.create_data -c pipeline.yaml

The YAML config provides at least ``work_dir`` and ``corpus_files`` (OPIEC
avro files, or the JSON-lines debug format — see preprocessing/corpus.py);
optional keys: redirects_file, eval_data_size, mention_vocab_size,
relation_vocab_size, min_count, vocab_min_count, seed.

Dataset acquisition (machines without network access parse the formats but cannot
fetch them; elsewhere these make the pipeline runnable end-to-end):

    --print-downloads       print the exact wget/tar commands for OLPBench,
                            OPIEC-Clean, and the DBpedia redirects (the
                            reference's documented fetches, reference:
                            README.md:36-46,155-163,
                            preprocessing/create_redirects.py:33-36)
    --prepare-fb15k237 DIR  map a raw FB15k-237 directory
                            ({train,valid,test}.txt [+ mid2name.tsv.gz])
                            to mapped_to_ids/ — equivalent of the
                            reference's data/fb15k237/prepare_fb237.py
"""

from __future__ import annotations

import argparse
import gzip
import os
import subprocess
import sys

import yaml

from open_knowledge_graph_embeddings_tpu_torch.preprocessing.jobs import run_pipeline
from open_knowledge_graph_embeddings_tpu_torch.utils.logging_utils import setup_logging


def print_downloads() -> None:
    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "tools",
        "fetch_data.sh",
    )
    if os.path.exists(script):
        subprocess.run(["bash", script, "--print", "all"], check=True)
        subprocess.run(["bash", script, "--print", "opiec"], check=True)
    else:  # installed without the tools dir: print the commands directly
        for cmd in (
            "wget -c -P data http://data.dws.informatik.uni-mannheim.de/olpbench/olpbench.tar.gz",
            "tar xzf data/olpbench.tar.gz -C data",
            "wget -c -P data/downloads http://downloads.dbpedia.org/2016-10/core-i18n/en/redirects_en.ttl.bz2",
            "wget -c -P data http://data.dws.informatik.uni-mannheim.de/opiec/OPIEC-Clean.zip",
            "unzip -n data/OPIEC-Clean.zip -d data",
        ):
            print(cmd)


def prepare_fb15k237(data_dir: str) -> None:
    """Map raw FB15k-237 splits to the mapped_to_ids/ contract.

    Equivalent of the reference's ``prepare_fb237.py`` (reference:
    data/fb15k237/prepare_fb237.py:1-52): entity token sequences come from
    ``mid2name.tsv.gz`` when present, relation tokens from the '/._' split.
    """
    from open_knowledge_graph_embeddings_tpu_torch.preprocessing.map_to_ids import (
        convert_closed_dataset,
    )

    names = {}
    mid2name = os.path.join(data_dir, "mid2name.tsv.gz")
    if os.path.exists(mid2name):
        with gzip.open(mid2name, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    names[parts[0]] = " ".join(parts[1:])
    splits = [
        os.path.join(data_dir, name)
        for name in ("train.txt", "valid.txt", "test.txt")
        if os.path.exists(os.path.join(data_dir, name))
    ]
    if not splits:
        raise SystemExit(f"no train/valid/test .txt splits found in {data_dir}")
    out_dir = os.path.join(data_dir, "mapped_to_ids")
    written = convert_closed_dataset(out_dir, splits, entity_names=names or None)
    for path, n in written.items():
        print(f"wrote {path}: {n} triples")


def main(argv=None):
    parser = argparse.ArgumentParser(description="OLP benchmark creation pipeline")
    parser.add_argument("-c", "--config", help="pipeline YAML config")
    parser.add_argument(
        "--print-downloads", action="store_true",
        help="print the dataset fetch commands (OLPBench/OPIEC/redirects) and exit",
    )
    parser.add_argument(
        "--prepare-fb15k237", metavar="DIR",
        help="map a raw FB15k-237 directory to mapped_to_ids/ and exit",
    )
    args = parser.parse_args(argv)
    if args.print_downloads:
        print_downloads()
        return
    if args.prepare_fb15k237:
        setup_logging()
        prepare_fb15k237(args.prepare_fb15k237)
        return
    if not args.config:
        parser.error("-c/--config is required (or use --print-downloads / --prepare-fb15k237)")
    with open(args.config) as f:
        opts = yaml.safe_load(f)
    setup_logging()
    run_pipeline(opts)


if __name__ == "__main__":
    main(sys.argv[1:])
