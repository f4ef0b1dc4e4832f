"""The port's benchmark-creation pipeline end to end against the JAX
package's, then the port's trainer on its output, on the CPU.

On the 400-row synthetic corpus of ``tests/test_pipeline_e2e.py`` and on
the committed ``tests/fixtures/opiec_tiny.avro``, ``run_pipeline`` of both
packages writes the same text splits and ``mapped_to_ids`` files byte for
byte and the same pickles under ``indexes/`` (compared loaded: they hold
tuples and Counters).  Where both run in one process they share Python's
string hashing, whose per-process salt orders the sets both packages
iterate; the subprocess runs pin ``PYTHONHASHSEED`` for the same reason.
``cli.create_data`` of the port runs as a user runs it: ``-c`` in a
subprocess (a second run skips every job), ``--print-downloads`` (prints
JAX's lines and writes nothing) and ``--prepare-fb15k237``; then
``cli.train --device cpu`` trains on the pipeline's output."""

import gzip
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from open_knowledge_graph_embeddings_tpu.preprocessing.jobs import run_pipeline as jax_run_pipeline
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.preprocessing.jobs import ALL_JOBS, run_pipeline

from test_avro import FIXTURE

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_SPLITS = ("train_data_simple.txt", "train_data_basic.txt", "train_data_thorough.txt", "validation_data.txt",
               "validation_data_linked.txt", "validation_data_linked_no_mention.txt", "test_data.txt")
PICKLES = ("raw_triples", "redirects", "entity_mentions", "triples", "mention_tokens", "relation_tokens", "eval_ids")


def write_corpus(d):
    """The synthetic corpus of ``tests/test_pipeline_e2e.py``: 400 jsonl rows,
    20 person entities with two surface forms, 10 cities, 4 relations."""
    rng = np.random.default_rng(0)
    people = [f"person{i}" for i in range(20)]
    cities = [f"city{i}" for i in range(10)]
    rels = [["lives", "in"], ["works", "in"], ["was", "born", "in"], ["moved", "to"]]
    rows = []
    for _ in range(400):
        p = rng.choice(people)
        c = rng.choice(cities)
        r = rels[rng.integers(len(rels))]
        surface = [p] if rng.random() < 0.6 else ["mr", p]
        rows.append({"subject": surface, "relation": list(r), "object": [c], "subject_link": p.capitalize(),
                     "object_link": c.capitalize(), "confidence": 0.9})
    corpus = os.path.join(d, "corpus.jsonl")
    with open(corpus, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))
    return corpus


def _opts(work_dir, corpus, **over):
    opts = {"work_dir": str(work_dir), "corpus_files": [str(corpus)], "eval_data_size": 5, "min_count": 1,
            "mention_vocab_size": 1000, "relation_vocab_size": 1000, "seed": 0}
    opts.update(over)
    return opts


def _outputs(work_dir):
    """{relative path: bytes} of every text split and mapped_to_ids file."""
    out = {}
    for name in list(TEXT_SPLITS) + sorted("mapped_to_ids/" + n for n in os.listdir(os.path.join(work_dir, "mapped_to_ids"))):
        with open(os.path.join(work_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def _pickles(work_dir):
    out = {}
    for name in PICKLES:
        with open(os.path.join(work_dir, "indexes", f"{name}.pickle"), "rb") as f:
            out[name] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def corpus_runs(tmp_path_factory):
    """Both packages' pipelines on the 400-row corpus, in this process."""
    d = tmp_path_factory.mktemp("pipe")
    corpus = write_corpus(str(d))
    run_pipeline(_opts(d / "port", corpus))
    jax_run_pipeline(_opts(d / "jax", corpus))
    return d


CORPORA = {
    "synthetic-400": lambda d: _opts(d, write_corpus(str(d.parent))),
    # the fixture keeps one triple: no relation reaches 3 tokens, so every eval split is empty
    "opiec-tiny-avro": lambda d: _opts(d, FIXTURE, eval_data_size=2),
}


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_pipeline_writes_jaxs_files(corpus, corpus_runs, tmp_path):
    if corpus == "synthetic-400":
        port_dir, jax_dir = corpus_runs / "port", corpus_runs / "jax"
    else:
        port_dir, jax_dir = tmp_path / "w" / "port", tmp_path / "w" / "jax"
        run_pipeline(CORPORA[corpus](port_dir))
        jax_run_pipeline(CORPORA[corpus](jax_dir))
    got, want = _outputs(port_dir), _outputs(jax_dir)
    assert set(got) == set(want) and len(got) >= len(TEXT_SPLITS) + 10
    for name in want:
        assert got[name] == want[name], name
    got_p, want_p = _pickles(port_dir), _pickles(jax_dir)
    for name in PICKLES:
        assert got_p[name] == want_p[name], name
    assert list(got_p["mention_tokens"].most_common()) == list(want_p["mention_tokens"].most_common())
    assert got["train_data_thorough.txt"].count(b"\n") >= 1
    if corpus == "synthetic-400":
        assert got["test_data.txt"].count(b"\n") == 5


def test_thorough_split_excludes_test_pairs(corpus_runs):
    """No thorough-train triple shares a subject/object mention pair, in
    either order, with a test triple's mention alternatives."""
    d = corpus_runs / "port"
    test_pairs = set()
    for line in open(d / "test_data.txt"):
        s, r, o, s_alts, o_alts = line.rstrip("\n").split("\t")
        for sa in s_alts.split("|||"):
            for oa in o_alts.split("|||"):
                test_pairs |= {(sa, oa), (oa, sa)}
    thorough = {(ln.split("\t")[0], ln.split("\t")[2]) for ln in open(d / "train_data_thorough.txt")}
    assert test_pairs and thorough and not (test_pairs & thorough)
    n = {name: len(open(d / name).readlines()) for name in TEXT_SPLITS}
    assert 0 < n["train_data_thorough.txt"] <= n["train_data_basic.txt"]


def _cli(package, args, cwd, hash_seed="0"):
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED=hash_seed, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", f"{package}.cli.create_data", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_create_data_cli_runs_and_resumes(tmp_path):
    """``cli.create_data -c`` of the port in a subprocess writes JAX's files
    (JAX's CLI run with the same hash seed), and a second run skips every
    job."""
    corpus = write_corpus(str(tmp_path))
    for name in ("port", "jax"):
        with open(tmp_path / f"{name}.yaml", "w") as f:
            yaml.safe_dump(_opts(tmp_path / name, corpus), f)
    port = _cli("open_knowledge_graph_embeddings_tpu_torch", ["-c", str(tmp_path / "port.yaml")], tmp_path)
    assert port.returncode == 0, port.stderr[-3000:]
    jax = _cli("open_knowledge_graph_embeddings_tpu", ["-c", str(tmp_path / "jax.yaml")], tmp_path)
    assert jax.returncode == 0, jax.stderr[-3000:]
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "jax")
    assert all(f"{job.__name__}: running" in port.stderr for job in ALL_JOBS)
    again = _cli("open_knowledge_graph_embeddings_tpu_torch", ["-c", str(tmp_path / "port.yaml")], tmp_path)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "running" not in again.stderr
    assert all(f"{job.__name__}: all outputs exist, skipping" in again.stderr for job in ALL_JOBS)
    usage = _cli("open_knowledge_graph_embeddings_tpu_torch", [], tmp_path)
    assert usage.returncode == 2 and "-c/--config is required" in usage.stderr


def test_print_downloads_only_prints(tmp_path):
    """``--print-downloads`` prints the lines JAX's prints and writes nothing."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _cli("open_knowledge_graph_embeddings_tpu_torch", ["--print-downloads"], tmp_path / "port")
    jax = _cli("open_knowledge_graph_embeddings_tpu", ["--print-downloads"], tmp_path / "jax")
    assert port.returncode == 0 and jax.returncode == 0, port.stderr + jax.stderr
    assert port.stdout == jax.stdout
    assert "wget -c -P data http://data.dws.informatik.uni-mannheim.de/olpbench/olpbench.tar.gz" in port.stdout
    assert os.listdir(tmp_path / "port") == []


def test_prepare_fb15k237(tmp_path):
    """``--prepare-fb15k237`` on a tiny raw directory (three splits and a
    gzipped mid2name) writes JAX's mapped_to_ids files."""
    rows = {"train.txt": ["/m/1\t/film/actor\t/m/2", "/m/2\t/film/film/director\t/m/3", "/m/4\t/people/person.born_in\t/m/1"],
            "valid.txt": ["/m/1\t/film/film/director\t/m/3"],
            "test.txt": ["/m/4\t/film/actor\t/m/2"]}
    for name in ("port", "jax"):
        raw = tmp_path / name
        raw.mkdir()
        for split, lines in rows.items():
            (raw / split).write_text("\n".join(lines) + "\n")
        with gzip.open(raw / "mid2name.tsv.gz", "wt") as f:
            f.write("/m/1\tTom Hanks\n/m/2\tBig\n/m/3\tPenny Marshall\n")
    port = _cli("open_knowledge_graph_embeddings_tpu_torch", ["--prepare-fb15k237", str(tmp_path / "port")], tmp_path)
    jax = _cli("open_knowledge_graph_embeddings_tpu", ["--prepare-fb15k237", str(tmp_path / "jax")], tmp_path)
    assert port.returncode == 0 and jax.returncode == 0, port.stderr[-3000:] + jax.stderr[-3000:]
    got, want = _outputs_dir(tmp_path / "port" / "mapped_to_ids"), _outputs_dir(tmp_path / "jax" / "mapped_to_ids")
    assert got == want and "train.txt" in got and "entity_id_tokens_ids_map.txt" in got
    assert "train.txt: 3 triples" in port.stdout


def _outputs_dir(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_train_on_pipeline_output(corpus_runs, tmp_path):
    """``cli.train --device cpu`` of the port on the pipeline's
    mapped_to_ids: the LSTM-ComplEx token model with batch-shared negatives
    and row-sparse tables; the training loss falls over the passes."""
    cfg = dict(dataset_dir=str(corpus_runs / "port" / "mapped_to_ids"), experiment_dir=str(tmp_path / "exp"),
               model="LSTMComplexRelationModel",
               model_config={"entity_slot_size": 8, "relation_slot_size": 8, "sparse": True, "dropout": 0.0},
               optimization_config={"optimizer": "Adagrad", "lr": 0.2}, batch_size=8, epochs=6, eval_epoch_freq=0,
               print_freq=100, sparse_min_ratio=0.0, workers=2, seed=1,
               train_data_config={"input_file": "train_data_thorough.txt", "batch_size": 8,
                                  "use_batch_shared_entities": True, "min_size_batch_labels": 16},
               val_data_config={"input_file": "validation_data.txt"}, test_data_config={"input_file": "test_data.txt"})
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = port_train.cli_main([str(path), "--device", "cpu"])
    losses = [r["training_loss"] for r in trainer.results.to_dicts()]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert trainer.sparse and (tmp_path / "exp" / "checkpoint0" / "arrays.npz").exists()
    result = trainer.evaluate()  # filtered ranking of the validation split
    assert 0 < result["mrr"].avg <= 1
