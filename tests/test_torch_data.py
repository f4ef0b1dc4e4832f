"""load_meta of the torch port against the JAX package: every array equal."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from conftest import write_toy_dataset
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu_torch.data import vocab
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = (
    "entities_size", "relations_size", "min_entities_size", "min_relations_size",
    "entity_tokens_size", "relation_tokens_size", "max_length",
)
ARRAYS = ("entity_token_ids", "relation_token_ids", "entity_id_counts", "relation_id_counts")


def _assert_same_meta(a, b):
    for f in FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d),
         "--mentions", "400", "--relations", "40", "--triples", "300",
         "--eval-size", "20", "--ent-tokens", "120", "--rel-tokens", "30", "--seed", "3"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


@pytest.mark.parametrize("lengths", [(10, 10), (3, 4)])
def test_load_meta_toy_matches_jax(tmp_path, lengths):
    write_toy_dataset(str(tmp_path))
    want = jax_load_meta(str(tmp_path), lengths, cache_dir=str(tmp_path / "jax_cache"))
    got = load_meta(str(tmp_path), lengths, cache_dir=str(tmp_path / "port_cache"))
    _assert_same_meta(got, want)
    # the port reads its own cache back unchanged, and the JAX package's cache too
    _assert_same_meta(load_meta(str(tmp_path), lengths, cache_dir=str(tmp_path / "port_cache")), want)
    _assert_same_meta(load_meta(str(tmp_path), lengths, cache_dir=str(tmp_path / "jax_cache")), want)


def test_load_meta_synth_matches_jax(synth_dir, tmp_path):
    want = jax_load_meta(synth_dir, (10, 10), cache_dir=str(tmp_path / "jax_cache"))
    got = load_meta(synth_dir, (10, 10), cache_dir=str(tmp_path / "port_cache"))
    _assert_same_meta(got, want)
    # the synthetic mentions run from 3 to 10 tokens including BOS/EOS
    lens = (got.entity_token_ids[got.min_entities_size :] > 0).sum(1)
    assert lens.min() >= 3 and lens.max() <= 10


def test_special_ids_match_jax():
    from open_knowledge_graph_embeddings_tpu.data import vocab as jax_vocab

    assert (vocab.PAD, vocab.UNK, vocab.BOS, vocab.EOS) == (
        jax_vocab.PAD, jax_vocab.UNK, jax_vocab.BOS, jax_vocab.EOS
    )
