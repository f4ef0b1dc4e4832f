"""The port's C++ host helpers (``native/``) against the JAX package's and
against the port's own numpy branches: the 5-column reader, the
unique-and-remap of a batch's token ids, and the gather-sum grad plan.

Inputs: the ``content`` cases of tests/test_native.py, the toy dataset's
files, and a flagship-shaped batch drawn from a numpy seed (4096 query and
4096 candidate rows of 10 tokens, vocabulary 200,000).  Everything must be
equal array for array: the port's numpy plan groups each token's
positions in ascending order, as the kernel does.  ``OKET_DISABLE_NATIVE``
selects the numpy branches (read at every call).  Also: the
``copy_data_to_dev_shm`` staging of the dataset reader."""

import os

import numpy as np
import pytest

from open_knowledge_graph_embeddings_tpu.native import loader as jax_native
from open_knowledge_graph_embeddings_tpu.train.sparse import build_token_grad_plan as jax_build_plan
from open_knowledge_graph_embeddings_tpu_torch.data import dataset as port_dataset
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.native import (
    grad_plan_native,
    native_available,
    read_triple_file_native,
    unique_remap_native,
)
from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, build_token_grad_plan

pytestmark = pytest.mark.skipif(not (native_available() and jax_native.native_available()),
                                reason="no C++ toolchain for the native helpers")

CONTENTS = {
    "open": "2\t3\t4\t2 5\t4 6\n7\t3\t2\t7\t2\n",
    "closed-3col": "2\t3\t4\n5\t6\t7\n",
    "no-trailing-newline": "2\t3\t4\t2 5\t4 6",
    "blank-lines": "\n2\t3\t4\t2\t4\n\n",
}


def _python_read(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("OKET_DISABLE_NATIVE", "1")
        assert read_triple_file_native(path) is None
        return port_dataset.read_triple_file(path)


def _assert_same(got, want, msg):
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, msg
        np.testing.assert_array_equal(g, w, err_msg=msg)


@pytest.mark.parametrize("name", list(CONTENTS))
def test_reader_matches_jax_native_and_python(tmp_path, monkeypatch, name):
    p = tmp_path / f"{name}.txt"
    p.write_text(CONTENTS[name])
    got = read_triple_file_native(str(p))
    _assert_same(got, jax_native.read_triple_file_native(str(p)), name)
    _assert_same(got, _python_read(str(p), monkeypatch), name)
    _assert_same(port_dataset.read_triple_file(str(p)), got, name)  # the reader takes the native branch


@pytest.mark.parametrize("split", ["train.txt", "valid.txt", "test.txt"])
def test_reader_on_toy_dataset(toy_dataset_dir, monkeypatch, split):
    path = os.path.join(toy_dataset_dir, split)
    got = read_triple_file_native(path)
    _assert_same(got, jax_native.read_triple_file_native(path), split)
    _assert_same(got, _python_read(path, monkeypatch), split)


def flagship_tokens(seed=0, rows=4096 + 4096, L=10, vocab=200_000):
    """A flagship-shaped token matrix: lengths 1..L, ids Zipf-like over the
    vocabulary (popular tokens repeat, as mention tokens do), PAD after."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, L + 1, rows)
    ids = np.minimum(rng.zipf(1.2, (rows, L)), vocab - 1).astype(np.int32)
    ids = np.where(ids < 4, rng.integers(4, vocab, (rows, L)), ids).astype(np.int32)
    return np.where(np.arange(L)[None, :] < lens[:, None], ids, 0).astype(np.int32), vocab


def _toy_tokens(toy_dataset_dir):
    meta = port_dataset.load_meta(toy_dataset_dir)
    return meta.entity_token_ids, meta.entity_tokens_size


@pytest.mark.parametrize("which", ["toy", "flagship"])
def test_unique_remap_matches_jax_and_numpy(toy_dataset_dir, which):
    toks, vocab = _toy_tokens(toy_dataset_dir) if which == "toy" else flagship_tokens()
    uids, remapped = unique_remap_native(toks, vocab, np.empty(vocab, np.int32))
    ju, jr = jax_native.unique_remap_native(toks, vocab, np.empty(vocab, np.int32))
    np.testing.assert_array_equal(uids, ju)
    np.testing.assert_array_equal(remapped, jr)
    want = np.union1d(np.int32(0), toks)
    np.testing.assert_array_equal(uids, want)
    np.testing.assert_array_equal(remapped, np.searchsorted(want, toks).astype(np.int32))


@pytest.mark.parametrize("which,K,bucket", [("toy", 4, 8), ("flagship", 8, 256), ("flagship-block", 8, 256)])
def test_grad_plan_matches_jax_and_numpy(toy_dataset_dir, monkeypatch, which, K, bucket):
    """The plan of the remapped matrix: the port's kernel, JAX's kernel and
    the port's numpy branch give the same arrays, and the raw kernel's
    padding slots keep the contract (``valid`` False, ``pos`` 0, ``uid``
    out of range)."""
    toks, vocab = _toy_tokens(toy_dataset_dir) if which == "toy" else flagship_tokens()
    if which == "flagship-block":
        toks = toks[:4096]  # one rank's block of a 2-rank mesh
    uids, remapped = unique_remap_native(toks, vocab, np.empty(vocab, np.int32))
    U = len(uids)
    got = build_token_grad_plan(remapped, U, K=K, bucket_min=bucket)
    want = jax_build_plan(remapped, U, K=K, bucket_min=bucket)
    with monkeypatch.context() as m:
        m.setenv("OKET_DISABLE_NATIVE", "1")
        assert grad_plan_native(remapped, U, K, U) is None
        numpy_plan = build_token_grad_plan(remapped, U, K=K, bucket_min=bucket)
    for k in ("pos", "valid", "uid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(numpy_plan[k], got[k], err_msg=k)
    assert int(got["valid"].sum()) == int((remapped > 0).sum())
    pos, valid, uid, n_slots = grad_plan_native(remapped, U, K, U)
    assert pos.shape[0] >= n_slots and not valid[n_slots:].any()
    assert (pos[n_slots:] == 0).all() and (uid[n_slots:] == U).all()


@pytest.mark.parametrize("dedup_bucket", [8, 512])
def test_sparse_plan_builder_native_on_and_off(toy_dataset_dir, monkeypatch, dedup_bucket):
    """``SparsePlanBuilder`` gives the same arrays with the native branch
    and with ``OKET_DISABLE_NATIVE``, for the LSTM's token plans (query
    dedup on and off)."""
    ds = port_dataset.OneToNMentionRelationDataset(
        dataset_dir=toy_dataset_dir, cache_dir=toy_dataset_dir + "/port_cache", input_file="train.txt",
        is_training_data=True, batch_size=4, use_batch_shared_entities=True, min_size_batch_labels=6)
    model = build_model("LSTMComplexRelationModel", ds.meta, entity_slot_size=8, sparse=True)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0, dedup_bucket=dedup_bucket)
    batches = list(BatchBuilder(ds, seed=2).batches(shuffle=True))
    assert plan.plan_path == "native"
    on = [plan(b) for b in batches]
    with monkeypatch.context() as m:
        m.setenv("OKET_DISABLE_NATIVE", "1")
        assert plan.plan_path == "numpy" and not native_available()
        off = [plan(b) for b in batches]
    for a, b in zip(on, off):
        assert set(a) == set(b) and any(k.startswith("sparse/plan/") for k in a)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_copy_data_to_dev_shm_stages_and_matches(toy_dataset_dir, tmp_path, monkeypatch):
    """``copy_data_to_dev_shm``: the split's file is copied to the tmpfs
    directory (here a temporary one) and parsed from there; the records
    equal an unstaged dataset's."""
    shm = tmp_path / "shm"
    shm.mkdir()
    monkeypatch.setattr(port_dataset, "SHM_DIR", str(shm))
    kw = dict(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True, batch_size=4)
    staged = port_dataset.OneToNMentionRelationDataset(cache_dir=str(tmp_path / "c1"), copy_data_to_dev_shm=True, **kw)
    plain = port_dataset.OneToNMentionRelationDataset(cache_dir=str(tmp_path / "c2"), **kw)
    copies = list(shm.iterdir())
    assert len(copies) == 1 and copies[0].name.endswith("-train.txt")
    assert copies[0].read_bytes() == open(os.path.join(toy_dataset_dir, "train.txt"), "rb").read()
    for name in ("p1", "p2", "slot", "group_offsets", "mention_offsets", "mentions", "row_has_dup"):
        np.testing.assert_array_equal(getattr(staged.records, name), getattr(plain.records, name), err_msg=name)
