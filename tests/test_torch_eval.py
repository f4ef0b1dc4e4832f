"""The torch port's evaluation against the JAX package on the CPU: filtered
ranking (dense and chunked), the filtered top-k, the metric sums, the
filter index and the eval batches, the eval step on the same weights, and
the trainer and train CLI with eval (model selection, early stopping,
``--evaluate`` of a JAX checkpoint, the predictions TSV).

Exact-score inputs: q and the candidates are multiples of 1/8 in [-2, 2] at
d = 16, so every product term is a multiple of 1/64 and every score a sum
that f32 holds exactly, in any order, in both packages.  Then ranks must be
equal exactly, and so must the integer metric sums (count, mr, hits); the
mrr sums and the losses are f32 sums in other orders, held to rtol 1e-6.
Exact ties are made by duplicated candidate rows, as the real and the
synthetic OLPBench vocabularies make them with identical token sequences.
"""

import csv
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from open_knowledge_graph_embeddings_tpu.cli.train import main as jax_main
from open_knowledge_graph_embeddings_tpu.config.options import load_config as jax_load_config
from open_knowledge_graph_embeddings_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from open_knowledge_graph_embeddings_tpu.data.batching import pad_batches_to_common_shape as jax_pad
from open_knowledge_graph_embeddings_tpu.data.dataset import OneToNMentionRelationDataset as JaxDataset
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train import evaluate as jev
from open_knowledge_graph_embeddings_tpu.train.checkpoint import flatten_arrays as jax_flatten
from open_knowledge_graph_embeddings_tpu.train.loss import one_vs_n_loss as jax_one_vs_n_loss
from open_knowledge_graph_embeddings_tpu.train.step import eval_batch_to_arrays as jax_eval_arrays
from open_knowledge_graph_embeddings_tpu.train.step import make_eval_step as jax_make_eval_step
from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder, pad_batches_to_common_shape
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train import evaluate as pev
from open_knowledge_graph_embeddings_tpu_torch.train import step as pstep
from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import load_checkpoint, variables_from_jax_arrays
from open_knowledge_graph_embeddings_tpu_torch.train.loss import one_vs_n_loss

torch.set_num_threads(1)  # fixed GEMM partition order (see test_headtohead.py)

ROOT = pathlib.Path(__file__).resolve().parents[1]
INT_KEYS = ("count", "mr", "h50", "h10", "h3", "h1")


# ---------------------------------------------------------------- inputs


def _case(seed, B=6, N=100, N_real=90, d=16, exact=True):
    """One eval batch over a [N, d] candidate matrix: random filter cells,
    0-2 golds a row with 1-2 mention columns (all filtered), a gold on a
    duplicated candidate (exact tie cells), a gold with no valid mention
    column, padded filter and gold arrays, unique positive pairs."""
    rng = np.random.default_rng(seed)
    if exact:
        q = rng.integers(-16, 17, (B, d)).astype(np.float32) / 8
        cand = rng.integers(-16, 17, (N, d)).astype(np.float32) / 8
    else:
        q = rng.standard_normal((B, d)).astype(np.float32)
        cand = rng.standard_normal((N, d)).astype(np.float32)
    cand[7] = cand[11] = cand[3]
    cand[40] = cand[41]
    col_valid = np.zeros(N, bool)
    col_valid[:N_real] = True
    fmask = (rng.random((B, N)) < 0.2) & col_valid[None, :]
    g_rows, g_ments = [], []
    for b in range(B - 1):  # the last row has no gold
        for _ in range(int(rng.integers(0, 3))):
            cols = rng.choice(N_real, int(rng.integers(1, 3)), replace=False)
            fmask[b, cols] = True
            g_rows.append(b)
            g_ments.append(cols)
    g_rows.append(2)
    g_ments.append(np.array([3]))
    fmask[2, 3] = True
    g_rows.append(1)
    g_ments.append(np.array([41]))
    fmask[1, 41] = True
    g_rows.append(0)  # a gold with no valid mention column: not ranked
    g_ments.append(np.array([], dtype=np.int64))
    fr, fc = np.nonzero(fmask)
    perm = rng.permutation(len(fr))
    fr, fc = fr[perm], fc[perm]
    F, G, A = len(fr) + 5, len(g_rows) + 2, 3
    frp, fcp = np.full(F, -1, np.int32), np.full(F, -1, np.int32)
    frp[: len(fr)], fcp[: len(fc)] = fr, fc
    grp, gmp = np.full(G, -1, np.int32), np.full((G, A), -1, np.int32)
    for i, (r, m) in enumerate(zip(g_rows, g_ments)):
        grp[i] = r
        gmp[i, : len(m)] = m
    pairs = sorted(set(zip(rng.integers(0, B - 1, 12).tolist(), rng.integers(0, N_real, 12).tolist())))
    P = len(pairs) + 3
    prp, pcp = np.full(P, -1, np.int32), np.full(P, -1, np.int32)
    prp[: len(pairs)], pcp[: len(pairs)] = np.array(pairs).T
    row_valid = np.arange(B) < B - 1
    return dict(q=q, cand=cand, col_valid=col_valid, filter_rows=frp, filter_cols=fcp, gold_rows=grp,
                gold_mention_cols=gmp, pos_rows=prp, pos_cols=pcp, row_valid=row_valid, n_real=np.float32(N_real))


def _t(c, *names):
    return [torch.from_numpy(np.asarray(c[n])) for n in names]


def _j(c, *names):
    return [jnp.asarray(c[n]) for n in names]


GOLD = ("filter_rows", "filter_cols", "gold_rows", "gold_mention_cols")
POS = ("pos_rows", "pos_cols", "row_valid", "col_valid")


# ------------------------------------------------------------- ranking


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ranks_and_metric_sums_match_jax(seed):
    """ranks_from_scores, metric_sums_from_ranks and the BCE one_vs_n_loss
    on exact scores: ranks and gold_valid equal, integer sums equal, mrr
    and loss to rtol 1e-6."""
    c = _case(seed)
    scores = c["q"] @ c["cand"].T
    jr, jvalid = jev.ranks_from_scores(jnp.asarray(scores), *_j(c, *GOLD), jnp.asarray(c["col_valid"]))
    pr, pvalid = pev.ranks_from_scores(torch.from_numpy(scores), *_t(c, *GOLD), torch.from_numpy(c["col_valid"]))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    v = np.asarray(jvalid)
    assert not v[len(v) - 3] and v.sum() >= 3  # the gold without a mention column is not ranked
    np.testing.assert_array_equal(pr.numpy()[v], np.asarray(jr)[v])
    js = jev.metric_sums_from_ranks(jr, jvalid)
    ps = pev.metric_sums_from_ranks(pr, pvalid)
    for k in INT_KEYS:
        assert float(ps[k]) == float(js[k]), k
    assert float(ps["mrr"]) == pytest.approx(float(js["mrr"]), rel=1e-6)
    jl, jn = jax_one_vs_n_loss("bce", jnp.asarray(scores), *_j(c, *POS), jnp.float32(c["n_real"]), 0.1)
    pl, pn = one_vs_n_loss("bce", torch.from_numpy(scores), *_t(c, *POS), torch.tensor(c["n_real"]), 0.1)
    assert float(pl) == pytest.approx(float(jl), rel=1e-6)
    assert float(pn) == float(jn)


def _chunked(mod, c, chunk, smoothing, lib):
    conv = _t if lib == "torch" else _j
    q, cand = conv(c, "q", "cand")
    n_real = torch.tensor(c["n_real"]) if lib == "torch" else jnp.float32(c["n_real"])
    pos_rows, pos_cols, row_valid, col_valid = conv(c, *POS)
    loss, ranks, valid = mod.eval_stats_chunked(q, cand, pos_rows, pos_cols, row_valid, col_valid, n_real,
                                                *conv(c, *GOLD), smoothing, chunk=chunk)
    return float(loss), np.asarray(ranks), np.asarray(valid)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("chunk", [16, 32, 100, 33])
def test_eval_stats_chunked_matches_jax_and_dense(chunk, smoothing):
    """The port's chunked formulation against JAX's and against the dense
    one (scores, ranks_from_scores, the indexed BCE), chunk sizes that
    divide N, exceed a row, equal N and do not divide it, on exact scores
    with tie cells: ranks equal, loss to rtol 1e-6."""
    c = _case(5)
    scores = torch.from_numpy(c["q"] @ c["cand"].T)
    dense_ranks, valid = pev.ranks_from_scores(scores, *_t(c, *GOLD), torch.from_numpy(c["col_valid"]))
    dense_loss, _ = one_vs_n_loss("bce", scores, *_t(c, *POS), torch.tensor(c["n_real"]), smoothing)
    p_loss, p_ranks, p_valid = _chunked(pev, c, chunk, smoothing, "torch")
    j_loss, j_ranks, j_valid = _chunked(jev, c, chunk, smoothing, "jax")
    v = valid.numpy()
    np.testing.assert_array_equal(p_valid, v)
    np.testing.assert_array_equal(j_valid, v)
    np.testing.assert_array_equal(p_ranks[v], j_ranks[v])
    np.testing.assert_array_equal(p_ranks[v], dense_ranks.numpy()[v])
    assert p_loss == pytest.approx(j_loss, rel=1e-6)
    assert p_loss == pytest.approx(float(dense_loss), rel=1e-6)


@pytest.mark.parametrize("chunk", [16, 33, 100])
def test_chunked_and_dense_ranks_agree_on_inexact_ties(chunk):
    """Non-exact random f32 inputs with exact ties (duplicated candidate
    rows, golds on them): the chunked and the dense formulation of the port
    give equal ranks, since each takes every value a rank compares from one
    product."""
    c = _case(7, B=8, N=200, N_real=180, d=24, exact=False)
    q, cand, col_valid = _t(c, "q", "cand", "col_valid")
    dense, valid = pev.ranks_from_scores(q @ cand.T, *_t(c, *GOLD), col_valid)
    _, ranks, _ = _chunked(pev, c, chunk, 0.0, "torch")
    v = valid.numpy()
    np.testing.assert_array_equal(ranks[v], dense.numpy()[v])
    tie_gold = int(np.flatnonzero(c["gold_mention_cols"][:, 0] == 3)[0])
    assert ranks[tie_gold] == dense.numpy()[tie_gold]


@pytest.mark.parametrize("k", [5, 30])
def test_filtered_topk_matches_jax_tie_order(k):
    """Dense filtered top-k on exact scores full of ties: the same scores
    and the same columns, lowest column first among equals (lax.top_k)."""
    c = _case(3)
    scores = c["q"] @ c["cand"].T
    js, jc = jev.filtered_topk(jnp.asarray(scores), *_j(c, "filter_rows", "filter_cols", "col_valid"), k)
    ps, pc = pev.filtered_topk(torch.from_numpy(scores), *_t(c, "filter_rows", "filter_cols", "col_valid"), k)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


# ----------------------------------------------------------------- data


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_eval")
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(d), "--mentions", "300",
         "--relations", "30", "--triples", "400", "--eval-size", "40", "--ent-tokens", "100",
         "--rel-tokens", "25", "--seed", "3"],
        check=True, capture_output=True, timeout=120,
    )
    return str(d)


def _eval_sets(path, tag, split="valid.txt", **cfg):
    cfg = dict(dict(input_file=split, is_training_data=False, batch_size=8), **cfg)
    j = JaxDataset(dataset_dir=path, cache_dir=f"{path}/{tag}_jax", **cfg)
    p = OneToNMentionRelationDataset(dataset_dir=path, cache_dir=f"{path}/{tag}_port", **cfg)
    for ds in (j, p):
        ds.attach_filter_index("train.txt", "valid.txt", "test.txt")
    return j, p


@pytest.mark.parametrize("split", ["valid.txt", "test.txt"])
def test_filter_index_matches_jax_and_each_reads_the_other(synth_dir, split):
    j, p = _eval_sets(synth_dir, "filter", split)
    for name in ("filter_offsets", "filter_values", "p1", "p2", "slot", "group_offsets", "mentions"):
        np.testing.assert_array_equal(getattr(p.records, name), getattr(j.records, name), err_msg=name)
    assert p.records.filter_values.size > len(p)
    cfg = dict(input_file=split, is_training_data=False, batch_size=8)
    p_from_j = OneToNMentionRelationDataset(dataset_dir=synth_dir, cache_dir=f"{synth_dir}/filter_jax", **cfg)
    j_from_p = JaxDataset(dataset_dir=synth_dir, cache_dir=f"{synth_dir}/filter_port", **cfg)
    for ds in (p_from_j, j_from_p):
        ds.attach_filter_index("train.txt", "valid.txt", "test.txt")
        np.testing.assert_array_equal(ds.records.filter_offsets, j.records.filter_offsets)
        np.testing.assert_array_equal(ds.records.filter_values, j.records.filter_values)
    i = int(np.argmax(np.diff(p.records.group_offsets)))
    assert p.records.row_groups(i) == j.records.row_groups(i)
    np.testing.assert_array_equal(p.records.row_mentions(i), j.records.row_mentions(i))
    np.testing.assert_array_equal(p.records.row_filter(i), j.records.row_filter(i))


BATCH_FIELDS = ("ent_ids", "rel_ids", "is_sp", "row_valid", "candidate_ids", "col_valid", "pos_rows", "pos_cols",
                "filter_rows", "filter_cols", "gold_rows", "gold_mention_cols")


def _assert_batch_equal(pb, jb):
    for name in BATCH_FIELDS:
        got, want = getattr(pb, name), getattr(jb, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert (pb.num_rows, pb.num_cols, pb.cand_offset, pb.normalizer_loss) == (
        jb.num_rows, jb.num_cols, jb.cand_offset, jb.normalizer_loss)


@pytest.mark.parametrize("data", ["toy", "synth"])
@pytest.mark.parametrize("shared", [False, True], ids=["full-vocab", "batch-shared"])
def test_eval_batches_match_jax(toy_dataset_dir, synth_dir, data, shared):
    """Every field of every eval batch (the last one partial), negatives
    drawn to min_size_batch_labels included, for the same seed."""
    path = toy_dataset_dir if data == "toy" else synth_dir
    bs, min_size = (4, 7) if data == "toy" else (8, 64)
    cfg = dict(batch_size=bs, use_batch_shared_entities=shared, min_size_batch_labels=min_size if shared else -1)
    j, p = _eval_sets(path, f"batches_{shared}", **cfg)
    jl = list(JaxBatchBuilder(j, seed=3).batches())
    pl = list(BatchBuilder(p, seed=3).batches())
    assert len(pl) == len(jl) == -(-len(p) // bs) and pl[-1].num_rows == len(p) - bs * (len(pl) - 1)
    for pb, jb in zip(pl, jl):
        _assert_batch_equal(pb, jb)
    if shared:
        assert any(b.num_cols == min_size for b in pl)  # negatives topped up


@pytest.mark.parametrize("shared", [False, True], ids=["full-vocab", "batch-shared"])
def test_pad_batches_to_common_shape_matches_jax(synth_dir, shared):
    cfg = dict(batch_size=8, use_batch_shared_entities=shared, min_size_batch_labels=64 if shared else -1)
    j, p = _eval_sets(synth_dir, f"pad_{shared}", **cfg)
    jl = jax_pad(list(JaxBatchBuilder(j, seed=4, pos_bucket_min=4).batches()))
    pl = pad_batches_to_common_shape(list(BatchBuilder(p, seed=4, pos_bucket_min=4).batches()))
    assert len({(len(b.pos_rows), len(b.filter_rows), b.gold_mention_cols.shape) for b in pl}) == 1
    for pb, jb in zip(pl, jl):
        _assert_batch_equal(pb, jb)


# ------------------------------------------------------------ eval step


def _eval_models(path, d=32):
    cfg = dict(entity_slot_size=d, normalize="batchnorm", init_std=0.1, dropout=0.0)
    j, p = _eval_sets(path, "models", split="test.txt")
    jmodel = jax_build_model("LSTMComplexRelationModel", j.meta, **cfg)
    jv = jmodel.init(jax.random.key(0))
    model = build_model("LSTMComplexRelationModel", p.meta, **cfg)
    pv = model.init(torch.Generator().manual_seed(0))
    pv.update(variables_from_jax_arrays({**jax_flatten(jv["params"], "params"), **jax_flatten(jv["state"], "state")}))
    return jmodel, jv, model, pv


@pytest.mark.parametrize("mode", ["batch-shared", "full-vocab", "full-vocab-chunked"])
def test_eval_step_matches_jax(synth_dir, monkeypatch, mode):
    """make_eval_step of both packages on the same weights (LSTM-ComplEx,
    d=32, batchnorm, f32) over every test batch: count, mr and hits equal,
    mrr to rtol 1e-6; the loss to rtol 1e-5 (the encodes of the two
    packages differ by f32 rounding, ~1e-6 of a score, summed over B x N
    cells).  The chunked branch of the port (forced below its 100,000
    candidates) is held against JAX's dense one."""
    jmodel, jv, model, pv = _eval_models(synth_dir)
    shared = mode == "batch-shared"
    cfg = dict(batch_size=16, use_batch_shared_entities=shared, min_size_batch_labels=64 if shared else -1)
    j, p = _eval_sets(synth_dir, f"step_{shared}", split="test.txt", **cfg)
    jcache = pcache = None
    if not shared:
        off = p.meta.min_entities_size
        jcache = jmodel.encode_all_entities(jv)[off:]
        pcache = model.encode_all_entities(pv)[off:]
    if mode == "full-vocab-chunked":
        monkeypatch.setattr(pstep, "CHUNKED_ABOVE", 0)
    jstep, pstep_fn = jax_make_eval_step(jmodel), pstep.make_eval_step(model)
    n = 0
    for jb, pb in zip(JaxBatchBuilder(j, seed=2).batches(), BatchBuilder(p, seed=2).batches()):
        _assert_batch_equal(pb, jb)
        ja = {k: jnp.asarray(v) for k, v in jax_eval_arrays(jb).items()}
        want = pstep.unpack_eval_stats(np.asarray(jstep(jv, ja) if shared else jstep(jv, ja, jcache)))
        got = pstep.unpack_eval_stats(pstep_fn(pv, pstep.arrays_to_device(pstep.eval_batch_to_arrays(pb), "cpu"),
                                               pcache))
        for k in INT_KEYS + ("normalizer_metric",):
            assert got[k] == want[k], (k, got, want)
        assert got["mrr"] == pytest.approx(want["mrr"], rel=1e-6)
        assert got["loss_sum"] == pytest.approx(want["loss_sum"], rel=1e-5)
        n += got["count"]
    assert n > 40


# ------------------------------------------------------- trainer and CLI


MODEL_CONFIG = {"entity_slot_size": 8, "init_std": 0.1, "dropout": 0.0}


def _config(toy_dataset_dir, exp_dir, **over):
    cfg = dict(
        dataset_dir=toy_dataset_dir, experiment_dir=str(exp_dir), model="LSTMComplexRelationModel",
        model_config=MODEL_CONFIG, optimization_config={"optimizer": "Adagrad", "epoch": 0, "lr": 0.3},
        train_data_config={"input_file": "train.txt", "batch_size": 4, "use_batch_shared_entities": False},
        val_data_config={"input_file": "valid.txt", "batch_size": 4, "use_batch_shared_entities": True,
                         "min_size_batch_labels": 6},
        test_data_config={"input_file": "test.txt", "batch_size": 4, "use_batch_shared_entities": False},
        batch_size=4, epochs=4, eval_epoch_freq=1, save_epoch_freq=1, eval_freq=-1, print_freq=1, workers=2,
        seed=1,
    )
    cfg.update(over)
    return cfg


def _port_cli(path, cfg, *argv):
    path.write_text(yaml.safe_dump(cfg))
    return port_train.cli_main([str(path), "--device", "cpu", *argv])


def test_cli_train_with_validation_selects_the_best_model(toy_dataset_dir, tmp_path):
    """cli.train --device cpu, 4 passes with a validation eval after each:
    validation_* results, model_best-mrr that loads, checkpoint_epoch_n."""
    trainer = _port_cli(tmp_path / "c.yaml", _config(toy_dataset_dir, tmp_path / "exp"))
    rows = [r for r in trainer.results.to_dicts() if "validation_mrr" in r]
    assert len(rows) == len([r for r in trainer.results.to_dicts() if "training_loss" in r]) >= 4
    for r in rows:
        assert 0 < r["validation_mrr"] <= 1 and np.isfinite(r["validation_loss"])
        assert r["validation_h1"] <= r["validation_h3"] <= r["validation_h10"] <= r["validation_h50"]
    best_row = max(rows, key=lambda r: r["validation_mrr"])  # the first of equals: only a gain is "best"
    _, _, meta = load_checkpoint(str(tmp_path / "exp" / "model_best-mrr"),
                                 trainer.model.init(torch.Generator().manual_seed(2)), {})
    assert meta["training_steps"] == best_row["training_steps"]
    assert (tmp_path / "exp" / "checkpoint_epoch_1").is_dir()
    with open(tmp_path / "exp" / "results.csv") as f:
        header = next(csv.reader(f))
    assert "validation_mrr" in header and "training_loss" in header


def test_early_stopping_fires_at_jaxs_epoch(toy_dataset_dir, tmp_path):
    """SGD lr 0, patience 1 (JAX's tests/test_trainer.py::test_early_stopping_fires
    with the LSTM model): the metric never improves after the first eval, so
    both packages stop at the same epoch and step."""
    over = dict(epochs=50, patience_epochs=1, optimization_config={"optimizer": "SGD", "epoch": 0, "lr": 0.0},
                save_epoch_freq=0)
    port = _port_cli(tmp_path / "c.yaml", _config(toy_dataset_dir, tmp_path / "port", **over))
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, tmp_path / "jax", **over))
    jtrainer = jax_main(args)
    assert port.terminate and jtrainer.terminate
    assert port.epoch == jtrainer.epoch < 50
    assert port.training_steps == jtrainer.training_steps


@pytest.fixture(scope="module")
def jax_checkpoint(toy_dataset_dir, tmp_path_factory):
    """A JAX cli.train run on the toy set (LSTM-ComplEx, d=8, 3 passes)."""
    d = tmp_path_factory.mktemp("jax_eval_ckpt")
    args = jax_load_config()
    args.update(_config(toy_dataset_dir, d / "exp", epochs=3, eval_epoch_freq=0))
    trainer = jax_main(args)
    return str(trainer.save())


def _scores_row(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


@pytest.mark.parametrize("on_validation", [True, False], ids=["validation", "test"])
def test_evaluate_a_jax_checkpoint_in_both_packages(toy_dataset_dir, tmp_path, jax_checkpoint, on_validation):
    """cli.train --evaluate on a JAX checkpoint: the same filtered MRR, MR
    and hits in both packages' evaluate_scores_file rows (same columns; mrr
    rtol 1e-6, the loss rtol 1e-5), on the batch-shared validation split
    and the full-vocabulary test split."""
    over = dict(resume=jax_checkpoint, evaluate=True, evaluate_on_validation=on_validation)
    jargs = jax_load_config()
    jargs.update(_config(toy_dataset_dir, tmp_path / "jax", evaluate_scores_file=str(tmp_path / "j.csv"), **over))
    jax_main(jargs)
    trainer = _port_cli(tmp_path / "c.yaml", _config(toy_dataset_dir, tmp_path / "port",
                                                     evaluate_scores_file=str(tmp_path / "p.csv"), **over))
    assert trainer.training_steps == 6 and trainer.last_eval["batches"] >= 1
    want, got = _scores_row(tmp_path / "j.csv"), _scores_row(tmp_path / "p.csv")
    assert list(got) == list(want)
    for k in ("mr", "h1", "h3", "h10", "h50", "epoch", "checkpoint", "batch_size", "model"):
        assert got[k] == want[k], k
    assert float(got["mrr"]) == pytest.approx(float(want["mrr"]), rel=1e-6)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    assert 0 < float(got["mrr"]) <= 1


def test_log_predictions_writes_jaxs_tsv(toy_dataset_dir, tmp_path, jax_checkpoint):
    """log_predictions on the full-vocabulary test split (the checkpoint's
    config not adopted, so the flag holds): the same TSV rows (ids exactly,
    the 4-decimal scores to 1.5e-4)."""
    over = dict(resume=jax_checkpoint, resume_load_args=False, evaluate=True, evaluate_on_validation=False,
                log_predictions=True, log_predictions_topk=5)
    jargs = jax_load_config()
    jargs.update(_config(toy_dataset_dir, tmp_path / "jax", **over))
    jax_main(jargs)
    _port_cli(tmp_path / "c.yaml", _config(toy_dataset_dir, tmp_path / "port", **over))

    def rows(d):
        (name,) = [n for n in os.listdir(d) if n.startswith("predictions_step")]
        with open(os.path.join(d, name)) as f:
            return name, [ln.rstrip("\n").split("\t") for ln in f]

    jname, jrows = rows(tmp_path / "jax")
    pname, prows = rows(tmp_path / "port")
    assert pname == jname and len(prows) == len(jrows) > 1
    assert prows[0] == jrows[0]
    for p, j in zip(prows[1:], jrows[1:]):
        assert p[:4] == j[:4]
        np.testing.assert_allclose(np.array(p[4].split(), float), np.array(j[4].split(), float), atol=1.5e-4)
