"""The comparison that decides ``correct``, at a size the CPU holds: a sound
run of each cell is correct; the same run with the timed path broken
underneath is not, for each fault the cell can have (a training cell: its
state returned unchanged; half of the batch left out, the mean over the
rest; a token altered where it is produced.  A serving cell: half of a
request's queries answered with the other half's answers; an answer
altered where it is produced); and the control, the reference in the
precision below the configuration's put in the program's place, is not.

The run skips only the harness's look for a card (the cell's runner on the
CPU, where the program takes its plain kernels).  The sound and fault runs
compute in f32, so that the program's own rounding stays far under the
limits set on the card for the cell's precision.  The card test reads the
program and the control at the cell's own size."""

import json
import time

import pytest
import torch

import bench_tiny
import readings
from okbench import cli, compare

PORT = "open_knowledge_graph_embeddings_tpu_torch"
#: the cells ``BENCHMARK.json`` lists, by their traffic's kind
CELLS = [w["name"] for w in json.loads((bench_tiny.BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
TRAIN_CELLS = [c for c in CELLS if bench_tiny.load(c).traffic["kind"] == "train"]
SERVE_CELLS = [c for c in CELLS if bench_tiny.load(c).traffic["kind"] == "serve"]
SEED = 2 ** 31 + 12345


def plant(fault, monkeypatch):
    import importlib

    optim = importlib.import_module(f"{PORT}.train.optim")
    sparse = importlib.import_module(f"{PORT}.train.sparse")
    step = importlib.import_module(f"{PORT}.train.step")
    dataset = importlib.import_module(f"{PORT}.data.dataset")
    inference = importlib.import_module(f"{PORT}.inference")
    if fault == "half_answers":  # the second half of a request's queries get the first half's answers
        def halved(self, *a, **k):
            scores, cols = topk(self, *a, **k)
            h = (scores.shape[0] + 1) // 2
            return torch.cat([scores[:h], scores[: scores.shape[0] - h]]), torch.cat([cols[:h], cols[: cols.shape[0] - h]])

        topk = inference.Predictor._topk
        monkeypatch.setattr(inference.Predictor, "_topk", halved)
    elif fault == "answer":  # each query's first answer altered
        def altered_answer(self, *a, **k):
            scores, cols = topk(self, *a, **k)
            cols = cols.clone()
            cols[:, 0] = (cols[:, 0] + 1) % self.cand_emb.shape[0]
            return scores, cols

        topk = inference.Predictor._topk
        monkeypatch.setattr(inference.Predictor, "_topk", altered_answer)
    elif fault == "unchanged":  # every update returns the state it was given
        monkeypatch.setattr(optim, "adagrad_update_leaves", lambda gs, ps, accs, steps, hp: list(steps))
        monkeypatch.setattr(sparse, "scatter_adagrad_tables", lambda *a: list(a[-2]))
    elif fault == "half_batch":
        def half(model, variables, batch, *a, **k):
            n = batch["row_valid"].shape[0]
            keep = torch.arange(n, device=batch["row_valid"].device) < n // 2
            share = (batch["row_valid"] & keep).sum() / batch["row_valid"].sum()
            batch["row_valid"] = batch["row_valid"] & keep
            gone = batch["pos_rows"] >= n // 2
            batch["pos_rows"] = torch.where(gone, -1, batch["pos_rows"])
            batch["pos_cols"] = torch.where(gone, -1, batch["pos_cols"])
            batch["normalizer_loss"] = batch["normalizer_loss"] * share
            return inner(model, variables, batch, *a, **k)

        inner = step.prefix_loss
        monkeypatch.setattr(step, "prefix_loss", half)
        monkeypatch.setattr(sparse, "prefix_loss", half)
    elif fault == "window_unchanged":  # a multi-step window runs, and hands its state back as it was given
        def unchanged(self, variables, opt_state, *a, **k):
            kept = [(t, t.detach().clone()) for t in tensors((variables, opt_state))]
            out = window(self, variables, opt_state, *a, **k)
            with torch.no_grad():
                for t, was in kept:
                    t.copy_(was)
            return out

        window = step.ScannedStep.__call__
        monkeypatch.setattr(step.ScannedStep, "__call__", unchanged)
    elif fault == "token":  # the loader hands out each mention's first body token altered
        def altered(*a, **k):
            meta = load(*a, **k)
            first = meta.entity_token_ids[:, 1]
            meta.entity_token_ids[:, 1] = (first >= 4) * (4 + (first - 3) % (meta.entity_tokens_size - 4)) + (
                first < 4) * first
            return meta

        load = dataset.load_meta
        monkeypatch.setattr(dataset, "load_meta", altered)


def tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, (list, tuple)) else []
    return [t for x in items for t in tensors(x)]


def run_cell(w):
    res = cli.RUNNERS[w.traffic["kind"]](w, SEED, 0.1, False, "cpu", time.perf_counter(), lambda msg: None)
    return cli.is_correct(res), res


#: a sound f32 run on the CPU against the reference: the numbers of the
#: first step (before any update amplifies round-off) and of serving
AGREE = {"loss1_gap": 1e-5, "grad_gap": 1e-5, "grad_med_gap": 1e-5, "rows_gap": 1e-5, "label_faults": 0.0,
         "topk_gap": 1e-5, "score_gap": 1e-5}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell):
    _, res = run_cell(bench_tiny.tiny(cell, dtype="float32"))
    assert res["failed"] == 0
    for k, v in res["numbers"].items():
        if k in AGREE:
            assert v <= AGREE[k], (k, res["numbers"])


#: the training cells whose trainer runs multi-step windows
WINDOW_CELLS = [c for c in TRAIN_CELLS if int(bench_tiny.tiny(c).config["run"].get("train_scan_steps") or 1) > 1]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TRAIN_CELLS for f in ("unchanged", "half_batch", "token")]
                         + [(c, "window_unchanged") for c in WINDOW_CELLS]
                         + [(c, f) for c in SERVE_CELLS for f in ("half_answers", "answer")])
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    w = bench_tiny.tiny(cell, dtype="float32")
    plant(fault, monkeypatch)
    correct, res = run_cell(w)
    assert not correct, res["checks"]


@pytest.mark.parametrize("cell", WINDOW_CELLS)
def test_a_window_never_replayed_is_not_correct(cell, monkeypatch):
    """A cell whose checks read a replayed window fails where none comes."""
    from okbench import train_cell

    monkeypatch.setattr(train_cell, "REPLAYED", ())
    correct, res = run_cell(bench_tiny.tiny(cell, dtype="float32"))
    assert not correct
    assert any(k.startswith("replay_") and c["value"] is None for k, c in res["checks"].items()), res["checks"]


@pytest.mark.parametrize("cell", WINDOW_CELLS)
def test_the_checked_window_is_read(cell):
    _, res = run_cell(bench_tiny.tiny(cell, dtype="float32"))
    assert {"replay_loss_gap", "replay_grad_gap", "replay_change_gap", "replay_rows_gap"} <= set(res["numbers"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    w = bench_tiny.tiny(cell)
    rows, _ = readings.readings(w, [SEED], 1, device="cpu")
    control = next(r for r in rows if r["kind"] == "control")
    assert not compare.judge(control, w.cell["limits"]), control


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_on_the_card(card, cell):
    w = bench_tiny.load(cell)
    rows, _ = readings.readings(w, [SEED, SEED + 1, SEED + 2], 3, device="cuda")
    for r in rows:
        sound = compare.judge(r, w.cell["limits"])
        assert sound == (r["kind"] == "program"), r
