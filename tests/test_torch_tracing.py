"""The port's host spans (``utils/tracing.py``) on the CPU: a span is a
profiler range only while a profiler records, its ms and nesting, the clock
across threads; and the trainer's spans and records on the toy set with
windows of 2 (two windows and a flushed tail a pass): the names a plain
profiler and the ``profile_steps`` trace hold, ``step_log``'s ``step_ms``,
``plan_ms`` and ``flushed``, and the flush counts."""

import json
import threading
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train import trainer as trainer_mod
from open_knowledge_graph_embeddings_tpu_torch.train.trainer import Trainer
from open_knowledge_graph_embeddings_tpu_torch.utils import tracing
from open_knowledge_graph_embeddings_tpu_torch.utils.tracing import clock, span

torch.set_num_threads(1)


def _names(prof):
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_span_is_a_profiler_range_only_while_one_records(monkeypatch):
    """A host event of the function scope (a user-scope range would also be
    laid on a card's timeline as a device event)."""
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("during"):
            torch.ones(4).sum()
    with span("after"):
        pass
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "during" in events and not {"before", "after"} & set(events)
    assert events["during"].device_type() == torch.autograd.DeviceType.CPU
    assert events["during"].scope() == events["aten::sum"].scope()  # as an operator's, not a user annotation
    # no profiler: the span never reaches the dispatcher
    monkeypatch.setattr(tracing, "_Range", lambda name: pytest.fail(f"opened a range {name}"))
    with span("unrecorded") as s:
        pass
    assert s.ms >= 0


def test_span_on_another_thread_is_a_range_where_the_profiler_records_it():
    """The check is the process-wide flag: a worker thread's span is a range
    of a profiler that records every thread."""
    kw = trainer_mod._every_thread()
    if not kw:
        pytest.skip("this torch's profiler cannot record every thread")

    def work():
        with span("worker"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert "worker" in _names(prof)


def test_span_ms_is_set_on_exit_and_nests():
    with span("outer") as outer:
        assert outer.ms is None
        with span("inner") as inner:
            sum(range(10000))
        assert inner.ms > 0 and outer.ms is None
    assert outer.ms >= inner.ms > 0 and outer.name == "outer"


def test_span_ms_is_set_when_the_block_raises():
    with pytest.raises(ValueError):
        with span("raises") as s:
            raise ValueError("x")
    assert s.ms >= 0


def test_clock_sums_spans_of_any_thread_until_its_block_ends():
    def work(n):
        for _ in range(n):
            with span("worker.part"):
                pass

    with clock() as c:
        with span("main.part") as main:
            pass
        t = threading.Thread(target=work, args=(3,))
        t.start()
        t.join()
        with clock() as inner:  # clocks nest: each sums what exits while it is open
            work(1)
    assert set(c.ms) == {"main.part", "worker.part"} and c.ms["main.part"] == main.ms
    assert set(inner.ms) == {"worker.part"} and inner.ms["worker.part"] < c.ms["worker.part"]
    read = dict(c.ms)
    work(2)
    assert c.ms == read and not tracing._clocks


# ----------------------------------------------------------------- trainer

#: the toy set's 10 training prefixes in batches of 2: five steps a pass,
#: windows of 2, so each pass is two windows and a tail of one flushed step
CONFIG = dict(batch_size=2, epochs=3, eval_epoch_freq=0, eval_freq=-1, save_epoch_freq=0, print_freq=100,
              model="LookupComplexRelationModel", model_config={"entity_slot_size": 8, "init_std": 0.1,
                                                               "sparse": True},
              optimization_config={"optimizer": "Adagrad", "lr": 0.3}, sparse_min_ratio=0.0,
              train_data_config={"input_file": "train.txt", "batch_size": 2, "use_batch_shared_entities": False},
              seed=17, workers=1, train_scan_steps=2)
#: the training thread's spans of this path (a row-sparse step in windows)
TRAINING_SPANS = {"train.wait_batch", "train.window", "train.step", "train.log", "train.drain", "train.forward",
                  "train.backward", "train.optimizer", "optim.dense", "optim.rows"}
BATCH_SPANS = {"batch.build", "batch.plan", "batch.copy", "batch.pack"}


def _trainer(toy_dataset_dir, tmp_path, **over):
    cfg = dict(CONFIG, dataset_dir=toy_dataset_dir, experiment_dir=str(tmp_path), **over)
    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2)
    model = build_model(cfg["model"], ds.meta, **cfg["model_config"])
    return Trainer(cfg, model, ds, save_path=str(tmp_path), device="cpu")


def test_training_thread_spans_under_a_plain_profiler(toy_dataset_dir, tmp_path):
    """A plain profiler around a pass (the benchmark's, recording the
    training thread) holds every training-thread span the path runs."""
    trainer = _trainer(toy_dataset_dir, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch()
    assert trainer.scan_steps == 2 and len(trainer.step_log) == 5
    assert TRAINING_SPANS <= _names(prof), TRAINING_SPANS - _names(prof)


def test_step_log_accounts_for_every_step(toy_dataset_dir, tmp_path, caplog):
    """``step_log`` rows carry ``step_ms``, ``plan_ms`` and ``flushed``; the
    flush counts add up to the single steps that are not windows'; a
    window's step ms falls on its first row; the TRAINING line reports the
    host ms, the replayed and the flushed steps."""
    trainer = _trainer(toy_dataset_dir, tmp_path)
    with caplog.at_level("INFO", logger=trainer_mod.__name__):
        for _ in range(2):
            trainer.train_epoch()
    log = trainer.step_log
    assert len(log) == 10 and all({"step_ms", "plan_ms", "flushed", "wait_ms"} <= set(r) for r in log)
    assert all(r["plan_ms"] > 0 for r in log)
    singles = [r for r in log if r["window"] is None]
    assert [r["window"] is None for r in log] == [False] * 4 + [True] + [False] * 4 + [True]
    assert all(r["flushed"] == "tail" for r in singles) and all(r["flushed"] is None for r in log if r["window"])
    assert trainer.flush_counts == Counter(r["flushed"] for r in singles) == {"tail": 2}
    assert sum(trainer.flush_counts.values()) == len(singles)
    firsts = log[0:4:2] + log[5:9:2]
    assert all(r["step_ms"] > 0 for r in firsts + singles)
    assert all(r["step_ms"] == 0.0 and r["wait_ms"] == 0.0 for r in log[1:4:2] + log[6:9:2])
    lines = [r.getMessage() for r in caplog.records if "TRAINING" in r.getMessage()]
    assert len(lines) == 2 and all("host ms/step: wait" in ln and "flushed: {'tail': 1}" in ln for ln in lines)
    assert all("replayed: 0/5" in ln for ln in lines)  # the CPU runs windows as loops, not graphs


def test_profile_steps_trace_holds_every_thread(toy_dataset_dir, tmp_path):
    """The ``profile_steps`` trace, from step 2 through the next pass:
    the training thread's spans, and the prefetch and producer threads'
    where the installed torch records every thread."""
    trainer = _trainer(toy_dataset_dir, tmp_path, profile_steps=100)
    for _ in range(2):
        trainer.train_epoch()
    trainer._stop_profile()
    with open(trainer.profile_trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert TRAINING_SPANS <= names, TRAINING_SPANS - names
    if trainer_mod._every_thread():
        assert BATCH_SPANS <= names, BATCH_SPANS - names
