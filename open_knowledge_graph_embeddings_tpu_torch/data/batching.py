"""1-vs-N training and eval batches as bucketed index arrays.

Counterpart of ``open_knowledge_graph_embeddings_tpu/data/batching.py``.  The
host emits only index arrays with bucketed shapes; the loss reads the
positives as (row, col) pairs and never builds a dense [B, N] label matrix.
Semantics kept from the reference collate:

* rows are ordered po-slot first, then sp-slot;
* batch-shared candidates are the first-seen-order unique answer ids (of
  this split in training; in eval, of every split, through each row's
  filter set), topped up with uniform random negative entity ids (drawn
  without replacement, excluding the seen set) to ``min_size_batch_labels``;
* ``normalizer_loss`` = real rows x real columns;
* (row, col) positive pairs are unique (the indexed BCE relies on it), and
  so are an eval batch's (row, col) filter pairs (the sparse filter
  corrections of the ranking rely on it).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import (
    SLOT_PO,
    SLOT_SP,
    OneToNMentionRelationDataset,
    PrefixRecords,
)
from open_knowledge_graph_embeddings_tpu_torch.utils.misc import next_bucket
from open_knowledge_graph_embeddings_tpu_torch.utils.tracing import span

PAD_COL = -1  # padding value for candidate-space column indices


@dataclass
class Batch:
    """One 1-vs-N batch as bucketed numpy arrays.

    Candidate-space columns index either the full entity vocabulary minus
    specials (``candidate_ids is None``; col j <-> entity id j + cand_offset)
    or the batch-shared candidate list (``candidate_ids[j]``)."""

    ent_ids: np.ndarray  # [B] int32, po rows first then sp rows
    rel_ids: np.ndarray  # [B] int32
    is_sp: np.ndarray  # [B] bool
    row_valid: np.ndarray  # [B] bool
    num_rows: int
    candidate_ids: Optional[np.ndarray]  # [N] int32 or None (full vocabulary)
    col_valid: Optional[np.ndarray]  # [N] bool or None
    num_cols: int
    cand_offset: int
    pos_rows: np.ndarray  # [P] int32 (-1 pad)
    pos_cols: np.ndarray  # [P] int32 (-1 pad)
    normalizer_loss: float
    # eval only: the known-true cells, and one gold row per (prefix, gold
    # entity) with its mention-alternative columns
    filter_rows: Optional[np.ndarray] = None  # [F] int32 (-1 pad)
    filter_cols: Optional[np.ndarray] = None  # [F] int32 (-1 pad)
    gold_rows: Optional[np.ndarray] = None  # [G] int32 (-1 pad)
    gold_mention_cols: Optional[np.ndarray] = None  # [G, A] int32 (-1 pad)

    @property
    def batch_size(self) -> int:
        return len(self.ent_ids)


def pad_batches_to_common_shape(batches: List[Batch]) -> List[Batch]:
    """The batches with every bucketed array grown to the list-wide largest
    size (the trainer keeps the full-vocabulary eval batches padded so)."""
    if not batches:
        return batches

    def grow(arr, n, fill):
        if arr is None or len(arr) >= n:
            return arr
        out = np.full((n,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[: len(arr)] = arr
        return out

    def largest(sizes, default):
        sizes = [n for n in sizes if n is not None]
        return max(sizes) if sizes else default

    P = largest((len(b.pos_rows) for b in batches), 0)
    F = largest((None if b.filter_rows is None else len(b.filter_rows) for b in batches), 0)
    G = largest((None if b.gold_rows is None else len(b.gold_rows) for b in batches), 0)
    A = largest((None if b.gold_mention_cols is None else b.gold_mention_cols.shape[1] for b in batches), 0)
    N = largest((None if b.candidate_ids is None else len(b.candidate_ids) for b in batches), None)
    out = []
    for b in batches:
        gm = b.gold_mention_cols
        if gm is not None and (gm.shape[0] < G or gm.shape[1] < A):
            gm = np.full((G, A), PAD_COL, dtype=gm.dtype)
            gm[: b.gold_mention_cols.shape[0], : b.gold_mention_cols.shape[1]] = b.gold_mention_cols
        cand, cv = b.candidate_ids, b.col_valid
        if cand is not None and N is not None:
            cand, cv = grow(cand, N, 0), grow(cv, N, False)
        out.append(Batch(
            ent_ids=b.ent_ids, rel_ids=b.rel_ids, is_sp=b.is_sp, row_valid=b.row_valid, num_rows=b.num_rows,
            candidate_ids=cand, col_valid=cv, num_cols=b.num_cols, cand_offset=b.cand_offset,
            pos_rows=grow(b.pos_rows, P, PAD_COL), pos_cols=grow(b.pos_cols, P, PAD_COL),
            normalizer_loss=b.normalizer_loss,
            filter_rows=grow(b.filter_rows, F, PAD_COL), filter_cols=grow(b.filter_cols, F, PAD_COL),
            gold_rows=grow(b.gold_rows, G, PAD_COL), gold_mention_cols=gm,
        ))
    return out


@dataclass
class _Scratch:
    """Per-thread build state: reusable lookup buffers (written and reset
    within one build) and the negative sampler's generator."""

    col_of_ent: np.ndarray
    first_pos: np.ndarray
    rng: np.random.Generator


class BatchBuilder:
    """Builds batches from a :class:`OneToNMentionRelationDataset`; an eval
    split's batches keep their last partial batch and carry the eval
    fields."""

    def __init__(
        self,
        dataset: OneToNMentionRelationDataset,
        batch_size: Optional[int] = None,
        drop_last: Optional[bool] = None,
        pos_bucket_min: int = 1024,
        seed: int = 0,
        host_shard: Optional[Tuple[int, int]] = None,
    ):
        """``host_shard=(rank, ranks)`` gives each rank the strided slice
        ``rank::ranks`` of every (identically seeded) epoch order: the
        host-sharded eval of several processes.  The slices cover every
        record, no tail dropped, as eval needs."""
        self.ds = dataset
        self.rec: PrefixRecords = dataset.records
        self.meta = dataset.meta
        self.batch_size = batch_size or dataset.batch_size
        self.drop_last = dataset.is_training_data if drop_last is None else drop_last
        self.host_shard = host_shard
        self.pos_bucket_min = pos_bucket_min
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.cand_offset = self.meta.min_entities_size
        self.full_num_cols = self.meta.entities_size - self.cand_offset
        self._scratch = None
        self._epoch_counter = -1

    def _make_scratch(self) -> _Scratch:
        return _Scratch(
            col_of_ent=np.full(self.meta.entities_size, PAD_COL, dtype=np.int32),
            first_pos=np.full(self.meta.entities_size, -1, dtype=np.int64),
            rng=self.rng,
        )

    def __len__(self) -> int:
        n, b = len(self.rec), self.batch_size
        if self.host_shard is not None:
            rank, ranks = self.host_shard
            n = len(range(rank, n, ranks))
        return n // b if self.drop_last else -(-n // b)

    def batches(
        self, shuffle: bool = False, prefetch: int = 0, transform=None, workers: int = 1
    ) -> Iterator:
        """Iterate ``transform(batch)`` in order.  ``prefetch > 0`` builds on
        background threads so host work overlaps device steps; ``workers >
        1`` builds batches concurrently, each drawing its negatives from its
        own generator seeded by (builder seed, epoch, batch ordinal), so the
        result is reproducible but differs from the one-stream order."""
        order = np.arange(len(self.rec))
        if shuffle:
            self.rng.shuffle(order)
        if self.host_shard is not None:
            rank, ranks = self.host_shard
            order = order[rank::ranks]
        b = self.batch_size
        limit = (len(order) // b) * b if self.drop_last else len(order)
        starts = range(0, limit, b)
        if transform is None:
            transform = lambda batch: batch  # noqa: E731
        if prefetch <= 0:
            for start in starts:
                yield transform(self.build(order[start : start + b]))
            return
        if workers <= 1:
            yield from self._one_worker(order, starts, transform, prefetch)
            return
        yield from self._many_workers(order, starts, transform, prefetch, workers)

    def _one_worker(self, order, starts, transform, prefetch):
        b = self.batch_size
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            try:
                for start in starts:
                    if stop.is_set():
                        return
                    q.put(transform(self.build(order[start : start + b])))
            except BaseException as e:  # surfaced to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # let the worker finish its last put
                q.get_nowait()

    def _many_workers(self, order, starts, transform, prefetch, workers):
        b = self.batch_size
        self._epoch_counter += 1
        epoch = self._epoch_counter
        tasks: "queue.Queue" = queue.Queue()
        for item in enumerate(starts):
            tasks.put(item)
        done: dict = {}
        cond = threading.Condition()
        budget = threading.Semaphore(max(prefetch, workers))
        stop = threading.Event()

        def worker():
            scratch = self._make_scratch()
            while not stop.is_set():
                budget.acquire()
                try:
                    i, start = tasks.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    scratch.rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, i]))
                    item = transform(self.build(order[start : start + b], scratch=scratch))
                except BaseException as e:  # surfaced to the consumer in order
                    item = e
                with cond:
                    done[i] = item
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(workers)]
        for t in threads:
            t.start()
        try:
            for next_out in range(len(starts)):
                with cond:
                    while next_out not in done:
                        cond.wait()
                    item = done.pop(next_out)
                budget.release()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            for _ in threads:  # unblock workers parked on the budget
                budget.release()

    # ------------------------------------------------------------------ core

    def build(self, item_ids: Sequence[int], scratch: Optional[_Scratch] = None) -> Batch:
        """The batch of ``item_ids`` (the ``batch.build`` span)."""
        with span("batch.build"):
            return self._build(item_ids, scratch)

    def _build(self, item_ids: Sequence[int], scratch: Optional[_Scratch]) -> Batch:
        if scratch is None:
            if self._scratch is None:
                self._scratch = self._make_scratch()
            scratch = self._scratch
            scratch.rng = self.rng  # one sequential stream without workers
        rec = self.rec
        item_ids = np.asarray(item_ids)
        item_ids = np.concatenate(
            [item_ids[rec.slot[item_ids] == SLOT_PO], item_ids[rec.slot[item_ids] == SLOT_SP]]
        )
        n_rows = len(item_ids)
        B = self.batch_size
        is_sp_rows = rec.slot[item_ids] == SLOT_SP
        # sp rows store (subj, rel) in (p1, p2); po rows (rel, obj)
        ent_ids = np.zeros(B, dtype=np.int32)
        rel_ids = np.zeros(B, dtype=np.int32)
        is_sp = np.zeros(B, dtype=bool)
        row_valid = np.zeros(B, dtype=bool)
        ent_ids[:n_rows] = np.where(is_sp_rows, rec.p1[item_ids], rec.p2[item_ids])
        rel_ids[:n_rows] = np.where(is_sp_rows, rec.p2[item_ids], rec.p1[item_ids])
        is_sp[:n_rows] = is_sp_rows
        row_valid[:n_rows] = True

        # each row's positive mention ids: one ragged gather
        gs = rec.group_offsets[item_ids]
        ge = rec.group_offsets[item_ids + 1]
        ms = rec.mention_offsets[gs]
        lens = (rec.mention_offsets[ge] - ms).astype(np.int64)
        idx = np.repeat(ms - (np.cumsum(lens) - lens), lens) + np.arange(int(lens.sum()), dtype=np.int64)
        ment_flat = rec.mentions[idx]
        row_dup = None if rec.row_has_dup is None else rec.row_has_dup[item_ids]
        rows = (ent_ids, rel_ids, is_sp, row_valid, n_rows)
        if self.ds.use_batch_shared_entities:
            return self._build_batch_shared(item_ids, ment_flat, lens, row_dup, rows, scratch)
        return self._build_full_vocab(item_ids, ment_flat, lens, row_dup, rows)

    def _build_full_vocab(self, item_ids, ment_flat, lens, row_dup, rows) -> Batch:
        ent_ids, rel_ids, is_sp, row_valid, n_rows = rows
        off = self.cand_offset
        pos_rows, pos_cols = self._pack_positives(ment_flat, lens, lambda m: m - off, row_dup)
        batch = Batch(
            ent_ids=ent_ids, rel_ids=rel_ids, is_sp=is_sp, row_valid=row_valid, num_rows=n_rows,
            candidate_ids=None, col_valid=None, num_cols=self.full_num_cols, cand_offset=off,
            pos_rows=pos_rows, pos_cols=pos_cols,
            normalizer_loss=float(n_rows) * float(self.full_num_cols),
        )
        if not self.ds.is_training_data:
            self._attach_eval(batch, item_ids, lambda m: m.astype(np.int32) - off)
        return batch

    def _build_batch_shared(self, item_ids, ment_flat, lens, row_dup, rows, scratch) -> Batch:
        ent_ids, rel_ids, is_sp, row_valid, n_rows = rows
        if self.ds.is_training_data:
            pool = ment_flat
        else:  # eval: the answers of every split, so that every known-true cell can be filtered
            parts = [self.rec.row_filter(i) for i in item_ids]
            pool = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        shared = self._first_seen_unique(pool, scratch.first_pos)
        min_size = self.ds.min_size_batch_labels
        if min_size is None or min_size < 0:
            min_size = 0
        if len(shared) >= min_size:
            cand_real = shared
        else:
            # uniform negatives without replacement (numpy's Floyd sampling)
            neg = scratch.rng.choice(
                self.meta.entities_size - self.cand_offset, size=min_size, replace=False
            ).astype(np.int32) + self.cand_offset
            neg = neg[~np.isin(neg, shared, assume_unique=False)]
            cand_real = np.concatenate([shared, neg])[:min_size]
        N_real = len(cand_real)
        N_pad = next_bucket(N_real, minimum=256)
        candidate_ids = np.zeros(N_pad, dtype=np.int32)
        candidate_ids[:N_real] = cand_real
        col_valid = np.zeros(N_pad, dtype=bool)
        col_valid[:N_real] = True

        lut = scratch.col_of_ent  # entity id -> column, reset below
        lut[cand_real] = np.arange(N_real, dtype=np.int32)
        pos_rows, pos_cols = self._pack_positives(ment_flat, lens, lambda m: lut[m], row_dup)
        batch = Batch(
            ent_ids=ent_ids, rel_ids=rel_ids, is_sp=is_sp, row_valid=row_valid, num_rows=n_rows,
            candidate_ids=candidate_ids, col_valid=col_valid, num_cols=N_real,
            cand_offset=self.cand_offset, pos_rows=pos_rows, pos_cols=pos_cols,
            normalizer_loss=float(n_rows) * float(N_real),
        )
        if not self.ds.is_training_data:
            self._attach_eval(batch, item_ids, lambda m: lut[m])
        lut[cand_real] = PAD_COL
        return batch

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _first_seen_unique(pool: np.ndarray, lut: np.ndarray) -> np.ndarray:
        """``np.unique`` in first-seen order, O(n) through a reusable lookup
        buffer (reset before returning)."""
        n = len(pool)
        if n == 0:
            return pool
        # reversed assignment: the last write per id wins, which is its first occurrence
        lut[pool[::-1]] = np.arange(n - 1, -1, -1, dtype=lut.dtype)
        out = pool[lut[pool] == np.arange(n, dtype=lut.dtype)]
        lut[pool] = -1
        return out

    def _pack_positives(self, ment_flat, lens, translate, row_dup) -> Tuple[np.ndarray, np.ndarray]:
        total = len(ment_flat)
        rows = cols = None
        if total:
            rows = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
            cols = translate(ment_flat.astype(np.int64)).astype(np.int32)
            # dedup (row, col) pairs, only among the rows flagged at index
            # build: distinct mentions always map to distinct columns
            pos_flag = np.ones(total, dtype=bool) if row_dup is None else np.repeat(row_dup, lens)
            if pos_flag.any():
                sub = np.flatnonzero(pos_flag)
                pair = rows[sub].astype(np.int64) << 32 | (cols[sub].astype(np.int64) & 0xFFFFFFFF)
                keep_sub = sub[np.unique(pair, return_index=True)[1]]
                if len(keep_sub) != len(sub):
                    keep = np.concatenate([np.flatnonzero(~pos_flag), keep_sub])
                    keep.sort()
                    rows, cols = rows[keep], cols[keep]
                    total = len(keep)
        P = next_bucket(total, minimum=self.pos_bucket_min)
        pos_rows = np.full(P, PAD_COL, dtype=np.int32)
        pos_cols = np.full(P, PAD_COL, dtype=np.int32)
        if total:
            pos_rows[:total] = rows
            pos_cols[:total] = cols
        return pos_rows, pos_cols

    def _attach_eval(self, batch: Batch, item_ids, translate) -> None:
        """The eval fields: each row's filter cells (unique (row, col) pairs,
        asserted: a duplicate would double-correct the ranking), and one gold
        row per (prefix, gold entity) with its mention alternatives' columns."""
        rec = self.rec
        if rec.filter_offsets is None:
            raise ValueError("eval batches need a filter index: call dataset.attach_filter_index(...) first")
        filt_parts = [rec.row_filter(i) for i in item_ids]
        flens = np.array([len(f) for f in filt_parts], dtype=np.int64)
        ftotal = int(flens.sum())
        F = next_bucket(ftotal, minimum=self.pos_bucket_min)
        filter_rows = np.full(F, PAD_COL, dtype=np.int32)
        filter_cols = np.full(F, PAD_COL, dtype=np.int32)
        if ftotal:
            filter_rows[:ftotal] = np.repeat(np.arange(len(item_ids), dtype=np.int32), flens)
            filter_cols[:ftotal] = translate(np.concatenate(filt_parts).astype(np.int64)).astype(np.int32)
            valid = filter_cols[:ftotal] >= 0
            packed = (filter_rows[:ftotal][valid].astype(np.int64) << 32
                      | (filter_cols[:ftotal][valid].astype(np.int64) & 0xFFFFFFFF))
            assert len(np.unique(packed)) == len(packed), (
                "duplicate (row, col) filter pairs would double-correct the sparse filtered ranking")

        g_rows: List[int] = []
        g_ments: List[np.ndarray] = []
        for bi, i in enumerate(item_ids):
            for g in range(rec.group_offsets[i], rec.group_offsets[i + 1]):
                g_rows.append(bi)
                g_ments.append(rec.mentions[rec.mention_offsets[g] : rec.mention_offsets[g + 1]])
        A = next_bucket(max((len(m) for m in g_ments), default=1), minimum=1)
        G = next_bucket(len(g_rows), minimum=self.pos_bucket_min)
        gold_rows = np.full(G, PAD_COL, dtype=np.int32)
        gold_mention_cols = np.full((G, A), PAD_COL, dtype=np.int32)
        for gi, (r, m) in enumerate(zip(g_rows, g_ments)):
            gold_rows[gi] = r
            gold_mention_cols[gi, : len(m)] = translate(m.astype(np.int64)).astype(np.int32)
        batch.filter_rows, batch.filter_cols = filter_rows, filter_cols
        batch.gold_rows, batch.gold_mention_cols = gold_rows, gold_mention_cols
