"""Mapped-to-ids datasets: vocabulary metadata and training prefix records.

Counterpart of ``open_knowledge_graph_embeddings_tpu/data/dataset.py``:

* the metadata half: the id maps and the dense [num_items, max_len]
  token-id matrices the token encoders read;
* the split half: the 5-column triple reader (its Python branch; the
  JAX package's native parser is pinned to it by its own tests), the 1-vs-N
  prefix records of both directions, :class:`OneToNMentionRelationDataset`
  for a training or an eval split, and an eval split's all-splits filter
  index (:meth:`OneToNMentionRelationDataset.attach_filter_index`).

Every cache is the same npz under the same key in ``<dataset>/.oket_cache/``,
so either package can read what the other wrote.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from open_knowledge_graph_embeddings_tpu_torch.data.vocab import BOS, EOS, PAD, UNK

SLOT_PO = 0  # prefix = (rel, obj), predict subject
SLOT_SP = 2  # prefix = (subj, rel), predict object

_CACHE_VERSION = 4


@dataclass
class DatasetMeta:
    """Static vocabulary metadata shared by datasets and models."""

    entities_size: int
    relations_size: int
    min_entities_size: int  # first real entity id (PAD/UNK excluded)
    min_relations_size: int
    entity_tokens_size: int
    relation_tokens_size: int
    max_length: Tuple[int, int]
    entity_token_ids: Optional[np.ndarray] = None  # [entities_size, max_length[0]] int32
    relation_token_ids: Optional[np.ndarray] = None  # [relations_size, max_length[1]] int32
    entity_id_counts: Optional[np.ndarray] = None
    relation_id_counts: Optional[np.ndarray] = None

    @property
    def num_candidate_entities(self) -> int:
        return self.entities_size - self.min_entities_size


def _token_matrix(id_to_tokens: Dict[int, List[int]], size: int, max_len: int) -> np.ndarray:
    """Dense [size, max_len] token-id matrix keeping the LAST max_len tokens."""
    mat = np.zeros((size, max_len), dtype=np.int32)
    for iid, toks in id_to_tokens.items():
        toks = toks[-max_len:]
        mat[iid, : len(toks)] = toks
    return mat


def _read_id_map(path: str) -> Tuple[Dict[str, int], Dict[int, int], int]:
    text_to_id: Dict[str, int] = {}
    id_counts: Dict[int, int] = {}
    max_id = -1
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f):
            if ln == 0 and line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            text, iid, count = parts[0], int(parts[1]), int(parts[2])
            text_to_id[text] = iid
            id_counts[iid] = count
            max_id = max(max_id, iid)
    return text_to_id, id_counts, max_id


def _read_id_tokens_map(path: str) -> Tuple[Dict[int, List[int]], int]:
    id_to_tokens: Dict[int, List[int]] = {}
    max_tok = -1
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f):
            if ln == 0 and line.startswith("#"):
                continue
            iid_s, toks_s = line.rstrip("\n").split("\t")
            toks = [int(t) for t in toks_s.split()]
            id_to_tokens[int(iid_s)] = toks
            max_tok = max(max_tok, max(toks))
    return id_to_tokens, max_tok


def load_meta(
    dataset_dir: str,
    max_lengths_tuple: Tuple[int, int] = (10, 10),
    cache_dir: Optional[str] = None,
) -> DatasetMeta:
    """Load vocabulary metadata from a mapped-to-ids directory (cached)."""
    cache_dir = _resolve_cache_dir(dataset_dir, cache_dir)
    key = f"meta-v{_CACHE_VERSION}-{max_lengths_tuple[0]}-{max_lengths_tuple[1]}"
    cache_path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(cache_path):
        with np.load(cache_path, allow_pickle=False) as z:
            opt = lambda k: z[k] if k in z else None  # noqa: E731
            return DatasetMeta(
                entities_size=int(z["entities_size"]),
                relations_size=int(z["relations_size"]),
                min_entities_size=int(z["min_entities_size"]),
                min_relations_size=int(z["min_relations_size"]),
                entity_tokens_size=int(z["entity_tokens_size"]),
                relation_tokens_size=int(z["relation_tokens_size"]),
                max_length=tuple(int(x) for x in z["max_length"]),
                entity_token_ids=opt("entity_token_ids"),
                relation_token_ids=opt("relation_token_ids"),
                entity_id_counts=opt("entity_id_counts"),
                relation_id_counts=opt("relation_id_counts"),
            )

    _, ent_counts, ent_max = _read_id_map(os.path.join(dataset_dir, "entity_id_map.txt"))
    _, rel_counts, rel_max = _read_id_map(os.path.join(dataset_dir, "relation_id_map.txt"))
    entities_size = ent_max + 1
    relations_size = rel_max + 1
    # first real ids follow PAD=0 / UNK=1
    min_entities_size = max(PAD, UNK) + 1
    min_relations_size = max(PAD, UNK) + 1

    entity_token_ids = relation_token_ids = None
    entity_tokens_size = relation_tokens_size = max(PAD, UNK, BOS, EOS) + 1
    ent_tok_path = os.path.join(dataset_dir, "entity_id_tokens_ids_map.txt")
    if os.path.exists(ent_tok_path):
        ent_map, ent_tok_max = _read_id_tokens_map(ent_tok_path)
        for sid in range(min_entities_size):
            ent_map.setdefault(sid, [UNK])
        entity_tokens_size = ent_tok_max + 1
        entity_token_ids = _token_matrix(ent_map, entities_size, max_lengths_tuple[0])
    rel_tok_path = os.path.join(dataset_dir, "relation_id_tokens_ids_map.txt")
    if os.path.exists(rel_tok_path):
        rel_map, rel_tok_max = _read_id_tokens_map(rel_tok_path)
        for sid in range(min_relations_size):
            rel_map.setdefault(sid, [UNK])
        relation_tokens_size = rel_tok_max + 1
        relation_token_ids = _token_matrix(rel_map, relations_size, max_lengths_tuple[1])

    ent_count_arr = np.zeros(entities_size, dtype=np.int64)
    for iid, c in ent_counts.items():
        ent_count_arr[iid] = c
    rel_count_arr = np.zeros(relations_size, dtype=np.int64)
    for iid, c in rel_counts.items():
        rel_count_arr[iid] = c

    meta = DatasetMeta(
        entities_size=entities_size,
        relations_size=relations_size,
        min_entities_size=min_entities_size,
        min_relations_size=min_relations_size,
        entity_tokens_size=entity_tokens_size,
        relation_tokens_size=relation_tokens_size,
        max_length=tuple(max_lengths_tuple),
        entity_token_ids=entity_token_ids,
        relation_token_ids=relation_token_ids,
        entity_id_counts=ent_count_arr,
        relation_id_counts=rel_count_arr,
    )
    arrays = dict(
        entities_size=entities_size,
        relations_size=relations_size,
        min_entities_size=min_entities_size,
        min_relations_size=min_relations_size,
        entity_tokens_size=entity_tokens_size,
        relation_tokens_size=relation_tokens_size,
        max_length=np.array(max_lengths_tuple),
        entity_id_counts=ent_count_arr,
        relation_id_counts=rel_count_arr,
    )
    if entity_token_ids is not None:
        arrays["entity_token_ids"] = entity_token_ids
    if relation_token_ids is not None:
        arrays["relation_token_ids"] = relation_token_ids
    _atomic_savez(cache_path, **arrays)
    return meta


def _resolve_cache_dir(dataset_dir: str, cache_dir: Optional[str]) -> str:
    if cache_dir is None:
        if os.access(dataset_dir, os.W_OK):
            cache_dir = os.path.join(dataset_dir, ".oket_cache")
        else:
            digest = hashlib.sha1(os.path.abspath(dataset_dir).encode()).hexdigest()[:12]
            cache_dir = os.path.join(
                os.environ.get("OKET_CACHE_DIR", os.path.expanduser("~/.cache/oket")), digest
            )
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


def _atomic_savez(path: str, **arrays) -> None:
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


# ----------------------------------------------------------- triple file I/O


def read_triple_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Parse a 5-column mapped file: ``subj rel obj subj_mentions
    obj_mentions`` (TAB-separated, mentions space-separated).

    Returns (triples [T, 3] int32, subj_offsets [T+1], subj_mentions,
    obj_offsets [T+1], obj_mentions): the mention columns in CSR form.
    Empty or missing mention columns fall back to columns 1 / 3."""
    triples: List[Tuple[int, int, int]] = []
    subj_offs = [0]
    obj_offs = [0]
    subj_vals: List[int] = []
    obj_vals: List[int] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s, r, o = int(parts[0]), int(parts[1]), int(parts[2])
            triples.append((s, r, o))
            s_m = [int(x) for x in parts[3].split()] if len(parts) >= 5 else []
            o_m = [int(x) for x in parts[4].split()] if len(parts) >= 5 else []
            subj_vals.extend(s_m if s_m else [s])
            obj_vals.extend(o_m if o_m else [o])
            subj_offs.append(len(subj_vals))
            obj_offs.append(len(obj_vals))
    return (
        np.asarray(triples, dtype=np.int32).reshape(-1, 3),
        np.asarray(subj_offs, dtype=np.int64),
        np.asarray(subj_vals, dtype=np.int32),
        np.asarray(obj_offs, dtype=np.int64),
        np.asarray(obj_vals, dtype=np.int32),
    )


# ------------------------------------------------------------ prefix records


@dataclass
class PrefixRecords:
    """CSR store of 1-vs-N prefix examples for one split (both directions).

    Row i: prefix ``(p1[i], p2[i])`` with slot[i] in {SLOT_PO, SLOT_SP}; its
    gold answers are groups ``group_offsets[i]..group_offsets[i+1]``, and
    group g covers mention ids ``mentions[mention_offsets[g]:mention_offsets[g+1]]``
    (one group per triple line: the mention alternatives of one gold
    entity).  ``row_has_dup[i]``: the example holds one mention twice
    across its groups (None: unknown, treated as maybe).  An eval split's
    ``filter_offsets``/``filter_values`` hold each row's known-true mention
    ids over all splits, for filtered ranking."""

    p1: np.ndarray  # [P] int32
    p2: np.ndarray  # [P] int32
    slot: np.ndarray  # [P] int8
    group_offsets: np.ndarray  # [P+1] int64
    mention_offsets: np.ndarray  # [G+1] int64
    mentions: np.ndarray  # [M] int32
    filter_offsets: Optional[np.ndarray] = None  # [P+1] int64
    filter_values: Optional[np.ndarray] = None  # [F] int32
    row_has_dup: Optional[np.ndarray] = None  # [P] bool

    def __len__(self) -> int:
        return len(self.p1)

    @property
    def num_positives(self) -> int:
        return int(self.mention_offsets[-1])

    def row_groups(self, i: int) -> List[List[int]]:
        gs, ge = self.group_offsets[i], self.group_offsets[i + 1]
        return [self.mentions[self.mention_offsets[g] : self.mention_offsets[g + 1]].tolist() for g in range(gs, ge)]

    def row_mentions(self, i: int) -> np.ndarray:
        gs, ge = self.group_offsets[i], self.group_offsets[i + 1]
        return self.mentions[self.mention_offsets[gs] : self.mention_offsets[ge]]

    def row_filter(self, i: int) -> np.ndarray:
        return self.filter_values[self.filter_offsets[i] : self.filter_offsets[i + 1]]


def _group_direction(
    triples: np.ndarray, ans_offsets: np.ndarray, ans_values: np.ndarray,
    pref_cols: Tuple[int, int], slot: int,
) -> dict:
    """Group triples by their ``pref_cols`` prefix (lexsort, then segment);
    each line is one answer group."""
    t = triples
    order = np.lexsort((t[:, pref_cols[1]], t[:, pref_cols[0]]))
    p1 = t[order, pref_cols[0]]
    p2 = t[order, pref_cols[1]]
    new_prefix = np.ones(len(order), dtype=bool)
    if len(order) > 1:
        new_prefix[1:] = (p1[1:] != p1[:-1]) | (p2[1:] != p2[:-1])
    prefix_starts = np.flatnonzero(new_prefix)
    group_counts = np.diff(np.append(prefix_starts, len(order)))

    lens = (ans_offsets[1:] - ans_offsets[:-1])[order]
    mention_offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(lens, out=mention_offsets[1:])
    starts = ans_offsets[:-1][order]
    idx = np.repeat(starts, lens) + (np.arange(mention_offsets[-1]) - np.repeat(mention_offsets[:-1], lens))
    group_offsets = np.zeros(len(prefix_starts) + 1, dtype=np.int64)
    np.cumsum(group_counts, out=group_offsets[1:])
    return dict(
        p1=p1[prefix_starts].astype(np.int32),
        p2=p2[prefix_starts].astype(np.int32),
        slot=np.full(len(prefix_starts), slot, dtype=np.int8),
        group_offsets=group_offsets,
        mention_offsets=mention_offsets,
        mentions=ans_values[idx.astype(np.int64)].astype(np.int32),
    )


def _concat_directions(sp: dict, po: dict) -> PrefixRecords:
    """sp_o records first, then po_s (the reference's file layout)."""

    def cat_offsets(key):
        return np.concatenate([sp[key], sp[key][-1] + po[key][1:]])

    return PrefixRecords(
        p1=np.concatenate([sp["p1"], po["p1"]]),
        p2=np.concatenate([sp["p2"], po["p2"]]),
        slot=np.concatenate([sp["slot"], po["slot"]]),
        group_offsets=cat_offsets("group_offsets"),
        mention_offsets=cat_offsets("mention_offsets"),
        mentions=np.concatenate([sp["mentions"], po["mentions"]]),
    )


def _compute_dup_flags(rec: PrefixRecords) -> np.ndarray:
    """[P] bool: the example has one mention in more than one position
    across its groups (one vectorized sort, cached with the records)."""
    P = len(rec)
    row_lens = (
        rec.mention_offsets[rec.group_offsets[1:]] - rec.mention_offsets[rec.group_offsets[:-1]]
    ).astype(np.int64)
    flags = np.zeros(P, dtype=bool)
    if rec.mentions.size == 0:
        return flags
    ex = np.repeat(np.arange(P, dtype=np.int64), row_lens)
    stride = np.int64(rec.mentions.max(initial=0)) + 1
    key = np.sort(ex * stride + rec.mentions)
    dup = key[1:][key[1:] == key[:-1]]
    if dup.size:
        flags[np.unique(dup // stride)] = True
    return flags


def _split_large_prefixes(rec: PrefixRecords, max_groups: int) -> PrefixRecords:
    """Split training prefixes with more than ``max_groups`` answer groups
    into repeated examples of at most ``max_groups`` groups each
    (``max_size_prefix_label``).  The chunks tile each prefix's groups in
    order, so the mentions and their offsets are unchanged."""
    if max_groups is None or max_groups <= 1:
        return rec
    counts = np.diff(rec.group_offsets)
    if counts.max(initial=0) <= max_groups:
        return rec
    reps = (-(-counts // max_groups)).astype(np.int64)  # 0-group prefixes drop
    rep_counts = np.repeat(counts, reps)
    first = np.repeat(np.cumsum(reps) - reps, reps)
    idx_in_prefix = np.arange(int(reps.sum()), dtype=np.int64) - first
    sizes = np.minimum(max_groups, rep_counts - idx_in_prefix * max_groups)
    goff = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=goff[1:])
    return PrefixRecords(
        p1=np.repeat(rec.p1, reps),
        p2=np.repeat(rec.p2, reps),
        slot=np.repeat(rec.slot, reps),
        group_offsets=goff,
        mention_offsets=np.asarray(rec.mention_offsets, dtype=np.int64) - rec.mention_offsets[0],
        mentions=np.asarray(rec.mentions),
    )


# ------------------------------------------------------------------- dataset


class OneToNMentionRelationDataset:
    """1-vs-N prefix dataset over mention-annotated triples; the batches are
    built by :class:`..data.batching.BatchBuilder`.  The config keys of the
    JAX class are accepted.  An eval split (``is_training_data=False``)
    keeps every prefix whole (no ``max_size_prefix_label`` split) and needs
    :meth:`attach_filter_index` before its batches are built."""

    def __init__(
        self,
        dataset_dir: str,
        input_file: str,
        is_training_data: bool,
        batch_size: int = 512,
        use_batch_shared_entities: bool = False,
        min_size_batch_labels: int = -1,
        max_size_prefix_label: int = -1,
        max_lengths_tuple: Tuple[int, int] = (10, 10),
        loss: str = "bce",
        cache_dir: Optional[str] = None,
        batch_size_for_backward: Optional[int] = None,
        replace_entities_by_tokens: bool = False,
        replace_relations_by_tokens: bool = False,
        copy_data_to_dev_shm: bool = False,
    ):
        if copy_data_to_dev_shm:
            raise NotImplementedError("copy_data_to_dev_shm is not ported: ROADMAP Queue 1 item 1")
        self.dataset_dir = dataset_dir
        self.input_file_name = input_file
        self.is_training_data = is_training_data
        self.batch_size = batch_size
        self.batch_size_for_backward = batch_size_for_backward
        self.use_batch_shared_entities = use_batch_shared_entities
        self.min_size_batch_labels = min_size_batch_labels
        self.max_size_prefix_label = max_size_prefix_label
        self.loss = loss
        self.cache_dir = _resolve_cache_dir(dataset_dir, cache_dir)
        self.meta = load_meta(dataset_dir, max_lengths_tuple, cache_dir=self.cache_dir)
        self.records = self._build_records()

    def _records_cache_path(self) -> str:
        split = self.max_size_prefix_label if self.is_training_data else "eval"
        key = f"records-v{_CACHE_VERSION}-{self.input_file_name}-{split}"
        return os.path.join(self.cache_dir, key + ".npz")

    def _build_records(self) -> PrefixRecords:
        path = self._records_cache_path()
        if os.path.exists(path):
            with np.load(path) as z:
                return PrefixRecords(
                    p1=z["p1"], p2=z["p2"], slot=z["slot"],
                    group_offsets=z["group_offsets"], mention_offsets=z["mention_offsets"],
                    mentions=z["mentions"],
                    row_has_dup=z["row_has_dup"] if "row_has_dup" in z.files else None,
                )
        triples, s_off, s_val, o_off, o_val = read_triple_file(
            os.path.join(self.dataset_dir, self.input_file_name)
        )
        sp = _group_direction(triples, o_off, o_val, (0, 1), SLOT_SP)
        po = _group_direction(triples, s_off, s_val, (1, 2), SLOT_PO)
        rec = _concat_directions(sp, po)
        if self.is_training_data:
            rec = _split_large_prefixes(rec, self.max_size_prefix_label)
        rec.row_has_dup = _compute_dup_flags(rec)
        _atomic_savez(
            path,
            p1=rec.p1, p2=rec.p2, slot=rec.slot,
            group_offsets=rec.group_offsets, mention_offsets=rec.mention_offsets,
            mentions=rec.mentions, row_has_dup=rec.row_has_dup,
        )
        return rec

    def __len__(self) -> int:
        return len(self.records)

    def attach_filter_index(self, train_file: str, valid_file: str, test_file: str) -> None:
        """Attach each row's known-true mention ids over all three splits
        (a split that is absent or unnamed is skipped) for filtered ranking.  Each
        row's set is built as a Python set, so its pairs are unique, in the
        JAX package's order; the cache is the JAX package's npz."""
        key = f"filter-v{_CACHE_VERSION}-{self.input_file_name}-{train_file}-{valid_file}-{test_file}"
        path = os.path.join(self.cache_dir, key + ".npz")
        rec = self.records
        if os.path.exists(path):
            with np.load(path) as z:
                rec.filter_offsets, rec.filter_values = z["filter_offsets"], z["filter_values"]
            return
        union: Dict[Tuple[int, int, int], set] = {}
        for fname in (train_file, valid_file, test_file):
            fpath = os.path.join(self.dataset_dir, fname)
            if not fname or not os.path.isfile(fpath):
                continue
            triples, s_off, s_val, o_off, o_val = read_triple_file(fpath)
            for i in range(len(triples)):
                s, r, o = (int(x) for x in triples[i])
                union.setdefault((s, r, SLOT_SP), set()).update(o_val[o_off[i] : o_off[i + 1]].tolist())
                union.setdefault((r, o, SLOT_PO), set()).update(s_val[s_off[i] : s_off[i + 1]].tolist())
        offsets = np.zeros(len(rec) + 1, dtype=np.int64)
        chunks = []
        for i in range(len(rec)):
            ents = union.get((int(rec.p1[i]), int(rec.p2[i]), int(rec.slot[i])), set())
            chunks.append(np.fromiter(ents, dtype=np.int32, count=len(ents)))
            offsets[i + 1] = offsets[i] + len(ents)
        values = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)
        rec.filter_offsets, rec.filter_values = offsets, values
        _atomic_savez(path, filter_offsets=offsets, filter_values=values)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(file={self.input_file_name}, prefixes={len(self)}, "
            f"positives={self.records.num_positives}, entities={self.meta.entities_size}, "
            f"relations={self.meta.relations_size}, batch_shared={self.use_batch_shared_entities})"
        )
