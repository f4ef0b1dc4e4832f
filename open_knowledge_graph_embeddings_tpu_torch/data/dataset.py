"""Vocabulary metadata from a mapped-to-ids dataset directory.

Counterpart of the metadata half of
``open_knowledge_graph_embeddings_tpu/data/dataset.py``: the id maps and the
dense [num_items, max_len] token-id matrices the token encoders read.  The
cache is the same npz under the same key in ``<dataset>/.oket_cache/``, so
either package can read what the other wrote.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from open_knowledge_graph_embeddings_tpu_torch.data.vocab import BOS, EOS, PAD, UNK

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
