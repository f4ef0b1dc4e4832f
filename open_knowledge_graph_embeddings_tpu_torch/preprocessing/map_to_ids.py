"""Text -> id mapping of benchmark datasets (capabilities P9/P10; the port's
copy of ``open_knowledge_graph_embeddings_tpu/preprocessing/map_to_ids.py``,
writing the same files byte for byte).

Produces the ``mapped_to_ids`` on-disk contract consumed by the data layer
(see data/dataset.py): 5-col id files plus ``entity_id_map.txt``,
``entity_id_tokens_ids_map.txt``, ``entity_token_id_map.txt`` and relation
analogues.

* :func:`convert_open_dataset` — OLP datasets with ``|||``-separated
  alternative mentions in columns 4/5
  (reference: utils/map_open_dataset_to_ids.py:161-305): mention and token
  vocabularies are built from the training split (mention vocabulary also
  collects the other splits so eval mentions are rankable), converted
  mentions whose token sequence is more than ``max_unk_fraction`` UNK are
  treated as unknown, and triples with an unknown slot are dropped
  (reference :269-270),
* :func:`convert_closed_dataset` — closed KGs (FB15k-237): entities carry
  token sequences from a names file, relations tokenize on ``/ . _``
  (reference: data/fb15k237/prepare_fb237.py:12-20), and columns 4/5
  duplicate columns 1/3 (reference: utils/map_dataset_to_ids.py:17).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from open_knowledge_graph_embeddings_tpu_torch.data.vocab import BOS, EOS, UNK, IndexMapper

logger = logging.getLogger(__name__)


def _read_5col_text(path: str) -> List[Tuple[str, str, str, List[str], List[str]]]:
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s, r, o = parts[0], parts[1], parts[2]
            s_alts = parts[3].split("|||") if len(parts) > 3 and parts[3] else [s]
            o_alts = parts[4].split("|||") if len(parts) > 4 and parts[4] else [o]
            rows.append((s, r, o, s_alts, o_alts))
    return rows


def _too_many_unks(token_ids: Sequence[int], max_unk_fraction: float) -> bool:
    body = [t for t in token_ids if t not in (BOS, EOS)]
    if not body:
        return True
    return sum(1 for t in body if t == UNK) / len(body) > max_unk_fraction


def convert_open_dataset(
    out_dir: str,
    train_file: str,
    other_files: Sequence[str],
    min_count: int = 1,
    max_unk_fraction: float = 2.0 / 3.0,
) -> Dict[str, int]:
    """Map an open-KG text dataset to ids.  ``train_file`` builds the token
    vocabularies; mention vocabularies also collect ``other_files``.
    Writes ``<basename of input>`` id files into ``out_dir``.
    Returns counts of written triples per file."""
    os.makedirs(out_dir, exist_ok=True)
    entity_mapper = IndexMapper(segment=True, min_count=min_count)
    relation_mapper = IndexMapper(segment=True, min_count=min_count)

    train_rows = _read_5col_text(train_file)
    for s, r, o, s_alts, o_alts in train_rows:
        for m in {s, o, *s_alts, *o_alts}:
            entity_mapper.collect(m)
        relation_mapper.collect(r)
    # mention vocab also collects eval splits (tokens only from train):
    # freeze segment counts by snapshotting before the eval sweep
    train_segment_counts = dict(entity_mapper.segment_counts)
    train_rel_segment_counts = dict(relation_mapper.segment_counts)
    other_rows = {p: _read_5col_text(p) for p in other_files}
    for rows in other_rows.values():
        for s, r, o, s_alts, o_alts in rows:
            for m in {s, o, *s_alts, *o_alts}:
                entity_mapper.collect(m)
            relation_mapper.collect(r)
    entity_mapper.segment_counts.clear()
    entity_mapper.segment_counts.update(train_segment_counts)
    relation_mapper.segment_counts.clear()
    relation_mapper.segment_counts.update(train_rel_segment_counts)

    entity_mapper.finalize()
    relation_mapper.finalize()
    entity_mapper.save(out_dir, "entity")
    relation_mapper.save(out_dir, "relation")

    def convert_mention(mapper: IndexMapper, text: str) -> int:
        iid, toks = mapper.toidx(text)
        if iid == UNK or _too_many_unks(toks, max_unk_fraction):
            return UNK
        return iid

    written: Dict[str, int] = {}
    for path, rows in [(train_file, train_rows)] + list(other_rows.items()):
        out_path = os.path.join(out_dir, os.path.basename(path))
        n = 0
        with open(out_path, "w", encoding="utf-8") as f:
            for s, r, o, s_alts, o_alts in rows:
                sid = convert_mention(entity_mapper, s)
                rid = convert_mention(relation_mapper, r)
                oid = convert_mention(entity_mapper, o)
                if UNK in (sid, rid, oid):
                    continue
                s_ids = sorted({convert_mention(entity_mapper, m) for m in s_alts} - {UNK} | {sid})
                o_ids = sorted({convert_mention(entity_mapper, m) for m in o_alts} - {UNK} | {oid})
                f.write(
                    f"{sid}\t{rid}\t{oid}\t{' '.join(map(str, s_ids))}\t{' '.join(map(str, o_ids))}\n"
                )
                n += 1
        written[out_path] = n
        logger.info("wrote %s (%d triples)", out_path, n)
    return written


_REL_SPLIT = re.compile(r"[/._]")


def tokenize_closed_relation(relation: str) -> List[str]:
    """FB15k-237 relation text -> tokens by splitting on '/', '.', '_'
    (reference: data/fb15k237/prepare_fb237.py:12-20)."""
    return [t for t in _REL_SPLIT.split(relation) if t]


def convert_closed_dataset(
    out_dir: str,
    split_files: Sequence[str],
    entity_names: Optional[Dict[str, str]] = None,
    min_count: int = 1,
) -> Dict[str, int]:
    """Map a closed-KG dataset (TAB-separated ``s  r  o`` text triples).

    Entity token sequences come from ``entity_names`` (e.g. mid2name);
    entities without a name tokenize to their own identifier.  Columns 4/5
    of the output duplicate columns 1/3."""
    os.makedirs(out_dir, exist_ok=True)
    entity_mapper = IndexMapper(segment=False, min_count=min_count)
    relation_mapper = IndexMapper(segment=False, min_count=min_count)
    entity_token_mapper = IndexMapper(segment=True, min_count=min_count)
    relation_token_mapper = IndexMapper(segment=True, min_count=min_count)

    rows_per_file = {}
    for path in split_files:
        rows = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                rows.append((parts[0], parts[1], parts[2]))
        rows_per_file[path] = rows
        for s, r, o in rows:
            entity_mapper.collect(s)
            entity_mapper.collect(o)
            relation_mapper.collect(r)
            for e in (s, o):
                name = (entity_names or {}).get(e, e)
                entity_token_mapper.collect(name)
            relation_token_mapper.collect(" ".join(tokenize_closed_relation(r)))

    for m in (entity_mapper, relation_mapper, entity_token_mapper, relation_token_mapper):
        m.finalize()

    # id maps (surface form = raw id text, token ids from names)
    with open(os.path.join(out_dir, "entity_id_map.txt"), "w", encoding="utf-8") as f:
        f.write("# token\tid\tcount\t\n")
        for text, iid in entity_mapper.item_to_id.items():
            f.write(f"{text}\t{iid}\t{entity_mapper.item_id_counts[iid]}\n")
    with open(os.path.join(out_dir, "relation_id_map.txt"), "w", encoding="utf-8") as f:
        f.write("# token\tid\tcount\t\n")
        for text, iid in relation_mapper.item_to_id.items():
            f.write(f"{text}\t{iid}\t{relation_mapper.item_id_counts[iid]}\n")
    entity_token_mapper.save(out_dir, "entity_tokens_raw")
    os.replace(
        os.path.join(out_dir, "entity_tokens_raw_token_id_map.txt"),
        os.path.join(out_dir, "entity_token_id_map.txt"),
    )
    for leftover in ("entity_tokens_raw_id_map.txt", "entity_tokens_raw_id_tokens_ids_map.txt"):
        p = os.path.join(out_dir, leftover)
        if os.path.exists(p):
            os.remove(p)
    relation_token_mapper.save(out_dir, "relation_tokens_raw")
    os.replace(
        os.path.join(out_dir, "relation_tokens_raw_token_id_map.txt"),
        os.path.join(out_dir, "relation_token_id_map.txt"),
    )
    for leftover in ("relation_tokens_raw_id_map.txt", "relation_tokens_raw_id_tokens_ids_map.txt"):
        p = os.path.join(out_dir, leftover)
        if os.path.exists(p):
            os.remove(p)

    with open(os.path.join(out_dir, "entity_id_tokens_ids_map.txt"), "w", encoding="utf-8") as f:
        f.write("# entity id\ttokens\t\n")
        for text, iid in entity_mapper.item_to_id.items():
            name = (entity_names or {}).get(text, text)
            _, toks = entity_token_mapper.toidx(name)
            f.write(f"{iid}\t{' '.join(map(str, toks))}\n")
    with open(os.path.join(out_dir, "relation_id_tokens_ids_map.txt"), "w", encoding="utf-8") as f:
        f.write("# relation id\ttokens\t\n")
        for text, iid in relation_mapper.item_to_id.items():
            _, toks = relation_token_mapper.toidx(" ".join(tokenize_closed_relation(text)))
            f.write(f"{iid}\t{' '.join(map(str, toks))}\n")

    written: Dict[str, int] = {}
    for path, rows in rows_per_file.items():
        out_path = os.path.join(out_dir, os.path.basename(path))
        n = 0
        with open(out_path, "w", encoding="utf-8") as f:
            for s, r, o in rows:
                sid = entity_mapper.item_id(s)
                rid = relation_mapper.item_id(r)
                oid = entity_mapper.item_id(o)
                f.write(f"{sid}\t{rid}\t{oid}\t{sid}\t{oid}\n")
                n += 1
        written[out_path] = n
    return written
