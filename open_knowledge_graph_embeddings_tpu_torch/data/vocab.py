"""Vocabulary / index mapping: the special ids of the mapped-to-ids contract
and :class:`IndexMapper`, the port's copy of
``open_knowledge_graph_embeddings_tpu/data/vocab.py``.

Text<->id mapping with a surface-form ("mention") vocabulary and a token
("segment") vocabulary, count thresholds, and BOS/EOS insertion (reference:
openkge/index_mapper.py:16-158).  The special ids are PAD=0, UNK=1, BOS=2,
EOS=3 for token vocabularies and PAD=0, UNK=1 for item vocabularies, so
``mapped_to_ids`` datasets written by either package are interchangeable.
"""

from __future__ import annotations

import os
from collections import Counter, OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

PAD = 0
UNK = 1
BOS = 2
EOS = 3

SPECIAL_TOKENS = OrderedDict([("PAD", PAD), ("UNK", UNK)])
SPECIAL_TOKENS_SEGMENT = OrderedDict([("PAD", PAD), ("UNK", UNK), ("BOS", BOS), ("EOS", EOS)])


class IndexMapper:
    """Builds and applies a two-level vocabulary.

    Level 1 ("item"): whole surface forms (entity/relation mentions) -> ids.
    Level 2 ("segment"): whitespace tokens of the surface form -> token ids,
    optionally wrapped in BOS/EOS.

    Typical life cycle: collect(text) over a corpus -> finalize(min_count) ->
    toidx(text) -> save(dir)/load(dir).
    """

    def __init__(
        self,
        segment: bool = True,
        insert_start: Optional[int] = BOS,
        insert_end: Optional[int] = EOS,
        min_count: int = 1,
        max_vocab_size: int = -1,
        lowercase: bool = False,
    ):
        self.segment = segment
        self.insert_start = insert_start
        self.insert_end = insert_end
        self.min_count = min_count
        self.max_vocab_size = max_vocab_size
        self.lowercase = lowercase

        self.item_counts: Counter = Counter()
        self.segment_counts: Counter = Counter()
        self.item_to_id: "OrderedDict[str, int]" = OrderedDict()
        self.segment_to_id: "OrderedDict[str, int]" = OrderedDict()
        self.item_id_counts: Dict[int, int] = {}
        self.segment_id_counts: Dict[int, int] = {}
        self.finalized = False

    # ------------------------------------------------------------------ build

    def _norm(self, text: str) -> str:
        return text.lower() if self.lowercase else text

    def collect(self, text: str, count: int = 1) -> None:
        text = self._norm(text)
        self.item_counts[text] += count
        if self.segment:
            for tok in text.split():
                self.segment_counts[tok] += count

    def collect_many(self, texts: Iterable[str]) -> None:
        for t in texts:
            self.collect(t)

    def finalize(self) -> None:
        """Freeze vocabularies; ids are assigned by descending count then
        insertion order, starting after the special ids."""
        self.item_to_id = OrderedDict()
        next_id = max(SPECIAL_TOKENS.values()) + 1
        items = self.item_counts.most_common()
        if self.max_vocab_size > 0:
            items = items[: self.max_vocab_size]
        for text, cnt in items:
            if cnt < self.min_count:
                continue
            self.item_to_id[text] = next_id
            self.item_id_counts[next_id] = cnt
            next_id += 1

        if self.segment:
            self.segment_to_id = OrderedDict()
            next_sid = max(SPECIAL_TOKENS_SEGMENT.values()) + 1
            for tok, cnt in self.segment_counts.most_common():
                if cnt < self.min_count:
                    continue
                self.segment_to_id[tok] = next_sid
                self.segment_id_counts[next_sid] = cnt
                next_sid += 1
        self.finalized = True

    # ------------------------------------------------------------------ apply

    def item_id(self, text: str) -> int:
        return self.item_to_id.get(self._norm(text), UNK)

    def toidx(self, text: str) -> Tuple[int, List[int]]:
        """Map a surface form to (item_id, token_id_sequence)."""
        text = self._norm(text)
        item = self.item_to_id.get(text, UNK)
        if not self.segment:
            return item, []
        toks = [self.segment_to_id.get(t, UNK) for t in text.split()]
        if self.insert_start is not None:
            toks = [self.insert_start] + toks
        if self.insert_end is not None:
            toks = toks + [self.insert_end]
        return item, toks

    @property
    def item_vocab_size(self) -> int:
        return (max(self.item_to_id.values()) + 1) if self.item_to_id else max(SPECIAL_TOKENS.values()) + 1

    @property
    def segment_vocab_size(self) -> int:
        return (
            (max(self.segment_to_id.values()) + 1)
            if self.segment_to_id
            else max(SPECIAL_TOKENS_SEGMENT.values()) + 1
        )

    # ------------------------------------------------------------------- disk

    def save(self, directory: str, prefix: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, f"{prefix}_id_map.txt"), "w", encoding="utf-8") as f:
            f.write("# token\tid\tcount\t\n")
            for text, iid in self.item_to_id.items():
                f.write(f"{text}\t{iid}\t{self.item_id_counts[iid]}\n")
        if self.segment:
            with open(os.path.join(directory, f"{prefix}_token_id_map.txt"), "w", encoding="utf-8") as f:
                f.write("# token\tid\tcount\t\n")
                for tok, sid in self.segment_to_id.items():
                    f.write(f"{tok}\t{sid}\t{self.segment_id_counts[sid]}\n")
            with open(
                os.path.join(directory, f"{prefix}_id_tokens_ids_map.txt"), "w", encoding="utf-8"
            ) as f:
                f.write(f"# {prefix} id\ttokens\t\n")
                for text, iid in self.item_to_id.items():
                    _, toks = self.toidx(text)
                    f.write(f"{iid}\t{' '.join(map(str, toks))}\n")

    @classmethod
    def load(cls, directory: str, prefix: str, **kwargs) -> "IndexMapper":
        m = cls(**kwargs)
        with open(os.path.join(directory, f"{prefix}_id_map.txt", ), encoding="utf-8") as f:
            for ln, line in enumerate(f):
                if ln == 0 and line.startswith("#"):
                    continue
                text, iid, cnt = line.rstrip("\n").split("\t")[:3]
                m.item_to_id[text] = int(iid)
                m.item_id_counts[int(iid)] = int(cnt)
        seg_path = os.path.join(directory, f"{prefix}_token_id_map.txt")
        if m.segment and os.path.exists(seg_path):
            with open(seg_path, encoding="utf-8") as f:
                for ln, line in enumerate(f):
                    if ln == 0 and line.startswith("#"):
                        continue
                    tok, sid, cnt = line.rstrip("\n").split("\t")[:3]
                    m.segment_to_id[tok] = int(sid)
                    m.segment_id_counts[int(sid)] = int(cnt)
        m.finalized = True
        return m

    def state(self) -> dict:
        return {
            "item_to_id": list(self.item_to_id.items()),
            "segment_to_id": list(self.segment_to_id.items()),
        }

    def __repr__(self) -> str:
        return (
            f"IndexMapper(items={len(self.item_to_id)}, segments={len(self.segment_to_id)}, "
            f"segment={self.segment})"
        )
