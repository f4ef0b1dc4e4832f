"""Dependency-free in-memory triple search index (the port's copy of
``open_knowledge_graph_embeddings_tpu/preprocessing/search.py``).

The reference filters evaluation leakage by querying a localhost
Elasticsearch index of the training triples with match / match_phrase /
term queries over raw, stopword-filtered and exact fields
(reference: preprocessing/create_elasticsearch_index.py:66-131,
create_training_data.py:14-358).  This module provides the same three
predicates over an inverted index held in memory:

* ``match(field, text)``  — every query token occurs in the field
  (ES bool-must of single-word match clauses),
* ``match_phrase(field, text)`` — the query tokens occur consecutively,
* ``term(field_exact, text)`` — exact string equality on the joined
  stopword-filtered field.

Two deliberate upgrades over the ES setup: results are exact and
unbounded (no top-1000 score truncation — the reference's ``hits`` cap can
silently under-filter), and no external service is needed.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Set, Tuple

Tokens = Tuple[str, ...]

RAW_FIELDS = ("subject_mention", "relation", "object_mention")


def make_stopword_filter(stopwords: Set[str]):
    """Drop stopwords, but keep the original tokens if everything would be
    dropped (reference: create_training_data.py:441-446)."""

    def filter_stopwords(toks: Sequence[str]) -> Tuple[str, ...]:
        result = tuple(t for t in toks if t not in stopwords)
        return result if result else tuple(toks)

    return filter_stopwords


class TripleSearchIndex:
    def __init__(self, stopwords: Set[str]):
        self.filter_stopwords = make_stopword_filter(stopwords)
        self.docs: List[Dict[str, Tokens]] = []
        self.triple_ids: List[int] = []
        # field -> token -> sorted doc positions
        self._inv: Dict[str, Dict[str, List[int]]] = defaultdict(lambda: defaultdict(list))
        self._exact: Dict[str, Dict[str, List[int]]] = defaultdict(lambda: defaultdict(list))

    def add(self, triple_id: int, subject_mention: Sequence[str], relation: Sequence[str],
            object_mention: Sequence[str]) -> None:
        doc: Dict[str, Tokens] = {}
        for name, toks in zip(RAW_FIELDS, (subject_mention, relation, object_mention)):
            toks = tuple(toks)
            filt = self.filter_stopwords(toks)
            doc[name] = toks
            doc[name + "_filt"] = filt
            doc[name + "_exact"] = (" ".join(filt),)
        pos = len(self.docs)
        self.docs.append(doc)
        self.triple_ids.append(triple_id)
        for field in doc:
            if field.endswith("_exact"):
                self._exact[field][doc[field][0]].append(pos)
            else:
                for tok in set(doc[field]):
                    self._inv[field][tok].append(pos)

    # ------------------------------------------------------------- queries

    def _candidates(self, field: str, tokens: Sequence[str]) -> Set[int]:
        postings = [set(self._inv[field].get(t, ())) for t in set(tokens)]
        if not postings:
            return set()
        out = postings[0]
        for p in postings[1:]:
            out = out & p
        return out

    def match(self, field: str, text: str) -> Set[int]:
        """Docs containing every query token in ``field`` (bool-must of
        single-word match clauses)."""
        toks = text.split() if isinstance(text, str) else list(text)
        if not toks:
            return set()
        return self._candidates(field, toks)

    def match_any(self, field: str, text: str) -> Set[int]:
        """Docs containing at least one query token — ES default ``match``
        (OR) semantics, used for the relation clause of the full-triple
        query (reference: create_training_data.py:566)."""
        toks = text.split() if isinstance(text, str) else list(text)
        out: Set[int] = set()
        for t in set(toks):
            out |= set(self._inv[field].get(t, ()))
        return out

    def match_phrase(self, field: str, text: str) -> Set[int]:
        toks = tuple(text.split() if isinstance(text, str) else text)
        if not toks:
            return set()
        out = set()
        for pos in self._candidates(field, toks):
            hay = self.docs[pos][field]
            n, m = len(hay), len(toks)
            if any(hay[i : i + m] == toks for i in range(n - m + 1)):
                out.add(pos)
        return out

    def term(self, field: str, text: str) -> Set[int]:
        return set(self._exact[field].get(text, ()))

    def hits(self, positions: Iterable[int]) -> Set[Tuple[Tokens, Tokens, Tokens, int]]:
        """(subject, relation, object, triple_id) result tuples, matching the
        reference query functions' return shape."""
        return {
            (
                self.docs[p]["subject_mention"],
                self.docs[p]["relation"],
                self.docs[p]["object_mention"],
                self.triple_ids[p],
            )
            for p in positions
        }

    def __len__(self) -> int:
        return len(self.docs)
