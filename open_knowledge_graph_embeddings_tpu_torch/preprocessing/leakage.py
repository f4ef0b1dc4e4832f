"""Evaluation-leakage filtering -> train_data_{simple,basic,thorough} splits
(the port's copy of ``open_knowledge_graph_embeddings_tpu/preprocessing/leakage.py``).

Re-implements the reference's query battery
(reference: preprocessing/create_training_data.py:14-358,361-594) over the
in-memory :class:`..preprocessing.search.TripleSearchIndex`:

* *simple* excluded ids: full-triple matches (exact filtered subject/object
  pair in either orientation + all relation tokens),
* *thorough* excluded ids: entity-pair phrase matches, entity-pair term
  matches, and entity-pair-in-relation matches — each skipped when the
  query is unselective (>= ``unselective_threshold`` hits, mirroring the
  reference's ``len(res) < 1000`` guard),
* split construction: ``simple`` drops only the evaluation triples
  themselves; ``basic`` drops full-triple matches; ``thorough`` drops both
  exclusion sets (reference :516-527).

Alternative mentions of each eval triple's linked entities expand the
queries exactly as in the reference (the ``q1_stack``/``q2_stack``
expansion), and the eval files carry ``|||``-separated mention
alternatives from ``get_mentions_for_entity`` (reference :547-558).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from open_knowledge_graph_embeddings_tpu_torch.preprocessing.search import TripleSearchIndex

Tokens = Tuple[str, ...]
# ((s_tokens, r_tokens, o_tokens), (subject_entity_or_None, object_entity_or_None))
LinkedTriple = Tuple[Tuple[Tokens, Tokens, Tokens], Tuple[Optional[str], Optional[str]]]


def _mention_stacks(triple: LinkedTriple, entity_mentions: Dict[str, Dict[Tokens, int]]):
    (s, r, o), (se, oe) = triple
    q1_stack: List[Tokens] = [tuple(s)]
    q2_stack: List[Tokens] = [tuple(o)]
    if se is not None and se in entity_mentions:
        q1_stack.extend(tuple(m) for m in entity_mentions[se])
    if oe is not None and oe in entity_mentions:
        q2_stack.extend(tuple(m) for m in entity_mentions[oe])
    return q1_stack, q2_stack


def query_full_triple(index: TripleSearchIndex, triple: LinkedTriple, entity_mentions) -> Set:
    (s, r, o), _ = triple
    fs = index.filter_stopwords
    r_text = " ".join(r)
    q1_stack, q2_stack = _mention_stacks(triple, entity_mentions)
    pairs = set()
    for q1 in q1_stack:
        for q2 in q2_stack:
            pairs.add((" ".join(fs(q1)), " ".join(fs(q2))))
            pairs.add((" ".join(fs(q2)), " ".join(fs(q1))))
    out = set()
    for q1, q2 in pairs:
        pos = (
            index.term("subject_mention_exact", q1)
            & index.match_any("relation", r_text)  # ES match = OR over tokens
            & index.term("object_mention_exact", q2)
        )
        out |= index.hits(pos)
    return out


def query_match_entity_pair(index: TripleSearchIndex, triple: LinkedTriple, entity_mentions) -> Set:
    fs = index.filter_stopwords
    q1_stack, q2_stack = _mention_stacks(triple, entity_mentions)
    pairs = set()
    for q1 in q1_stack:
        for q2 in q2_stack:
            pairs.add((" ".join(fs(q1)), " ".join(fs(q2))))
            pairs.add((" ".join(fs(q2)), " ".join(fs(q1))))
    out = set()
    for q1, q2 in pairs:
        pos = index.match_phrase("subject_mention_filt", q1) & index.match_phrase(
            "object_mention_filt", q2
        )
        out |= index.hits(pos)
    return out


def query_terms_entity_pair(index: TripleSearchIndex, triple: LinkedTriple, entity_mentions) -> Set:
    fs = index.filter_stopwords
    q1_stack, q2_stack = _mention_stacks(triple, entity_mentions)
    queries = set()
    for q1 in q1_stack:
        for q2 in q2_stack:
            joined = " ".join(fs(q1) + fs(q2))
            queries.add((joined, "subject_mention_filt"))
            queries.add((joined, "object_mention_filt"))
    out = set()
    for q, field in queries:
        out |= index.hits(index.match(field, q))
    return out


def query_match_entity_pair_in_relation(
    index: TripleSearchIndex, triple: LinkedTriple, entity_mentions
) -> Set:
    fs = index.filter_stopwords
    q1_stack, q2_stack = _mention_stacks(triple, entity_mentions)
    pairs = set()
    for q1 in q1_stack:
        for q2 in q2_stack:
            pairs.add((" ".join(fs(q1)), " ".join(fs(q2))))
            pairs.add((" ".join(fs(q2)), " ".join(fs(q1))))
    out = set()
    for q1, q2 in pairs:
        for field in ("subject_mention_filt", "object_mention_filt"):
            pos = index.match_phrase(field, q1) & index.match_phrase("relation_filt", q2)
            out |= index.hits(pos)
    return out


def compute_exclusion_sets(
    index: TripleSearchIndex,
    eval_triples: Iterable[LinkedTriple],
    entity_mentions: Dict[str, Dict[Tokens, int]],
    unselective_threshold: int = 1000,
) -> Tuple[Set[int], Set[int]]:
    """Returns (simple_excluded_ids, thorough_excluded_ids)."""
    simple: Set[int] = set()
    thorough: Set[int] = set()
    for triple in eval_triples:
        for *_ , tid in query_full_triple(index, triple, entity_mentions):
            simple.add(tid)
        res = query_match_entity_pair(index, triple, entity_mentions)
        for *_, tid in res:
            thorough.add(tid)
        res = query_terms_entity_pair(index, triple, entity_mentions)
        if len(res) < unselective_threshold:
            for *_, tid in res:
                thorough.add(tid)
        res = query_match_entity_pair_in_relation(index, triple, entity_mentions)
        if len(res) < unselective_threshold:
            for *_, tid in res:
                thorough.add(tid)
    return simple, thorough


def build_train_splits(
    training_triples: Sequence[LinkedTriple],
    evaluation_ids: Set[int],
    simple_excluded: Set[int],
    thorough_excluded: Set[int],
) -> Tuple[List[LinkedTriple], List[LinkedTriple], List[LinkedTriple]]:
    """(train_simple, train_basic, train_thorough) — reference :516-527."""
    train_simple, train_basic, train_thorough = [], [], []
    for i, t in enumerate(training_triples):
        if i not in evaluation_ids:
            train_simple.append(t)
        if i not in simple_excluded:
            train_basic.append(t)
        if i not in thorough_excluded and i not in simple_excluded:
            train_thorough.append(t)
    return train_simple, train_basic, train_thorough


def get_mentions_for_entity(
    entity: Optional[str], default_mention: Tokens,
    entity_mentions: Dict[str, Dict[Tokens, int]],
) -> List[str]:
    """All alternative surface forms of an entity (always including the
    triple's own mention; reference :547-558)."""
    if entity is not None and entity in entity_mentions and entity_mentions[entity]:
        return sorted(
            {" ".join(m) for m in entity_mentions[entity]} | {" ".join(default_mention)}
        )
    return [" ".join(default_mention)]


def write_triples_file(path: str, triples: Sequence[LinkedTriple], entity_mentions=None) -> None:
    """5-col text file; with ``entity_mentions``, columns 4/5 carry
    ``|||``-separated mention alternatives (eval files)."""
    with open(path, "w", encoding="utf-8") as f:
        for (s, r, o), (se, oe) in triples:
            if entity_mentions is None:
                c4, c5 = " ".join(s), " ".join(o)
            else:
                c4 = "|||".join(get_mentions_for_entity(se, tuple(s), entity_mentions))
                c5 = "|||".join(get_mentions_for_entity(oe, tuple(o), entity_mentions))
            f.write(f"{' '.join(s)}\t{' '.join(r)}\t{' '.join(o)}\t{c4}\t{c5}\n")
