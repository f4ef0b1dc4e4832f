"""Corpus-side preprocessing (the port's copy of
``open_knowledge_graph_embeddings_tpu/preprocessing/corpus.py``, the same
operations in the same order): OPIEC extraction, redirects, entity/mention
maps, triple aggregation (capabilities P2-P5 of the reference pipeline).

* :func:`iter_opiec_triples` — streaming reader of OPIEC-Clean triples.
  Avro container files are read with the self-contained spec
  implementation in ``preprocessing/avro.py`` (no external dependency); a
  JSON-lines debug format with the same record fields is also supported.  Filter semantics mirror the reference
  (reference: preprocessing/process_avro.py:16-80): confidence >= 0.3,
  POSITIVE polarity, quantity substitution, token length <= 10.
* :func:`parse_redirects` — DBpedia ``redirects_en.ttl(.bz2)`` parsing with
  the reference's two-sweep transitive resolution
  (reference: preprocessing/create_redirects.py:14-70).  The download
  itself is the caller's problem: the package fetches nothing.
* :func:`build_entity_mention_maps` — apply redirects, drop mentions
  below ``min_fraction`` of an entity's total count and comma-qualifier
  artifacts (reference: preprocessing/process_entities_and_mentions.py:15-125).
* :func:`aggregate_triples` — lowercased dedup, most-popular entity link
  per slot with the log-count confidence threshold ``1 - 1/log(total)``,
  self-loop removal, top-K token vocab restriction, rare mention/relation
  dropping (reference: preprocessing/process_triples.py:14-199).
"""

from __future__ import annotations

import bz2
import json
import logging
import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from open_knowledge_graph_embeddings_tpu_torch.preprocessing.avro import reader as avro_reader

logger = logging.getLogger(__name__)

Tokens = Tuple[str, ...]


# ------------------------------------------------------------- P2: OPIEC


def normalize_wiki_entity(links: Sequence[Optional[str]]) -> List[str]:
    """Anchor-snipped, capitalized, order-preserving unique wiki links
    (reference: preprocessing/misc.py:25-35)."""
    seen: Set[str] = set()
    out: List[str] = []
    for link in links:
        if not link:
            continue
        link = link.split("#", 1)[0]
        if not link:
            continue
        link = link[0].upper() + link[1:]
        if link not in seen:
            out.append(link)
            seen.add(link)
    return out


def _passes_filters(rec: Dict, min_confidence: float, max_tokens: int) -> bool:
    if float(rec.get("confidence", 1.0)) < min_confidence:
        return False
    if rec.get("polarity", "POSITIVE") != "POSITIVE":
        return False
    for slot in ("subject", "relation", "object"):
        toks = rec[slot]
        if not toks or len(toks) > max_tokens:
            return False
    return True


def _substitute_quantities(tokens: Sequence[Dict]) -> List[str]:
    """QUANT_* placeholders for quantity tokens (reference semantics)."""
    out = []
    for tok in tokens:
        word = tok["word"] if isinstance(tok, dict) else str(tok)
        if isinstance(tok, dict) and tok.get("ner") == "QUANTITY":
            word = "QUANT"
        out.append(word)
    return out


#: POS tags that disqualify a slot when they tag its LAST token
#: (reference: preprocessing/process_avro.py:53-66)
_BAD_LAST_POS_ALWAYS = ("RB", "WDT")
_BAD_LAST_POS_UNLESS_I = ("DT", "PRP", "PRP$")


def _merged_words(slot_tokens: Sequence[Dict], dropped: Sequence[Dict], quantities: Dict) -> List[str]:
    """Slot words = slot + dropped words sorted by sentence index, with
    QUANT_x placeholders resolved back to their quantity strings
    (reference: process_avro.py:31-37)."""
    merged = sorted(list(slot_tokens) + list(dropped), key=lambda w: w.get("index", 0))
    out = []
    for w in merged:
        word = w["word"]
        if "QUANT" in word:
            key = word[6:]
            if key in quantities:
                word = quantities[key]
        out.append(word)
    return out


def extract_opiec_triple(
    rec: Dict,
    min_confidence: float = 0.3,
    max_subject: int = 10,
    max_relation: int = 10,
    max_object: int = 10,
) -> Optional[Dict]:
    """Full-fidelity extraction of one OPIEC-Clean record
    (reference: preprocessing/process_avro.py:16-96, 112-195).

    Expects the OPIEC-Clean avro record shape: slot token dicts with
    word/pos/index, ``dropped_words_*`` lists, ``quantities`` dict,
    ``confidence_score``, ``polarity``, per-token ``w_link.wiki_link``,
    ``sentence_linked.tokens``, ``triple_id``/``article_id``.

    Returns None when any reference filter rejects the record, else the
    normalized dict consumed by the downstream aggregation jobs.
    """
    if rec.get("polarity", "POSITIVE") != "POSITIVE":
        return None
    if float(rec.get("confidence_score", rec.get("confidence", 1.0))) < min_confidence:
        return None
    dropped_s = rec.get("dropped_words_subject", [])
    dropped_r = rec.get("dropped_words_relation", [])
    dropped_o = rec.get("dropped_words_object", [])
    if "PRP$" in [w.get("pos") for w in dropped_s]:
        return None
    quantities = rec.get("quantities") or {}
    if "no" in quantities.values():
        return None

    subj, relation, obj = rec["subject"], rec["relation"], rec["object"]
    if not subj or not obj:
        return None
    for slot in (subj, obj):
        last_pos = slot[-1].get("pos")
        if last_pos in _BAD_LAST_POS_ALWAYS:
            return None
        if last_pos in _BAD_LAST_POS_UNLESS_I and slot[-1]["word"] not in ("I",):
            return None

    subject_word = _merged_words(subj, dropped_s, quantities)
    relation_word = _merged_words(relation, dropped_r, quantities)
    object_word = _merged_words(obj, dropped_o, quantities)
    if relation_word == ["is:impl_appos-clause"]:
        return None
    if not subject_word or not object_word:
        return None
    if len(subject_word) > max_subject or len(object_word) > max_object:
        return None
    if subject_word == object_word:
        return None
    if not relation_word or len(relation_word) > max_relation:
        return None

    s_links = normalize_wiki_entity(
        [(w.get("w_link") or {}).get("wiki_link") for w in subj]
    )
    o_links = normalize_wiki_entity(
        [(w.get("w_link") or {}).get("wiki_link") for w in obj]
    )

    out = {
        "subject": subject_word,
        "relation": relation_word,
        "object": object_word,
        # links feed the entity-mention maps only when unambiguous (exactly
        # one wiki link in the slot; reference: process_avro.py:129-140)
        "subject_link": s_links[0] if len(s_links) == 1 else None,
        "object_link": o_links[0] if len(o_links) == 1 else None,
        "confidence": float(rec.get("confidence_score", rec.get("confidence", 1.0))),
        "polarity": "POSITIVE",
        "triple_id": rec.get("triple_id"),
        "article_id": rec.get("article_id"),
    }
    # "sentence_linked" may be PRESENT with a null value (avro union branch)
    sent = (rec.get("sentence_linked") or {}).get("tokens")
    if sent:
        tag_of = {}
        for toks, tag in ((relation, "[REL]"), (subj, "[SUBJ]"), (obj, "[OBJ]")):
            for w in toks:
                tag_of[w.get("index")] = tag
        for toks, tag in (
            (dropped_r, "[REL]"), (dropped_s, "[SUBJ]"), (dropped_o, "[OBJ]")
        ):
            for w in toks:
                tag_of.setdefault(w.get("index"), tag)
        ordered = sorted(sent, key=lambda w: w.get("index", 0))
        out["sentence"] = [w["word"] for w in ordered]
        out["sentence_mask"] = [tag_of.get(w.get("index"), "-") for w in ordered]
    return out


def _is_full_record(rec: Dict) -> bool:
    if "dropped_words_subject" in rec or "confidence_score" in rec:
        return True
    toks = rec.get("subject") or []
    return bool(toks) and isinstance(toks[0], dict) and "pos" in toks[0]


def iter_opiec_triples(
    paths: Sequence[str],
    min_confidence: float = 0.3,
    max_tokens: int = 10,
) -> Iterator[Dict]:
    """Yield filtered OPIEC triples as dicts with keys
    subject/relation/object (token lists), subject_link/object_link
    (wikipedia links or None), confidence."""
    for path in paths:
        if path.endswith(".avro"):
            with open(path, "rb") as f:
                yield from _iter_records(avro_reader(f), min_confidence, max_tokens)
        else:
            opener = bz2.open if path.endswith(".bz2") else open
            with opener(path, "rt", encoding="utf-8") as f:
                yield from _iter_records(
                    (json.loads(line) for line in f if line.strip()),
                    min_confidence,
                    max_tokens,
                )


def _iter_records(records: Iterable[Dict], min_confidence: float, max_tokens: int):
    for rec in records:
        if _is_full_record(rec):
            # full OPIEC-Clean record shape: POS filters, dropped-word
            # merging, QUANT resolution, wiki-link extraction
            norm = extract_opiec_triple(
                rec, min_confidence=min_confidence,
                max_subject=max_tokens, max_relation=max_tokens, max_object=max_tokens,
            )
            if norm is not None:
                yield norm
            continue
        norm = {
            "subject": _substitute_quantities(rec.get("subject", [])),
            "relation": _substitute_quantities(rec.get("relation", [])),
            "object": _substitute_quantities(rec.get("object", [])),
            "subject_link": rec.get("subject_link"),
            "object_link": rec.get("object_link"),
            "confidence": float(rec.get("confidence", 1.0)),
            "polarity": rec.get("polarity", "POSITIVE"),
        }
        if _passes_filters(norm, min_confidence, max_tokens):
            yield norm


# --------------------------------------------- P2: parallel extraction


def _extract_one_file(args) -> Tuple[List[Dict], Dict[str, Counter], Counter]:
    """Worker: one corpus file -> (records, entity_mention_counts,
    relation_counter).  Module-level for pickling."""
    path, min_confidence, max_tokens = args
    records: List[Dict] = []
    mentions: Dict[str, Counter] = defaultdict(Counter)
    relations: Counter = Counter()
    for rec in iter_opiec_triples([path], min_confidence, max_tokens):
        records.append(rec)
        if rec.get("subject_link"):
            mentions[rec["subject_link"]][tuple(rec["subject"])] += 1
        if rec.get("object_link"):
            mentions[rec["object_link"]][tuple(rec["object"])] += 1
        relations[tuple(rec["relation"])] += 1
    return records, dict(mentions), relations


def extract_corpus_parallel(
    paths: Sequence[str],
    workers: int = 1,
    min_confidence: float = 0.3,
    max_tokens: int = 10,
) -> Tuple[List[Dict], Dict[str, Counter], Counter]:
    """Multiprocess corpus extraction (reference worker pool:
    preprocessing/process_avro.py:221-288 — queue-fed processes, one corpus
    file per work item, partial maps merged by the parent).

    Returns (records, entity->mention counts, relation counter)."""
    work = [(p, min_confidence, max_tokens) for p in paths]
    if workers <= 1 or len(paths) <= 1:
        parts = [_extract_one_file(w) for w in work]
    else:
        import multiprocessing

        with multiprocessing.Pool(min(workers, len(paths))) as pool:
            parts = pool.map(_extract_one_file, work)
    records: List[Dict] = []
    mentions: Dict[str, Counter] = defaultdict(Counter)
    relations: Counter = Counter()
    for recs, ment, rels in parts:
        records.extend(recs)
        for link, counts in ment.items():
            mentions[link].update(counts)
        relations.update(rels)
    return records, dict(mentions), relations


# --------------------------------------------------------- P3: redirects


_TTL_RE = re.compile(r"<[^>]*/([^>/]+)>\s+<[^>]+>\s+<[^>]*/([^>/]+)>\s*\.")


def parse_redirects(path: str) -> Dict[str, str]:
    """Two-sweep transitive redirect resolution over a DBpedia ttl dump."""
    redirects: Dict[str, str] = {}
    opener = bz2.open if path.endswith(".bz2") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            m = _TTL_RE.match(line)
            if m:
                redirects[m.group(1)] = m.group(2)
    # sweep twice: A->B->C collapses to A->C (reference does exactly two
    # sweeps, not a full closure)
    for _ in range(2):
        for src, dst in list(redirects.items()):
            if dst in redirects and redirects[dst] != src:
                redirects[src] = redirects[dst]
    return redirects


def apply_redirects(link: Optional[str], redirects: Dict[str, str]) -> Optional[str]:
    if link is None:
        return None
    return redirects.get(link, link)


# ------------------------------------------- P4: entity / mention maps


def build_entity_mention_maps(
    entity_mention_counts: Dict[str, Dict[Tokens, int]],
    redirects: Optional[Dict[str, str]] = None,
    min_fraction: float = 0.1,
) -> Tuple[Dict[str, Dict[Tokens, int]], Dict[Tokens, Set[str]]]:
    """Apply redirects; drop per-entity mentions below ``min_fraction`` of
    the entity's total count and comma-qualifier artifacts ("X , Y" where
    "X" is also a mention).  Returns (entity->mention->count,
    mention->entities)."""
    merged: Dict[str, Dict[Tokens, int]] = defaultdict(Counter)
    for entity, mentions in entity_mention_counts.items():
        target = apply_redirects(entity, redirects or {})
        for m, c in mentions.items():
            merged[target][tuple(m)] += c

    filtered: Dict[str, Dict[Tokens, int]] = {}
    for entity, mentions in merged.items():
        total = sum(mentions.values())
        keep: Dict[Tokens, int] = {}
        for m, c in mentions.items():
            if c < min_fraction * total:
                continue
            if "," in m:
                head = tuple(m[: m.index(",")])
                if head in mentions:
                    continue
            keep[m] = c
        if keep:
            filtered[entity] = keep

    mention_entities: Dict[Tokens, Set[str]] = defaultdict(set)
    for entity, mentions in filtered.items():
        for m in mentions:
            mention_entities[m].add(entity)
    return filtered, dict(mention_entities)


# ------------------------------------------------ P5: triple aggregation


def aggregate_triples(
    triples: Iterable[Dict],
    mention_vocab_size: int = 200_000,
    relation_vocab_size: int = 50_000,
    min_count: int = 3,
    drop_relations: Sequence[Tuple[str, ...]] = (
        ("is:impl_appos-clause",),
        ("is:impl_appos-clause", "in:impl_appos-clause"),
    ),
) -> Tuple[List[Tuple[Tuple[Tokens, Tokens, Tokens], Tuple[Optional[str], Optional[str]]]], Counter, Counter]:
    """Dedup + link + vocab-restrict raw extractions.

    * lowercased (s, r, o) dedup keeping the most confident instance and
      pooling link votes,
    * per slot, pick the most popular link if its vote share passes the
      ``1 - 1/log(total_votes)`` confidence threshold
      (reference: process_triples.py:77-79),
    * self-loops (same link both slots) keep the triple but null both links
      (reference: process_triples.py:102-107),
    * restrict to the top-K mention/relation token vocabularies, THEN count
      surviving mentions/relations and drop those rarer than ``min_count``
      (reference order: process_triples.py:139-159, count > 2),
    * drop configured implicit-appositive marker relations
      (reference: process_triples.py:168-169).
    """
    by_key: Dict[Tuple[Tokens, Tokens, Tokens], Dict] = {}
    for t in triples:
        s, r, o = (tuple(w.lower() for w in t[k]) for k in ("subject", "relation", "object"))
        key = (s, r, o)
        slot = by_key.setdefault(
            key, {"s_links": Counter(), "o_links": Counter(), "count": 0}
        )
        slot["count"] += 1
        if t.get("subject_link"):
            slot["s_links"][t["subject_link"]] += 1
        if t.get("object_link"):
            slot["o_links"][t["object_link"]] += 1

    def pick_link(votes: Counter) -> Optional[str]:
        total = sum(votes.values())
        if total == 0:
            return None
        link, cnt = votes.most_common(1)[0]
        if total < 3:
            return link
        threshold = 1.0 - 1.0 / math.log(total)
        return link if cnt / total >= threshold else None

    mention_tokens = Counter()
    relation_tokens = Counter()
    linked: List[Tuple[Tuple[Tokens, Tokens, Tokens], Tuple[Optional[str], Optional[str]]]] = []
    for (s, r, o), info in by_key.items():
        se = pick_link(info["s_links"])
        oe = pick_link(info["o_links"])
        if se is not None and se == oe:
            # same link on both slots: something is wrong with the linking;
            # keep the triple, null the links (reference :102-107)
            se = oe = None
        linked.append(((s, r, o), (se, oe)))
        mention_tokens.update(s)
        mention_tokens.update(o)
        relation_tokens.update(r)

    keep_mention_toks = {t for t, _ in mention_tokens.most_common(mention_vocab_size)}
    keep_relation_toks = {t for t, _ in relation_tokens.most_common(relation_vocab_size)}

    # token-vocab restriction first, then recount survivors (reference order)
    tok_filtered = [
        t for t in linked
        if all(x in keep_mention_toks for x in t[0][0] + t[0][2])
        and all(x in keep_relation_toks for x in t[0][1])
    ]
    mention_counts = Counter()
    relation_counts = Counter()
    for (s, r, o), _ in tok_filtered:
        mention_counts.update((s, o))
        relation_counts[r] += 1

    drop_rel_set = {tuple(r) for r in drop_relations}
    out = []
    for (s, r, o), links in tok_filtered:
        if r in drop_rel_set:
            continue
        if mention_counts[s] < min_count or mention_counts[o] < min_count:
            continue
        if relation_counts[r] < min_count:
            continue
        out.append(((s, r, o), links))
    return out, mention_tokens, relation_tokens
