"""The OLPBench-creation pipeline as PipelineJob DAG nodes (the port's copy
of ``open_knowledge_graph_embeddings_tpu/preprocessing/jobs.py``: the same
jobs, files and pickles).

End-to-end: corpus triples -> redirects -> entity/mention maps -> triple
aggregation -> eval sampling -> leakage-filtered train splits -> id mapping
(reference: scripts/create_data.py:68-77 wiring the same stages backed by
Elasticsearch; here the leakage filter runs on the in-memory index).

All intermediate artifacts live under ``<work_dir>/indexes/`` as pickles;
final text splits under ``<work_dir>/``; mapped id files under
``<work_dir>/mapped_to_ids/``.
"""

from __future__ import annotations

import logging
import os
import pickle
from collections import Counter, defaultdict
from typing import Dict

from open_knowledge_graph_embeddings_tpu_torch.preprocessing import corpus as corpus_mod
from open_knowledge_graph_embeddings_tpu_torch.preprocessing import leakage as leakage_mod
from open_knowledge_graph_embeddings_tpu_torch.preprocessing import sampling as sampling_mod
from open_knowledge_graph_embeddings_tpu_torch.preprocessing.map_to_ids import convert_open_dataset
from open_knowledge_graph_embeddings_tpu_torch.preprocessing.pipeline import PipelineJob
from open_knowledge_graph_embeddings_tpu_torch.preprocessing.search import TripleSearchIndex

logger = logging.getLogger(__name__)


def _p(opts, *parts) -> str:
    return os.path.join(opts["work_dir"], *parts)


def _dump(path, obj):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


class ExtractTriples(PipelineJob):
    """Corpus files -> filtered raw extractions (capability P2)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__([], [_p(opts, "indexes", "raw_triples.pickle")], opts, jobs)

    def _run(self):
        raws, _, _ = corpus_mod.extract_corpus_parallel(
            self.opts["corpus_files"],
            workers=int(self.opts.get("workers", 1)),
            min_confidence=self.opts.get("min_confidence", 0.3),
            max_tokens=self.opts.get("max_tokens", 10),
        )
        logger.info("extracted %d filtered triples", len(raws))
        _dump(self.provides[0], raws)


class BuildRedirects(PipelineJob):
    """DBpedia redirects ttl -> dict (capability P3).  When no redirects
    file is configured an empty map is used."""

    def __init__(self, opts=None, jobs=None):
        super().__init__([], [_p(opts, "indexes", "redirects.pickle")], opts, jobs)

    def _run(self):
        path = self.opts.get("redirects_file")
        redirects = corpus_mod.parse_redirects(path) if path else {}
        _dump(self.provides[0], redirects)


class BuildEntityMentionMaps(PipelineJob):
    """Entity -> mention-count maps with redirects applied (capability P4)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__(
            [
                _p(opts, "indexes", "raw_triples.pickle"),
                _p(opts, "indexes", "redirects.pickle"),
            ],
            [_p(opts, "indexes", "entity_mentions.pickle")],
            opts,
            jobs,
        )

    def _run(self):
        raws = _load(self.requires[0])
        redirects = _load(self.requires[1])
        counts: Dict[str, Counter] = defaultdict(Counter)
        for t in raws:
            if t.get("subject_link"):
                counts[t["subject_link"]][tuple(w.lower() for w in t["subject"])] += 1
            if t.get("object_link"):
                counts[t["object_link"]][tuple(w.lower() for w in t["object"])] += 1
        filtered, _ = corpus_mod.build_entity_mention_maps(
            counts, redirects, min_fraction=self.opts.get("mention_min_fraction", 0.1)
        )
        _dump(self.provides[0], filtered)


class AggregateTriples(PipelineJob):
    """Dedup + link + vocab restriction (capability P5)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__(
            [_p(opts, "indexes", "raw_triples.pickle")],
            [
                _p(opts, "indexes", "triples.pickle"),
                _p(opts, "indexes", "mention_tokens.pickle"),
                _p(opts, "indexes", "relation_tokens.pickle"),
            ],
            opts,
            jobs,
        )

    def _run(self):
        raws = _load(self.requires[0])
        triples, ment_toks, rel_toks = corpus_mod.aggregate_triples(
            raws,
            mention_vocab_size=self.opts.get("mention_vocab_size", 200_000),
            relation_vocab_size=self.opts.get("relation_vocab_size", 50_000),
            min_count=self.opts.get("min_count", 3),
        )
        logger.info("aggregated to %d unique linked triples", len(triples))
        _dump(self.provides[0], triples)
        _dump(self.provides[1], ment_toks)
        _dump(self.provides[2], rel_toks)


class SampleEvaluation(PipelineJob):
    """Disjoint validation / validation-linked / test samples (capability P7)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__(
            [_p(opts, "indexes", "triples.pickle")],
            [_p(opts, "indexes", "eval_ids.pickle")],
            opts,
            jobs,
        )

    def _run(self):
        triples = _load(self.requires[0])
        v, vl, t = sampling_mod.sample_evaluation_data(
            triples,
            eval_size=self.opts.get("eval_data_size", 10_000),
            min_relation_tokens=self.opts.get("min_relation_tokens", 3),
            seed=self.opts.get("seed", 0),
        )
        _dump(self.provides[0], {"validation": v, "validation_linked": vl, "test": t})


class CreateTrainingData(PipelineJob):
    """Leakage filtering -> train_data_{simple,basic,thorough} + eval files
    (capabilities P6+P8; the in-memory index replaces Elasticsearch)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__(
            [
                _p(opts, "indexes", "triples.pickle"),
                _p(opts, "indexes", "entity_mentions.pickle"),
                _p(opts, "indexes", "mention_tokens.pickle"),
                _p(opts, "indexes", "relation_tokens.pickle"),
                _p(opts, "indexes", "eval_ids.pickle"),
            ],
            [
                _p(opts, "train_data_simple.txt"),
                _p(opts, "train_data_basic.txt"),
                _p(opts, "train_data_thorough.txt"),
                _p(opts, "validation_data.txt"),
                _p(opts, "validation_data_linked.txt"),
                _p(opts, "validation_data_linked_no_mention.txt"),
                _p(opts, "test_data.txt"),
            ],
            opts,
            jobs,
        )

    def _run(self):
        triples = _load(self.requires[0])
        entity_mentions = _load(self.requires[1])
        ment_toks: Counter = _load(self.requires[2])
        rel_toks: Counter = _load(self.requires[3])
        eval_ids = _load(self.requires[4])

        # top-25 mention + top-25 relation tokens as stopwords
        # (reference: create_elasticsearch_index.py:42-46)
        stopwords = {t for t, _ in ment_toks.most_common(25)}
        stopwords |= {t for t, _ in rel_toks.most_common(25)}

        index = TripleSearchIndex(stopwords)
        for i, ((s, r, o), _) in enumerate(triples):
            index.add(i, s, r, o)

        eval_triples = [
            triples[i]
            for i in eval_ids["test"] + eval_ids["validation"] + eval_ids["validation_linked"]
        ]
        simple, thorough = leakage_mod.compute_exclusion_sets(
            index, eval_triples, entity_mentions,
            unselective_threshold=self.opts.get("unselective_threshold", 1000),
        )
        evaluation_ids = set(
            eval_ids["test"] + eval_ids["validation"] + eval_ids["validation_linked"]
        )
        tr_simple, tr_basic, tr_thorough = leakage_mod.build_train_splits(
            triples, evaluation_ids, simple, thorough
        )
        logger.info(
            "train splits: simple=%d basic=%d thorough=%d",
            len(tr_simple), len(tr_basic), len(tr_thorough),
        )
        w = leakage_mod.write_triples_file
        w(self.provides[0], tr_simple)
        w(self.provides[1], tr_basic)
        w(self.provides[2], tr_thorough)
        val = [triples[i] for i in eval_ids["validation"]]
        val_l = [triples[i] for i in eval_ids["validation_linked"]]
        test = [triples[i] for i in eval_ids["test"]]
        w(self.provides[3], val)
        w(self.provides[4], val_l, entity_mentions)
        w(self.provides[5], val_l)
        w(self.provides[6], test, entity_mentions)


class MapToIds(PipelineJob):
    """Text splits -> mapped_to_ids id files (capability P9)."""

    def __init__(self, opts=None, jobs=None):
        super().__init__(
            [
                _p(opts, "train_data_thorough.txt"),
                _p(opts, "train_data_simple.txt"),
                _p(opts, "train_data_basic.txt"),
                _p(opts, "validation_data.txt"),
                _p(opts, "validation_data_linked.txt"),
                _p(opts, "test_data.txt"),
            ],
            [
                _p(opts, "mapped_to_ids", "entity_id_map.txt"),
                _p(opts, "mapped_to_ids", "train_data_thorough.txt"),
                _p(opts, "mapped_to_ids", "train_data_simple.txt"),
                _p(opts, "mapped_to_ids", "train_data_basic.txt"),
                _p(opts, "mapped_to_ids", "validation_data.txt"),
                _p(opts, "mapped_to_ids", "validation_data_linked.txt"),
                _p(opts, "mapped_to_ids", "test_data.txt"),
            ],
            opts,
            jobs,
        )

    def _run(self):
        out = _p(self.opts, "mapped_to_ids")
        convert_open_dataset(
            out,
            train_file=self.requires[0],
            other_files=self.requires[1:],
            min_count=self.opts.get("vocab_min_count", 1),
        )


ALL_JOBS = [
    ExtractTriples,
    BuildRedirects,
    BuildEntityMentionMaps,
    AggregateTriples,
    SampleEvaluation,
    CreateTrainingData,
    MapToIds,
]


def run_pipeline(opts: Dict) -> None:
    PipelineJob.run_jobs(ALL_JOBS, opts)
