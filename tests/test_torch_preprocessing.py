"""The port's OLPBench pipeline modules against the JAX package's on the CPU.

Every check of ``tests/test_preprocessing.py``, ``tests/test_avro.py`` and
``tests/test_vocab.py`` runs through both packages (the ``pkg`` parameter),
and where a check produces something (aggregated triples, splits, id files,
avro bytes, vocabularies), the port's result must equal JAX's exactly: the
same values, and the same bytes for every file written."""

import importlib
import io
import json
import os
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_avro import FIXTURE, SCHEMA, fixture_records
from test_preprocessing import _opiec_record

ROOTS = {"jax": "open_knowledge_graph_embeddings_tpu", "port": "open_knowledge_graph_embeddings_tpu_torch"}
MODULES = {
    "pipeline": "preprocessing.pipeline", "search": "preprocessing.search", "leakage": "preprocessing.leakage",
    "sampling": "preprocessing.sampling", "avro": "preprocessing.avro", "corpus": "preprocessing.corpus",
    "map_to_ids": "preprocessing.map_to_ids", "vocab": "data.vocab", "dataset": "data.dataset",
}


def _pkg(name):
    return SimpleNamespace(name=name, **{k: importlib.import_module(f"{ROOTS[name]}.{m}") for k, m in MODULES.items()})


JAX, PORT = _pkg("jax"), _pkg("port")


@pytest.fixture(params=list(ROOTS))
def pkg(request):
    return _pkg(request.param)


def _files(d):
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


# --------------------------------------------------------------- pipeline


def test_pipeline_dag(pkg, tmp_path):
    order = []

    class JobA(pkg.pipeline.PipelineJob):
        def __init__(self, opts=None, jobs=None):
            super().__init__([], [str(tmp_path / "a.txt")], opts, jobs)

        def _run(self):
            order.append("A")
            open(self.provides[0], "w").write("a")

    class JobB(pkg.pipeline.PipelineJob):
        def __init__(self, opts=None, jobs=None):
            super().__init__([str(tmp_path / "a.txt")], [str(tmp_path / "b.txt")], opts, jobs)

        def _run(self):
            order.append("B")
            open(self.provides[0], "w").write(open(self.requires[0]).read() + "b")

    pkg.pipeline.PipelineJob.run_jobs([JobB, JobA], opts=None)
    assert order == ["A", "B"]  # the dependency ran first
    assert open(tmp_path / "b.txt").read() == "ab"
    order.clear()  # a second run: everything satisfied, nothing runs
    pkg.pipeline.PipelineJob.run_jobs([JobB, JobA], opts=None)
    assert order == []


def test_pipeline_missing_provider(pkg, tmp_path):
    class JobC(pkg.pipeline.PipelineJob):
        def __init__(self, opts=None, jobs=None):
            super().__init__([str(tmp_path / "nope.txt")], [str(tmp_path / "c.txt")], opts, jobs)

        def _run(self):
            pass

    with pytest.raises(FileNotFoundError):
        pkg.pipeline.PipelineJob.run_jobs([JobC], opts=None)


# ----------------------------------------------------------------- search


def _index(pkg):
    idx = pkg.search.TripleSearchIndex(stopwords={"the", "of"})
    idx.add(0, ("barack", "obama"), ("president", "of"), ("united", "states"))
    idx.add(1, ("obama",), ("visited",), ("berlin",))
    idx.add(2, ("the", "president"), ("lives", "in"), ("washington",))
    return idx


SEARCH_CASES = {
    "match": [("match", "subject_mention", "obama", {0, 1}), ("match", "subject_mention", "barack obama", {0}),
              ("match", "subject_mention", "nixon", set())],
    "match-phrase": [("match_phrase", "subject_mention", "barack obama", {0}),
                     ("match_phrase", "object_mention", "united berlin", set())],  # not consecutive
    "term-exact": [("term", "subject_mention_exact", "president", {2})],  # "the president" filters to it
    "match-any": [("match_any", "relation", "lives visited", {1, 2})],
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_queries(pkg, case):
    idx = _index(pkg)
    for query, field, text, want in SEARCH_CASES[case]:
        got = getattr(idx, query)(field, text)
        assert {idx.triple_ids[p] for p in got} == want, (query, text)
        assert got == getattr(_index(JAX), query)(field, text)
    fs = idx.filter_stopwords
    assert fs(("the", "of")) == ("the", "of")  # an all-stopword mention keeps its tokens
    assert fs(("the", "president")) == ("president",)


# ---------------------------------------------------------------- leakage


def _leakage_fixture(pkg):
    idx = pkg.search.TripleSearchIndex(stopwords=set())
    train = [
        ((("obama",), ("visited",), ("berlin",)), ("Obama", None)),  # 0: the eval pair
        ((("obama",), ("met",), ("merkel",)), ("Obama", "Merkel")),  # 1
        ((("paris",), ("capital", "of"), ("france",)), ("Paris", "France")),  # 2
        ((("barack", "obama"), ("visited",), ("berlin",)), ("Obama", None)),  # 3: an alternative mention pair
    ]
    for i, ((s, r, o), _) in enumerate(train):
        idx.add(i, s, r, o)
    entity_mentions = {"Obama": {("obama",): 5, ("barack", "obama"): 3}}
    eval_triples = [((("obama",), ("visited",), ("berlin",)), ("Obama", None))]
    return idx, train, entity_mentions, eval_triples


def test_leakage_filter_and_splits(pkg):
    idx, train, em, eval_triples = _leakage_fixture(pkg)
    simple, thorough = pkg.leakage.compute_exclusion_sets(idx, eval_triples, em)
    assert 0 in simple and 3 in simple  # exact and alternative-mention full-triple leaks
    assert {0, 3} <= thorough
    assert 2 not in simple and 2 not in thorough
    splits = pkg.leakage.build_train_splits(train, evaluation_ids={0}, simple_excluded=simple,
                                            thorough_excluded=thorough)
    tr_simple, tr_basic, tr_thorough = splits
    assert len(tr_simple) == 3  # only the eval triple itself removed
    assert all(t[0][0] != ("obama",) or t[0][1] != ("visited",) for t in tr_thorough)
    assert len(tr_thorough) <= len(tr_basic) <= len(train)
    jidx, jtrain, jem, jeval = _leakage_fixture(JAX)
    jsimple, jthorough = JAX.leakage.compute_exclusion_sets(jidx, jeval, jem)
    assert (simple, thorough) == (jsimple, jthorough)
    assert splits == JAX.leakage.build_train_splits(jtrain, {0}, jsimple, jthorough)
    for query in ("query_full_triple", "query_match_entity_pair", "query_terms_entity_pair",
                  "query_match_entity_pair_in_relation"):
        assert getattr(pkg.leakage, query)(idx, eval_triples[0], em) == getattr(JAX.leakage, query)(
            jidx, jeval[0], jem), query


def test_mentions_for_entity_and_writer(pkg, tmp_path):
    em = {"Obama": {("obama",): 2, ("barack", "obama"): 1}}
    assert set(pkg.leakage.get_mentions_for_entity("Obama", ("obama",), em)) == {"obama", "barack obama"}
    assert pkg.leakage.get_mentions_for_entity(None, ("x", "y"), em) == ["x y"]
    triples = [((("obama",), ("visited",), ("berlin",)), ("Obama", None))]
    for name, mentions in (("eval.txt", em), ("train.txt", None)):
        pkg.leakage.write_triples_file(str(tmp_path / name), triples, mentions)
        JAX.leakage.write_triples_file(str(tmp_path / ("jax_" + name)), triples, mentions)
        assert (tmp_path / name).read_bytes() == (tmp_path / ("jax_" + name)).read_bytes()
    line = (tmp_path / "eval.txt").read_text().strip().split("\t")
    assert line[0] == "obama" and line[2] == "berlin"
    assert set(line[3].split("|||")) == {"obama", "barack obama"}
    assert line[4] == "berlin"


# ----------------------------------------------------------------- corpus


JSONL_ROWS = [
    {"subject": ["a"], "relation": ["likes"], "object": ["b"], "confidence": 0.9},
    {"subject": ["a"], "relation": ["likes"], "object": ["b"], "confidence": 0.1},  # low confidence
    {"subject": ["a"], "relation": ["hates"], "object": ["b"], "polarity": "NEGATIVE"},
    {"subject": ["x"] * 11, "relation": ["r"], "object": ["b"]},  # too long
    {"subject": [{"word": "5", "ner": "QUANTITY"}, {"word": "cats"}],
     "relation": [{"word": "live"}], "object": [{"word": "here"}]},
]


@pytest.mark.parametrize("rows", ["filters", "full-record"])
def test_opiec_jsonl_reader(pkg, tmp_path, rows):
    p = tmp_path / "triples.jsonl"
    records = JSONL_ROWS if rows == "filters" else [_opiec_record()]
    p.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    got = list(pkg.corpus.iter_opiec_triples([str(p)]))
    assert got == list(JAX.corpus.iter_opiec_triples([str(p)]))
    if rows == "filters":
        assert len(got) == 2 and got[1]["subject"] == ["QUANT", "cats"]
    else:
        assert len(got) == 1 and got[0]["subject"] == ["Barack", "Obama"]


def test_avro_built_in_reader_surfaces_a_malformed_file(pkg, tmp_path):
    """``.avro`` paths go through the package's own reader: a malformed file
    surfaces its error, not an ImportError."""
    p = tmp_path / "x.avro"
    p.write_bytes(b"not-an-avro-file")
    with pytest.raises((ValueError, EOFError)):
        list(pkg.corpus.iter_opiec_triples([str(p)]))


def test_parse_redirects(pkg, tmp_path):
    ttl = tmp_path / "redirects.ttl"
    ttl.write_text(
        "<http://dbpedia.org/resource/A> <http://dbpedia.org/ontology/wikiPageRedirects> <http://dbpedia.org/resource/B> .\n"
        "<http://dbpedia.org/resource/B> <http://dbpedia.org/ontology/wikiPageRedirects> <http://dbpedia.org/resource/C> .\n"
        "<http://dbpedia.org/resource/D> <http://dbpedia.org/ontology/wikiPageRedirects> <http://dbpedia.org/resource/A> .\n"
    )
    red = pkg.corpus.parse_redirects(str(ttl))
    assert red["A"] == "C" and red["B"] == "C"
    assert red == JAX.corpus.parse_redirects(str(ttl))
    assert pkg.corpus.apply_redirects("D", red) == red["D"] and pkg.corpus.apply_redirects(None, red) is None


def test_entity_mention_maps(pkg):
    counts = {
        "Obama": {("obama",): 90, ("barack", "obama"): 30, ("rare",): 2, ("obama", ",", "president"): 20},
        "OldObama": {("potus",): 40},
    }
    filtered, mention_entities = pkg.corpus.build_entity_mention_maps(counts, redirects={"OldObama": "Obama"},
                                                                      min_fraction=0.1)
    m = filtered["Obama"]
    assert ("obama",) in m and ("barack", "obama") in m
    assert ("rare",) not in m  # below 10 %
    assert ("obama", ",", "president") not in m  # the comma qualifier of a mention it has
    assert ("potus",) in m  # merged through the redirect
    assert "Obama" in mention_entities[("obama",)]
    jf, jme = JAX.corpus.build_entity_mention_maps(counts, redirects={"OldObama": "Obama"}, min_fraction=0.1)
    assert (filtered, mention_entities) == (jf, jme)
    assert [list(v) for v in filtered.values()] == [list(v) for v in jf.values()]  # the same order


def test_aggregate_triples(pkg):
    raws = (
        [{"subject": ["Obama"], "relation": ["visited"], "object": ["Berlin"],
          "subject_link": "Obama", "object_link": "Berlin"}] * 5
        + [{"subject": ["obama"], "relation": ["visited"], "object": ["berlin"],
            "subject_link": "Obama", "object_link": "Berlin"}] * 2
        + [{"subject": ["x"], "relation": ["is"], "object": ["x2"], "subject_link": "X", "object_link": "X"}] * 5
        + [{"subject": ["solo"], "relation": ["seen"], "object": ["once"]}]
        + [{"subject": ["paris"], "relation": ["capital"], "object": ["france"]}] * 4
    )
    out, ment_toks, rel_toks = pkg.corpus.aggregate_triples(raws, min_count=1)
    keys = {t[0] for t in out}
    assert (("obama",), ("visited",), ("berlin",)) in keys  # lowercased dedup
    assert all(not (lk[0] is not None and lk[0] == lk[1]) for _, lk in out)  # no self-loops
    assert dict(out)[(("obama",), ("visited",), ("berlin",))] == ("Obama", "Berlin")
    jout, jm, jr = JAX.corpus.aggregate_triples(raws, min_count=1)
    assert out == jout  # the same triples in the same order
    assert list(ment_toks.most_common()) == list(jm.most_common())
    assert list(rel_toks.most_common()) == list(jr.most_common())


def _tok(word, pos, index, link=""):
    return {"word": word, "pos": pos, "index": index, "w_link": {"wiki_link": link}}


EXTRACT_CASES = {  # record overrides -> None (rejected) or the expected subject words
    "whole": ({}, ["Barack", "Obama"]),
    "last-subject-DT": ({"subject": [_tok("the", "DT", 1)]}, None),
    "last-subject-PRP-I": ({"subject": [_tok("I", "PRP", 1)]}, ["I"]),
    "last-object-RB": ({"object": [_tok("quickly", "RB", 5)]}, None),
    "dropped-PRP$": ({"dropped_words_subject": [_tok("his", "PRP$", 0)]}, None),
    "low-confidence": ({"confidence_score": 0.2}, None),
    "negative": ({"polarity": "NEGATIVE"}, None),
    "quant-and-dropped": ({"subject": [_tok("QUANT_a", "CD", 2), _tok("cats", "NNS", 3)],
                           "dropped_words_subject": [_tok("exactly", "RB", 1)], "quantities": {"a": "5"}},
                          ["exactly", "5", "cats"]),
    "quantity-no": ({"quantities": {"a": "no"}}, None),
    "self-loop": ({"object": [_tok("Barack", "NNP", 1), _tok("Obama", "NNP", 2)]}, None),
    "appositive": ({"relation": [_tok("is:impl_appos-clause", "VBZ", 3)]}, None),
}


@pytest.mark.parametrize("case", list(EXTRACT_CASES))
def test_opiec_full_record_extraction(pkg, case):
    over, want = EXTRACT_CASES[case]
    out = pkg.corpus.extract_opiec_triple(_opiec_record(**over))
    assert out == JAX.corpus.extract_opiec_triple(_opiec_record(**over))
    if want is None:
        assert out is None
        return
    assert out["subject"] == want
    if case == "whole":
        assert out["relation"] == ["lives", "in"] and out["object"] == ["Washington"]
        # links are anchor-snipped, capitalized and unambiguous only
        assert out["subject_link"] == "Barack_obama" and out["object_link"] == "Washington,_d.c."
        assert out["sentence_mask"] == ["[SUBJ]", "[SUBJ]", "[REL]", "[REL]", "[OBJ]", "-"]


def test_extract_corpus_parallel(pkg, tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"part{i}.jsonl"
        p.write_text(json.dumps(_opiec_record(triple_id=i)) + "\n")
        files.append(str(p))
    records, mentions, relations = pkg.corpus.extract_corpus_parallel(files, workers=3)
    assert len(records) == 3
    assert mentions["Barack_obama"][("Barack", "Obama")] == 3
    assert relations[("lives", "in")] == 3
    r1, m1, c1 = pkg.corpus.extract_corpus_parallel(files, workers=1)  # one worker: the same aggregates
    assert r1 == records and m1 == mentions and c1 == relations
    assert (records, mentions, relations) == JAX.corpus.extract_corpus_parallel(files, workers=1)


# ------------------------------------------------------------------ sample


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_evaluation_data(pkg, seed):
    triples = []
    for i in range(60):
        linked = ("E%d" % i, "F%d" % i) if i % 2 == 0 else (None, None)
        rel = ("r", "x", "y") if i % 3 == 0 else ("r",)
        triples.append((((f"s{i}",), rel, (f"o{i}",)), linked))
    v, vl, t = pkg.sampling.sample_evaluation_data(triples, eval_size=3, seed=seed)
    assert (v, vl, t) == JAX.sampling.sample_evaluation_data(triples, eval_size=3, seed=seed)
    assert len(v) == 3 and len(vl) == 3 and len(t) == 3
    assert not (set(v) & set(vl)) and not (set(vl) & set(t)) and not (set(v) & set(t))
    assert all(len(triples[i][0][1]) >= 3 for i in v + vl + t)  # all three want long relations
    assert all(triples[i][1][0] is not None and triples[i][1][1] is not None for i in vl + t)


# ---------------------------------------------------------------- mapping


def _write_open(tmp_path):
    train = tmp_path / "train_data_thorough.txt"
    train.write_text(
        "B O\tworks in\tN Y\tB O|||Barack Obama\tN Y|||New York\n"
        "Barack Obama\tlives in\tNew York\tB O|||Barack Obama\tN Y|||New York\n"
        "A Merkel\tleads\tGermany\tA Merkel\tGermany\n"
    )
    valid = tmp_path / "validation_data.txt"
    valid.write_text("Barack Obama\tworks in\tNew York\tB O|||Barack Obama\tN Y|||New York\n"
                     "zz qq\tworks in\tNew York\tzz qq\tN Y\n")  # all-unseen tokens: UNK mention, dropped
    return train, valid


def test_convert_open_dataset(pkg, tmp_path):
    train, valid = _write_open(tmp_path)
    out = tmp_path / "mapped"
    written = pkg.map_to_ids.convert_open_dataset(str(out), str(train), [str(valid)])
    assert written[str(out / "train_data_thorough.txt")] == 3
    assert written[str(out / "validation_data.txt")] == 1
    JAX.map_to_ids.convert_open_dataset(str(tmp_path / "jax"), str(train), [str(valid)])
    assert _files(out) == _files(tmp_path / "jax")
    # the output obeys the package's data-layer contract end to end
    ds = pkg.dataset.OneToNMentionRelationDataset(dataset_dir=str(out), input_file="train_data_thorough.txt",
                                                  is_training_data=True, batch_size=2)
    assert ds.meta.entity_token_ids is not None and len(ds.records) > 0
    line = (out / "validation_data.txt").read_text().strip().split("\t")
    assert len(line[3].split()) == 2  # two alternative subject mention ids


def test_convert_closed_dataset(pkg, tmp_path):
    for name, rows in (("train.txt", ["/m/1\t/film/actor\t/m/2", "/m/2\t/film/director\t/m/3"]),
                       ("valid.txt", ["/m/1\t/film/director\t/m/3"])):
        (tmp_path / name).write_text("\n".join(rows) + "\n")
    names = {"/m/1": "Tom Hanks", "/m/2": "Big", "/m/3": "Penny Marshall"}
    splits = [str(tmp_path / "train.txt"), str(tmp_path / "valid.txt")]
    out = tmp_path / "mapped"
    written = pkg.map_to_ids.convert_closed_dataset(str(out), splits, names)
    assert written[str(out / "train.txt")] == 2
    assert pkg.map_to_ids.tokenize_closed_relation("/film/actor_of.type") == ["film", "actor", "of", "type"]
    JAX.map_to_ids.convert_closed_dataset(str(tmp_path / "jax"), splits, names)
    assert _files(out) == _files(tmp_path / "jax")
    meta = pkg.dataset.load_meta(str(out))
    assert meta.entities_size >= 5  # 3 entities and the specials
    rec = pkg.dataset.OneToNMentionRelationDataset(dataset_dir=str(out), input_file="train.txt",
                                                   is_training_data=True, batch_size=2).records
    assert len(rec) == 4  # 2 triples x 2 directions
    assert all(len(g) == 1 for i in range(len(rec)) for g in rec.row_groups(i))  # columns 4/5 duplicated


# -------------------------------------------------------------------- avro


def test_zigzag_spec_vectors(pkg):
    for value, raw in ((0, b"\x00"), (-1, b"\x01"), (1, b"\x02"), (-2, b"\x03"), (2, b"\x04"), (-64, b"\x7f"),
                       (64, b"\x80\x01"), (-65, b"\x81\x01"), (2**40 + 3, JAX.avro._zigzag(2**40 + 3))):
        assert pkg.avro._zigzag(value) == raw, value
        assert pkg.avro._Reader(raw).read_long() == value


@pytest.mark.parametrize("records_per_block,copies", [(1000, 1), (4, 7)], ids=["one-block", "multi-block"])
def test_avro_roundtrip_and_bytes(pkg, records_per_block, copies):
    records = fixture_records() * copies
    buf, jbuf = io.BytesIO(), io.BytesIO()
    pkg.avro.writer(buf, SCHEMA, records, records_per_block=records_per_block)
    JAX.avro.writer(jbuf, SCHEMA, records, records_per_block=records_per_block)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    assert list(pkg.avro.reader(buf)) == records


def test_avro_deflate_codec_read(pkg):
    payload = io.BytesIO()
    for s in ("alpha", "beta"):
        pkg.avro._encode(payload, "string", s, {})
    compressed = zlib.compress(payload.getvalue())[2:-4]  # raw deflate
    sync = bytes(range(16))
    f = io.BytesIO()
    f.write(pkg.avro.MAGIC)
    meta = [("avro.schema", json.dumps("string").encode()), ("avro.codec", b"deflate")]
    f.write(pkg.avro._zigzag(len(meta)))
    for k, v in meta:
        f.write(pkg.avro._zigzag(len(k)) + k.encode() + pkg.avro._zigzag(len(v)) + v)
    f.write(pkg.avro._zigzag(0) + sync)
    f.write(pkg.avro._zigzag(2) + pkg.avro._zigzag(len(compressed)) + compressed + sync)
    f.seek(0)
    assert list(pkg.avro.reader(f)) == ["alpha", "beta"]


def test_avro_corrupt_sync_detected(pkg):
    buf = io.BytesIO()
    pkg.avro.writer(buf, "long", [1, 2, 3])
    raw = bytearray(buf.getvalue())
    raw[-1] ^= 0xFF  # a bit of the trailing sync marker
    with pytest.raises(ValueError, match="sync"):
        list(pkg.avro.reader(io.BytesIO(bytes(raw))))


def test_avro_fixture_extracts_and_regenerates(pkg, tmp_path):
    """The committed fixture parses, yields the one record the filters keep,
    and the package's writer regenerates it byte for byte."""
    with open(FIXTURE, "rb") as f:
        assert len(list(pkg.avro.reader(f))) == 3
    triples = list(pkg.corpus.iter_opiec_triples([FIXTURE]))
    assert triples == list(JAX.corpus.iter_opiec_triples([FIXTURE]))
    assert len(triples) == 1
    t = triples[0]
    assert (t["subject"], t["relation"], t["object"]) == (["Barack", "Obama"], ["visited"], ["Paris"])
    assert (t["subject_link"], t["object_link"]) == ("Barack_Obama", "Paris")
    assert t["sentence"] == ["Barack", "Obama", "visited", "Paris"]
    assert t["sentence_mask"] == ["[SUBJ]", "[SUBJ]", "[REL]", "[OBJ]"]
    out = tmp_path / "regen.avro"
    with open(out, "wb") as f:
        pkg.avro.writer(f, SCHEMA, fixture_records())
    assert out.read_bytes() == open(FIXTURE, "rb").read()


# ------------------------------------------------------------------- vocab


def test_vocab_collect_finalize_toidx(pkg):
    m = pkg.vocab.IndexMapper(segment=True, min_count=1)
    for t in ["new york", "new york", "berlin"]:
        m.collect(t)
    m.finalize()
    nyid, toks = m.toidx("new york")
    assert nyid >= 2 and toks[0] == pkg.vocab.BOS and toks[-1] == pkg.vocab.EOS and len(toks) == 4
    uid, utoks = m.toidx("paris france")
    assert uid == pkg.vocab.UNK and utoks[1] == utoks[2] == pkg.vocab.UNK


def test_vocab_min_count_and_frequency_order(pkg):
    m = pkg.vocab.IndexMapper(segment=True, min_count=2)
    for t in ("rare thing", "common", "common"):
        m.collect(t)
    m.finalize()
    assert m.item_id("common") != pkg.vocab.UNK and m.item_id("rare thing") == pkg.vocab.UNK
    m = pkg.vocab.IndexMapper(segment=False)
    for t in ["x"] * 5 + ["y"] * 10:
        m.collect(t)
    m.finalize()
    assert m.item_id("y") < m.item_id("x")


@pytest.mark.parametrize("kwargs", [dict(), dict(lowercase=True, max_vocab_size=3, min_count=1),
                                    dict(segment=False, insert_start=None, insert_end=None)],
                         ids=["default", "lowercase-capped", "items-only"])
def test_vocab_save_load_matches_jax(pkg, tmp_path, kwargs):
    """Ties broken in insertion order, the special ids, the three files of
    the on-disk contract byte for byte, and a load that gives the same
    mapping."""
    texts = ["a b", "c", "a b", "D e", "c", "f", "g h i", "F"]
    m, jm = pkg.vocab.IndexMapper(**kwargs), JAX.vocab.IndexMapper(**kwargs)
    for t in texts:
        m.collect(t)
        jm.collect(t)
    m.finalize()
    jm.finalize()
    assert m.state() == jm.state() and repr(m) == repr(jm)
    assert (m.item_vocab_size, m.segment_vocab_size) == (jm.item_vocab_size, jm.segment_vocab_size)
    m.save(str(tmp_path / "port"), "entity")
    jm.save(str(tmp_path / "jax"), "entity")
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    names = set(_files(tmp_path / "port"))
    assert "entity_id_map.txt" in names
    assert ("entity_token_id_map.txt" in names) == m.segment
    m2 = pkg.vocab.IndexMapper.load(str(tmp_path / "port"), "entity", **kwargs)
    assert m2.item_to_id == m.item_to_id and m2.segment_to_id == m.segment_to_id
    assert all(m2.toidx(t) == m.toidx(t) == jm.toidx(t) for t in texts + ["unseen"])
    assert np.all([pkg.vocab.PAD, pkg.vocab.UNK, pkg.vocab.BOS, pkg.vocab.EOS] == [0, 1, 2, 3])
