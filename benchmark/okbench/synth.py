"""The synthetic OLPBench-shaped dataset of a configuration, made once per
checkout from the configuration's data seed and read back by later runs.

A frozen copy of the repository's ``tools/make_synth_olpbench.py`` (numpy
only), so that a change to the program or its tools cannot move the
yardstick.  It writes the ``mapped_to_ids`` files the program reads
(5-column triple files, the six vocabulary maps) and, beside them, the same
data as arrays (``arrays.npz``) for the benchmark's own reference, traffic
and work counts: each mention's and relation's token row as the program's
``max_lengths_tuple`` lays it out (BOS and EOS around the body, zero padded,
ids 0 and 1 holding UNK alone), the training and test triples, and each
mention's alternative (0 for none).

Mention surface forms are token sequences drawn Zipf-ish from the token
vocabulary; ~30 % of mentions are paired into two-mention entities, so the
max-over-alternatives credit of the eval is exercised.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict

import numpy as np

UNK, BOS, EOS = 1, 2, 3
#: bumped when the files written change, so that a cached set is made anew
FORMAT = 2


def _tok_lines(n_items, vocab, max_body, rng):
    """Token-id sequences (without BOS/EOS) for ``n_items`` items."""
    lens = 1 + (rng.zipf(1.6, size=n_items) - 1) % max_body
    toks = 4 + ((rng.zipf(1.2, size=(n_items, max_body)) - 1) % (vocab - 4))
    return lens.astype(np.int64), toks.astype(np.int64)


def _write_map(path, ids, texts, counts):
    with open(path, "w") as f:
        f.write("# token\tid\tcount\t\n")
        f.writelines(f"{t}\t{i}\t{c}\n" for i, t, c in zip(ids, texts, counts))


def _token_rows(lens, toks, max_len):
    """[n + 2, max_len] int32: row ``i + 2`` holds BOS, the body, EOS, rows
    0 and 1 hold UNK alone, zero padded (a body of at most ``max_len - 2``
    tokens, so no row is cut)."""
    n, max_body = toks.shape
    if max_body + 2 > max_len:
        raise ValueError(f"bodies of up to {max_body} tokens do not fit rows of {max_len}")
    out = np.zeros((n + 2, max_len), np.int32)
    out[:2, 0] = UNK
    out[2:, 0] = BOS
    out[2:, 1 : 1 + max_body] = np.where(np.arange(max_body)[None, :] < lens[:, None], toks, 0)
    out[2 + np.arange(n), lens + 1] = EOS
    return out


def generate(outdir: Path, p: Dict) -> None:
    """Write the dataset of the generator parameters ``p`` into ``outdir``."""
    rng = np.random.default_rng(int(p["seed"]))
    outdir.mkdir(parents=True, exist_ok=True)
    M, R, max_body = int(p["mentions"]), int(p["relations"]), int(p["max_body_tokens"])
    m_lens, m_toks = _tok_lines(M, int(p["entity_tokens"]), max_body, rng)
    r_lens, r_toks = _tok_lines(R, int(p["relation_tokens"]), max_body, rng)

    def dump_vocab(prefix, n, lens, toks, tok_vocab):
        ids = np.arange(2, 2 + n)
        texts = [" ".join(f"t{t}" for t in toks[i, : lens[i]]) + f" #{i + 2}" for i in range(n)]
        _write_map(outdir / f"{prefix}_id_map.txt", ids, texts, 3 + (rng.zipf(1.5, size=n) - 1) % 1000)
        with open(outdir / f"{prefix}_id_tokens_ids_map.txt", "w") as f:
            f.write(f"# {prefix} id\ttokens\t\n")
            f.writelines(f"{i + 2}\t2 {' '.join(str(t) for t in toks[i, : lens[i]])} 3\n" for i in range(n))
        tok_ids = np.arange(4, tok_vocab)
        _write_map(outdir / f"{prefix}_token_id_map.txt", tok_ids, [f"t{t}" for t in tok_ids],
                   3 + (rng.zipf(1.5, size=len(tok_ids)) - 1) % 1000)

    dump_vocab("entity", M, m_lens, m_toks, int(p["entity_tokens"]))
    dump_vocab("relation", R, r_lens, r_toks, int(p["relation_tokens"]))

    # alternative mentions: ~30 % of mentions paired
    n_pair = int(0.3 * M) // 2 * 2
    paired = rng.permutation(M)[:n_pair] + 2
    partner = np.zeros(M + 2, np.int64)
    partner[paired[0::2]], partner[paired[1::2]] = paired[1::2], paired[0::2]

    def sample_triples(n):
        s = 2 + (rng.zipf(1.3, size=n) - 1) % M
        o = 2 + (rng.zipf(1.3, size=n) - 1) % M
        r = 2 + ((rng.zipf(1.1, size=n) - 1) % R)
        keep = s != o
        return s[keep], r[keep], o[keep]

    def alts(mid):
        return f"{mid} {partner[mid]}" if partner[mid] else f"{mid}"

    arrays = {}
    for name, n in (("train", int(p["train_triples"])), ("valid", int(p["eval_triples"])),
                    ("test", int(p["eval_triples"]))):
        s, r, o = sample_triples(int(n * 1.05))
        s, r, o = s[:n], r[:n], o[:n]
        with open(outdir / f"{name}.txt", "w") as f:
            f.writelines(f"{si}\t{ri}\t{oi}\t{alts(si)}\t{alts(oi)}\n" for si, ri, oi in zip(s, r, o))
        if name in ("train", "test"):
            arrays.update({f"{name}_s": s.astype(np.int32), f"{name}_r": r.astype(np.int32),
                           f"{name}_o": o.astype(np.int32)})
    max_len = int(p["max_len"])
    arrays.update(entity_tokens=_token_rows(m_lens, m_toks, max_len),
                  relation_tokens=_token_rows(r_lens, r_toks, max_len),
                  partner=partner.astype(np.int32))
    np.savez(outdir / "arrays.npz", **arrays)


def ensure(params: Dict, cache_root: Path) -> Path:
    """The dataset directory of ``params``, generated unless a complete one
    is there.  The directory is named by the parameters, so each set lives
    at a fixed path and a cached one is found by every later run."""
    key = "-".join(f"{k}{params[k]}" for k in sorted(params)) + f"-f{FORMAT}"
    outdir = cache_root / "data" / key
    done = outdir / "done.json"
    if done.exists():
        return outdir
    shutil.rmtree(outdir, ignore_errors=True)
    tmp = outdir.with_name(outdir.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    generate(tmp, params)
    (tmp / "done.json").write_text(json.dumps(params, sort_keys=True))
    os.replace(tmp, outdir)
    return outdir


def load_arrays(data_dir: Path) -> Dict[str, np.ndarray]:
    with np.load(data_dir / "arrays.npz") as z:
        return {k: z[k] for k in z.files}
