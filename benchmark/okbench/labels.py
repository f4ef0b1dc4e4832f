"""The stage the reference takes from the program's batches, checked on its
own: every positive cell of a step is a training fact, and a prefix whose
answers are not split over several examples (at most
``max_size_prefix_label`` answer lines) has every answer mention among its
positives.

A fact of an sp row ``(s, r)`` is each mention alternative of the object of
a training line ``s r o``; of a po row ``(r, o)`` each alternative of the
subject.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _key(direction, ent, rel, m=None):
    k = (direction.astype(np.int64) << 62) | (ent.astype(np.int64) << 38) | (rel.astype(np.int64) << 22)
    return k if m is None else k | m.astype(np.int64)


class Facts:
    def __init__(self, arrays: Dict[str, np.ndarray]):
        s, r, o, partner = arrays["train_s"], arrays["train_r"], arrays["train_o"], arrays["partner"]
        if max(len(partner), int(r.max()) + 1) >= 1 << 22 or int(r.max()) >= 1 << 16:
            raise ValueError("ids too large for the fact keys")
        keys, prefixes = [], []
        for d, ent, ans in ((0, s, o), (1, o, s)):
            dd = np.full(len(ent), d)
            prefixes.append(_key(dd, ent, r))
            alt = partner[ans]
            keys += [_key(dd, ent, r, ans), _key(dd[alt > 0], ent[alt > 0], r[alt > 0], alt[alt > 0])]
        self.facts = np.unique(np.concatenate(keys))
        pk, self.lines = np.unique(np.concatenate(prefixes), return_counts=True)
        self.prefixes = pk
        # distinct answer mentions a prefix has
        self.n_answers = np.bincount(np.searchsorted(pk, self.facts & ~np.int64((1 << 22) - 1)), minlength=len(pk))

    def check(self, batch, min_entity: int, max_lines: int) -> List[str]:
        """The faults found in one program batch (empty when its positives
        are sound)."""
        n = batch.num_rows
        pos = batch.pos_rows >= 0
        rows, cols = batch.pos_rows[pos].astype(np.int64), batch.pos_cols[pos].astype(np.int64)
        ments = cols + min_entity if batch.candidate_ids is None else batch.candidate_ids[cols]
        d = (~batch.is_sp[rows]).astype(np.int64)
        keys = _key(d, batch.ent_ids[rows], batch.rel_ids[rows], ments)
        at = np.minimum(np.searchsorted(self.facts, keys), len(self.facts) - 1)
        found = self.facts[at] == keys
        bad = []
        if not found.all():
            bad.append(f"{int((~found).sum())} of {len(keys)} positive cells are no training fact")
        if np.any(rows >= n) or np.any(~batch.row_valid[rows]):
            bad.append("positive cells on padding rows")
        if batch.candidate_ids is not None and np.any(cols >= batch.num_cols):
            bad.append("positive cells on padding columns")
        pk = _key((~batch.is_sp[:n]).astype(np.int64), batch.ent_ids[:n], batch.rel_ids[:n])
        idx = np.searchsorted(self.prefixes, pk)
        idx[idx >= len(self.prefixes)] = 0
        known = self.prefixes[idx] == pk
        if not known.all():
            bad.append(f"{int((~known).sum())} rows hold no training prefix")
        whole = known & ((max_lines <= 0) | (self.lines[idx] <= max_lines))
        got = np.bincount(rows, minlength=n)[:n]
        short = whole & (got != self.n_answers[idx])
        if short.any():
            bad.append(f"{int(short.sum())} rows miss answer mentions or hold extra ones")
        return bad
