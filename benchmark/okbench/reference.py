"""Plain PyTorch reference of an LSTM-ComplEx training step: token rows ->
LSTM (torch gate order, zero initial state, the state at each row's last
token) -> batchnorm over the encode's rows -> dropout -> ComplEx query ->
scores against the candidates -> BCE over the real cells, divided by the
batch's cell count -> Adagrad (additive weight decay, the dense update of a
table or, for a table the configuration makes row-sparse, the update of the
rows the batch touches).

It imports nothing of the program and takes nothing the program made: the
weights come from :func:`okbench.params.make_params` with the run's seed,
the token rows from the benchmark's own dataset arrays, the dropout masks
from a generator seeded as the configuration's seed says, in the encode
order candidates, query entities, relations.  From the program's batches
it takes each step's sample (its rows, candidate ids and positive cells),
which :mod:`okbench.labels` checks against the training triples on its own.

``precision`` selects the control: ``fp8`` rounds the operands of every
product, forward and backward, to float8 (e4m3), ``tf32`` to TF32's 10-bit
mantissa; the products still accumulate in f32.  ``fault`` plants one of the faults the comparison has
to catch (``half_batch``, ``token``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from okbench.params import leaves, nest

#: Adagrad's epsilon (torch's default), the configuration's lr_decay is 0
ADAGRAD_EPS = 1e-10
#: rows a sparse plan's unique-row count is bucketed to at least
UID_BUCKET_MIN = 256
#: the token tables (leaf paths), which the configuration may make row-sparse
TOKEN_TABLES = ("entity_token_embedding", "relation_token_embedding")


def next_bucket(n: int, minimum: int) -> int:
    b = max(minimum, 1)
    while b < n:
        b <<= 1
    return b


def lower(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to float8 (e4m3) or to TF32's 10-bit mantissa (both to
    nearest)."""
    if kind == "fp8":
        return x.to(torch.float8_e4m3fn).to(x.dtype)
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Round(torch.autograd.Function):
    """A product's operand rounded to a lower precision on the way in (the
    gradient passes through)."""

    @staticmethod
    def forward(ctx, x, kind):
        return lower(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """A product's output, whose incoming gradient is rounded to the lower
    precision before the backward products read it."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return x

    @staticmethod
    def backward(ctx, g):
        return lower(g, ctx.kind), None


def lstm_last(table, lstm, toks, mm):
    """[R, L] token rows -> [R, H]: an LSTM (torch gate order, two biases,
    zero initial state) over each row's tokens, its state at the row's last
    token; ``mm`` takes the products."""
    lengths = (toks > 0).sum(1)
    R, H = toks.shape[0], lstm["w_hh"].shape[1]
    h = c = out = torch.zeros(R, H, device=table.device)
    bias = lstm["b_ih"] + lstm["b_hh"]
    for t in range(int(lengths.max())):
        gates = mm(table[toks[:, t]], lstm["w_ih"].t()) + mm(h, lstm["w_hh"].t()) + bias
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out = torch.where((lengths == t + 1)[:, None], h, out)
    return out


def complex_query(e, r, is_sp):
    """ComplEx query vectors: ``e * r`` for sp rows, ``e * conj(r)`` for po
    rows, as complex numbers of the vectors' two halves."""
    e1, e2 = e.chunk(2, dim=1)
    r1, r2 = r.chunk(2, dim=1)
    r2 = r2 * torch.where(is_sp, 1.0, -1.0)[:, None]
    return torch.cat([e1 * r1 - e2 * r2, e2 * r1 + e1 * r2], dim=1)


def products(precision: str):
    """``a @ b`` in f32, or in the control's precision: the operands of the
    forward and of both backward products rounded."""
    if precision == "f32":
        return torch.matmul

    def mm(a, b):
        return _RoundGrad.apply(_Round.apply(a, precision) @ _Round.apply(b, precision), precision)

    return mm


class TrainReference:
    """Runs the steps of :meth:`run` on ``device`` in f32 (TF32 off)."""

    def __init__(self, arrays: Dict[str, np.ndarray], spec: Dict, device, precision: str = "f32",
                 fault: Optional[str] = None):
        """``spec``: the configuration's ``run`` section (the model, the data
        and the optimizer as the configuration states them)."""
        self.device = torch.device(device)
        self.ent_tokens = torch.from_numpy(arrays["entity_tokens"]).long().to(self.device)
        self.rel_tokens = torch.from_numpy(arrays["relation_tokens"]).long().to(self.device)
        mc = spec["model_config"]
        self.dropout = float(mc.get("dropout") or 0.0)
        opt = spec["optimization_config"]
        self.lr, self.wd = float(opt["lr"]), float(opt.get("weight_decay") or 0.0)
        tdc = spec["train_data_config"]
        batch_shared = bool(tdc.get("use_batch_shared_entities"))
        sparse = bool(mc.get("sparse"))
        self.sparse_tables = {"entity_token_embedding": sparse and batch_shared,
                              "relation_token_embedding": sparse}
        self.min_ratio = float(spec.get("sparse_min_ratio", 12.0))
        self.heights = {"entity_token_embedding": int(self.ent_tokens.max()) + 1,
                        "relation_token_embedding": int(self.rel_tokens.max()) + 1}
        self._mm = products(precision)
        self.fault = fault

    # ---------------------------------------------------------------- model

    def _lstm(self, table, lstm, toks):
        return lstm_last(table, lstm, toks, self._mm)

    def _finish(self, x, bn, gen):
        """Batchnorm over the rows of ``x`` (biased variance, eps 1e-5), then
        inverted dropout with a mask drawn from ``gen``."""
        mean = x.mean(0)
        var = x.var(0, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + 1e-5) * bn["scale"] + bn["bias"]
        if self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.rand(y.shape, generator=gen, device=self.device) < keep
            y = torch.where(mask, y / keep, torch.zeros((), device=self.device))
        return y

    def loss(self, p, b, gen):
        """The batch's mean BCE per real cell; ``b`` holds device tensors."""
        ent_toks = self.ent_tokens[b["ent_ids"]]
        if self.fault == "token":  # every query mention's first body token altered
            first = ent_toks[:, 1]
            height = self.heights["entity_token_embedding"]
            ent_toks = ent_toks.clone()
            ent_toks[:, 1] = torch.where(first >= 4, 4 + (first - 3) % (height - 4), first)
        cand_ids = b["candidate_ids"]
        cand = self._finish(self._lstm(p["entity_token_embedding"], p["entity_lstm"], self.ent_tokens[cand_ids]),
                            p["entity_bn"], gen)
        e = self._finish(self._lstm(p["entity_token_embedding"], p["entity_lstm"], ent_toks), p["entity_bn"], gen)
        r = self._finish(self._lstm(p["relation_token_embedding"], p["relation_lstm"],
                                    self.rel_tokens[b["rel_ids"]]), p["relation_bn"], gen)
        s = self._mm(complex_query(e, r, b["is_sp"]), cand.t())
        row_valid, normalizer = b["row_valid"], b["normalizer_loss"]
        pos_rows, pos_cols = b["pos_rows"], b["pos_cols"]
        if self.fault == "half_batch":  # the second half of the rows left out, the mean over the rest
            half = row_valid.shape[0] // 2
            row_valid = row_valid & (torch.arange(row_valid.shape[0], device=self.device) < half)
            keep = pos_rows < half
            pos_rows, pos_cols = pos_rows[keep], pos_cols[keep]
            normalizer = normalizer * row_valid.sum() / b["row_valid"].sum()
        mask = row_valid[:, None] & b["col_valid"][None, :]
        per_cell = torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs()))
        loss_sum = torch.where(mask, per_cell, 0.0).sum() - s[pos_rows, pos_cols].sum()
        return loss_sum / normalizer

    # ------------------------------------------------------------ optimizer

    def _touched(self, name, b):
        """The table rows a step's row-sparse update covers (every token of
        the encoded rows, PAD included), or None where the table takes the
        dense update: where it is not row-sparse, or where its height is
        under ``sparse_min_ratio`` times the bucketed row count."""
        if not self.sparse_tables[name]:
            return None
        if name == "entity_token_embedding":
            toks = self.ent_tokens[torch.cat([b["ent_ids"], b["candidate_ids"]])]
        else:
            toks = self.rel_tokens[b["rel_ids"]]
        rows = torch.unique(torch.cat([toks.reshape(-1), toks.new_zeros(1)]))
        if self.heights[name] < self.min_ratio * next_bucket(rows.numel(), UID_BUCKET_MIN):
            return None
        return rows

    def _adagrad(self, p, g, acc, rows):
        """In place; returns the gradient as the update takes it."""
        if rows is None:
            g = g + self.wd * p
            acc += g * g
            p -= self.lr * g / (acc.sqrt() + ADAGRAD_EPS)
            return g
        g = g[rows] + self.wd * p[rows]
        a = acc[rows] + g * g
        acc[rows] = a
        p[rows] = p[rows] - self.lr * g / (a.sqrt() + ADAGRAD_EPS)
        return g

    # ------------------------------------------------------------------ run

    def run(self, params: Dict, batches: List[Dict], seed: int, acc: Optional[Dict] = None,
            gen_state: Optional[torch.Tensor] = None) -> Dict:
        """Train ``params`` (f32 leaves on the device, updated in place) on
        ``batches`` from the Adagrad sums ``acc`` (zero where None) with
        dropout masks drawn from a generator seeded with ``seed`` (or set to
        ``gen_state``) -> ``{"loss": [per step], "grad": {leaf: norm of the
        first step's gradient as Adagrad takes it}, "rows": {token table:
        [rows] norms of that gradient's rows}, "growth": {leaf: root of the
        Adagrad sums' growth over the steps}, "growth_rows": {token table:
        [rows] the same by row}, "change": {leaf: norm of the parameters'
        change over the steps}}``."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            gen = torch.Generator(device=self.device)
            if gen_state is None:
                gen.manual_seed(seed)
            else:
                gen.set_state(gen_state)
            flat = dict(leaves(params))
            start = {k: v.detach().clone() for k, v in flat.items()}
            acc = {k: torch.zeros_like(v) for k, v in flat.items()} if acc is None else dict(leaves(acc))
            acc0 = {k: a.clone() for k, a in acc.items()}
            out = {"loss": [], "grad": {}, "rows": {}, "growth": {}, "growth_rows": {}, "change": {}}
            for i, b in enumerate(batches):
                grads_of = {k: v.detach().requires_grad_() for k, v in flat.items()}
                loss = self.loss(nest(grads_of), b, gen)
                loss.backward()
                out["loss"].append(float(loss.detach()))
                with torch.no_grad():
                    for k, v in flat.items():
                        table = k if k in self.sparse_tables else None
                        rows = self._touched(table, b) if table else None
                        grad = grads_of[k].grad if grads_of[k].grad is not None else torch.zeros_like(v)
                        g = self._adagrad(v, grad, acc[k], rows)
                        if i == 0:
                            out["grad"][k] = float(g.double().norm())
                            if table:
                                out["rows"][k] = row_norms(g, rows, v.shape[0])
            for k, v in flat.items():
                out["change"][k] = float((v - start[k]).double().norm())
                grown = (acc[k] - acc0[k]).double()
                out["growth"][k] = float(grown.sum().clamp_min(0).sqrt())
                if k in self.sparse_tables:
                    out["growth_rows"][k] = grown.sum(1).clamp_min(0).sqrt().cpu().numpy()
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def row_norms(g: torch.Tensor, rows: Optional[torch.Tensor], height: int) -> np.ndarray:
    """[height] f64 norms of a table gradient's rows (``g`` holds only the
    rows ``rows`` where that is not None; other rows are zero)."""
    norms = g.double().square().sum(1).sqrt()
    if rows is None:
        return norms.cpu().numpy()
    out = torch.zeros(height, dtype=torch.float64, device=g.device)
    out[rows] = norms
    return out.cpu().numpy()


class ServeReference:
    """Plain eval-mode scoring of the served model: every entity's
    candidate vector, query vectors, and the top-k of a query over all of
    them.  Batchnorm normalizes by its running statistics, which serving
    finds as the configuration initialises them (mean 0, variance 1); no
    dropout.  In f32 with TF32 off, or in the control's precision."""

    def __init__(self, arrays: Dict[str, np.ndarray], device, precision: str = "f32", rows: int = 65536):
        self.device = torch.device(device)
        self.ent_tokens = torch.from_numpy(arrays["entity_tokens"]).long().to(self.device)
        self.rel_tokens = torch.from_numpy(arrays["relation_tokens"]).long().to(self.device)
        self._mm = products(precision)
        self.rows = rows

    def _encode(self, p, kind, ids):
        bn = p[f"{kind}_bn"]
        toks = (self.ent_tokens if kind == "entity" else self.rel_tokens)[ids]
        x = lstm_last(p[f"{kind}_token_embedding"], p[f"{kind}_lstm"], toks, self._mm)
        return x / (1.0 + 1e-5) ** 0.5 * bn["scale"] + bn["bias"]

    @torch.no_grad()
    def cache(self, p, first: int = 2) -> torch.Tensor:
        """[E - first, d] f32: the entities from id ``first`` on, encoded in
        blocks of rows."""
        n = self.ent_tokens.shape[0]
        return torch.cat([self._encode(p, "entity", torch.arange(i, min(i + self.rows, n), device=self.device))
                          for i in range(first, n, self.rows)])

    @torch.no_grad()
    def queries(self, p, ent_ids, rel_ids, is_sp) -> torch.Tensor:
        return complex_query(self._encode(p, "entity", ent_ids), self._encode(p, "relation", rel_ids), is_sp)

    @torch.no_grad()
    def topk(self, q, cache, k: int, chunk: int = 131072):
        """(scores, columns) of each query's ``k`` best candidates."""
        best_s = torch.full((q.shape[0], k), float("-inf"), device=self.device)
        best_c = torch.zeros((q.shape[0], k), dtype=torch.long, device=self.device)
        for c0 in range(0, cache.shape[0], chunk):
            s, c = torch.topk(self._mm(q, cache[c0 : c0 + chunk].t()), min(k, cache.shape[0] - c0), dim=1)
            best_s, pos = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
            best_c = torch.gather(torch.cat([best_c, c + c0], 1), 1, pos)
        return best_s, best_c

    @torch.no_grad()
    def scores_of(self, q, cache, cols) -> torch.Tensor:
        """[B, k] f32 scores of the candidate columns ``cols`` [B, k]."""
        return torch.einsum("bd,bkd->bk", q, cache[cols])
