"""Token-composition embedders: the LSTM family, in train and eval mode.

Counterpart of ``open_knowledge_graph_embeddings_tpu/models/embedders.py``
limited to :class:`TokenEmbedderBase` (parameters, token buffers,
sparse-table padding) and :class:`LSTMEmbedder`.  Variables are a plain
nested dict of tensors, ``{"params", "state", "buffers"}``, with the JAX
package's names and shapes, so checkpoints cross over key for key
(train/checkpoint.py).

Encode pipeline of one row batch: token gather (:func:`token_gather_tm`,
whose backward is a scatter-add or the host-planned gather-sum) -> stable
descending-length sort -> fused last-state LSTM (the CUDA kernels on the
card) -> unsort -> [query dedup gather] -> batchnorm in f32 (batch
statistics in train mode) -> cast to the compute dtype -> dropout (train).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
from open_knowledge_graph_embeddings_tpu_torch.data.vocab import PAD
from open_knowledge_graph_embeddings_tpu_torch.ops.lstm import (
    init_lstm_params,
    length_sort_perm,
    lstm_last_fused,
)
from open_knowledge_graph_embeddings_tpu_torch.ops.norm import apply_batchnorm, init_batchnorm

Variables = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh}


def _table_rows(n: int, sparse: bool) -> int:
    """Table height; row-sparse tables are padded to a multiple of 8, as in
    the JAX package, so checkpoints load both ways.  The pad rows are never
    referenced by any id."""
    return -(-n // 8) * 8 if sparse else n


def _dropout(x: torch.Tensor, rate: float, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _pad_stop_gradient(emb: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Keep the PAD-token embedding values in the forward but drop their
    gradient (torch's ``padding_idx`` without a PAD-row fixup)."""
    return torch.where((toks == PAD)[..., None], emb.detach(), emb)


class _TokenGatherScatter(torch.autograd.Function):
    """``table[toks].to(cdtype)``; the backward scatter-adds the time-major
    cotangent into an f32 table gradient, PAD ids dropped (JAX ``_tg_scatter``)."""

    @staticmethod
    def forward(ctx, table, toks, cdtype):
        ctx.save_for_backward(toks)
        ctx.height = table.shape[0]
        return table[toks].to(cdtype)

    @staticmethod
    def backward(ctx, ct):
        (toks,) = ctx.saved_tensors
        d = ct.shape[-1]
        ids = toks.reshape(-1)
        keep = ids != PAD
        dtable = torch.zeros(ctx.height, d, dtype=torch.float32, device=ct.device)
        dtable.index_add_(0, ids[keep], ct.reshape(-1, d)[keep].float())
        return dtable, None, None


class _TokenGatherPlan(torch.autograd.Function):
    """``table[toks].to(cdtype)``; the backward is the host-planned
    gather-sum (JAX ``_tg_plan``): ``pos`` [S, K] flat time-major positions,
    ``valid`` [S, K], ``uid`` [S] target rows (out of range for padding
    slots).  Level 1 gathers and sums each slot's K cotangent rows in f32,
    level 2 scatter-adds only the slot sums."""

    @staticmethod
    def forward(ctx, table, toks, pos, valid, uid, cdtype):
        ctx.save_for_backward(pos, valid, uid)
        ctx.height = table.shape[0]
        return table[toks].to(cdtype)

    @staticmethod
    def backward(ctx, ct):
        pos, valid, uid = ctx.saved_tensors
        d = ct.shape[-1]
        g = ct.reshape(-1, d)[pos.reshape(-1)].reshape(*pos.shape, d).float()
        slot_sums = torch.where(valid[..., None], g, 0.0).sum(1)
        keep = uid < ctx.height
        dtable = torch.zeros(ctx.height, d, dtype=torch.float32, device=ct.device)
        dtable.index_add_(0, uid[keep], slot_sums[keep])
        return dtable, None, None, None, None, None


def token_gather_tm(
    table: torch.Tensor, toks_tm: torch.Tensor, cdtype, stop_pad_grad: bool = False, grad_plan=None
) -> torch.Tensor:
    """``table[toks_tm].to(cdtype)`` for time-major ``toks_tm`` [L, R].  The
    value is a plain gather; the backward is a scatter-add of the cotangent
    with PAD ids dropped, or, with ``grad_plan`` (train/sparse.py
    ``build_token_grad_plan``), the gather-sum over the host plan.
    ``stop_pad_grad`` also blocks the PAD positions in the forward value's
    gradient path."""
    if grad_plan is None:
        emb = _TokenGatherScatter.apply(table, toks_tm, cdtype)
    else:
        emb = _TokenGatherPlan.apply(
            table, toks_tm, grad_plan["pos"], grad_plan["valid"], grad_plan["uid"], cdtype
        )
    return _pad_stop_gradient(emb, toks_tm) if stop_pad_grad else emb


@dataclass
class TokenEmbedderBase:
    """Shared machinery of token-composition embedders."""

    meta: DatasetMeta = None
    entity_slot_size: int = 128
    relation_slot_size: Optional[int] = None
    sparse: bool = False
    init_std: float = 0.01
    normalize: Optional[str] = None
    dropout: float = 0.0
    entity_dropout: Optional[float] = None
    relation_dropout: Optional[float] = None
    project_relation: bool = False
    l2_reg: float = 0.0  # accepted for config parity; token models don't use it
    dtype: str = "float32"  # compute dtype of gathers and products (params stay f32)

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {self.dtype!r}")
        self._cdtype = _DTYPES[self.dtype]
        if self.relation_slot_size is None or self.relation_slot_size <= 0:
            self.relation_slot_size = self.entity_slot_size
        # reference: a falsy entity_dropout falls back to dropout
        self.entity_dropout = self.entity_dropout if self.entity_dropout else self.dropout
        self.relation_dropout = self.relation_dropout if self.relation_dropout else self.dropout
        if self.project_relation:
            raise NotImplementedError(
                "the relation projection (Tucker3 models) is not ported yet: ROADMAP Queue 1 item 11"
            )
        self.entity_dim = self.entity_slot_size
        self.relation_dim = self.relation_slot_size
        if self.meta.entity_token_ids is None:
            raise ValueError("dataset has no entity token map")

    def _init_base(self, generator: torch.Generator) -> Tuple[Dict, Dict, Dict]:
        device = generator.device

        def normal(*shape):
            return torch.empty(*shape, device=device).normal_(generator=generator) * self.init_std

        params: Dict[str, Any] = {
            "entity_token_embedding": normal(
                _table_rows(self.meta.entity_tokens_size, self.sparse), self.entity_slot_size
            ),
            "relation_token_embedding": normal(
                _table_rows(self.meta.relation_tokens_size, self.sparse), self.relation_slot_size
            ),
        }
        state: Dict[str, Any] = {}
        buffers = {
            "entity_token_ids": torch.from_numpy(self.meta.entity_token_ids).to(device),
            "relation_token_ids": torch.from_numpy(self.meta.relation_token_ids).to(device),
        }
        if self.normalize == "batchnorm":
            params["entity_bn"], state["entity_bn"] = init_batchnorm(
                self.entity_slot_size, uniform_weight=True, generator=generator, device=device
            )
            params["relation_bn"], state["relation_bn"] = init_batchnorm(
                self.relation_slot_size, uniform_weight=True, generator=generator, device=device
            )
        return params, state, buffers

    def _tokens(self, variables: Variables, ids: torch.Tensor, kind: str) -> torch.Tensor:
        return variables["buffers"][f"{kind}_token_ids"][ids]


@dataclass
class LSTMEmbedder(TokenEmbedderBase):
    """LSTM over token embeddings; representation = output at the last
    non-pad position."""

    encoder_activation: Optional[str] = None

    def init(self, generator: torch.Generator) -> Variables:
        """Random parameters on ``generator.device`` (the numbers differ from
        the JAX package's for the same seed)."""
        params, state, buffers = self._init_base(generator)
        params["entity_lstm"] = init_lstm_params(
            generator, self.entity_slot_size, self.entity_slot_size, generator.device
        )
        params["relation_lstm"] = init_lstm_params(
            generator, self.relation_slot_size, self.relation_slot_size, generator.device
        )
        return {"params": params, "state": state, "buffers": buffers}

    def _lstm_states_core(self, table, lstm, toks, plan) -> torch.Tensor:
        """Token gather + sort + fused last-state LSTM + unsort on a [R, L]
        token block -> raw [R, H].  Rows sorted by descending length make
        the rows active at step t a prefix, which lets the kernels skip
        finished rows; the gather-sum plan indexes this sorted time-major
        layout."""
        toks_tm = toks.t()  # [L, R]
        L = toks_tm.shape[0]
        lengths = (toks_tm > 0).sum(0)
        order, unsort = length_sort_perm(lengths, L)
        toks_tm = toks_tm[:, order]
        emb_tm = token_gather_tm(table, toks_tm, self._cdtype, grad_plan=plan)  # [L, R, d]
        x = lstm_last_fused(lstm, emb_tm, lengths[order])
        return x[unsort]

    def _lstm_states(self, variables, ids, kind, table_name, lstm_name, train=False) -> torch.Tensor:
        # the gather-sum plan rides in the buffers of a sparse train batch
        plan = variables["buffers"].get(f"{kind}_token_grad_plan") if train else None
        return self._lstm_states_core(
            variables["params"][table_name], variables["params"][lstm_name],
            self._tokens(variables, ids, kind), plan,
        )

    def _finish(self, variables, x, bn_name, dropout, train, generator):
        """Activation -> batchnorm (f32) -> dropout on raw LSTM states;
        batch statistics see exactly the rows in ``x``."""
        if self.encoder_activation:
            x = _ACTIVATIONS[self.encoder_activation.lower()](x)
        new_state = dict(variables["state"])
        if self.normalize == "batchnorm":
            y32, new_state[bn_name] = apply_batchnorm(
                variables["params"][bn_name], variables["state"][bn_name], x.float(), train
            )
            x = y32.to(self._cdtype)
        x = _dropout(x, dropout, train, generator)
        return x.to(self._cdtype), new_state, x.new_zeros((), dtype=torch.float32)

    def _compose(self, variables, ids, kind, dropout, train, generator, inv=None):
        # query dedup: the recurrence runs over unique rows; ``inv`` gathers
        # back to per-row BEFORE batchnorm and dropout
        x = self._lstm_states(variables, ids, kind, f"{kind}_token_embedding", f"{kind}_lstm", train)
        if inv is not None:
            x = x[inv]
        return self._finish(variables, x, f"{kind}_bn", dropout, train, generator)

    def encode_entity_pair(self, variables, ids_a, ids_b, *, train=False, generator=None, inv_b=None):
        """Encode two entity id batches through ONE token-gather + LSTM pass
        (rows of ``ids_a`` first); batchnorm and dropout still run per group,
        a first, so the numbers equal two ``encode_entity`` calls.  Returns
        ``(emb_a, emb_b, state, reg)``."""
        na = ids_a.shape[0]
        x = self._lstm_states(
            variables, torch.cat([ids_a, ids_b]), "entity", "entity_token_embedding", "entity_lstm", train
        )
        xa, state_a, reg_a = self._finish(variables, x[:na], "entity_bn", self.entity_dropout, train, generator)
        xb = x[na:]
        if inv_b is not None:
            xb = xb[inv_b]
        xb, state_b, reg_b = self._finish(
            {**variables, "state": state_a}, xb, "entity_bn", self.entity_dropout, train, generator
        )
        return xa, xb, state_b, reg_a + reg_b

    def encode_entity(self, variables, ids, *, is_sp=None, train=False, generator=None, inv=None):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "entity", self.entity_dropout, train, generator, inv)

    def encode_relation(self, variables, ids, *, train=False, generator=None, inv=None):
        """Relation rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "relation", self.relation_dropout, train, generator, inv)
