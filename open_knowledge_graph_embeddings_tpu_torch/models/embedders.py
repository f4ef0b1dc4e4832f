"""Entity and relation embedders: lookup tables and token-composition
encoders, in train and eval mode.

Counterpart of ``open_knowledge_graph_embeddings_tpu/models/embedders.py``,
all four families:

* :class:`LookupEmbedder`: per-id tables, encoded by input dropout ->
  batchnorm -> projection and activation -> l2 norm -> dropout, with the
  cubic-abs regularizer in train mode;
* :class:`UnigramPoolingEmbedder`: sum, mean or max over the token
  embeddings (sum includes the PAD vectors, as the reference does);
* :class:`BigramPoolingEmbedder`: a width-2 convolution over the token
  embeddings, batchnorm over its positions (cumulative statistics), a gated
  or residual mix, masked pooling;
* :class:`LSTMEmbedder`: token gather (:func:`token_gather_tm`, whose
  backward is a scatter-add or the host-planned gather-sum) -> the LSTM,
  fused or unfused by JAX's rule (``ops/lstm.py::lstm_fused_supported``):
  the fused path sorts the rows by descending length and runs the
  last-state kernels, the unfused path projects the inputs and runs the
  recurrence over every row and step, then selects each row's last state
  -> unsort -> [query dedup gather] -> batchnorm in f32 -> [relation
  projection] -> dropout.

The token families share :class:`TokenEmbedderBase` (token tables and
buffers, sparse-table padding, the relation projection of the Tucker3
models).  Variables are a plain nested dict of tensors, ``{"params",
"state", "buffers"}``, with the JAX package's names and shapes, so
checkpoints cross over key for key (train/checkpoint.py).  Every product of
a compute-dtype operand accumulates in f32 and rounds once to the compute
dtype where the JAX package does (``preferred_element_type=float32``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
from open_knowledge_graph_embeddings_tpu_torch.data.vocab import PAD
from open_knowledge_graph_embeddings_tpu_torch.ops.lstm import (
    init_lstm_params,
    last_states,
    length_sort_perm,
    lstm_forward_tm,
    lstm_fused_supported,
    lstm_last_fused,
)
from open_knowledge_graph_embeddings_tpu_torch.ops.norm import apply_batchnorm, init_batchnorm

Variables = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` op by op in ``x``'s dtype: XLA's expansion of
    ``jax.nn.sigmoid``, whose bf16 result rounds after each op (torch's
    sigmoid rounds once, and differs from it in 30 % of bf16 values)."""
    return 1 / (1 + torch.exp(-x))


# jax.nn's activations by their lower-case names (gelu: jax.nn's default tanh form)
_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": _sigmoid,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "elu": torch.nn.functional.elu,
    "leaky_relu": torch.nn.functional.leaky_relu,
}


def _activation(name: Optional[str]):
    """The activation a config names (``ReLU``, ``Tanh``, ``LeakyReLU`` ...),
    or None."""
    if not name:
        return None
    return _ACTIVATIONS[{"LeakyReLU": "leaky_relu"}.get(name, name.lower())]


def _compute_dtype(dtype: str) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
    return _DTYPES[dtype]


def params_device(variables: Variables) -> torch.device:
    """The device the parameters live on (a lookup model has no buffers)."""
    node = variables["params"]
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.device


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` over the last axis (torch ``normalize``
    semantics), the norm rounded where the JAX package's ``jnp.linalg.norm``
    rounds it: squares and their sum in f32, the sum rounded to ``x``'s
    dtype, then the square root in that dtype."""
    return x / (x.float() * x.float()).sum(-1, keepdim=True).to(x.dtype).sqrt().clamp_min(eps)


def _xavier_normal(generator: torch.Generator, fan_out: int, fan_in: int) -> torch.Tensor:
    std = (2.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty(fan_out, fan_in, device=generator.device).normal_(generator=generator) * std


def _cubic_abs_reg(x: torch.Tensor, l2_reg: float, dropout: float) -> torch.Tensor:
    """``l2_reg * sum(|x'|^3)`` with the reference's dropout quirk: ``x' = x
    / dropout`` when the dropout rate is above 0."""
    if dropout > 0:
        x = x / dropout
    return l2_reg * (x.abs() ** 3).sum()


def _product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32 (operands of the compute dtype widened
    exactly); autograd rounds the operands' gradients back to their dtype
    after an f32 product, as JAX's transpose of the product does."""
    return torch.matmul(x.float(), w.float())


def _table_rows(n: int, sparse: bool) -> int:
    """Table height; row-sparse tables are padded to a multiple of 8, as in
    the JAX package, so checkpoints load both ways.  The pad rows are never
    referenced by any id."""
    return -(-n // 8) * 8 if sparse else n


def _dropout(x, rate: float, train: bool, generator: Optional[torch.Generator], block=None):
    """Inverted dropout with the mask drawn from ``generator``; a list of
    tensors of one shape takes one mask (JAX draws each from the same key).
    With a candidate ``block`` (``x`` holds its rows), the mask of all the
    block's ``n`` rows is drawn and the block's rows kept, so every rank
    draws the stream of one process."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    xs = x if isinstance(x, list) else [x]
    shape = xs[0].shape if block is None else (block.n, *xs[0].shape[1:])
    mask = torch.rand(shape, generator=generator, device=xs[0].device) < keep
    if block is not None:
        mask = mask[block.lo : block.hi]
    out = [torch.where(mask, v / keep, torch.zeros((), dtype=v.dtype, device=v.device)) for v in xs]
    return out if isinstance(x, list) else out[0]


def _bn_group(block, per_row: int = 1) -> Dict[str, Any]:
    """The batchnorm keywords of a candidate block: statistics over the
    ``n * per_row`` rows of every rank's block of its group."""
    return {} if block is None else {"group": block.group, "n_total": block.n * per_row}


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
        # PAD ids land in a spare row that is cut off (no boolean-mask
        # indexing: its host sync would break a CUDA graph's capture)
        dtable = torch.zeros(ctx.height + 1, d, dtype=torch.float32, device=ct.device)
        dtable.index_add_(0, torch.where(ids != PAD, ids, ctx.height), ct.reshape(-1, d).float())
        return dtable[: ctx.height], None, None


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
        # padding slots land in a spare row that is cut off
        dtable = torch.zeros(ctx.height + 1, d, dtype=torch.float32, device=ct.device)
        dtable.index_add_(0, torch.clamp(uid, max=ctx.height), slot_sums)
        return dtable[: ctx.height], None, None, None, None, None


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


class _RowShardContext:
    """The mesh of ranks (models/model.py ``set_mesh``) and the encode-region
    context that the model sets around each encode of a step on a mesh: a
    mesh and axis whose ranks each encode a block of the rows, the
    gather-sum plan key that region reads (the candidate and the query
    plans differ), and, for the candidate region of a model axis, the
    ``block`` of the candidate rows this rank keeps (a
    ``parallel.sharding.RowBlock``).

    Over ``data`` only a sequence core (the LSTM) splits its rows and the
    blocks are gathered; everything else runs whole on every rank.  In a
    candidate block the encode returns the block's rows only: the core runs
    on the block, batchnorm takes its statistics over the block's group and
    dropout keeps the block's rows of the whole mask.

    Rows of a row-sharded table (one named in ``variables["slabs"]``) are
    read through the boundary gather (``parallel.distributed``) over the
    model group: a lookup table's ids directly, a token table's as the
    unique tokens of the encode's rows, remapped (:meth:`_compact`)."""

    def set_mesh(self, mesh) -> None:
        self._mesh = mesh

    def set_row_shard_ctx(self, mesh, axis, plan_key: Optional[str] = None, block=None) -> None:
        self._row_shard_ctx = None if mesh is None else (mesh, axis)
        self._plan_key_override = plan_key
        self._block = block

    def _model_group(self):
        from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import MODEL_AXIS

        mesh = getattr(self, "_mesh", None)
        return None if mesh is None else mesh.group(MODEL_AXIS)

    def _rows(self, variables, name: str, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` of the parameter ``name``, by the boundary gather
        when this rank holds a slab of it."""
        table = variables["params"][name]
        slab = (variables.get("slabs") or {}).get(name)
        if slab is None:
            return table[ids]
        from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import boundary_gather

        return boundary_gather(table, ids, slab[0], self._model_group())

    def _compact(self, variables, name: str, toks: torch.Tensor):
        """``(table, toks)`` to gather token rows from: the parameter and the
        ids themselves, or for a slab the unique tokens' rows (PAD first, as
        compact row 0) and the ids remapped into them."""
        table = variables["params"][name]
        if (variables.get("slabs") or {}).get(name) is None:
            return table, toks
        uniq, inv = torch.unique(torch.cat([toks.new_zeros(1), toks.reshape(-1)]), return_inverse=True)
        return self._rows(variables, name, uniq), inv[1:].view_as(toks)


@dataclass
class LookupEmbedder(_RowShardContext):
    """Per-id embedding tables.  ``project_relation`` projects the relation
    embedding to ``entity_slot_size ** 2`` (the Tucker3 core);
    ``project_entity`` adds subject and object linear maps, chosen per row
    by ``is_sp`` (candidates take the object map)."""

    meta: DatasetMeta = None
    entity_slot_size: int = 128
    relation_slot_size: Optional[int] = None
    entity_embedding_size: Optional[int] = None
    relation_embedding_size: Optional[int] = None
    normalize: str = ""
    dropout: float = 0.0
    input_dropout: float = 0.0
    relation_dropout: Optional[float] = None
    relation_input_dropout: Optional[float] = None
    project_entity: bool = False
    project_entity_activation: Optional[str] = "ReLU"
    project_relation: bool = False
    project_relation_activation: Optional[str] = None
    sparse: bool = False
    init_std: float = 0.01
    batch_norm: bool = False
    l2_reg: float = 0.0
    dtype: str = "float32"  # compute dtype of gathers and products (params stay f32)

    def __post_init__(self):
        self._cdtype = _compute_dtype(self.dtype)
        if self.relation_slot_size is None or self.relation_slot_size <= 0:
            self.relation_slot_size = self.entity_slot_size
        self._entity_emb_size = self.entity_embedding_size or self.entity_slot_size
        self._relation_emb_size = self.relation_embedding_size or self.relation_slot_size
        if self.relation_dropout is None:
            self.relation_dropout = self.dropout
        if self.relation_input_dropout is None:
            self.relation_input_dropout = self.input_dropout
        self.entity_dim = self.entity_slot_size
        self.relation_dim = self.entity_slot_size ** 2 if self.project_relation else self._relation_emb_size

    def init(self, generator: torch.Generator) -> Variables:
        """Random parameters on ``generator.device`` (the numbers differ from
        the JAX package's for the same seed)."""
        device = generator.device

        def normal(*shape):
            return torch.empty(*shape, device=device).normal_(generator=generator) * self.init_std

        params: Dict[str, Any] = {
            "entity_embedding": normal(_table_rows(self.meta.entities_size, self.sparse), self._entity_emb_size),
            "relation_embedding": normal(_table_rows(self.meta.relations_size, self.sparse),
                                         self._relation_emb_size),
        }
        state: Dict[str, Any] = {}
        d = self.entity_slot_size
        if self.project_relation:
            params["relation_projection"] = {"w": _xavier_normal(generator, d * d, self._relation_emb_size)}
        if self.project_entity:
            params["subj_projection"] = {"w": _xavier_normal(generator, d, d)}
            params["obj_projection"] = {"w": _xavier_normal(generator, d, d)}
        if self.batch_norm:
            params["bn_e"], state["bn_e"] = init_batchnorm(self._entity_emb_size, device=device)
            params["bn_r"], state["bn_r"] = init_batchnorm(self._relation_emb_size, device=device)
        return {"params": params, "state": state, "buffers": {}}

    def _encode(self, variables, x, bn_name, proj_names, proj_act, input_dropout, dropout, train, generator,
                block=None):
        """input dropout -> batchnorm (f32) -> each projection (f32 product,
        one rounding) and its activation -> l2 norm -> dropout -> the
        cubic-abs regularizer (train mode).  Several projections give a list.
        ``x`` may be a candidate ``block``'s rows (:class:`_RowShardContext`)."""
        params, state = variables["params"], variables["state"]
        new_state = dict(state)
        x = _dropout(x, input_dropout, train, generator, block)
        if self.batch_norm and bn_name is not None:
            y32, new_state[bn_name] = apply_batchnorm(params[bn_name], state[bn_name], x.float(), train,
                                                      **_bn_group(block))
            x = y32.to(x.dtype)
        if proj_names:
            act = _activation(proj_act)
            projected = []
            for name in proj_names:
                y = _product_f32(x, params[name]["w"].to(x.dtype).t()).to(x.dtype)
                projected.append(act(y) if act else y)
            x = projected[0] if len(projected) == 1 else projected
        if self.normalize == "norm":
            x = [_l2_normalize(v) for v in x] if isinstance(x, list) else _l2_normalize(x)
        x = _dropout(x, dropout, train, generator, block)
        reg = torch.zeros((), device=params_device(variables))
        if train and self.l2_reg > 0:
            for v in x if isinstance(x, list) else [x]:
                reg = reg + _cubic_abs_reg(v, self.l2_reg, self.dropout)
        return x, new_state, reg

    def encode_entity(self, variables, ids, *, is_sp=None, train=False, generator=None):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``; in a
        candidate block, the block's rows of them."""
        x = self._rows(variables, "entity_embedding", ids).to(self._cdtype)
        block = getattr(self, "_block", None)
        if block is not None:
            x = x[block.lo : block.hi]
            is_sp = None if is_sp is None else is_sp[block.lo : block.hi]
        return self._encode_entity_repr(variables, x, is_sp, train, generator, block)

    def encode_entity_rows(self, variables, rows, *, is_sp=None, train=False, generator=None):
        """Encode raw table rows [R, d] through the entity pipeline."""
        return self._encode_entity_repr(variables, rows, is_sp, train, generator)

    def encode_entity_range(self, variables, start: int, stop: int, *, train=False, generator=None):
        """The entities ``start:stop`` as a slice of the table: the values
        of ``encode_entity(arange(start, stop))``, but the backward pads the
        cotangent with zeros instead of scatter-adding (stop - start) rows.
        In a candidate block, the block's entities, read from this rank's
        slab (the model takes the block inside it)."""
        block = getattr(self, "_block", None)
        if block is not None:
            start, stop = start + block.lo, start + block.hi
        slab = (variables.get("slabs") or {}).get("entity_embedding")
        if slab is not None:
            if block is None or start < slab[0] or stop > slab[1]:
                raise ValueError(f"entities {start}:{stop} are not all in this rank's slab {slab[:2]}")
            start, stop = start - slab[0], stop - slab[0]
        x = variables["params"]["entity_embedding"][start:stop].to(self._cdtype)
        return self._encode_entity_repr(variables, x, None, train, generator, block)

    def _encode_entity_repr(self, variables, x, is_sp, train, generator, block=None):
        bn = "bn_e" if self.batch_norm else None
        if not self.project_entity:
            return self._encode(variables, x, bn, [], None, self.input_dropout, self.dropout, train, generator,
                                block)
        (subj, obj), new_state, reg = self._encode(
            variables, x, bn, ["subj_projection", "obj_projection"], self.project_entity_activation,
            self.input_dropout, self.dropout, train, generator, block)
        return (obj if is_sp is None else torch.where(is_sp[:, None], subj, obj)), new_state, reg

    def encode_relation(self, variables, ids, *, train=False, generator=None):
        """Relation rows ``ids`` [R] -> ``(emb [R, d_r], state, reg)``."""
        x = variables["params"]["relation_embedding"][ids].to(self._cdtype)
        return self._encode(
            variables, x, "bn_r" if self.batch_norm else None,
            ["relation_projection"] if self.project_relation else [], self.project_relation_activation,
            self.relation_input_dropout, self.relation_dropout, train, generator)


@dataclass
class TokenEmbedderBase(_RowShardContext):
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
        self._cdtype = _compute_dtype(self.dtype)
        if self.relation_slot_size is None or self.relation_slot_size <= 0:
            self.relation_slot_size = self.entity_slot_size
        # reference: a falsy entity_dropout falls back to dropout
        self.entity_dropout = self.entity_dropout if self.entity_dropout else self.dropout
        self.relation_dropout = self.relation_dropout if self.relation_dropout else self.dropout
        self.entity_dim = self.entity_slot_size
        self.relation_dim = self.entity_slot_size ** 2 if self.project_relation else self.relation_slot_size
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
        if self.project_relation:
            # the Tucker3 core: d_r -> d^2, then a batchnorm over d^2
            d2 = self.entity_slot_size ** 2
            std = 1.0 / (d2 * self.relation_slot_size * self.init_std ** 3)
            w = torch.empty(d2, self.relation_slot_size, device=device).normal_(generator=generator) * std
            bn_p, state["relation_projection_bn"] = init_batchnorm(d2, device=device)
            params["relation_projection"] = {"w": w, "bn": bn_p}
        return params, state, buffers

    def _tokens(self, variables: Variables, ids: torch.Tensor, kind: str) -> torch.Tensor:
        return variables["buffers"][f"{kind}_token_ids"][ids]

    def _apply_relation_projection(self, variables, x, train):
        """Linear d_r -> d^2 (f32 product) then a batchnorm over d^2 in f32,
        rounded once to ``x``'s dtype -> ``(y, new batchnorm state)``."""
        params, state = variables["params"], variables["state"]
        y = _product_f32(x, params["relation_projection"]["w"].to(x.dtype).t())
        y, new_bn = apply_batchnorm(params["relation_projection"]["bn"], state["relation_projection_bn"], y, train)
        return y.to(x.dtype), new_bn


@dataclass
class UnigramPoolingEmbedder(TokenEmbedderBase):
    """Entity and relation embedding = pooled token embeddings."""

    pool: str = "sum"
    activation: Optional[str] = None

    def init(self, generator: torch.Generator) -> Variables:
        params, state, buffers = self._init_base(generator)
        return {"params": params, "state": state, "buffers": buffers}

    def _pool_states(self, variables, ids, kind, block=None):
        """Token gather, pool and activation: the per-row stage (of a
        candidate block's rows only)."""
        table, toks = self._compact(variables, f"{kind}_token_embedding", self._tokens(variables, ids, kind))  # [B, L]
        if block is not None:
            toks = toks[block.lo : block.hi]
        emb = _pad_stop_gradient(table[toks].to(self._cdtype), toks)
        if self.pool == "max":
            x = emb.max(1).values
        elif self.pool == "mean":
            x = emb.sum(1) / ((toks > 0).float().sum(1, keepdim=True) + 1e-12)
        else:  # sum: the PAD vectors included, as in the reference
            x = emb.sum(1)
        act = _activation(self.activation)
        return act(x) if act else x

    def _finish(self, variables, x, kind, proj, dropout, train, generator, block=None):
        new_state = dict(variables["state"])
        if self.normalize == "norm":
            x = _l2_normalize(x)
        elif self.normalize == "batchnorm":
            y32, new_state[f"{kind}_bn"] = apply_batchnorm(
                variables["params"][f"{kind}_bn"], variables["state"][f"{kind}_bn"], x.float(), train,
                **_bn_group(block))
            x = y32.to(self._cdtype)
        if proj:
            x, new_state["relation_projection_bn"] = self._apply_relation_projection(variables, x, train)
        x = _dropout(x, dropout, train, generator, block)
        return x, new_state, x.new_zeros((), dtype=torch.float32)

    def _compose(self, variables, ids, kind, proj, dropout, train, generator, inv=None):
        # query dedup: pooling runs over unique rows; ``inv`` gathers back to
        # per-row BEFORE batchnorm and dropout
        block = getattr(self, "_block", None)
        x = self._pool_states(variables, ids, kind, block)
        if inv is not None:
            x = x[inv]
        return self._finish(variables, x, kind, proj, dropout, train, generator, block)

    def encode_entity_pair(self, variables, ids_a, ids_b, *, train=False, generator=None, inv_b=None):
        """One token gather and pool over both id batches (rows of ``ids_a``
        first); batchnorm and dropout run per group, a first, so the numbers
        equal two ``encode_entity`` calls.  Returns ``(emb_a, emb_b, state,
        reg)``."""
        na = ids_a.shape[0]
        x = self._pool_states(variables, torch.cat([ids_a, ids_b]), "entity")
        xa, state_a, reg_a = self._finish(variables, x[:na], "entity", False, self.entity_dropout, train,
                                          generator)
        xb = x[na:] if inv_b is None else x[na:][inv_b]
        xb, state_b, reg_b = self._finish({**variables, "state": state_a}, xb, "entity", False,
                                          self.entity_dropout, train, generator)
        return xa, xb, state_b, reg_a + reg_b

    def encode_entity(self, variables, ids, *, is_sp=None, train=False, generator=None, inv=None):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "entity", False, self.entity_dropout, train, generator, inv)

    def encode_relation(self, variables, ids, *, train=False, generator=None, inv=None):
        """Relation rows ``ids`` [R] -> ``(emb, state, reg)``; [R, d^2] with
        the relation projection."""
        return self._compose(variables, ids, "relation", self.project_relation, self.relation_dropout, train,
                             generator, inv)


@dataclass
class BigramPoolingEmbedder(TokenEmbedderBase):
    """A width-2 convolution over the token embeddings, ``out[:, t, c] =
    sum_d emb[:, t, d] w[c, d, 0] + emb[:, t+1, d] w[c, d, 1]`` (the two
    products accumulated in f32, one rounding), an optional activation, with
    ``normalize: batchnorm`` a batchnorm over the [B (L-1), C] positions with
    cumulative statistics (torch's ``momentum=None``), a sigmoid-gated
    (``gates``) or residual mix with the next token, the pad positions
    masked, then sum or max pooling.  The reference never applies its
    relation projection in this family, so ``project_relation`` is refused;
    there is no pair encode and no query dedup (its batchnorm sees the
    positions of the encode batch)."""

    pool: str = ""
    gates: bool = False
    encoder_activation: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if self.project_relation:
            raise ValueError("project_relation is unsupported for the bigram embedder "
                             "(the reference defines but never applies it)")

    def init(self, generator: torch.Generator) -> Variables:
        params, state, buffers = self._init_base(generator)
        device = generator.device
        for kind, d in (("entity", self.entity_slot_size), ("relation", self.relation_slot_size)):
            out_ch = d + 1 if self.gates else d
            k = 1.0 / (d * 2) ** 0.5  # torch's conv default U(-k, k)
            params[f"{kind}_conv"] = torch.empty(out_ch, d, 2, device=device).uniform_(-k, k, generator=generator)
            params[f"{kind}_conv_bn"], state[f"{kind}_conv_bn"] = init_batchnorm(out_ch, device=device)
        return {"params": params, "state": state, "buffers": buffers}

    def _compose(self, variables, ids, kind, dropout, train, generator):
        table, toks = self._compact(variables, f"{kind}_token_embedding", self._tokens(variables, ids, kind))  # [B, L]
        block = getattr(self, "_block", None)
        if block is not None:
            toks = toks[block.lo : block.hi]
        # the batchnorm over conv positions couples pad outputs into the
        # loss: block their gradient at the gather
        emb = _pad_stop_gradient(table[toks].to(self._cdtype), toks)
        w = variables["params"][f"{kind}_conv"].to(self._cdtype)  # [out_ch, d, 2]
        y = (_product_f32(emb[:, :-1], w[:, :, 0].t()) + _product_f32(emb[:, 1:], w[:, :, 1].t())).to(
            self._cdtype)  # [B, L-1, out_ch]
        act = _activation(self.encoder_activation)
        if act:
            y = act(y)
        new_state = dict(variables["state"])
        if self.normalize == "batchnorm":
            B, Lm1, C = y.shape
            y2, new_state[f"{kind}_conv_bn"] = apply_batchnorm(
                variables["params"][f"{kind}_conv_bn"], variables["state"][f"{kind}_conv_bn"],
                y.reshape(B * Lm1, C).float(), train, momentum=None, **_bn_group(block, Lm1))
            y = y2.to(self._cdtype).reshape(B, Lm1, C)
        if self.gates:
            g = _sigmoid(y[..., -1:])
            y = y[..., :-1] * g + emb[:, 1:] * (1 - g)
        else:
            y = y + emb[:, 1:]
        mask = (toks > 0).to(y.dtype)[:, 1:, None]  # [B, L-1, 1]
        x = (y * mask).max(1).values if self.pool == "max" else (y * mask).sum(1)
        if self.normalize == "mean":
            x = x / (mask.sum(1) + 1e-12)
        if self.normalize == "norm":
            x = _l2_normalize(x)
        x = _dropout(x, dropout, train, generator, block)
        return x, new_state, x.new_zeros((), dtype=torch.float32)

    def encode_entity(self, variables, ids, *, is_sp=None, train=False, generator=None):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "entity", self.entity_dropout, train, generator)

    def encode_relation(self, variables, ids, *, train=False, generator=None):
        """Relation rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "relation", self.relation_dropout, train, generator)


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
        """Token gather + LSTM + last-state select on a [R, L] token block
        -> raw [R, H], on the path the JAX package takes for this shape
        (``models/embedders.py:784-807``).  The rows are sorted by descending
        length when the path is fused (the rows active at step t are then a
        prefix, which lets the kernels skip finished rows) or a gather-sum
        plan is present (it indexes the sorted time-major layout); the
        unfused path runs every step of every row, sorted or not."""
        toks_tm = toks.t()  # [L, R]
        L, B = toks_tm.shape
        fused = lstm_fused_supported(B, L, table.shape[1], lstm["w_hh"].shape[1])
        use_sorted = fused or plan is not None
        lengths = (toks_tm > 0).sum(0)
        if use_sorted:
            order, unsort = length_sort_perm(lengths, L)
            toks_tm, lengths = toks_tm[:, order], lengths[order]
        emb_tm = token_gather_tm(table, toks_tm, self._cdtype, grad_plan=plan)  # [L, R, d]
        if fused:
            x = lstm_last_fused(lstm, emb_tm, lengths)
        else:
            x = last_states(lstm_forward_tm(lstm, emb_tm), lengths)
        return x[unsort] if use_sorted else x

    def _lstm_states(self, variables, ids, kind, table_name, lstm_name, train=False, block=None) -> torch.Tensor:
        """Raw [B, H] states of the rows ``ids``.  With a row-shard context
        (:meth:`set_row_shard_ctx`) over ``A`` ranks and ``B % A == 0``, each
        rank sorts, gathers and runs the LSTM on its own block of B / A rows
        (with its own slice of a stacked [A, S, K] gather-sum plan) and the
        blocks are gathered over the axis's group
        (``parallel.distributed.gather_rows``: the backward sums the ranks'
        cotangents, then each keeps its block), as the JAX package's
        ``shard_map`` region does; otherwise every rank encodes every row.
        In a candidate ``block`` only the block's states are returned: the
        core runs on the block (all rows, then sliced, where a 2-D plan
        indexes every row)."""
        # the gather-sum plan rides in the buffers of a sparse train batch
        ctx = getattr(self, "_row_shard_ctx", None)
        key = getattr(self, "_plan_key_override", None) or f"{kind}_token_grad_plan"
        plan = variables["buffers"].get(key) if train else None
        lstm = variables["params"][lstm_name]
        table, toks = self._compact(variables, table_name, self._tokens(variables, ids, kind))
        B = toks.shape[0]
        if block is not None:
            if plan is None or (plan["pos"].dim() == 3 and B % block.parts == 0):
                plan_i = None if plan is None else {k: v[block.index] for k, v in plan.items()}
                return self._lstm_states_core(table, lstm, toks[block.lo : block.hi], plan_i)
            return self._lstm_states_core(table, lstm, toks, plan)[block.lo : block.hi]
        if ctx is not None:
            mesh, axis = ctx
            A, i = mesh.shape[axis], mesh.index(axis)
            if A > 1 and B % A == 0 and (plan is None or plan["pos"].dim() == 3):
                from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import gather_rows

                blk = B // A
                plan_i = None if plan is None else {k: v[i] for k, v in plan.items()}
                return gather_rows(self._lstm_states_core(table, lstm, toks[i * blk : (i + 1) * blk], plan_i), i, A,
                                   mesh.group(axis))
        return self._lstm_states_core(table, lstm, toks, plan)

    def _finish(self, variables, x, bn_name, proj, dropout, train, generator, block=None):
        """Activation -> batchnorm (f32) -> [relation projection] -> dropout
        on raw LSTM states; batch statistics see exactly the rows in ``x``
        (in a candidate ``block``, the rows of every rank's block)."""
        act = _activation(self.encoder_activation)
        if act:
            x = act(x)
        new_state = dict(variables["state"])
        if self.normalize == "batchnorm":
            y32, new_state[bn_name] = apply_batchnorm(
                variables["params"][bn_name], variables["state"][bn_name], x.float(), train, **_bn_group(block)
            )
            x = y32.to(self._cdtype)
        if proj:
            x, new_state["relation_projection_bn"] = self._apply_relation_projection(
                variables, x.to(self._cdtype), train)
        x = _dropout(x, dropout, train, generator, block)
        return x.to(self._cdtype), new_state, x.new_zeros((), dtype=torch.float32)

    def _compose(self, variables, ids, kind, proj, dropout, train, generator, inv=None):
        # query dedup: the recurrence runs over unique rows; ``inv`` gathers
        # back to per-row BEFORE batchnorm and dropout
        block = getattr(self, "_block", None)
        x = self._lstm_states(variables, ids, kind, f"{kind}_token_embedding", f"{kind}_lstm", train, block)
        if inv is not None:
            x = x[inv]
        return self._finish(variables, x, f"{kind}_bn", proj, dropout, train, generator, block)

    def encode_entity_pair(self, variables, ids_a, ids_b, *, train=False, generator=None, inv_b=None):
        """Encode two entity id batches through ONE token-gather + LSTM pass
        (rows of ``ids_a`` first); batchnorm and dropout still run per group,
        a first, so the numbers equal two ``encode_entity`` calls.  Returns
        ``(emb_a, emb_b, state, reg)``."""
        na = ids_a.shape[0]
        x = self._lstm_states(
            variables, torch.cat([ids_a, ids_b]), "entity", "entity_token_embedding", "entity_lstm", train
        )
        xa, state_a, reg_a = self._finish(variables, x[:na], "entity_bn", False, self.entity_dropout, train,
                                          generator)
        xb = x[na:]
        if inv_b is not None:
            xb = xb[inv_b]
        xb, state_b, reg_b = self._finish(
            {**variables, "state": state_a}, xb, "entity_bn", False, self.entity_dropout, train, generator
        )
        return xa, xb, state_b, reg_a + reg_b

    def encode_entity(self, variables, ids, *, is_sp=None, train=False, generator=None, inv=None):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "entity", False, self.entity_dropout, train, generator, inv)

    def encode_relation(self, variables, ids, *, train=False, generator=None, inv=None):
        """Relation rows ``ids`` [R] -> ``(emb, state, reg)``; [R, d^2] with
        the relation projection."""
        return self._compose(variables, ids, "relation", self.project_relation, self.relation_dropout, train,
                             generator, inv)
