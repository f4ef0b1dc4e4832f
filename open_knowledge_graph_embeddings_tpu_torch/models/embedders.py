"""Token-composition embedders, eval-mode forward.

Counterpart of ``open_knowledge_graph_embeddings_tpu/models/embedders.py``
limited to what serving needs: :class:`TokenEmbedderBase` (parameters,
token buffers, sparse-table padding) and the eval forward of
:class:`LSTMEmbedder`.  Variables are a plain nested dict of tensors,
``{"params", "state", "buffers"}``, with the JAX package's names and shapes,
so checkpoints cross over key for key (train/checkpoint.py).

Encode pipeline of one row batch: token gather -> stable descending-length
sort -> fused last-state LSTM (the CUDA kernel on the card) -> unsort ->
batchnorm in f32 -> cast to the compute dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
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


def _train_not_ported():
    return NotImplementedError(
        "train-mode encoding (batch statistics, dropout) comes with the training "
        "step: ROADMAP Queue 1 items 3-6"
    )


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

    def _lstm_states(self, variables, ids, kind, table_name, lstm_name) -> torch.Tensor:
        """Token gather + sort + fused last-state LSTM + unsort -> raw [R, H]."""
        toks_tm = self._tokens(variables, ids, kind).t()  # [L, R]
        L = toks_tm.shape[0]
        lengths = (toks_tm > 0).sum(0)
        order, unsort = length_sort_perm(lengths, L)
        # rows sorted by descending length: the rows active at step t are a
        # prefix, which is what lets the kernel skip finished rows
        toks_tm = toks_tm[:, order]
        emb_tm = variables["params"][table_name][toks_tm].to(self._cdtype)  # [L, R, d]
        x = lstm_last_fused(variables["params"][lstm_name], emb_tm, lengths[order])
        return x[unsort]

    def _finish(self, variables, x, bn_name) -> torch.Tensor:
        """Activation -> batchnorm (f32, running statistics) on raw states."""
        if self.encoder_activation:
            x = _ACTIVATIONS[self.encoder_activation.lower()](x)
        if self.normalize == "batchnorm":
            x, _ = apply_batchnorm(
                variables["params"][bn_name], variables["state"][bn_name], x.float()
            )
        return x.to(self._cdtype)

    def _compose(self, variables, ids, kind, train):
        if train:
            raise _train_not_ported()
        x = self._lstm_states(
            variables, ids, kind, f"{kind}_token_embedding", f"{kind}_lstm"
        )
        return self._finish(variables, x, f"{kind}_bn"), variables["state"], x.new_zeros((), dtype=torch.float32)

    def encode_entity(self, variables, ids, *, is_sp=None, train=False):
        """Entity rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "entity", train)

    def encode_relation(self, variables, ids, *, train=False):
        """Relation rows ``ids`` [R] -> ``(emb [R, d], state, reg)``."""
        return self._compose(variables, ids, "relation", train)
