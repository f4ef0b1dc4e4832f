"""Scorer x embedder composition and the model registry.

Counterpart of ``open_knowledge_graph_embeddings_tpu/models/model.py``
on one device: per-row query vectors for a mixed sp/po batch, the candidate
encode, the train step's encode stage (candidates and query entities in one
LSTM pass) and the chunked full-vocabulary candidate cache.  The mesh
branch of the encode stage comes with multi-device training (ROADMAP Queue 1
item 14).

Randomness (dropout in train mode) is drawn from one ``torch.Generator`` in
the JAX package's encode order: candidates, query entities, relations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder, Variables
from open_knowledge_graph_embeddings_tpu_torch.ops import scoring

QUERY_FNS: Dict[str, Callable] = {
    "complex": scoring.complex_query,
    "distmult": scoring.distmult_query,
}


@dataclass
class KGEModel:
    scorer: str
    embedder: LSTMEmbedder

    def __post_init__(self):
        if self.scorer not in QUERY_FNS:
            raise ValueError(f"unknown scorer {self.scorer}")
        if self.scorer == "complex" and self.embedder.entity_dim % 2:
            raise ValueError("ComplEx needs an even embedding size")
        if self.embedder.relation_dim != self.embedder.entity_dim:
            raise ValueError(
                f"{self.scorer} scoring is elementwise over the embedding dim: "
                f"relation_slot_size ({self.embedder.relation_dim}) must equal "
                f"entity_slot_size ({self.embedder.entity_dim})"
            )

    @property
    def meta(self) -> DatasetMeta:
        return self.embedder.meta

    def init(self, generator: torch.Generator) -> Variables:
        return self.embedder.init(generator)

    def queries(self, variables: Variables, ent_ids, rel_ids, is_sp, *, train: bool = False,
                generator: Optional[torch.Generator] = None, ent_inv=None, rel_inv=None):
        """Per-row query vectors [B, d] for a mixed sp/po prefix batch ->
        ``(q, state, reg)``.  With query dedup, ``ent_ids``/``rel_ids`` hold
        unique ids and ``ent_inv``/``rel_inv`` gather the encoded rows back
        to per-row before batchnorm and dropout."""
        e, state, reg_e = self.embedder.encode_entity(
            variables, ent_ids, is_sp=is_sp, train=train, generator=generator, inv=ent_inv)
        variables = {**variables, "state": state}
        r, state, reg_r = self.embedder.encode_relation(
            variables, rel_ids, train=train, generator=generator, inv=rel_inv)
        return QUERY_FNS[self.scorer](e, r, is_sp), state, reg_e + reg_r

    def encode_candidates(self, variables: Variables, cand_ids: Optional[torch.Tensor], *,
                          train=False, generator: Optional[torch.Generator] = None):
        """Encode the candidate label space; ``None`` means every entity id
        from ``meta.min_entities_size`` on.  Candidates use the object
        encoding."""
        if cand_ids is None:
            device = variables["buffers"]["entity_token_ids"].device
            cand_ids = torch.arange(self.meta.min_entities_size, self.meta.entities_size, device=device)
        return self.embedder.encode_entity(variables, cand_ids, is_sp=None, train=train, generator=generator)

    def prefix_scores(self, variables: Variables, ent_ids, rel_ids, is_sp, cand_ids=None, cand_emb=None, *,
                      train: bool = False, generator: Optional[torch.Generator] = None, ent_inv=None,
                      rel_inv=None):
        """[B, N] f32 scores -> ``(scores, state, reg)``; the candidates are
        encoded unless ``cand_emb`` is given."""
        q, cand_emb, state, reg = self.prefix_queries_and_candidates(
            variables, ent_ids, rel_ids, is_sp, cand_ids, cand_emb, train=train, generator=generator,
            ent_inv=ent_inv, rel_inv=rel_inv)
        return scoring.score_against_candidates(q, cand_emb), state, reg

    def prefix_queries_and_candidates(self, variables: Variables, ent_ids, rel_ids, is_sp,
                                      cand_ids=None, cand_emb=None, *, train: bool = False,
                                      generator: Optional[torch.Generator] = None,
                                      ent_inv=None, rel_inv=None):
        """The train step's encode stage -> ``(q [B, d], cand_emb [N, d],
        state, reg)``, without the score product (the loss fuses it).  With
        batch-shared candidates, the candidates and the query entities go
        through ONE LSTM pass (``encode_entity_pair``, candidates first);
        batchnorm still sees each group alone.  A given ``cand_emb`` (the
        eval cache) is used as it is."""
        if cand_emb is not None:
            q, state, reg = self.queries(variables, ent_ids, rel_ids, is_sp, train=train, generator=generator,
                                         ent_inv=ent_inv, rel_inv=rel_inv)
            return q, cand_emb, state, reg
        if cand_ids is not None:
            cand_emb, e, state, reg_c = self.embedder.encode_entity_pair(
                variables, cand_ids, ent_ids, train=train, generator=generator, inv_b=ent_inv)
            variables = {**variables, "state": state}
            r, state, reg_r = self.embedder.encode_relation(
                variables, rel_ids, train=train, generator=generator, inv=rel_inv)
            return QUERY_FNS[self.scorer](e, r, is_sp), cand_emb, state, reg_c + reg_r
        cand_emb, state, reg_c = self.encode_candidates(variables, None, train=train, generator=generator)
        q, state, reg_q = self.queries(
            {**variables, "state": state}, ent_ids, rel_ids, is_sp, train=train,
            generator=generator, ent_inv=ent_inv, rel_inv=rel_inv)
        return q, cand_emb, state, reg_c + reg_q

    @torch.no_grad()
    def encode_all_entities(self, variables: Variables, chunk_size: int = 32768) -> torch.Tensor:
        """Candidate embeddings for every entity id [E, d], in the embedder's
        compute dtype, encoded in chunks of ``chunk_size`` rows to bound the
        per-chunk activations.  As in the JAX package (``models/model.py``
        :379-408), the last chunk is padded to ``chunk_size`` with ids clipped
        to E - 1 and the padding rows are dropped, so every chunk has the
        same B and takes the same LSTM path."""
        E = self.meta.entities_size
        device = variables["buffers"]["entity_token_ids"].device
        cache = torch.empty(E, self.embedder.entity_dim, dtype=self.embedder._cdtype, device=device)
        for start in range(0, E, chunk_size):
            ids = torch.arange(start, start + chunk_size, device=device).clamp(max=E - 1)
            n = min(chunk_size, E - start)
            cache[start : start + n] = self.embedder.encode_entity(variables, ids)[0][:n]
        return cache


def _lstm(meta: DatasetMeta, scorer: str, **cfg) -> KGEModel:
    cfg.pop("input_dropout", None)  # token embedders have no input dropout stage
    return KGEModel(scorer, LSTMEmbedder(meta=meta, **cfg))


def _not_ported(item: str) -> Callable[..., KGEModel]:
    def build(meta: DatasetMeta, **cfg) -> KGEModel:
        raise NotImplementedError(f"not ported to the torch package yet: ROADMAP {item}")

    return build


MODELS: Dict[str, Callable[..., KGEModel]] = {
    "LSTMComplexRelationModel": lambda meta, **cfg: _lstm(meta, "complex", **cfg),
    "LSTMDistmultRelationModel": lambda meta, **cfg: _lstm(meta, "distmult", **cfg),
    "LookupComplexRelationModel": _not_ported("Queue 1 item 11 (LookupEmbedder)"),
    "LookupDistmultRelationModel": _not_ported("Queue 1 item 11 (LookupEmbedder)"),
    "LookupTucker3RelationModel": _not_ported("Queue 1 item 11 (LookupEmbedder, rescal scorer)"),
    "UnigramPoolingComplexRelationModel": _not_ported("Queue 1 item 11 (UnigramPoolingEmbedder)"),
    "BigramPoolingComplexRelationModel": _not_ported("Queue 1 item 11 (BigramPoolingEmbedder)"),
    "LSTMTucker3RelationModel": _not_ported("Queue 1 item 11 (rescal scorer, relation projection)"),
    "DataBiasOnlyEntityModel": _not_ported("Queue 1 item 11 (bias scorers)"),
    "DataBiasOnlyRelationModel": _not_ported("Queue 1 item 11 (bias scorers)"),
}


def build_model(name: str, meta: DatasetMeta, **model_config) -> KGEModel:
    if name not in MODELS:
        raise KeyError(f"unknown model {name}; available: {sorted(MODELS)}")
    return MODELS[name](meta, **model_config)
