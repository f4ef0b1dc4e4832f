"""Scorer x embedder composition and the model registry (all 10 names of
the JAX package).

Counterpart of ``open_knowledge_graph_embeddings_tpu/models/model.py``:
per-row query vectors for a mixed sp/po batch, the candidate encode (a
table slice for lookup models), the train step's encode stage (candidates
and query entities in one pass where the embedder has a pair encode),
triple scores and the chunked full-vocabulary candidate cache.  On a
data-parallel mesh of ranks (:meth:`KGEModel.set_mesh`) a training step's
encode stage takes the JAX package's mesh branch: candidates, then queries,
each its own region, whose LSTM rows split over the ranks and are gathered
(models/embedders.py).  The model axis (row-sharded tables, the candidate
axis over ``model``) waits for ROADMAP Queue 1 item 16.

Randomness (dropout in train mode) is drawn from one ``torch.Generator`` in
the JAX package's encode order: candidates, query entities, relations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import (
    BigramPoolingEmbedder,
    LookupEmbedder,
    LSTMEmbedder,
    TokenEmbedderBase,
    UnigramPoolingEmbedder,
    Variables,
    params_device,
)
from open_knowledge_graph_embeddings_tpu_torch.ops import scoring

QUERY_FNS: Dict[str, Callable] = {
    "complex": scoring.complex_query,
    "distmult": scoring.distmult_query,
    "rescal": scoring.rescal_query,
    "bias_relation": scoring.bias_relation_query,
    "bias_entity": scoring.bias_entity_query,
}

#: scorers whose triple score is defined (the bias diagnostics raise, as in
#: the reference)
TRIPLE_CAPABLE = {"complex", "distmult", "rescal"}


@dataclass
class KGEModel:
    scorer: str
    embedder: Union[LookupEmbedder, TokenEmbedderBase]

    def __post_init__(self):
        if self.scorer not in QUERY_FNS:
            raise ValueError(f"unknown scorer {self.scorer}")
        if self.scorer == "complex" and self.embedder.entity_dim % 2:
            raise ValueError("ComplEx needs an even embedding size")
        if self.scorer in ("complex", "distmult") and self.embedder.relation_dim != self.embedder.entity_dim:
            raise ValueError(
                f"{self.scorer} scoring is elementwise over the embedding dim: "
                f"relation_slot_size ({self.embedder.relation_dim}) must equal "
                f"entity_slot_size ({self.embedder.entity_dim})"
            )
        if self.scorer == "rescal" and self.embedder.relation_dim != self.embedder.entity_dim ** 2:
            raise ValueError("RESCAL/Tucker3 needs relation_dim == entity_dim^2 "
                             "(set project_relation=True on the embedder)")

    @property
    def meta(self) -> DatasetMeta:
        return self.embedder.meta

    def init(self, generator: torch.Generator) -> Variables:
        return self.embedder.init(generator)

    def set_mesh(self, mesh) -> None:
        """The mesh of ranks a training step runs on (``parallel/mesh.py``),
        or None for one process.  With a mesh, a training batch's encode
        stage splits into a candidate and a query region (no pair fusion);
        the step scores only this rank's block of the rows
        (``train/step.py::prefix_loss``)."""
        self._mesh = mesh

    @property
    def mesh(self):
        return getattr(self, "_mesh", None)

    def _relation_for_query(self, r: torch.Tensor) -> torch.Tensor:
        if self.scorer == "rescal":
            d = self.embedder.entity_dim
            return r.reshape(-1, d, d)
        return r

    def _query(self, e, r, is_sp):
        return QUERY_FNS[self.scorer](e, self._relation_for_query(r), is_sp)

    def queries(self, variables: Variables, ent_ids, rel_ids, is_sp, *, train: bool = False,
                generator: Optional[torch.Generator] = None, ent_inv=None, rel_inv=None):
        """Per-row query vectors [B, d] for a mixed sp/po prefix batch ->
        ``(q, state, reg)``.  With query dedup, ``ent_ids``/``rel_ids`` hold
        unique ids and ``ent_inv``/``rel_inv`` gather the encoded rows back
        to per-row before batchnorm and dropout."""
        e, state, reg_e = self.embedder.encode_entity(
            variables, ent_ids, is_sp=is_sp, train=train, generator=generator, **_inv(ent_inv))
        variables = {**variables, "state": state}
        r, state, reg_r = self.embedder.encode_relation(
            variables, rel_ids, train=train, generator=generator, **_inv(rel_inv))
        return self._query(e, r, is_sp), state, reg_e + reg_r

    def encode_candidates(self, variables: Variables, cand_ids: Optional[torch.Tensor], *,
                          train=False, generator: Optional[torch.Generator] = None):
        """Encode the candidate label space; ``None`` means every entity id
        from ``meta.min_entities_size`` on (a table slice for lookup
        models).  Candidates use the object encoding."""
        if cand_ids is None:
            if hasattr(self.embedder, "encode_entity_range"):
                return self.embedder.encode_entity_range(
                    variables, self.meta.min_entities_size, self.meta.entities_size, train=train,
                    generator=generator)
            cand_ids = torch.arange(self.meta.min_entities_size, self.meta.entities_size,
                                    device=params_device(variables))
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
        batch-shared candidates and an embedder that has
        ``encode_entity_pair`` (LSTM, unigram), the candidates and the query
        entities go through ONE pass (candidates first); batchnorm still
        sees each group alone.  A given ``cand_emb`` (the eval cache) is
        used as it is."""
        if cand_emb is not None:
            q, state, reg = self.queries(variables, ent_ids, rel_ids, is_sp, train=train, generator=generator,
                                         ent_inv=ent_inv, rel_inv=rel_inv)
            return q, cand_emb, state, reg
        if self.mesh is not None and train and cand_ids is not None:
            return self._mesh_encodes(variables, ent_ids, rel_ids, is_sp, cand_ids, generator, ent_inv, rel_inv)
        if cand_ids is not None and hasattr(self.embedder, "encode_entity_pair"):
            cand_emb, e, state, reg_c = self.embedder.encode_entity_pair(
                variables, cand_ids, ent_ids, train=train, generator=generator, inv_b=ent_inv)
            variables = {**variables, "state": state}
            r, state, reg_r = self.embedder.encode_relation(
                variables, rel_ids, train=train, generator=generator, **_inv(rel_inv))
            return self._query(e, r, is_sp), cand_emb, state, reg_c + reg_r
        cand_emb, state, reg_c = self.encode_candidates(variables, cand_ids, train=train, generator=generator)
        q, state, reg_q = self.queries(
            {**variables, "state": state}, ent_ids, rel_ids, is_sp, train=train,
            generator=generator, ent_inv=ent_inv, rel_inv=rel_inv)
        return q, cand_emb, state, reg_c + reg_q

    def _mesh_encodes(self, variables, ent_ids, rel_ids, is_sp, cand_ids, generator, ent_inv, rel_inv):
        """The mesh branch of the encode stage (the JAX package's
        ``prefix_queries_and_candidates`` with a mesh): the candidates in a
        region over ``data`` reading the ``cand`` plan, then the queries
        (entities, relations) in a region over ``data``; the random stream
        and the batchnorm state follow that order.  Every rank ends with the
        whole q [B, d] and cand_emb [N, d]."""
        from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS

        set_ctx = self.embedder.set_row_shard_ctx
        set_ctx(self.mesh, DATA_AXIS, plan_key="cand_token_grad_plan")
        try:
            cand_emb, state, reg_c = self.encode_candidates(variables, cand_ids, train=True, generator=generator)
        finally:
            set_ctx(None, None)
        set_ctx(self.mesh, DATA_AXIS)
        try:
            q, state, reg_q = self.queries({**variables, "state": state}, ent_ids, rel_ids, is_sp, train=True,
                                           generator=generator, ent_inv=ent_inv, rel_inv=rel_inv)
        finally:
            set_ctx(None, None)
        return q, cand_emb, state, reg_c + reg_q

    def triple_score(self, variables: Variables, s_ids, r_ids, o_ids, *, train: bool = False,
                     generator: Optional[torch.Generator] = None):
        """Scores of explicit (s, r, o) triples [B] -> ``(scores, state,
        reg)``; undefined for the bias diagnostics, as in the reference."""
        if self.scorer not in TRIPLE_CAPABLE:
            raise NotImplementedError(f"triple_score undefined for diagnostic scorer {self.scorer} "
                                      "(matches reference behaviour)")
        is_sp = torch.ones(s_ids.shape[0], dtype=torch.bool, device=s_ids.device)
        s, state, reg_s = self.embedder.encode_entity(variables, s_ids, is_sp=is_sp, train=train,
                                                      generator=generator)
        variables = {**variables, "state": state}
        r, state, reg_r = self.embedder.encode_relation(variables, r_ids, train=train, generator=generator)
        variables = {**variables, "state": state}
        o, state, reg_o = self.embedder.encode_entity(variables, o_ids, is_sp=None, train=train,
                                                      generator=generator)
        return scoring.triple_scores(self._query(s, r, is_sp), o), state, reg_s + reg_r + reg_o

    @torch.no_grad()
    def candidate_cache(self, variables: Variables) -> torch.Tensor:
        """The [N, d] eval-mode candidates of a full-vocabulary ranking,
        every entity from ``meta.min_entities_size`` on: token embedders
        encode every mention in chunks (``encode_all_entities``), lookup
        models read the table slice (``encode_candidates(None)``)."""
        if isinstance(self.embedder, TokenEmbedderBase):
            return self.encode_all_entities(variables)[self.meta.min_entities_size :]
        return self.encode_candidates(variables, None)[0]

    @torch.no_grad()
    def encode_all_entities(self, variables: Variables, chunk_size: int = 32768) -> torch.Tensor:
        """Candidate embeddings for every entity id [E, d], in the embedder's
        compute dtype, encoded in chunks of ``chunk_size`` rows to bound the
        per-chunk activations.  As in the JAX package (``models/model.py``
        :379-408), the last chunk is padded to ``chunk_size`` with ids clipped
        to E - 1 and the padding rows are dropped, so every chunk has the
        same B and takes the same LSTM path."""
        E = self.meta.entities_size
        device = params_device(variables)
        cache = torch.empty(E, self.embedder.entity_dim, dtype=self.embedder._cdtype, device=device)
        for start in range(0, E, chunk_size):
            ids = torch.arange(start, start + chunk_size, device=device).clamp(max=E - 1)
            n = min(chunk_size, E - start)
            cache[start : start + n] = self.embedder.encode_entity(variables, ids)[0][:n]
        return cache


def _inv(inv) -> Dict[str, torch.Tensor]:
    """The ``inv`` keyword of a dedup-capable encode, only when there is one
    (lookup and bigram embedders take none)."""
    return {} if inv is None else {"inv": inv}


def _lookup(meta: DatasetMeta, scorer: str, project_relation: bool = False, **cfg) -> KGEModel:
    if not project_relation:
        # the reference's simple lookup embedder: relation slot = entity slot, no projection
        cfg.pop("relation_slot_size", None)
    return KGEModel(scorer, LookupEmbedder(meta=meta, project_relation=project_relation, **cfg))


def _token(meta: DatasetMeta, scorer: str, family, project_relation: bool = False, **cfg) -> KGEModel:
    cfg.pop("input_dropout", None)  # token embedders have no input dropout stage
    return KGEModel(scorer, family(meta=meta, project_relation=project_relation, **cfg))


MODELS: Dict[str, Callable[..., KGEModel]] = {
    "LookupComplexRelationModel": lambda meta, **cfg: _lookup(meta, "complex", **cfg),
    "LookupDistmultRelationModel": lambda meta, **cfg: _lookup(meta, "distmult", **cfg),
    "LookupTucker3RelationModel": lambda meta, **cfg: _lookup(meta, "rescal", project_relation=True, **cfg),
    "UnigramPoolingComplexRelationModel": lambda meta, **cfg: _token(meta, "complex", UnigramPoolingEmbedder,
                                                                     **cfg),
    "BigramPoolingComplexRelationModel": lambda meta, **cfg: _token(meta, "complex", BigramPoolingEmbedder,
                                                                    **cfg),
    "LSTMComplexRelationModel": lambda meta, **cfg: _token(meta, "complex", LSTMEmbedder, **cfg),
    "LSTMDistmultRelationModel": lambda meta, **cfg: _token(meta, "distmult", LSTMEmbedder, **cfg),
    "LSTMTucker3RelationModel": lambda meta, **cfg: _token(meta, "rescal", LSTMEmbedder, project_relation=True,
                                                           **cfg),
    # the data-bias diagnostics
    "DataBiasOnlyEntityModel": lambda meta, **cfg: _token(meta, "bias_entity", LSTMEmbedder, **cfg),
    "DataBiasOnlyRelationModel": lambda meta, **cfg: _token(meta, "bias_relation", LSTMEmbedder, **cfg),
}


def build_model(name: str, meta: DatasetMeta, **model_config) -> KGEModel:
    if name not in MODELS:
        raise KeyError(f"unknown model {name}; available: {sorted(MODELS)}")
    return MODELS[name](meta, **model_config)
