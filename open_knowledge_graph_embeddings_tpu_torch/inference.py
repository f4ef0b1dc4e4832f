"""Top-k link-prediction serving.

Counterpart of ``open_knowledge_graph_embeddings_tpu/inference.py``: a
:class:`Predictor` encodes the candidate cache once and answers
``(s, r, ?)`` / ``(?, r, o)`` queries with the top-k entities, optionally
through the dataset's vocabulary maps.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta, _read_id_map
from open_knowledge_graph_embeddings_tpu_torch.models.embedders import params_device
from open_knowledge_graph_embeddings_tpu_torch.models.model import KGEModel
from open_knowledge_graph_embeddings_tpu_torch.ops.scoring import score_against_candidates
from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import (
    CHUNKED_ABOVE,
    filtered_topk_chunked,
    stable_topk,
)

logger = logging.getLogger(__name__)


class Predictor:
    def __init__(self, model: KGEModel, variables, dataset_dir: Optional[str] = None):
        """``variables`` live on the device the predictor serves from."""
        self.model = model
        self.variables = variables
        self.meta: DatasetMeta = model.meta
        self.device = params_device(variables)
        self.offset = self.meta.min_entities_size
        self.cand_emb = model.candidate_cache(variables)

        self.entity_names: Dict[int, str] = {}
        self.relation_names: Dict[int, str] = {}
        if dataset_dir:
            e_map, _, _ = _read_id_map(os.path.join(dataset_dir, "entity_id_map.txt"))
            r_map, _, _ = _read_id_map(os.path.join(dataset_dir, "relation_id_map.txt"))
            self.entity_names = {v: k for k, v in e_map.items()}
            self.relation_names = {v: k for k, v in r_map.items()}
            self._entity_ids = e_map
            self._relation_ids = r_map

    def _topk(self, ent_ids, rel_ids, is_sp, k):
        q, _, _ = self.model.queries(self.variables, ent_ids, rel_ids, is_sp)
        if self.cand_emb.shape[0] > CHUNKED_ABOVE:
            none = torch.full((1,), -1, dtype=torch.int32, device=self.device)  # no filtering
            return filtered_topk_chunked(q, self.cand_emb, none, none, None, k)
        return stable_topk(score_against_candidates(q, self.cand_emb), min(k, self.cand_emb.shape[0]))

    def predict(
        self,
        subj: Optional[Sequence[int]] = None,
        rel: Sequence[int] = (),
        obj: Optional[Sequence[int]] = None,
        k: int = 10,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched completion.  Provide ``subj`` for (s, r, ?) queries or
        ``obj`` for (?, r, o); returns (scores [B, k], entity_ids [B, k])."""
        if (subj is None) == (obj is None):
            raise ValueError("provide exactly one of subj/obj")
        ent = torch.as_tensor(np.asarray(subj if subj is not None else obj, dtype=np.int64))
        rel = torch.as_tensor(np.asarray(rel, dtype=np.int64))
        is_sp = torch.full(ent.shape, subj is not None, dtype=torch.bool)
        scores, idx = self._topk(
            ent.to(self.device), rel.to(self.device), is_sp.to(self.device), k
        )
        return scores.cpu().numpy(), idx.cpu().numpy().astype(np.int64) + self.offset

    def predict_text(self, subj: Optional[str], rel: str, obj: Optional[str], k: int = 10):
        """Text-level completion through the vocabulary maps."""
        if not self.entity_names:
            raise ValueError("Predictor needs dataset_dir for text queries")
        rid = self._relation_ids.get(rel)
        if rid is None:
            raise KeyError(f"unknown relation {rel!r}")
        ent_text = subj if subj is not None else obj
        eid = self._entity_ids.get(ent_text)
        if eid is None:
            raise KeyError(f"unknown entity {ent_text!r}")
        scores, ids = self.predict(
            subj=[eid] if subj is not None else None,
            rel=[rid],
            obj=[eid] if obj is not None else None,
            k=k,
        )
        return [
            (self.entity_names.get(int(i), str(int(i))), float(s))
            for s, i in zip(scores[0], ids[0])
        ]
