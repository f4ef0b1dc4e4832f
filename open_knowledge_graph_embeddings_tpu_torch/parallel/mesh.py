"""The ranks of a run laid out as a [data, model] mesh.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/mesh.py``.
In the port one process drives one card, so the mesh's devices are the
processes (ranks) of the ``torch.distributed`` world:

* ``data``: the rows of a training batch (prefixes) split over it, each
  rank holding whole parameters; their gradients are summed over it;
* ``model``: row-sharded entity tables and the candidate axis of the
  scores.  Only ``model = 1`` runs (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks, rank-major over ``model``; ``rank`` is
    this process's place in it."""

    data: int
    model: int
    rank: int

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model


def make_mesh(data: int = 1, model: int = 1, rank: Optional[int] = None) -> Mesh:
    """A ``data`` x ``model`` mesh; ``rank`` defaults to this process's."""
    if rank is None:
        from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import process_index

        rank = process_index()
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} is outside a {data} x {model} mesh")
    return Mesh(data, model, rank)


def default_mesh(model_parallel: int = 1) -> Mesh:
    """Every rank of the world, ``model_parallel`` ranks per model group."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import process_count

    n = process_count()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of {model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel)
