"""The ranks of a run laid out as a [data, model] mesh.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/mesh.py``.
In the port one process drives one card, so the mesh's devices are the
processes (ranks) of the ``torch.distributed`` world, rank-major over
``model``: rank ``d * model + m`` has data index d and model index m.

* ``data``: the rows of a training batch (prefixes) split over it; the
  gradients of replicated leaves are summed over the world, those of a
  row-sharded table's slab over its data group;
* ``model``: row-sharded entity tables (each rank holds a slab of their
  rows, ``parallel/sharding.py``) and the candidate axis of the scores
  (each rank encodes and scores its block of the candidates).

Each axis has its process groups: for every data index its model group
(the ``model`` ranks ``d * model .. d * model + model - 1``), for every
model index its data group.  Every rank creates all of them, in the same
order, when a mesh of that shape is first made in a world
(:func:`..parallel.distributed.axis_groups`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks, rank-major over ``model``; ``rank`` is
    this process's place in it; ``groups`` maps each axis to the process
    group of this rank's ranks along it (empty outside a world)."""

    data: int
    model: int
    rank: int
    groups: Dict[str, Any] = field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model

    def group(self, axis: str):
        """The process group of the ranks that share this rank's other
        coordinate (its model group for ``model``, its data group for
        ``data``); None outside a world."""
        return self.groups.get(axis)


def make_mesh(data: int = 1, model: int = 1, rank: Optional[int] = None) -> Mesh:
    """A ``data`` x ``model`` mesh; ``rank`` defaults to this process's.  In a
    world of ``data * model`` ranks the mesh carries its axis groups."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel import distributed as dist

    if rank is None:
        rank = dist.process_index()
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} is outside a {data} x {model} mesh")
    groups = {}
    if dist.is_initialized() and dist.process_count() == data * model:
        groups = dist.axis_groups(data, model, rank)
    return Mesh(data, model, rank, groups)


def default_mesh(model_parallel: int = 1) -> Mesh:
    """Every rank of the world, ``model_parallel`` ranks per model group."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import process_count

    n = process_count()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of {model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel)
