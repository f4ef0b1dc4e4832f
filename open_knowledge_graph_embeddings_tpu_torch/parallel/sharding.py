"""Which arrays split over which mesh axis: the row-sharded tables and their
optimizer state, and the arrays of a training batch.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/sharding.py``
on a mesh of ranks.

* Parameters (:func:`variables_shardings`): the entity tables
  (``entity_embedding``, ``entity_token_embedding``) are row-sharded over
  ``model``: rank m holds the slab ``slab_bounds(n, model, m)`` of their n
  rows, JAX's uneven placement (``ceil(n / model)`` rows a shard, the last
  shorter), so per-shard checkpoint regions match JAX's.  Every other leaf
  is whole on every rank.  The token-id buffers stay whole on every rank
  (JAX row-shards its copy; they are rebuilt from the dataset, never
  saved).  :func:`shard_variables` keeps a rank's slab of each sharded
  table and records it under ``variables["slabs"]``.
* Optimizer state (:func:`opt_state_shardings`) follows its parameter;
  scalars (step counters) are whole.
* A training batch (:func:`train_batch_shardings`): a key maps to the axis
  whose ranks each take one contiguous block of its rows, or to None when
  every rank holds it whole.  Rows go over ``data`` when their count
  divides; the candidate ids ride ``model`` (each rank encodes and scores
  its block, ``slab_bounds``), or ``data`` on a pure data-parallel mesh,
  where each rank encodes its block of the candidates and the [N, d]
  result is gathered (models/model.py).  Positives, scalars, plans and
  anything that does not divide stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

#: the batch keys indexed by prefix row
ROW_KEYS = ("ent_ids", "rel_ids", "is_sp", "row_valid", "dedup/ent_inv", "dedup/rel_inv")
#: parameters whose rows are sharded over ``model``
ROW_SHARDED_TABLES = ("entity_embedding", "entity_token_embedding")


def train_batch_shardings(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Optional[str]]:
    data_n, model_n = mesh.data, mesh.model
    out: Dict[str, Optional[str]] = {}
    for k, v in batch.items():
        n = tuple(getattr(v, "shape", ()))[:1]
        if k in ROW_KEYS and n and n[0] % data_n == 0:
            out[k] = DATA_AXIS
        elif k in ("candidate_ids", "col_valid") and n:
            if model_n > 1 and n[0] % model_n == 0:
                out[k] = MODEL_AXIS
            elif model_n == 1 and n[0] % data_n == 0:
                out[k] = DATA_AXIS
            else:
                out[k] = None
        else:
            out[k] = None
    return out


def block(n: int, mesh: Mesh, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """``[lo, hi)`` of this rank's contiguous block of ``n`` rows over
    ``axis`` (blocks differ by at most one row when ``n`` does not divide)."""
    a, i = mesh.shape[axis], mesh.index(axis)
    q, r = divmod(n, a)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


def slab_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of shard ``index`` of ``n`` rows over ``parts``: JAX's
    placement of an uneven ``NamedSharding``, ``ceil(n / parts)`` rows a
    shard (the last ones shorter, possibly empty)."""
    c = -(-n // parts)
    lo = min(index * c, n)
    return lo, min(lo + c, n)


@dataclass(frozen=True)
class RowBlock:
    """This rank's block ``[lo, hi)`` of ``n`` rows split over the ``parts``
    ranks of ``group`` by :func:`slab_bounds`, the ``index``-th (the
    candidate block of a model axis)."""

    lo: int
    hi: int
    n: int
    parts: int
    index: int
    group: Any = None

    @property
    def width(self) -> int:
        """The largest block's rows (the first rank's)."""
        return -(-self.n // self.parts)


def _sharded_name(path: str) -> bool:
    return any(part in ROW_SHARDED_TABLES for part in path.split("/"))


def variables_shardings(variables: Dict[str, Any], mesh: Mesh) -> Dict[str, Optional[str]]:
    """{flat ``params/...`` / ``state/...`` key: ``model`` or None}: the
    row-sharded tables ride ``model`` when it has several ranks."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    out: Dict[str, Optional[str]] = {}
    for top in ("params", "state"):
        for path, _ in leaves(variables.get(top, {})):
            out[f"{top}/{path}"] = MODEL_AXIS if mesh.model > 1 and top == "params" and _sharded_name(path) else None
    return out


def opt_state_shardings(opt_state: Dict[str, Any], var_shardings: Dict[str, Optional[str]]) -> Dict[str, Optional[str]]:
    """{flat ``opt/...`` key: axis}: an accumulator shards like its
    parameter, a scalar (the step) is whole."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    out: Dict[str, Optional[str]] = {}
    for path, leaf in leaves(opt_state):
        param = "params/" + path.rsplit("/", 1)[0]
        out[f"opt/{path}"] = var_shardings.get(param) if leaf.dim() > 0 else None
    return out


def shard_variables(variables: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """``variables`` with each row-sharded table (whole, the same on every
    rank) cut to this rank's slab, and ``variables["slabs"]`` = {table:
    (lo, hi, n)}; unchanged without a model axis."""
    if mesh is None or mesh.model == 1:
        return variables
    params, slabs = dict(variables["params"]), {}
    m = mesh.index(MODEL_AXIS)
    for name in ROW_SHARDED_TABLES:
        if name in params:
            n = params[name].shape[0]
            lo, hi = slab_bounds(n, mesh.model, m)
            params[name] = params[name][lo:hi].clone()
            slabs[name] = (lo, hi, n)
    return {**variables, "params": params, "slabs": slabs}


def slab_regions(variables: Dict[str, Any], opt_state: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Tuple[int, int, int]]:
    """{flat checkpoint key: (lo, hi, n)} of every leaf this rank holds as a
    slab: the sharded tables and their optimizer state (not its scalars)."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import leaves

    slabs = variables.get("slabs") or {}
    out = {f"params/{name}": b for name, b in slabs.items()}
    for path, leaf in leaves(opt_state or {}):
        name = path.rsplit("/", 1)[0]
        if name in slabs and leaf.dim() > 0:
            out[f"opt/{path}"] = slabs[name]
    return out
