"""Which arrays of a training batch split over which mesh axis.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/sharding.py``
(``train_batch_shardings``), on a mesh of ranks: a key maps to the axis
whose ranks each take one contiguous block of its rows, or to None when
every rank holds it whole.  Rows go over ``data`` when their count divides;
the candidate ids ride ``model``, or ``data`` on a pure data-parallel mesh,
where each rank encodes its block of the candidates and the [N, d] result
is gathered (models/model.py).  Positives, scalars, plans and anything
that does not divide stay whole.  Parameters and optimizer state are whole
on every rank of a pure data-parallel mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

#: the batch keys indexed by prefix row
ROW_KEYS = ("ent_ids", "rel_ids", "is_sp", "row_valid", "dedup/ent_inv", "dedup/rel_inv")


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
