"""Small host-side helpers: seeding, ragged-array packing, shape buckets.

Counterpart of ``open_knowledge_graph_embeddings_tpu/utils/misc.py`` (the
parts the training path uses).
"""

from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np
import torch


def set_global_seeds(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (the port's own
    randomness goes through explicit ``torch.Generator`` objects)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def pack_ragged(list_of_lists: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a list of int lists into CSR (offsets[int64, n+1], values[int32])."""
    offsets = np.zeros(len(list_of_lists) + 1, dtype=np.int64)
    np.cumsum([len(lst) for lst in list_of_lists], out=offsets[1:])
    values = np.fromiter(
        (v for lst in list_of_lists for v in lst), dtype=np.int32, count=int(offsets[-1])
    )
    return offsets, values


def next_bucket(n: int, minimum: int = 128) -> int:
    """Smallest power of two >= n (and >= minimum): data-dependent sizes
    (candidate counts, positive counts, plan heights) fall into a few
    shapes."""
    b = max(minimum, 1)
    while b < n:
        b <<= 1
    return b
