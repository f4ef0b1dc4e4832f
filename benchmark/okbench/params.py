"""The weights of a run, made by the benchmark on the device from the run's
seed, one generator call a leaf, by the initialisation the configuration
states (token tables normal with ``init_std``, the LSTM's weights and biases
uniform in +-1/sqrt(H), batchnorm scales uniform in [0, 1), biases zero).
The program and the reference each get them from here, so the reference
takes no weight the program made."""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch


def leaves(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of a nested dict's leaves, paths joined by ``/``."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def node(tree: Dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """The nested dict of ``{path: leaf}``."""
    out: Dict = {}
    for path, v in flat.items():
        at = out
        *head, last = path.split("/")
        for h in head:
            at = at.setdefault(h, {})
        at[last] = v
    return out


def make_params(shapes: Dict[str, Tuple[int, ...]], seed: int, init_std: float, device) -> Dict[str, torch.Tensor]:
    """``{leaf path: f32 tensor}`` for the leaf paths and shapes of
    ``shapes``, drawn in sorted path order from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path in sorted(shapes):
        shape, leaf = shapes[path], path.rsplit("/", 1)[-1]
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if path.endswith("token_embedding"):
            t.normal_(0.0, init_std, generator=gen)
        elif leaf in ("w_ih", "w_hh", "b_ih", "b_hh"):
            k = 1.0 / math.sqrt(shapes[path.rsplit("/", 1)[0] + "/w_hh"][1])
            t.uniform_(-k, k, generator=gen)
        elif leaf == "scale":
            t.uniform_(0.0, 1.0, generator=gen)
        elif leaf == "bias":
            t.zero_()
        else:
            raise ValueError(f"no initialisation for the leaf {path}")
        out[path] = t
    return out
