"""Several processes on ``torch.distributed``: the world, and every collective
the port runs.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/distributed.py``.
Each process (rank) drives one card, or the CPU, and holds whole
parameters.  The input contract is JAX's multi-host one: every rank builds
the WHOLE global batch identically (same dataset, seed and builder), and
takes its own block of the rows (``parallel/sharding.py``); so an n-rank
run computes the 1-rank run's step up to the order of its sums.
Evaluation is split by host instead: each rank ranks a strided slice of
the eval set (``BatchBuilder(host_shard=...)``) against its own candidate
cache, and the metric sums are added with :func:`all_processes_sum`.

The backend follows the layout: ``nccl`` when each rank has a card of its
own, ``gloo`` on the CPU or when ranks share a card.  Every collective
goes through the helpers below, which use the two that ``gloo`` takes on
CUDA tensors, ``all_reduce`` and ``broadcast``: rows are gathered as an
``all_reduce`` of a zero-padded buffer, a barrier is an ``all_reduce`` of
one element.  A failing collective raises.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: the world of this process once :func:`maybe_initialize_distributed` set it up
_WORLD: Dict[str, Any] = {"rank": 0, "size": 1, "backend": None, "device": None}


def maybe_initialize_distributed(args: Optional[Dict[str, Any]] = None, device="cuda") -> Tuple[int, int]:
    """Join the world when one is configured -> ``(rank, world size)``;
    ``(0, 1)`` when none is.

    Sources, first match wins: the config keys ``coordinator_address`` /
    ``num_processes`` / ``process_id``; the environment variables
    ``OKET_COORDINATOR`` / ``OKET_NUM_PROCESSES`` / ``OKET_PROCESS_ID``;
    with ``OKET_AUTO_DISTRIBUTED`` set, the variables ``torchrun`` exports
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).  The ranks of one host are
    ``LOCAL_WORLD_SIZE`` (torchrun's), else all of them.  On ``cuda`` a rank
    runs on card ``local_rank % device_count`` (:func:`rank_device`)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return process_index(), process_count()
    args = args or {}
    env = os.environ
    coord = args.get("coordinator_address") or env.get("OKET_COORDINATOR")
    nproc = args.get("num_processes") or env.get("OKET_NUM_PROCESSES")
    pid = args.get("process_id")
    if pid is None:
        pid = env.get("OKET_PROCESS_ID")
    if coord and nproc is not None and pid is not None:
        init = coord if "://" in str(coord) else f"tcp://{coord}"
        rank, size = int(pid), int(nproc)
    elif env.get("OKET_AUTO_DISTRIBUTED"):
        init, rank, size = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return 0, 1
    local_size = int(env.get("LOCAL_WORLD_SIZE") or size)
    local_rank = int(env.get("LOCAL_RANK") or rank % local_size)
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
        if n_cards >= local_size:
            backend = "nccl"
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank, **kw)
    _WORLD.update(rank=rank, size=size, backend=backend, device=device)
    logger.info("torch.distributed: rank %d of %d via %s, backend %s, device %s", rank, size, init, backend, device)
    return rank, size


def is_initialized() -> bool:
    return _WORLD["backend"] is not None


def process_index() -> int:
    return _WORLD["rank"]


def process_count() -> int:
    return _WORLD["size"]


def backend() -> Optional[str]:
    return _WORLD["backend"]


def rank_device(device="cuda") -> torch.device:
    """The device this rank runs on: its card in a world on ``cuda``,
    ``device`` itself otherwise."""
    return _WORLD["device"] if is_initialized() else torch.device(device)


def destroy() -> None:
    """Leave the world (a no-op outside one)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.update(rank=0, size=1, backend=None, device=None)


def _host_device() -> torch.device:
    """Where host values (flags, metric sums) are reduced: the CPU for
    ``gloo``, the rank's card for ``nccl``."""
    return _WORLD["device"] if _WORLD["backend"] == "nccl" else torch.device("cpu")


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, in place: every reduction of the port goes
    through here."""
    import torch.distributed as dist

    dist.all_reduce(t)
    return t


def all_reduce_tensors(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in ONE f32 ``all_reduce``
    (every rank passes tensors of the same shapes in the same order)."""
    if not tensors:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off : off + n].view(t.shape))
        off += n


def all_processes_sum(x: np.ndarray) -> np.ndarray:
    """Sum a small host vector over the ranks (eval metric sums, f64); the
    vector itself outside a world."""
    if process_count() == 1:
        return x
    t = torch.as_tensor(np.asarray(x, np.float64), device=_host_device())
    return _all_reduce(t).cpu().numpy()


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank."""
    if process_count() == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=_host_device())
    dist.broadcast(t, src)
    return bool(t.item())


def barrier() -> None:
    """Every rank reaches this point before any leaves it."""
    if process_count() > 1:
        _all_reduce(torch.zeros(1, device=_host_device()))


class _GatherRows(torch.autograd.Function):
    """``[A * R, ...]`` rows from each of the ``A`` ranks' ``[R, ...]`` block,
    in rank order.  Forward: an ``all_reduce`` of a zero-padded f32 buffer
    (exact: each element is one rank's value plus zeros).  Backward: every
    rank's cotangent of the whole is summed, and each rank keeps its block's
    rows."""

    @staticmethod
    def forward(ctx, x, index, parts):
        ctx.index, ctx.rows = index, x.shape[0]
        buf = x.new_zeros((parts * x.shape[0], *x.shape[1:]), dtype=torch.float32)
        buf[index * x.shape[0] : (index + 1) * x.shape[0]] = x
        return _all_reduce(buf).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        g = _all_reduce(ct.float().contiguous())
        lo = ctx.index * ctx.rows
        return g[lo : lo + ctx.rows].to(ct.dtype), None, None


def gather_rows(x: torch.Tensor, index: int, parts: int) -> torch.Tensor:
    """Differentiable gather of the ``parts`` ranks' equal row blocks (this
    rank's is ``x``, at ``index``)."""
    return _GatherRows.apply(x, index, parts)


def local_eval_mesh(mesh) -> Optional[Any]:
    """The mesh a rank evaluates on by itself, or None.  With one rank per
    model group (``model = 1``) every rank holds whole parameters, so it
    evaluates its slice of the eval set alone: a 1 x 1 mesh.  Model groups
    of several ranks (ROADMAP Queue 1 item 16) would need their group."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import Mesh

    if mesh is None or mesh.model != 1:
        return None
    return Mesh(1, 1, 0)


def tensors_of(trees: List[Any]) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts, in key order."""
    out: List[torch.Tensor] = []
    for tree in trees:
        if isinstance(tree, dict):
            out.extend(tensors_of(list(tree.values())))
        elif tree is not None:
            out.append(tree)
    return out
