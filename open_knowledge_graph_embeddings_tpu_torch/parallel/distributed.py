"""Several processes on ``torch.distributed``: the world, its mesh groups, and
every collective the port runs.

Counterpart of ``open_knowledge_graph_embeddings_tpu/parallel/distributed.py``.
Each process (rank) drives one card, or the CPU.  The input contract is
JAX's multi-host one: every rank builds the WHOLE global batch identically
(same dataset, seed and builder), and takes its own block of the rows
(``parallel/sharding.py``); so an n-rank run computes the 1-rank run's step
up to the order of its sums.  Replicated leaves are whole on every rank;
on a model axis (``model > 1``) the entity tables are row-sharded, each
rank holding a slab, and rows are read through :func:`boundary_gather`.
Evaluation is split by data group instead: each data group ranks a strided
slice of the eval set (``BatchBuilder(host_shard=...)``), the ranks of a
model group together (:func:`local_eval_mesh`), and the metric sums are
added over the data group with :func:`all_processes_sum`.

Every collective names its group (a mesh axis's, ``parallel/mesh.py``);
None is the world.  The backend follows the layout: ``nccl`` when each
rank has a card of its own, ``gloo`` on the CPU or when ranks share a card.
Every collective goes through the helpers below, which use the two that
``gloo`` takes on CUDA tensors, ``all_reduce`` and ``broadcast``: rows are
gathered as an ``all_reduce`` of a zero-padded buffer, a barrier is an
``all_reduce`` of one element.  A failing collective raises.
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
    _GROUPS.clear()
    _WORLD.update(rank=0, size=1, backend=None, device=None)


def _host_device() -> torch.device:
    """Where host values (flags, metric sums) are reduced: the CPU for
    ``gloo``, the rank's card for ``nccl``."""
    return _WORLD["device"] if _WORLD["backend"] == "nccl" else torch.device("cpu")


#: the process groups of each mesh shape made in this world, by (data, model)
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}


def axis_groups(data: int, model: int, rank: int) -> Dict[str, Any]:
    """This rank's groups of a ``data`` x ``model`` mesh of the world: its
    model group (the ranks of its data index) and its data group (the ranks
    of its model index).  The first call for a shape creates every group of
    both axes on every rank, in one order (``new_group`` is collective)."""
    import torch.distributed as dist

    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    if (data, model) not in _GROUPS:
        model_groups = [dist.new_group(list(range(d * model, (d + 1) * model))) for d in range(data)]
        data_groups = [dist.new_group(list(range(m, data * model, model))) for m in range(model)]
        _GROUPS[(data, model)] = (model_groups, data_groups)
    model_groups, data_groups = _GROUPS[(data, model)]
    return {MODEL_AXIS: model_groups[rank // model], DATA_AXIS: data_groups[rank % model]}


def group_size(group=None) -> int:
    """The ranks in ``group`` (None: the world)."""
    if not is_initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The sum (or ``op`` ``max``) over the ranks of ``group`` (None: the
    world), in place: every reduction of the port goes through here; the
    tensor itself in a group of one."""
    if group_size(group) == 1:
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_tensors(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the ranks of ``group``, in place, in ONE f32
    ``all_reduce`` (every rank passes tensors of the same shapes in the same
    order); nothing to do in a group of one."""
    if not tensors or group_size(group) == 1:
        return
    flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]), group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off : off + n].view(t.shape))
        off += n


def all_processes_sum(x: np.ndarray, group=None) -> np.ndarray:
    """Sum a small host vector over the ranks of ``group`` (eval metric
    sums, f64); the vector itself in a group of one."""
    if group_size(group) == 1:
        return x
    t = torch.as_tensor(np.asarray(x, np.float64), device=_host_device())
    return _all_reduce(t, group).cpu().numpy()


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank."""
    if process_count() == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=_host_device())
    dist.broadcast(t, src)
    return bool(t.item())


def barrier(group=None) -> None:
    """Every rank of ``group`` reaches this point before any leaves it."""
    if group_size(group) > 1:
        _all_reduce(torch.zeros(1, device=_host_device()), group)


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``, on every rank; its backward sums the
    ranks' cotangents (each rank's ``x`` fed every rank's result)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return x if group_size(group) == 1 else _AllReduceSum.apply(x, group)


class _ReplicatedCotangent(torch.autograd.Function):
    """The identity on a value that every rank of ``group`` computes alike;
    its backward sums the ranks' cotangents and hands the sum to one rank
    (``keep``), zeros to the others.  So the computation behind the value
    is differentiated once, with the whole cotangent, as the transpose of a
    value replicated over a JAX mesh axis is, rather than once a rank with
    each rank's part (the same sum in exact arithmetic, not in bf16)."""

    @staticmethod
    def forward(ctx, x, group, keep):
        ctx.group, ctx.keep = group, keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        g = _all_reduce(ct.contiguous().clone(), ctx.group)
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def replicated_cotangent(x: torch.Tensor, group, keep: bool) -> torch.Tensor:
    """See :class:`_ReplicatedCotangent`; ``x`` itself in a group of one."""
    return x if group_size(group) == 1 else _ReplicatedCotangent.apply(x, group, keep)


class _GatherRows(torch.autograd.Function):
    """``[A * R, ...]`` rows from each of the ``A`` ranks' ``[R, ...]`` block,
    in rank order.  Forward: an ``all_reduce`` of a zero-padded f32 buffer
    (exact: each element is one rank's value plus zeros).  Backward: every
    rank's cotangent of the whole is summed, and each rank keeps its block's
    rows."""

    @staticmethod
    def forward(ctx, x, index, parts, group):
        ctx.index, ctx.rows, ctx.group = index, x.shape[0], group
        buf = x.new_zeros((parts * x.shape[0], *x.shape[1:]), dtype=torch.float32)
        buf[index * x.shape[0] : (index + 1) * x.shape[0]] = x
        return _all_reduce(buf, group).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        g = _all_reduce(ct.float().contiguous(), ctx.group)
        lo = ctx.index * ctx.rows
        return g[lo : lo + ctx.rows].to(ct.dtype), None, None, None


def gather_rows(x: torch.Tensor, index: int, parts: int, group=None) -> torch.Tensor:
    """Differentiable gather of the ``parts`` ranks' equal row blocks of
    ``group`` (this rank's is ``x``, at ``index``)."""
    return _GatherRows.apply(x, index, parts, group)


def _owned(ids: torch.Tensor, lo: int, rows: int):
    """(mask of the ids in ``[lo, lo + rows)``, their slab-local rows, 0
    elsewhere)."""
    mine = (ids >= lo) & (ids < lo + rows)
    return mine, torch.where(mine, ids - lo, 0).long()


class _BoundaryGather(torch.autograd.Function):
    """Rows ``ids`` (global, the same on every rank of ``group``) of a table
    row-sharded over ``group``; this rank holds its slab, the rows
    ``[lo, lo + len(slab))``.  Forward: each rank writes the rows it owns
    into a zero buffer, and an ``all_reduce`` assembles them (exact: one
    rank's value plus zeros).  Backward: the ranks' cotangents are summed
    and each rank scatter-adds the rows it owns into its slab's gradient,
    the transpose of JAX's ``psum`` gather."""

    @staticmethod
    def forward(ctx, slab, ids, lo, group):
        mine, local = _owned(ids, lo, slab.shape[0])
        ctx.save_for_backward(mine, local)
        ctx.group, ctx.shape = group, slab.shape
        kind = torch.float32 if slab.is_floating_point() else torch.int64
        buf = torch.zeros((ids.shape[0], *slab.shape[1:]), dtype=kind, device=slab.device)
        buf[mine] = slab[local[mine]].to(kind)
        return _all_reduce(buf, group).to(slab.dtype)

    @staticmethod
    def backward(ctx, ct):
        mine, local = ctx.saved_tensors
        g = _all_reduce(ct.float().contiguous(), ctx.group)
        dslab = torch.zeros(ctx.shape, dtype=torch.float32, device=ct.device)
        dslab.index_add_(0, local[mine], g[mine])
        return dslab.to(ct.dtype), None, None, None


def boundary_gather(slab: torch.Tensor, ids: torch.Tensor, lo: int, group=None) -> torch.Tensor:
    """Rows ``ids`` of a table row-sharded over ``group`` (this rank's slab
    starts at row ``lo``); differentiable in ``slab``.  Every rank of
    ``group`` must pass the same ``ids``."""
    return _BoundaryGather.apply(slab, ids, lo, group)


def unshard_rows(slab: torch.Tensor, lo: int, n: int, group=None) -> torch.Tensor:
    """The whole ``[n, ...]`` table from the slabs of ``group`` (no
    gradient): one ``all_reduce`` of a zero-padded buffer."""
    with torch.no_grad():
        kind = torch.float32 if slab.is_floating_point() else torch.int64
        buf = torch.zeros((n, *slab.shape[1:]), dtype=kind, device=slab.device)
        buf[lo : lo + slab.shape[0]] = slab.to(kind)
        return _all_reduce(buf, group).to(slab.dtype)


def local_eval_mesh(mesh) -> Optional[Any]:
    """The mesh a rank evaluates in, or None without one: its model group as
    a 1 x ``model`` mesh.  With ``model = 1`` every rank holds whole
    parameters and evaluates its slice of the eval set alone; with model
    groups of several ranks the group evaluates together (each rank scores
    its slab of the candidates) and the data groups split the eval set."""
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

    if mesh is None:
        return None
    m = mesh.index(MODEL_AXIS)
    return Mesh(1, mesh.model, m, {MODEL_AXIS: mesh.group(MODEL_AXIS)} if mesh.model > 1 else {})


def tensors_of(trees: List[Any]) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts, in key order."""
    out: List[torch.Tensor] = []
    for tree in trees:
        if isinstance(tree, dict):
            out.extend(tensors_of(list(tree.values())))
        elif tree is not None:
            out.append(tree)
    return out
