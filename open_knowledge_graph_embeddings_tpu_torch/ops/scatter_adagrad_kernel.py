"""Row-sparse Adagrad with lazy weight decay, indexed by compact row ids.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/scatter_adagrad_kernel.py``:
``scatter_adagrad_pallas`` (kernel ``_make_kernel``) and its XLA twin
``scatter_adagrad_xla``, which compute one function.  For each valid entry u
of the compact plan, row r = uids[u] of the parameter and accumulator
tables is updated in place:

    g'     = g_rows[u] + weight_decay * p[r]
    acc[r] = acc[r] + g'^2
    p[r]   = p[r] - clr * g' / (sqrt(acc[r]) + eps)

Entries with ``valid`` False are padding: the plan builder pads ``uids``
with row 0, which is also a real entry (the PAD token row), so a padding
entry must not touch row 0 at all — with weight decay, row 0's real update
is not a no-op and a second read-modify-write of it would race with it.
The TPU kernel stages whole 8-row HBM tiles by DMA; a GPU addresses single
rows, so the port takes the compact ``uids`` directly.

Two versions:

* the plain versions: :func:`scatter_adagrad_plain` (one table, given clr:
  ``scatter_adagrad_xla``'s gather, masked math and two scatter-adds of
  exact zeros for the padding entries) and
  :func:`scatter_adagrad_tables_plain` (the tables of a group, each with
  the learning rate of its own step, ``ops/adagrad_kernel.py::adagrad_clr``);
* the CUDA kernel ``csrc/adagrad.cu::adagrad_rows_kernel``: one launch
  updates up to :data:`MAX_TABLES` tables of one regime group, one warp per
  plan entry, each table's step and learning rate computed on the card (the
  design and its bound are in the source).  It is bit-equal to the plain
  versions.

:func:`scatter_adagrad_tables` (the sparse step's entry) and
:func:`scatter_adagrad` (one table, given clr) are the wrappers: CPU
tensors take the plain versions, CUDA tensors the kernel or raise; they
count launches in ``scatter_adagrad.launches``.
"""

from __future__ import annotations

import array
import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops.adagrad_kernel import _SOURCE, adagrad_clr, max_blocks

#: tables one launch takes (csrc/adagrad.cu MAX_TABLES)
MAX_TABLES = 8


def _check(g_rows, uids, valid, p, acc, clr=None):
    if g_rows.dim() != 2:
        raise ValueError(f"g_rows must be [U, d], got {tuple(g_rows.shape)}")
    U, d = g_rows.shape
    if p.dim() != 2 or p.shape[1] != d or acc.shape != p.shape:
        raise ValueError(f"p and acc must be [V, {d}], got {tuple(p.shape)} and {tuple(acc.shape)}")
    if tuple(uids.shape) != (U,) or tuple(valid.shape) != (U,) or valid.dtype != torch.bool:
        raise ValueError(f"uids and valid must be [{U}] (valid bool), got {tuple(uids.shape)}, "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if uids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"uids must be int32 or int64, got {uids.dtype}")
    if g_rows.dtype != torch.float32 or p.dtype != torch.float32 or acc.dtype != torch.float32:
        raise ValueError("g_rows, p and acc must be float32")
    if clr is not None and (clr.numel() != 1 or clr.dtype != torch.float32):
        raise ValueError(f"clr must be a float32 scalar tensor, got {clr.dtype} {tuple(clr.shape)}")
    devices = {x.device for x in (g_rows, uids, valid, p, acc)} | ({clr.device} if clr is not None else set())
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def scatter_adagrad_plain(g_rows, uids, valid, p, acc, clr, weight_decay: float, eps: float) -> None:
    """In place on the rows ``uids[valid]`` of ``p`` and ``acc``; duplicate
    uids may occur only among the invalid entries."""
    _check(g_rows, uids, valid, p, acc, clr)
    uids = uids.long()
    vm = valid[:, None].float()
    g = (g_rows + weight_decay * p[uids]) * vm
    g2 = g * g
    delta = -clr * g / (torch.sqrt(acc[uids] + g2) + eps)
    # invalid entries add exact zeros, so duplicate padding ids are harmless
    acc.index_add_(0, uids, g2)
    p.index_add_(0, uids, delta * vm)


def scatter_adagrad_tables_plain(g_rows, uids, valid, ps, accs, steps, hp: Dict[str, float]) -> List[torch.Tensor]:
    """Each table i as :func:`scatter_adagrad_plain` with the learning rate
    of step ``steps[i] + 1``; returns the new steps."""
    new_steps = []
    for g, u, v, p, acc, step in zip(g_rows, uids, valid, ps, accs, steps, strict=True):
        step = step + 1.0
        scatter_adagrad_plain(g, u, v, p, acc, adagrad_clr(step, hp["lr"], hp["lr_decay"]), hp["weight_decay"],
                              hp["eps"])
        new_steps.append(step)
    return new_steps


# ------------------------------------------------------------ CUDA kernel


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry, built and loaded on first use."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    fn = cuda_build.load(_SOURCE).oket_adagrad_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_float] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g_rows, uids, valid, ps, accs, steps, clr, hp) -> Optional[List[torch.Tensor]]:
    """One launch over up to MAX_TABLES tables on one card; ``steps`` and
    ``clr`` as in ``ops/adagrad_kernel.py::_launch``."""
    n = len(ps)
    if not 1 <= n <= MAX_TABLES:
        raise ValueError(f"one launch takes 1 to {MAX_TABLES} tables, got {n}")
    dev = ps[0].device
    out = torch.empty(n, dtype=torch.float32, device=dev) if steps is not None else None
    desc = []
    for i, (g, u, v, p, acc) in enumerate(zip(g_rows, uids, valid, ps, accs)):
        _check(g, u, v, p, acc)
        if p.device != dev:
            raise ValueError(f"all tables must be on one device, got {dev} and {p.device}")
        if not all(x.is_contiguous() for x in (g, u, v, p, acc)):
            raise ValueError(f"table {i}: g_rows, uids, valid, p and acc must be contiguous")
        if steps is None:
            s_in = s_out = 0
        else:
            s = steps[i]
            if s.numel() != 1 or s.dtype != torch.float32 or s.device != dev:
                raise ValueError(f"table {i}: the step must be one float32 element on {dev}, got {s.dtype} "
                                 f"{tuple(s.shape)} on {s.device}")
            s_in, s_out = s.data_ptr(), out.data_ptr() + 4 * i
        U, d = g.shape
        desc += (g.data_ptr(), u.data_ptr(), v.data_ptr(), p.data_ptr(), acc.data_ptr(), s_in, s_out, U, d,
                 int(u.dtype == torch.int64))
    if clr is not None and (clr.numel() != 1 or clr.dtype != torch.float32 or clr.device != dev):
        raise ValueError(f"clr must be a float32 scalar tensor on {dev}")
    desc = array.array("q", desc)  # alive until the call returns: the C entry reads it on the host
    err = _fn()(desc.buffer_info()[0], n, None if clr is None else clr.data_ptr(),
                hp["lr"], hp["lr_decay"], hp["weight_decay"], hp["eps"], max_blocks(dev.index),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adagrad_rows launch failed: cudaError {err}")
    scatter_adagrad.launches += 1
    return None if out is None else list(out.unbind(0))


def scatter_adagrad_tables(g_rows: Sequence[torch.Tensor], uids: Sequence[torch.Tensor],
                           valid: Sequence[torch.Tensor], ps: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                           steps: Sequence[torch.Tensor], hp: Dict[str, float]) -> List[torch.Tensor]:
    """The row-sparse Adagrad step of a group of tables that share ``hp``
    (``lr``, ``lr_decay``, ``weight_decay``, ``eps``): table i's plan
    (``g_rows[i]`` [U, d] f32, ``uids[i]`` [U] int32/int64, ``valid[i]``
    [U] bool) updates ``ps[i]`` and ``accs[i]`` [V, d] f32 in place with the
    learning rate of step ``steps[i] + 1`` (``steps[i]`` is not written).
    Returns the new steps.  On the card: ceil(tables / MAX_TABLES)
    launches."""
    if not (len(g_rows) == len(uids) == len(valid) == len(ps) == len(accs) == len(steps)):
        raise ValueError("one g_rows, uids, valid, p, acc and step per table")
    if not ps:
        return []
    if ps[0].is_cuda:
        new_steps = []
        for i in range(0, len(ps), MAX_TABLES):
            part = slice(i, i + MAX_TABLES)
            new_steps += _launch(g_rows[part], uids[part], valid[part], ps[part], accs[part], steps[part], None, hp)
        return new_steps
    if ps[0].device.type == "cpu":
        return scatter_adagrad_tables_plain(g_rows, uids, valid, ps, accs, steps, hp)
    raise ValueError(f"no row-Adagrad kernel for device {ps[0].device}")


def scatter_adagrad(g_rows, uids, valid, p, acc, clr, weight_decay: float, eps: float) -> None:
    """Row-sparse Adagrad step: ``g_rows`` [U, d] f32 gradients of the rows
    ``uids`` [U] (int32 or int64; ``valid`` [U] bool marks the real
    entries) of ``p`` and ``acc`` [V, d] f32, updated in place; ``clr`` is
    the effective learning rate as a float32 scalar tensor."""
    if p.is_cuda:
        _launch([g_rows], [uids], [valid], [p], [acc], None, clr,
                {"lr": 0.0, "lr_decay": 0.0, "weight_decay": weight_decay, "eps": eps})
    elif p.device.type == "cpu":
        scatter_adagrad_plain(g_rows, uids, valid, p, acc, clr, weight_decay, eps)
    else:
        raise ValueError(f"no row-Adagrad kernel for device {p.device}")


scatter_adagrad.launches = 0
