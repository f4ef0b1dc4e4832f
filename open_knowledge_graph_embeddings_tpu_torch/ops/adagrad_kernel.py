"""Dense in-place Adagrad with torch semantics.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/adagrad_kernel.py::
adagrad_update_pallas`` (kernel ``_kernel``).  One pass over a parameter,
its gradient and its accumulator:

    g'   = g + weight_decay * p
    acc' = acc + g'^2
    p'   = p - clr * g' / (sqrt(acc') + eps),   clr = lr / (1 + (step-1) * lr_decay)

Two versions of one function:

* the plain versions, PyTorch ops in the order of the JAX package's
  ``train/optim.py:141-155``: :func:`adagrad_clr` (the learning rate, one
  rounded f32 division), :func:`adagrad_update_plain` (one leaf, given
  clr) and :func:`adagrad_update_leaves_plain` (a group of leaves, each
  from its own step);
* the CUDA kernel ``csrc/adagrad.cu::adagrad_dense_kernel``: one launch
  updates up to :data:`MAX_LEAVES` leaves of one regime group, computing
  each leaf's step and learning rate on the card (the design and its bound
  are in the source).  It is bit-equal to the plain versions.

:func:`adagrad_update_leaves` (the optimizer's entry) and
:func:`adagrad_update` (one leaf, given clr: the TPU kernel's signature)
are the wrappers: CPU tensors take the plain versions, CUDA tensors the
kernel or raise.  They update ``p`` and ``acc`` in place (the TPU kernel
aliases them to its outputs) and count launches in
``adagrad_update.launches``.
"""

from __future__ import annotations

import array
import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import torch

#: leaves one launch takes (csrc/adagrad.cu MAX_LEAVES); a larger group
#: takes ceil(leaves / MAX_LEAVES) launches
MAX_LEAVES = 32
#: persistent blocks per SM
BLOCKS_PER_SM = 4
_SOURCE = "adagrad.cu"


def adagrad_clr(step: torch.Tensor, lr: float, lr_decay: float) -> torch.Tensor:
    """``lr / (1 + (step - 1) * lr_decay)`` in f32 with one rounded division,
    the JAX package's arithmetic (``train/optim.py:142``).  ``lr / tensor``
    would not do: torch takes it as a reciprocal and a product, two
    roundings."""
    one = torch.ones_like(step)
    return torch.div(torch.full_like(step, lr), one + (step - one) * torch.full_like(step, lr_decay))


def _check(g, p, acc, clr=None):
    if g.shape != p.shape or acc.shape != p.shape:
        raise ValueError(f"g, p and acc must have one shape, got {g.shape}, {p.shape}, {acc.shape}")
    if g.dtype != torch.float32 or p.dtype != torch.float32 or acc.dtype != torch.float32:
        raise ValueError(f"g, p and acc must be float32, got {g.dtype}, {p.dtype}, {acc.dtype}")
    if clr is not None and (clr.numel() != 1 or clr.dtype != torch.float32):
        raise ValueError(f"clr must be a float32 scalar tensor, got {clr.dtype} {tuple(clr.shape)}")
    if not (g.device == p.device == acc.device) or (clr is not None and clr.device != p.device):
        raise ValueError(f"all inputs must be on one device, got {g.device}, {p.device}, {acc.device}")


def adagrad_update_plain(g, p, acc, clr, weight_decay: float, eps: float) -> None:
    """In place: ``acc += g'^2``, ``p -= clr * g' / (sqrt(acc) + eps)``
    with ``g' = g + weight_decay * p``."""
    _check(g, p, acc, clr)
    g = g + weight_decay * p
    acc.add_(g * g)
    p.sub_(clr * g / (torch.sqrt(acc) + eps))


def adagrad_update_leaves_plain(gs, ps, accs, steps, hp: Dict[str, float]) -> List[torch.Tensor]:
    """Each leaf i as :func:`adagrad_update_plain` with the learning rate of
    step ``steps[i] + 1``; returns the new steps."""
    new_steps = []
    for g, p, acc, step in zip(gs, ps, accs, steps, strict=True):
        step = step + 1.0
        adagrad_update_plain(g, p, acc, adagrad_clr(step, hp["lr"], hp["lr_decay"]), hp["weight_decay"],
                             hp["eps"])
        new_steps.append(step)
    return new_steps


# ------------------------------------------------------------ CUDA kernel


@functools.lru_cache(maxsize=None)
def _fn():
    """The C entry, built and loaded on first use."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    fn = cuda_build.load(_SOURCE).oket_adagrad_dense
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_float] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def max_blocks(device_index: int) -> int:
    """The persistent grid's limit: a few blocks per SM of the card."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(gs, ps, accs, steps, clr, hp) -> Optional[List[torch.Tensor]]:
    """One launch over up to MAX_LEAVES leaves on one card: with ``steps``
    (one f32 element each) the kernel computes each leaf's step and
    learning rate and returns the new steps (views of one new buffer; the
    given ones are not written); else ``clr`` (a device f32 scalar) is every
    leaf's learning rate and it returns None."""
    n = len(ps)
    if not 1 <= n <= MAX_LEAVES:
        raise ValueError(f"one launch takes 1 to {MAX_LEAVES} leaves, got {n}")
    dev = ps[0].device
    out = torch.empty(n, dtype=torch.float32, device=dev) if steps is not None else None
    desc = []
    for i, (g, p, acc) in enumerate(zip(gs, ps, accs)):
        _check(g, p, acc)
        if p.device != dev:
            raise ValueError(f"all leaves must be on one device, got {dev} and {p.device}")
        if not (g.is_contiguous() and p.is_contiguous() and acc.is_contiguous()):
            raise ValueError(f"leaf {i}: g, p and acc must be contiguous")
        if steps is None:
            s_in = s_out = 0
        else:
            s = steps[i]
            if s.numel() != 1 or s.dtype != torch.float32 or s.device != dev:
                raise ValueError(f"leaf {i}: the step must be one float32 element on {dev}, got {s.dtype} "
                                 f"{tuple(s.shape)} on {s.device}")
            s_in, s_out = s.data_ptr(), out.data_ptr() + 4 * i
        desc += (g.data_ptr(), p.data_ptr(), acc.data_ptr(), s_in, s_out, p.numel())
    if clr is not None and (clr.numel() != 1 or clr.dtype != torch.float32 or clr.device != dev):
        raise ValueError(f"clr must be a float32 scalar tensor on {dev}")
    desc = array.array("q", desc)  # alive until the call returns: the C entry reads it on the host
    err = _fn()(desc.buffer_info()[0], n, None if clr is None else clr.data_ptr(),
                hp["lr"], hp["lr_decay"], hp["weight_decay"], hp["eps"], max_blocks(dev.index),
                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adagrad_dense launch failed: cudaError {err}")
    adagrad_update.launches += 1
    return None if out is None else list(out.unbind(0))


def adagrad_update_leaves(gs: Sequence[torch.Tensor], ps: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                          steps: Sequence[torch.Tensor], hp: Dict[str, float]) -> List[torch.Tensor]:
    """The dense Adagrad step of a group of leaves that share ``hp``
    (``lr``, ``lr_decay``, ``weight_decay``, ``eps``), in place on each
    ``ps[i]`` and ``accs[i]``; ``steps[i]`` is leaf i's step count so far (a
    float32 scalar tensor, not written).  Returns the new steps.  On the
    card: ceil(leaves / MAX_LEAVES) launches."""
    if not (len(gs) == len(ps) == len(accs) == len(steps)):
        raise ValueError(f"one g, p, acc and step per leaf, got {len(gs)}, {len(ps)}, {len(accs)}, {len(steps)}")
    if not ps:
        return []
    if ps[0].is_cuda:
        new_steps = []
        for i in range(0, len(ps), MAX_LEAVES):
            part = slice(i, i + MAX_LEAVES)
            new_steps += _launch(gs[part], ps[part], accs[part], steps[part], None, hp)
        return new_steps
    if ps[0].device.type == "cpu":
        return adagrad_update_leaves_plain(gs, ps, accs, steps, hp)
    raise ValueError(f"no Adagrad kernel for device {ps[0].device}")


def adagrad_update(g, p, acc, clr, weight_decay: float, eps: float) -> None:
    """Dense Adagrad step on one parameter, in place on ``p`` and ``acc``;
    ``clr`` is the effective learning rate as a float32 scalar tensor on the
    parameter's device."""
    if p.is_cuda:
        _launch([g], [p], [acc], None, clr, {"lr": 0.0, "lr_decay": 0.0, "weight_decay": weight_decay, "eps": eps})
    elif p.device.type == "cpu":
        adagrad_update_plain(g, p, acc, clr, weight_decay, eps)
    else:
        raise ValueError(f"no Adagrad kernel for device {p.device}")


adagrad_update.launches = 0
