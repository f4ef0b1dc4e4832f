"""Dense in-place Adagrad with torch semantics.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/adagrad_kernel.py::
adagrad_update_pallas`` (kernel ``_kernel``).  One pass over a parameter,
its gradient and its accumulator:

    g'   = g + weight_decay * p
    acc' = acc + g'^2
    p'   = p - clr * g' / (sqrt(acc') + eps),   clr = lr / (1 + (step-1) * lr_decay)

Two versions of one function:

* :func:`adagrad_update_plain` — the same arithmetic as PyTorch ops, in the
  order of ``train/optim.py:153-155``;
* a Triton kernel (``@triton.jit``), one elementwise pass in blocks of 1024
  f32 elements.  Bound on an H100 by bytes: 5 x 4 B per element (read g, p,
  acc; write p, acc), at 3.35 TB/s.  ``clr`` stays a device scalar (it
  depends on the device-side step count), read once per block.  The square
  root and the division are the correctly rounded ``sqrt_rn`` / ``div_rn``
  and floating-point contraction is off, so the kernel is bit-equal to the
  plain version on the card rather than within the error of fast math.

:func:`adagrad_update` is the wrapper: CPU tensors take the plain version,
CUDA tensors take the kernel or raise.  It updates ``p`` and ``acc`` in
place (the TPU kernel aliases them to its outputs) and counts launches in
``adagrad_update.launches``.
"""

from __future__ import annotations

import functools

import torch

BLOCK = 1024


def _check(g, p, acc, clr):
    if g.shape != p.shape or acc.shape != p.shape:
        raise ValueError(f"g, p and acc must have one shape, got {g.shape}, {p.shape}, {acc.shape}")
    if {g.dtype, p.dtype, acc.dtype} != {torch.float32}:
        raise ValueError(f"g, p and acc must be float32, got {g.dtype}, {p.dtype}, {acc.dtype}")
    if clr.numel() != 1 or clr.dtype != torch.float32:
        raise ValueError(f"clr must be a float32 scalar tensor, got {clr.dtype} {tuple(clr.shape)}")
    devices = {x.device for x in (g, p, acc, clr)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")


def adagrad_update_plain(g, p, acc, clr, weight_decay: float, eps: float) -> None:
    """In place: ``acc += g'^2``, ``p -= clr * g' / (sqrt(acc) + eps)``
    with ``g' = g + weight_decay * p``."""
    _check(g, p, acc, clr)
    g = g + weight_decay * p
    acc.add_(g * g)
    p.sub_(clr * g / (torch.sqrt(acc) + eps))


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def adagrad_kernel(g_ptr, p_ptr, acc_ptr, clr_ptr, wd, eps, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        clr = tl.load(clr_ptr)
        g = tl.load(g_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        a = tl.load(acc_ptr + offs, mask=m, other=0.0)
        g = g + wd * p
        a = a + g * g
        p = p - tl.div_rn(clr * g, tl.sqrt_rn(a) + eps)
        tl.store(acc_ptr + offs, a, mask=m)
        tl.store(p_ptr + offs, p, mask=m)

    return triton, adagrad_kernel


def _launch(g, p, acc, clr, weight_decay, eps):
    _check(g, p, acc, clr)
    for name, x in (("g", g), ("p", p), ("acc", acc)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = p.numel()
    if n == 0:
        return
    triton, kernel = _kernel()
    kernel[(triton.cdiv(n, BLOCK),)](
        g, p, acc, clr, float(weight_decay), float(eps), n,
        BLOCK=BLOCK, num_warps=4, enable_fp_fusion=False,
    )
    adagrad_update.launches += 1


def adagrad_update(g, p, acc, clr, weight_decay: float, eps: float) -> None:
    """Dense Adagrad step on one parameter, in place on ``p`` and ``acc``;
    ``clr`` is the effective learning rate as a float32 scalar tensor on the
    parameter's device."""
    if p.is_cuda:
        _launch(g, p, acc, clr, weight_decay, eps)
    elif p.device.type == "cpu":
        adagrad_update_plain(g, p, acc, clr, weight_decay, eps)
    else:
        raise ValueError(f"no Adagrad kernel for device {p.device}")


adagrad_update.launches = 0
