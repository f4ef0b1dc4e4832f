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

* :func:`scatter_adagrad_plain` — ``scatter_adagrad_xla``'s gather, masked
  math and two scatter-adds of exact zeros for the padding entries;
* a Triton kernel (``@triton.jit``): one program per plan entry and row of
  up to 1024 columns, the row index gathered from ``uids``; padding entries
  are masked out of every load and store.  Bound on an H100 by bytes:
  5 x 4 B per touched element (read g, p, acc; write p, acc) at 3.35 TB/s.
  ``sqrt_rn`` / ``div_rn`` and no contraction, so it is bit-equal to the
  plain version on the card.

:func:`scatter_adagrad` is the wrapper: CPU tensors take the plain version,
CUDA tensors take the kernel or raise; it counts launches in
``scatter_adagrad.launches``.
"""

from __future__ import annotations

import functools

import torch


def _check(g_rows, uids, valid, p, acc, clr):
    U, d = g_rows.shape
    if p.dim() != 2 or p.shape[1] != d or acc.shape != p.shape:
        raise ValueError(f"p and acc must be [V, {d}], got {tuple(p.shape)} and {tuple(acc.shape)}")
    if tuple(uids.shape) != (U,) or tuple(valid.shape) != (U,) or valid.dtype != torch.bool:
        raise ValueError(f"uids and valid must be [{U}] (valid bool), got {tuple(uids.shape)}, "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if {g_rows.dtype, p.dtype, acc.dtype} != {torch.float32}:
        raise ValueError("g_rows, p and acc must be float32")
    if clr.numel() != 1 or clr.dtype != torch.float32:
        raise ValueError(f"clr must be a float32 scalar tensor, got {clr.dtype} {tuple(clr.shape)}")
    devices = {x.device for x in (g_rows, uids, valid, p, acc, clr)}
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


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton.language as tl
    import triton

    @triton.jit
    def scatter_adagrad_kernel(g_ptr, uid_ptr, valid_ptr, p_ptr, acc_ptr, clr_ptr, wd, eps, d,
                               BLOCK_D: tl.constexpr):
        u = tl.program_id(0).to(tl.int64)
        cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
        ok = tl.load(valid_ptr + u) != 0
        row = tl.load(uid_ptr + u).to(tl.int64)
        m = (cols < d) & ok
        clr = tl.load(clr_ptr)
        g = tl.load(g_ptr + u * d + cols, mask=m, other=0.0)
        p = tl.load(p_ptr + row * d + cols, mask=m, other=0.0)
        a = tl.load(acc_ptr + row * d + cols, mask=m, other=0.0)
        g = g + wd * p
        a = a + g * g
        p = p - tl.div_rn(clr * g, tl.sqrt_rn(a) + eps)
        tl.store(acc_ptr + row * d + cols, a, mask=m)
        tl.store(p_ptr + row * d + cols, p, mask=m)

    return triton, scatter_adagrad_kernel


def _launch(g_rows, uids, valid, p, acc, clr, weight_decay, eps):
    _check(g_rows, uids, valid, p, acc, clr)
    for name, x in (("g_rows", g_rows), ("uids", uids), ("valid", valid), ("p", p), ("acc", acc)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    U, d = g_rows.shape
    if U == 0 or d == 0:
        return
    triton, kernel = _kernel()
    block_d = min(1024, triton.next_power_of_2(d))
    kernel[(U, triton.cdiv(d, block_d))](
        g_rows, uids, valid.view(torch.uint8), p, acc, clr, float(weight_decay), float(eps), d,
        BLOCK_D=block_d, num_warps=4, enable_fp_fusion=False,
    )
    scatter_adagrad.launches += 1


def scatter_adagrad(g_rows, uids, valid, p, acc, clr, weight_decay: float, eps: float) -> None:
    """Row-sparse Adagrad step: ``g_rows`` [U, d] f32 gradients of the rows
    ``uids`` [U] (int32 or int64; ``valid`` [U] bool marks the real
    entries) of ``p`` and ``acc`` [V, d] f32, updated in place; ``clr`` is
    the effective learning rate as a float32 scalar tensor."""
    if p.is_cuda:
        _launch(g_rows, uids, valid, p, acc, clr, weight_decay, eps)
    elif p.device.type == "cpu":
        scatter_adagrad_plain(g_rows, uids, valid, p, acc, clr, weight_decay, eps)
    else:
        raise ValueError(f"no row-Adagrad kernel for device {p.device}")


scatter_adagrad.launches = 0
