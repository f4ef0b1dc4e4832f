"""Length-aware fused LSTM that returns each row's last state, with its backward.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::
lstm_encode_last_fused``: the forward ``_fused_fwd_last`` (kernel
``_fused_fwd_last_kernel``) and the backward ``_fused_bwd_last`` (kernel
``_fused_bwd_last_kernel``), joined by a custom VJP there and by
:class:`_LstmLast` (an ``autograd.Function``) here.  Two versions of each half:

* the plain PyTorch versions, :func:`lstm_encode_last_plain` and
  :func:`lstm_last_backward_plain` — loops over t with ``torch.matmul`` that
  repeat the kernels' arithmetic: f32 products of the compute-dtype operands
  (bf16 x bf16 is exact in f32), f32 gate math, cell state and carries, h
  rounded to the weight dtype before the recurrent product, and in the
  backward the residuals read in the compute dtype and dgates rounded to it
  before every product.  CPU tensors go here, and ``chip_smoke.py`` holds the
  kernels against them on the card;
* the hand-written CUDA kernels ``csrc/lstm_last_fwd.cu`` (one launch per
  step; with residuals it also writes hs/cs) and ``csrc/lstm_last_bwd.cu``
  (two launches per step and one for dW and db).  Both are bound by tensor-core
  operations on an H100; their design notes are at the top of the sources.

:func:`lstm_encode_last_fused` and :func:`lstm_last_backward` are the
wrappers: a CPU tensor takes the plain version, a CUDA tensor takes the
kernel or raises.  Each counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_FWD_SOURCE = "lstm_last_fwd.cu"
_BWD_SOURCE = "lstm_last_bwd.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _check(emb_tm, w_ih, w_hh, bias, lengths):
    if emb_tm.dim() != 3:
        raise ValueError(f"emb_tm must be [L, B, D], got {tuple(emb_tm.shape)}")
    L, B, D = emb_tm.shape
    H = w_hh.shape[-1]
    if tuple(w_ih.shape) != (4 * H, D) or tuple(w_hh.shape) != (4 * H, H):
        raise ValueError(
            f"weights must be w_ih [4H, D] = [{4 * H}, {D}] and w_hh [4H, H] = "
            f"[{4 * H}, {H}], got {tuple(w_ih.shape)} and {tuple(w_hh.shape)}"
        )
    if w_ih.dtype != emb_tm.dtype or w_hh.dtype != emb_tm.dtype:
        raise ValueError("w_ih and w_hh must have emb_tm's dtype")
    if tuple(bias.shape) != (4 * H,) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 [{4 * H}], got {bias.dtype} {tuple(bias.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")
    devices = {t.device for t in (emb_tm, w_ih, w_hh, bias, lengths)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    return L, B, D, H


def _check_residuals(L, B, H, dtype, hs, cs, dlast, device):
    for name, x, shape in (("hs", hs, (L, B, H)), ("cs", cs, (L, B, H)), ("dlast", dlast, (B, H))):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"{name} must be {dtype} {list(shape)} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


# ------------------------------------------------------------ plain versions


def _gates(x, h_prev, w_ih_t, w_hh_t, bias):
    """f32 pre-activations: x·W_ihᵀ + bias + h·W_hhᵀ (h already in the weight dtype)."""
    return torch.matmul(x.float(), w_ih_t) + bias + torch.matmul(h_prev.float(), w_hh_t)


def lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths, residuals: bool = False):
    """``emb_tm`` [L, B, D] (rows sorted by descending length), ``w_ih``
    [4H, D], ``w_hh`` [4H, H] (gate-major, as ``nn.LSTM`` stores them) in
    ``emb_tm``'s dtype, ``bias`` [4H] f32,
    ``lengths`` [B] -> ``last`` [B, H] in ``emb_tm``'s dtype: h at each row's
    step ``max(len, 1)``.  Every row runs all L steps; rows are independent,
    so a row's extra steps never reach another row's output.  With
    ``residuals`` also returns ``hs`` and ``cs`` [L, B, H] in ``emb_tm``'s
    dtype, the backward's inputs."""
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dt = emb_tm.dtype
    lens = lengths.clamp(min=1)
    w_ih_t = w_ih.float().t()
    w_hh_t = w_hh.float().t()
    h = torch.zeros(B, H, dtype=torch.float32, device=emb_tm.device)
    c = torch.zeros_like(h)
    last = torch.zeros(B, H, dtype=dt, device=emb_tm.device)
    hs, cs = [], []
    for t in range(L):
        i, f, g, o = _gates(emb_tm[t], h.to(dt), w_ih_t, w_hh_t, bias).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        last = torch.where((lens == t + 1)[:, None], h.to(dt), last)
        if residuals:
            hs.append(h.to(dt))
            cs.append(c.to(dt))
    if residuals:
        return last, torch.stack(hs), torch.stack(cs)
    return last


def _bwd_cell(gates, c_prev, c_t, dh, dc, dlast_in):
    """One step of ``_fused_bwd_last_kernel``'s cell arithmetic (:603-630),
    f32: the gate activations from their pre-activations, then
    ``(dgates [B, 4H], dc_prev)`` from the carries ``dh`` and ``dc`` and the
    cotangent injected at this step (``dlast_in``, 0 for the other rows)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    dh = dh + dlast_in
    tc = torch.tanh(c_t)
    do = dh * tc
    dc = dc + dh * o * (1.0 - tc * tc)
    dgates = torch.cat(
        [dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f), dc * i * (1.0 - g * g), do * o * (1.0 - o)],
        dim=-1,
    )
    return dgates, dc * f


def lstm_last_backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast):
    """The backward of :func:`lstm_encode_last_plain` from its residuals:
    ``hs``, ``cs`` [L, B, H] and the cotangent ``dlast`` [B, H], all in
    ``emb_tm``'s dtype -> ``(demb [L, B, D] in emb_tm's dtype, dw_ih, dw_hh
    in the weight dtype, db [4H] f32)``.  A reverse loop over t on the rows
    active at t (``max(len, 1) > t``): dlast enters at each row's step
    ``max(len, 1)``, the gates are recomputed from ``hs[t-1]``, c is read
    from the residuals (so at bf16 ``tanh(c_t)`` sees a bf16-rounded c),
    dh and dc carry in f32, dgates are rounded to the weight dtype before
    the demb, dh and dW products, db sums the unrounded f32 dgates, and dW
    accumulates in f32 and is rounded to the weight dtype at the end.
    demb is 0 at the positions a row never reaches."""
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dt = emb_tm.dtype
    dev = emb_tm.device
    _check_residuals(L, B, H, dt, hs, cs, dlast, dev)
    lens = lengths.clamp(min=1)
    w_ih32, w_hh32 = w_ih.float(), w_hh.float()
    w_ih_t, w_hh_t = w_ih32.t(), w_hh32.t()
    zeros = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dh, dc = zeros, zeros
    demb = torch.zeros(L, B, D, dtype=dt, device=dev)
    dw_ih = torch.zeros(4 * H, D, dtype=torch.float32, device=dev)
    dw_hh = torch.zeros(4 * H, H, dtype=torch.float32, device=dev)
    db = torch.zeros(4 * H, dtype=torch.float32, device=dev)
    dl = dlast.float()
    for t in reversed(range(L)):
        active = (lens > t)[:, None]
        # rows inactive at t are never read (the kernels' residuals hold
        # garbage there, possibly NaN, which would reach dW_hh through 0 * NaN)
        h_prev = torch.where(active, hs[t - 1], 0.0) if t > 0 else torch.zeros(B, H, dtype=dt, device=dev)
        c_prev = cs[t - 1].float() if t > 0 else zeros
        gates = _gates(emb_tm[t], h_prev, w_ih_t, w_hh_t, bias)
        dlast_in = torch.where((lens == t + 1)[:, None], dl, 0.0)
        dgates, dc_prev = _bwd_cell(gates, c_prev, cs[t].float(), dh, dc, dlast_in)
        dgates = torch.where(active, dgates, 0.0)
        dg = dgates.to(dt).float()
        demb[t] = torch.matmul(dg, w_ih32).to(dt)
        dh = torch.where(active, torch.matmul(dg, w_hh32), 0.0)
        dc = torch.where(active, dc_prev, 0.0)
        dw_ih += torch.matmul(dg.t(), emb_tm[t].float())
        if t > 0:
            dw_hh += torch.matmul(dg.t(), h_prev.float())
        db += dgates.sum(0)
    return demb, dw_ih.to(dt), dw_hh.to(dt), db


# ------------------------------------------------------------ CUDA kernels


@functools.lru_cache(maxsize=None)
def _fwd_fn():
    """The forward kernel's C entry point, built and loaded on first use."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    fn = cuda_build.load(_FWD_SOURCE).oket_lstm_last_step_bf16
    fn.argtypes = [_P] * 10 + [_LL, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    """The backward kernels' C entry points (gate, product, dW)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_BWD_SOURCE)
    gate, prod, dw = lib.oket_lstm_bwd_gate_bf16, lib.oket_lstm_bwd_product_bf16, lib.oket_lstm_bwd_dw_bf16
    gate.argtypes = [_P] * 13 + [_LL, _I, _I, _I, _P]
    prod.argtypes = [_P] * 6 + [_LL, _I, _I, _I, _P]
    dw.argtypes = [_P] * 8 + [_LL, _I, _I, _I, _P]
    for fn in (gate, prod, dw):
        fn.restype = _I
    return gate, prod, dw


def _check_kernel_inputs(dtype, D, H, **tensors):
    if dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA LSTM kernels take bfloat16 inputs, got {dtype}; "
            "run an f32 model with device='cpu'"
        )
    if D % 8 or H % 8:
        raise ValueError(f"the CUDA LSTM kernels take D and H divisible by 8, got D={D} H={H}")
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _launch_forward(emb_tm, w_ih, w_hh, bias, lengths, residuals):
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    _check_kernel_inputs(emb_tm.dtype, D, H, emb_tm=emb_tm, w_ih=w_ih, w_hh=w_hh)
    fn = _fwd_fn()
    bias = bias.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    dev, dt = emb_tm.device, emb_tm.dtype
    c = torch.empty(B, H, dtype=torch.float32, device=dev)
    last = torch.zeros(B, H, dtype=dt, device=dev)
    if residuals:
        # the h of step t is written straight into its residual slice hs[t]
        hs = torch.empty(L, B, H, dtype=dt, device=dev)
        cs = torch.empty(L, B, H, dtype=dt, device=dev)
        h_bufs = [hs[t] for t in range(L)]
    else:
        hs = cs = None
        h_bufs = [torch.empty(B, H, dtype=dt, device=dev) for _ in range(2)]
    if B and H:
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t in range(L):
            h_prev = h_bufs[(t - 1) % len(h_bufs)]
            h_next = h_bufs[t % len(h_bufs)]
            err = fn(
                emb_tm[t].data_ptr(), h_prev.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
                bias.data_ptr(), lens.data_ptr(), c.data_ptr(), h_next.data_ptr(),
                cs[t].data_ptr() if residuals else None, last.data_ptr(), B, D, H, t, stream,
            )
            _raise_on(err, f"lstm_last_fwd step {t}")
            lstm_encode_last_fused.launches += 1
    return (last, hs, cs) if residuals else last


def _launch_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast):
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dev, dt = emb_tm.device, emb_tm.dtype
    _check_residuals(L, B, H, dt, hs, cs, dlast, dev)
    _check_kernel_inputs(dt, D, H, emb_tm=emb_tm, w_ih=w_ih, w_hh=w_hh, hs=hs, cs=cs, dlast=dlast)
    gate, prod, dw = _bwd_fns()
    bias = bias.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dc = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dg = torch.empty(L, B, 4 * H, dtype=dt, device=dev)
    # per step and row block of 128 (the gate kernel's): written for the
    # active blocks, which are the only ones the dW kernel sums into db
    db_part = torch.empty(L, -(-B // 128), 4 * H, dtype=torch.float32, device=dev)
    demb = torch.empty(L, B, D, dtype=dt, device=dev)
    dw_ih = torch.empty(4 * H, D, dtype=dt, device=dev)
    dw_hh = torch.empty(4 * H, H, dtype=dt, device=dev)
    db = torch.empty(4 * H, dtype=torch.float32, device=dev)
    if not (B and H):
        return demb.zero_(), dw_ih.zero_(), dw_hh.zero_(), db.zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for t in reversed(range(L)):
        prev = max(t - 1, 0)
        err = gate(
            emb_tm[t].data_ptr(), hs[prev].data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
            bias.data_ptr(), lens.data_ptr(), cs[t].data_ptr(), cs[prev].data_ptr(),
            dlast.data_ptr(), dh.data_ptr(), dc.data_ptr(), dg[t].data_ptr(), db_part[t].data_ptr(),
            B, D, H, t, stream,
        )
        _raise_on(err, f"lstm_last_bwd gate step {t}")
        err = prod(
            dg[t].data_ptr(), w_hh.data_ptr(), w_ih.data_ptr(), lens.data_ptr(),
            dh.data_ptr(), demb[t].data_ptr(), B, D, H, t, stream,
        )
        _raise_on(err, f"lstm_last_bwd product step {t}")
        lstm_last_backward.launches += 2
    err = dw(dg.data_ptr(), emb_tm.data_ptr(), hs.data_ptr(), lens.data_ptr(), db_part.data_ptr(),
             dw_ih.data_ptr(), dw_hh.data_ptr(), db.data_ptr(), B, D, H, L, stream)
    _raise_on(err, "lstm_last_bwd dW and db")
    lstm_last_backward.launches += 1
    return demb, dw_ih, dw_hh, db


# ------------------------------------------------------------------ wrappers


def _forward(emb_tm, w_ih, w_hh, bias, lengths, residuals):
    if emb_tm.is_cuda:
        return _launch_forward(emb_tm, w_ih, w_hh, bias, lengths, residuals)
    if emb_tm.device.type != "cpu":
        raise ValueError(f"no LSTM kernel for device {emb_tm.device}")
    return lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths, residuals)


def lstm_last_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast):
    """Backward of the fused last-state LSTM: same contract as
    :func:`lstm_last_backward_plain`.  CUDA tensors launch the kernels (two
    per step and one for dW and db, counted in ``lstm_last_backward.launches``);
    CPU tensors take the plain version.  On the card demb holds unread
    garbage at the positions a row never reaches."""
    if emb_tm.is_cuda:
        return _launch_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast)
    if emb_tm.device.type != "cpu":
        raise ValueError(f"no LSTM kernel for device {emb_tm.device}")
    return lstm_last_backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast)


class _LstmLast(torch.autograd.Function):
    """The custom VJP of ``lstm_encode_last_fused`` (JAX :736-759): the
    forward keeps hs/cs as residuals, the backward casts the cotangent to
    the compute dtype (:751) and runs :func:`lstm_last_backward`."""

    @staticmethod
    def forward(ctx, emb_tm, w_ih, w_hh, bias, lengths):
        last, hs, cs = _forward(emb_tm, w_ih, w_hh, bias, lengths, residuals=True)
        ctx.save_for_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs)
        return last

    @staticmethod
    def backward(ctx, dlast):
        emb_tm, w_ih, w_hh, bias, lengths, hs, cs = ctx.saved_tensors
        demb, dw_ih, dw_hh, db = lstm_last_backward(
            emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast.to(emb_tm.dtype).contiguous()
        )
        return demb, dw_ih, dw_hh, db, None


def lstm_encode_last_fused(emb_tm, w_ih, w_hh, bias, lengths):
    """Length-aware fused LSTM forward: same contract as
    :func:`lstm_encode_last_plain`, differentiable in ``emb_tm``, the
    weights and the bias.  CUDA tensors launch the kernel (one launch per
    step, counted in ``lstm_encode_last_fused.launches``); CPU tensors take
    the plain version.  The hs/cs residuals are written only when autograd
    will need them, so serving writes none."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (emb_tm, w_ih, w_hh, bias)):
        return _LstmLast.apply(emb_tm, w_ih, w_hh, bias, lengths)
    return _forward(emb_tm, w_ih, w_hh, bias, lengths, residuals=False)


lstm_encode_last_fused.launches = 0
lstm_last_backward.launches = 0
