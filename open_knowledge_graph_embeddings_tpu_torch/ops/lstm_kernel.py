"""Length-aware fused LSTM, in two forms, with its backward.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::
lstm_encode_last_fused`` (the forward ``_fused_fwd_last``, kernel
``_fused_fwd_last_kernel``, and the backward ``_fused_bwd_last``, kernel
``_fused_bwd_last_kernel``), which returns each row's last state, and of
``::lstm_encode_fused`` (``_fused_fwd`` / ``_fused_fwd_kernel`` and
``_fused_bwd`` / ``_fused_bwd_kernel``), which returns every state.  A custom
VJP joins each pair there, an ``autograd.Function`` here (:class:`_LstmLast`,
:class:`_LstmAll`).  Two versions of each half:

* the plain PyTorch versions, :func:`lstm_encode_last_plain`,
  :func:`lstm_last_backward_plain`, :func:`lstm_all_forward_plain` and
  :func:`lstm_all_backward_plain` — loops over t with ``torch.matmul`` that
  repeat the kernels' arithmetic: f32 products of the compute-dtype operands
  (bf16 x bf16 is exact in f32), f32 gate math, cell state and carries, h
  rounded to the weight dtype before the recurrent product, and in the
  backward the residuals read in the compute dtype and dgates rounded to it
  before every product.  CPU tensors go here, and ``chip_smoke.py`` holds the
  kernels against them on the card;
* the hand-written CUDA kernels ``csrc/lstm_last_fwd.cu`` (one launch per
  step; with residuals it also writes hs/cs, and without ``last`` it is the
  every-state forward) and ``csrc/lstm_last_bwd.cu`` (two launches per step
  and one for dW and db; the cotangent enters at each row's last step or at
  every step).  At bf16 both are bound by tensor-core operations on an H100.
  Their f32 modes (``csrc/lstm_last_fwd_f32.cu`` and the ``*_f32`` entries of
  ``lstm_last_bwd.cu``) take 3xTF32 products on the tensor cores, as
  accurate as f32, through one gate loop (``csrc/lstm_tf32.cuh``); one more
  launch per call splits the weights.  Design notes are at the top of the
  sources.

:func:`lstm_encode_last_fused`, :func:`lstm_last_backward`,
:func:`lstm_all_forward` and :func:`lstm_all_backward` are the wrappers: a
CPU tensor takes the plain version, a CUDA tensor takes the kernel or
raises.  Each counts its kernel launches in ``.launches``, in either dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_FWD_SOURCE = "lstm_last_fwd.cu"
_FWD_F32_SOURCE = "lstm_last_fwd_f32.cu"
_BWD_SOURCE = "lstm_last_bwd.cu"
# the C entry points' suffix by compute dtype
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def _check_residuals(L, B, H, dtype, hs, cs, cot, device, every_step=False):
    cot_name, cot_shape = ("dhs", (L, B, H)) if every_step else ("dlast", (B, H))
    for name, x, shape in (("hs", hs, (L, B, H)), ("cs", cs, (L, B, H)), (cot_name, cot, cot_shape)):
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
    return _backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast, every_step=False)


def lstm_all_forward_plain(emb_tm, w_ih, w_hh, bias, lengths):
    """The every-state forward (``_fused_fwd``): same contract as
    :func:`lstm_encode_last_plain` but returns ``(hs, cs)`` [L, B, H] in
    ``emb_tm``'s dtype.  Every row runs all L steps here; only the positions
    a row reaches (step < ``max(len, 1)``) are defined, the kernel leaves the
    others unwritten."""
    _, hs, cs = lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths, residuals=True)
    return hs, cs


def lstm_all_backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs):
    """The backward of :func:`lstm_all_forward_plain` (``_fused_bwd``): as
    :func:`lstm_last_backward_plain`, but the cotangent ``dhs`` [L, B, H]
    of every state enters at every step a row reaches (``dhs[t]`` for the
    rows active at t; the other positions of ``dhs`` are not read)."""
    return _backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs, every_step=True)


def _backward_plain(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, cot, every_step):
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dt = emb_tm.dtype
    dev = emb_tm.device
    _check_residuals(L, B, H, dt, hs, cs, cot, dev, every_step)
    lens = lengths.clamp(min=1)
    w_ih32, w_hh32 = w_ih.float(), w_hh.float()
    w_ih_t, w_hh_t = w_ih32.t(), w_hh32.t()
    zeros = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dh, dc = zeros, zeros
    demb = torch.zeros(L, B, D, dtype=dt, device=dev)
    dw_ih = torch.zeros(4 * H, D, dtype=torch.float32, device=dev)
    dw_hh = torch.zeros(4 * H, H, dtype=torch.float32, device=dev)
    db = torch.zeros(4 * H, dtype=torch.float32, device=dev)
    for t in reversed(range(L)):
        active = (lens > t)[:, None]
        # rows inactive at t are never read (the kernels' residuals hold
        # garbage there, possibly NaN, which would reach dW_hh through 0 * NaN)
        h_prev = torch.where(active, hs[t - 1], 0.0) if t > 0 else torch.zeros(B, H, dtype=dt, device=dev)
        c_prev = cs[t - 1].float() if t > 0 else zeros
        gates = _gates(emb_tm[t], h_prev, w_ih_t, w_hh_t, bias)
        # the cotangent entering at t: dhs[t] on every active row, or dlast
        # on the rows whose last step is t
        enters = active if every_step else (lens == t + 1)[:, None]
        cot_in = torch.where(enters, (cot[t] if every_step else cot).float(), 0.0)
        dgates, dc_prev = _bwd_cell(gates, c_prev, cs[t].float(), dh, dc, cot_in)
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
    fn.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    fn.restype = _I
    return fn


# Kernel 1's tiles: 128 rows x 32 hidden units x the 4 gates (csrc/lstm_last_fwd.cu)
_ROW_TILE = 128
_UNIT_TILE = 32


def forward_grid(B: int, H: int, n_sm: int) -> int:
    """Kernel 1's persistent grid for B rows of H hidden units on a card with
    ``n_sm`` SMs: one block per SM, or per tile where there are fewer tiles
    (each block walks its tiles, and the kernel walks only the row tiles
    active at each step)."""
    return max(1, min(-(-B // _ROW_TILE) * -(-H // _UNIT_TILE), n_sm))


# The f32 backward's product tiles: 128 rows x 128 columns of [dh | demb]
_PRODUCT_TILE = 128


def backward_product_grid(B: int, H: int, D: int, n_sm: int) -> int:
    """The persistent grid of the f32 backward's product launch for B rows
    and the H + D columns of ``[dh | demb]``; its gate launch takes
    :func:`forward_grid` (the same 128-row x 32-unit tiles as kernel 1)."""
    return max(1, min(-(-B // _ROW_TILE) * -(-(H + D) // _PRODUCT_TILE), n_sm))


def backward_product_grid_bf16(B: int, H: int, D: int, n_sm: int) -> int:
    """The persistent grid of the bf16 backward's product launch: its column
    tiles of dh (read from W_hh) and of demb (from W_ih) are counted apart,
    so that no tile straddles the two weights.  Its gate launch takes
    :func:`forward_grid`, as kernel 1 does."""
    return max(1, min(-(-B // _ROW_TILE) * (-(-H // _PRODUCT_TILE) - (-D // _PRODUCT_TILE)), n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fwd_f32_fns():
    """The f32 (3xTF32) forward's C entry points: the weight split and the
    step."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_FWD_F32_SOURCE)
    split, step = lib.oket_lstm_fwd_split_f32, lib.oket_lstm_last_step_f32
    split.argtypes = [_P] * 3 + [_I, _I, _P]
    step.argtypes = [_P] * 9 + [_I] * 9 + [_P]
    for fn in (split, step):
        fn.restype = _I
    return split, step


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    """The bf16 backward kernels' C entry points (gate, product, dW)."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_BWD_SOURCE)
    gate, prod, dw = (getattr(lib, f"oket_lstm_bwd_{part}_bf16") for part in ("gate", "product", "dw"))
    gate.argtypes = [_P] * 9 + [_I] + [_P] * 5 + [_I] * 7 + [_P]
    prod.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    dw.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    for fn in (gate, prod, dw):
        fn.restype = _I
    return gate, prod, dw


@functools.lru_cache(maxsize=None)
def _bwd_f32_fns():
    """The f32 (3xTF32) backward kernels' C entry points: split, gate,
    product, dW."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    lib = cuda_build.load(_BWD_SOURCE)
    split, gate, prod, dw = (getattr(lib, f"oket_lstm_bwd_{part}_f32") for part in ("split", "gate", "product", "dw"))
    split.argtypes = [_P] * 3 + [_I, _I, _P]
    gate.argtypes = [_P] * 8 + [_I] + [_P] * 4 + [_I] * 7 + [_P]
    prod.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    dw.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    for fn in (split, gate, prod, dw):
        fn.restype = _I
    return split, gate, prod, dw


def kernel_multiple(dtype) -> int:
    """The multiple of D and H the LSTM kernels take at ``dtype``: a tile row
    is whole 16-byte copies (8 bf16 or 4 f32 values)."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _check_kernel_inputs(dtype, D, H, **tensors):
    if dtype not in _SUFFIX:
        raise TypeError(f"the CUDA LSTM kernels take bfloat16 or float32 inputs, got {dtype}")
    m = kernel_multiple(dtype)
    if D % m or H % m:
        # the model sends the fused kernels D and H divisible by 128 only
        # (ops/lstm.py::lstm_fused_supported); the recurrence pads H
        raise ValueError(f"the CUDA LSTM kernels take D and H divisible by {m} at {dtype}, got D={D} H={H}")
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _raise_on(err, what):
    if err == -1:
        raise RuntimeError(f"{what}: the driver could not encode the kernel's TMA tensor maps")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _launch_forward(emb_tm, w_ih, w_hh, bias, lengths, residuals):
    """Kernel 1: ``last`` [B, H], and with ``residuals`` also hs, cs."""
    last, hs, cs = _launch_steps(emb_tm, w_ih, w_hh, bias, lengths, residuals, True, lstm_encode_last_fused)
    return (last, hs, cs) if residuals else last


def _launch_all_forward(emb_tm, w_ih, w_hh, bias, lengths):
    """Kernel 5, the every-state mode of the same kernel: ``(hs, cs)``."""
    _, hs, cs = _launch_steps(emb_tm, w_ih, w_hh, bias, lengths, True, False, lstm_all_forward)
    return hs, cs


# what a launch of kernel 1 runs: the kernel, or for measuring it, the
# kernel without its epilogue or without its products (chip_smoke.py); at
# f32 also the planted checks that the f32 rule sees the correction
# products (1xTF32: one TF32 product where the kernel takes three) and the
# fold of the tensor cores' sums ("one accumulator" over all of K)
FORWARD_VARIANTS = {"kernel": 0, "no epilogue": 1, "no products": 2}
FORWARD_F32_VARIANTS = {**FORWARD_VARIANTS, "1xTF32": 3, "one accumulator": 4}


# kernel 1's measuring launch (bf16) that also stores each step's f32
# pre-activation gates, to hold the backward's recompute to them bitwise
_STORE_GATES = 3


def _launch_steps(emb_tm, w_ih, w_hh, bias, lengths, residuals, with_last, counter, variant="kernel", gates=None):
    """Kernel 1's launches over the L steps.  With ``gates`` (an [L, B, 4H]
    f32 tensor, bf16 kernel only) each step also stores its f32
    pre-activation gates of the active rows there (chip_smoke.py)."""
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    _check_kernel_inputs(emb_tm.dtype, D, H, emb_tm=emb_tm, w_ih=w_ih, w_hh=w_hh)
    f32 = emb_tm.dtype == torch.float32
    variants = FORWARD_F32_VARIANTS if f32 else FORWARD_VARIANTS
    if variant not in variants:
        raise ValueError(f"the {emb_tm.dtype} forward has no variant {variant!r}; it has {list(variants)}")
    if gates is not None:
        _check_gates_out(gates, L, B, H, emb_tm, variant)
    bias = bias.contiguous()
    if bias.data_ptr() % 8:  # the kernel reads the bias of a unit pair as one float2
        bias = bias.clone()
    lens = lengths.to(torch.int32).contiguous()
    dev, dt = emb_tm.device, emb_tm.dtype
    c = torch.empty(B, H, dtype=torch.float32, device=dev)
    last = torch.zeros(B, H, dtype=dt, device=dev) if with_last else None
    if residuals:
        # the h of step t is written straight into its residual slice hs[t]
        hs = torch.empty(L, B, H, dtype=dt, device=dev)
        cs = torch.empty(L, B, H, dtype=dt, device=dev)
        h_buf = hs
    else:
        hs = cs = None
        h_buf = torch.empty(2, B, H, dtype=dt, device=dev)  # h_{t-1} and h_t, in turns
    if not (B and H):
        return last, hs, cs
    if variant == "no epilogue":
        # the variant writes no h, so it would multiply stale memory, on which
        # the tensor cores can run faster than on the h a kernel writes
        h_buf.normal_(0.0, 0.1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = forward_grid(B, H, _sm_count(dev.index))
    if f32:
        # kernels 1 and 5 in f32 (csrc/lstm_last_fwd_f32.cu, 3xTF32): the hi
        # and lo parts of both weights, gate-major, once per call
        split, fn = _fwd_f32_fns()
        w_split = torch.empty(2 * 4 * H * (D + H), dtype=torch.float32, device=dev)
        _raise_on(split(w_ih.data_ptr(), w_hh.data_ptr(), w_split.data_ptr(), D, H, stream), "lstm_last_fwd_f32 split")
        counter.launches += 1
        weights, name = [w_split.data_ptr()], "lstm_last_fwd_f32"
    else:
        fn = _fwd_fn()
        weights, name = [w_ih.data_ptr(), w_hh.data_ptr()], "lstm_last_fwd"
    slots, step = h_buf.shape[0], B * H * h_buf.element_size()  # bytes of one [B, H] slice
    emb, h0 = emb_tm.data_ptr(), h_buf.data_ptr()
    rest = [x.data_ptr() for x in (bias, lens, c)]
    cs0 = cs.data_ptr() if residuals else None
    last_ptr = last.data_ptr() if with_last else None
    code = variants[variant] if gates is None else _STORE_GATES

    def gates_arg(t):  # the bf16 entry's gates pointer (the f32 entry has none)
        return [] if f32 else [None if gates is None else gates[t].data_ptr()]

    for t in range(L):
        err = fn(
            emb, h0, *weights, *rest, h0 + t % slots * step, None if cs0 is None else cs0 + t * step, last_ptr,
            *gates_arg(t), L, B, D, H, slots, (t - 1) % slots, t, grid, code, stream,
        )
        _raise_on(err, f"{name} step {t}")
        counter.launches += 1
    return last, hs, cs


def _launch_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast):
    """Kernel 2: the cotangent ``dlast`` [B, H] enters at each row's last step."""
    return _launch_bwd_steps(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast, False, lstm_last_backward)


def _launch_all_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs):
    """Kernel 6: the cotangent ``dhs`` [L, B, H] enters at every active step."""
    return _launch_bwd_steps(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs, True, lstm_all_backward)


# what a launch of the f32 backward computes: the kernel (3xTF32), or for
# chip_smoke.py's checks one TF32 product (1xTF32), which the f32 rule must
# fail, or one tensor-core accumulator over all of K in the gate and product
# launches ("one accumulator", no fold: what the fold buys on trained weights)
BACKWARD_F32_VARIANTS = {"kernel": 0, "1xTF32": 1, "one accumulator": 2}


def _check_gates_out(gates, L, B, H, emb_tm, variant):
    if emb_tm.dtype != torch.bfloat16 or variant != "kernel":
        raise ValueError("only the bf16 kernel stores its pre-activation gates")
    if gates.shape != (L, B, 4 * H) or gates.dtype != torch.float32 or gates.device != emb_tm.device:
        raise ValueError(f"gates must be a float32 [L, B, 4H] = {(L, B, 4 * H)} tensor on {emb_tm.device}")
    if not gates.is_contiguous() or gates.data_ptr() % 16:
        raise ValueError("gates must be contiguous and 16-byte aligned")


def _launch_bwd_steps(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, cot, every_step, counter, variant="kernel",
                      gates=None):
    """Kernels 2 and 6: in bf16 a gate and a product launch per step, then
    dW and db (2L + 1 launches).  With ``gates`` (an [L, B, 4H] f32 tensor,
    bf16 only) each gate launch also stores its recomputed f32
    pre-activation gates of the active rows there (chip_smoke.py)."""
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dev, dt = emb_tm.device, emb_tm.dtype
    _check_residuals(L, B, H, dt, hs, cs, cot, dev, every_step)
    _check_kernel_inputs(dt, D, H, emb_tm=emb_tm, w_ih=w_ih, w_hh=w_hh, hs=hs, cs=cs, cotangent=cot)
    if dt == torch.float32:
        return _launch_bwd_steps_f32(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, cot, every_step, counter, variant)
    if variant != "kernel":
        raise ValueError(f"the variant {variant!r} is the f32 backward's")
    if gates is not None:
        _check_gates_out(gates, L, B, H, emb_tm, variant)
    gate, prod, _ = _bwd_fns()
    bias = bias.contiguous()
    if bias.data_ptr() % 8:  # the gate kernel reads the bias of a unit pair as one float2
        bias = bias.clone()
    lens = lengths.to(torch.int32).contiguous()
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dc = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dg = torch.empty(L, B, 4 * H, dtype=dt, device=dev)
    # per step and row tile of 128 (the gate kernel's): written for the
    # active tiles, which are the only ones the dW kernel sums into db
    db_part = torch.empty(L, -(-B // 128), 4 * H, dtype=torch.float32, device=dev)
    demb = torch.empty(L, B, D, dtype=dt, device=dev)
    dw_ih = torch.empty(4 * H, D, dtype=dt, device=dev)
    dw_hh = torch.empty(4 * H, H, dtype=dt, device=dev)
    db = torch.empty(4 * H, dtype=torch.float32, device=dev)
    if not (L and B and H):
        return demb.zero_(), dw_ih.zero_(), dw_hh.zero_(), db.zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = _sm_count(dev.index)
    grid_gate, grid_prod = forward_grid(B, H, n_sm), backward_product_grid_bf16(B, H, D, n_sm)
    code = 0 if gates is None else 1  # the gate launch's STORE_GATES variant
    step = B * H * 2  # bytes of one [B, H] slice
    emb, hs0, cs0, cot0, wi, wh = (x.data_ptr() for x in (emb_tm, hs, cs, cot, w_ih, w_hh))
    for t in reversed(range(L)):
        err = gate(
            emb, hs0, wi, wh, bias.data_ptr(), lens.data_ptr(), cs0 + t * step, cs0 + max(t - 1, 0) * step,
            cot0 + (t * step if every_step else 0), int(every_step), dh.data_ptr(), dc.data_ptr(),
            dg[t].data_ptr(), db_part[t].data_ptr(), None if gates is None else gates[t].data_ptr(),
            L, B, D, H, t, grid_gate, code, stream,
        )
        _raise_on(err, f"lstm_last_bwd gate step {t}")
        err = prod(dg.data_ptr(), wh, wi, lens.data_ptr(), dh.data_ptr(), demb[t].data_ptr(), L, B, D, H, t,
                   grid_prod, stream)
        _raise_on(err, f"lstm_last_bwd product step {t}")
        counter.launches += 2
    _launch_dw(dg, emb_tm, hs, lens, db_part, dw_ih, dw_hh, db, n_sm, stream)
    counter.launches += 1
    return demb, dw_ih, dw_hh, db


# what a dW launch computes: the kernel, or for measuring it (chip_smoke.py)
# the kernel without its products (the loads alone); at f32 also the planted
# 1xTF32 check
DW_VARIANTS = {"kernel": 0, "no products": 1}
DW_F32_VARIANTS = {"kernel": 0, "1xTF32": 1, "no products": 2}


def _launch_dw(dg, emb_tm, hs, lens, db_part, dw_ih, dw_hh, db, n_sm, stream, variant="kernel"):
    """The dW launch of either dtype into ``dw_ih``, ``dw_hh`` and ``db``: dg
    [L, B, 4H], emb_tm [L, B, D], hs [L, B, H] (bf16 or f32), lens int32,
    db_part f32 as the gate launches write it; the grid is at most a block
    per SM (the C entry sizes it)."""
    L, B, D = emb_tm.shape
    H = hs.shape[2]
    f32 = emb_tm.dtype == torch.float32
    fn = _bwd_f32_fns()[3] if f32 else _bwd_fns()[2]
    code = (DW_F32_VARIANTS if f32 else DW_VARIANTS)[variant]
    err = fn(
        dg.data_ptr(), emb_tm.data_ptr(), hs.data_ptr(), lens.data_ptr(), db_part.data_ptr(), dw_ih.data_ptr(),
        dw_hh.data_ptr(), db.data_ptr(), L, B, D, H, n_sm, code, stream,
    )
    _raise_on(err, f"lstm_last_bwd{'_f32' if f32 else ''} dW and db")


def _launch_bwd_steps_f32(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, cot, every_step, counter, variant):
    """Kernels 2 and 6 in f32 (the 3xTF32 entries of ``csrc/lstm_last_bwd.cu``):
    the weight split, a gate and a product launch per step, dW and db: 2L + 2
    launches."""
    L, B, D, H = emb_tm.shape[0], emb_tm.shape[1], emb_tm.shape[2], w_hh.shape[1]
    split, gate, prod, _ = _bwd_f32_fns()
    code = BACKWARD_F32_VARIANTS[variant]
    dev, f32 = emb_tm.device, torch.float32
    bias = bias.contiguous()
    if bias.data_ptr() % 8:  # the gate kernel reads the bias of a unit pair as one float2
        bias = bias.clone()
    lens = lengths.to(torch.int32).contiguous()
    dh = torch.zeros(B, H, dtype=f32, device=dev)
    dc = torch.zeros(B, H, dtype=f32, device=dev)
    dg = torch.empty(L, B, 4 * H, dtype=f32, device=dev)
    # per step and row tile of 128 (the gate kernel's): written for the
    # active tiles, which are the only ones the dW kernel sums into db
    db_part = torch.empty(L, -(-B // 128), 4 * H, dtype=f32, device=dev)
    demb = torch.empty(L, B, D, dtype=f32, device=dev)
    dw_ih = torch.empty(4 * H, D, dtype=f32, device=dev)
    dw_hh = torch.empty(4 * H, H, dtype=f32, device=dev)
    db = torch.empty(4 * H, dtype=f32, device=dev)
    if not (L and B and H):
        return demb.zero_(), dw_ih.zero_(), dw_hh.zero_(), db.zero_()
    # hi and lo of W_ih, W_hh (gate-major) and of [W_hh | W_ih]^T
    w_split = torch.empty(4 * 4 * H * (H + D), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(split(w_ih.data_ptr(), w_hh.data_ptr(), w_split.data_ptr(), D, H, stream), "lstm_last_bwd_f32 split")
    counter.launches += 1
    n_sm = _sm_count(dev.index)
    grid_gate, grid_prod = forward_grid(B, H, n_sm), backward_product_grid(B, H, D, n_sm)
    step = B * H * 4  # bytes of one [B, H] slice
    emb, hs0, cs0, ws, cot0 = (x.data_ptr() for x in (emb_tm, hs, cs, w_split, cot))
    for t in reversed(range(L)):
        err = gate(
            emb, hs0, ws, bias.data_ptr(), lens.data_ptr(), cs0 + t * step, cs0 + max(t - 1, 0) * step,
            cot0 + (t * step if every_step else 0), int(every_step), dh.data_ptr(), dc.data_ptr(),
            dg.data_ptr() + t * B * 4 * H * 4, db_part[t].data_ptr(), L, B, D, H, t, grid_gate, code, stream,
        )
        _raise_on(err, f"lstm_last_bwd_f32 gate step {t}")
        err = prod(dg.data_ptr(), ws, lens.data_ptr(), dh.data_ptr(), demb[t].data_ptr(), L, B, D, H, t,
                   grid_prod, code, stream)
        _raise_on(err, f"lstm_last_bwd_f32 product step {t}")
        counter.launches += 2
    # "one accumulator" is the gate and product launches' alone: the dW
    # launch folds every 256 rows in every variant
    _launch_dw(dg, emb_tm, hs, lens, db_part, dw_ih, dw_hh, db, n_sm, stream,
               variant="1xTF32" if variant == "1xTF32" else "kernel")
    counter.launches += 1
    return demb, dw_ih, dw_hh, db


# ------------------------------------------------------------------ wrappers


def _on_device(x, kernel, plain):
    """The dispatch rule of every wrapper: a CUDA tensor launches the kernel
    (or raises), a CPU tensor takes the plain version."""
    if x.is_cuda:
        return kernel
    if x.device.type != "cpu":
        raise ValueError(f"no LSTM kernel for device {x.device}")
    return plain


def _forward(emb_tm, w_ih, w_hh, bias, lengths, residuals):
    run = _on_device(emb_tm, _launch_forward, lstm_encode_last_plain)
    return run(emb_tm, w_ih, w_hh, bias, lengths, residuals)


def lstm_last_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast):
    """Backward of the fused last-state LSTM: same contract as
    :func:`lstm_last_backward_plain`.  CUDA tensors launch the kernels (two
    per step and one for dW and db, and at f32 one more that splits the
    weights, counted in ``lstm_last_backward.launches``); CPU tensors take
    the plain version.  On the card demb holds unread garbage at the
    positions a row never reaches."""
    run = _on_device(emb_tm, _launch_backward, lstm_last_backward_plain)
    return run(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dlast)


def lstm_all_forward(emb_tm, w_ih, w_hh, bias, lengths):
    """The every-state fused forward (kernel 5): same contract as
    :func:`lstm_all_forward_plain`.  CUDA tensors launch the forward kernel
    without ``last`` (one launch per step, and at f32 the weight split,
    counted in ``lstm_all_forward.launches``); the positions a row never reaches hold
    unread garbage there."""
    run = _on_device(emb_tm, _launch_all_forward, lstm_all_forward_plain)
    return run(emb_tm, w_ih, w_hh, bias, lengths)


def lstm_all_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs):
    """Backward of the every-state fused LSTM (kernel 6): same contract as
    :func:`lstm_all_backward_plain`.  CUDA tensors launch the backward
    kernels with the cotangent added at every active step (2 launches per
    step, one for dW and db, and at f32 the weight split, counted in
    ``lstm_all_backward.launches``)."""
    run = _on_device(emb_tm, _launch_all_backward, lstm_all_backward_plain)
    return run(emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs)


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


class _LstmAll(torch.autograd.Function):
    """The custom VJP of ``lstm_encode_fused`` (JAX :783-801): hs and cs
    are the residuals, the backward runs :func:`lstm_all_backward`."""

    @staticmethod
    def forward(ctx, emb_tm, w_ih, w_hh, bias, lengths):
        hs, cs = lstm_all_forward(emb_tm, w_ih, w_hh, bias, lengths)
        ctx.save_for_backward(emb_tm, w_ih, w_hh, bias, lengths, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        emb_tm, w_ih, w_hh, bias, lengths, hs, cs = ctx.saved_tensors
        demb, dw_ih, dw_hh, db = lstm_all_backward(
            emb_tm, w_ih, w_hh, bias, lengths, hs, cs, dhs.to(emb_tm.dtype).contiguous()
        )
        return demb, dw_ih, dw_hh, db, None


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def lstm_encode_last_fused(emb_tm, w_ih, w_hh, bias, lengths):
    """Length-aware fused LSTM forward: same contract as
    :func:`lstm_encode_last_plain`, differentiable in ``emb_tm``, the
    weights and the bias.  CUDA tensors launch the kernel (one launch per
    step, and at f32 one more that splits the weights, counted in
    ``lstm_encode_last_fused.launches``); CPU tensors take
    the plain version.  The hs/cs residuals are written only when autograd
    will need them, so serving writes none."""
    if _needs_grad(emb_tm, w_ih, w_hh, bias):
        return _LstmLast.apply(emb_tm, w_ih, w_hh, bias, lengths)
    return _forward(emb_tm, w_ih, w_hh, bias, lengths, residuals=False)


def lstm_encode_fused(emb_tm, w_ih, w_hh, bias, lengths):
    """Length-aware fused LSTM returning every state: ``emb_tm`` [L, B, D]
    (rows sorted by descending length), gate-major weights in its dtype,
    ``bias`` [4H] f32, ``lengths`` [B] -> ``hs`` [L, B, H] in ``emb_tm``'s
    dtype; the positions at or past a row's length hold unread garbage on the
    card.  Differentiable in ``emb_tm``, the weights and the bias through
    :func:`lstm_all_forward` and :func:`lstm_all_backward`."""
    if _needs_grad(emb_tm, w_ih, w_hh, bias):
        return _LstmAll.apply(emb_tm, w_ih, w_hh, bias, lengths)
    return lstm_all_forward(emb_tm, w_ih, w_hh, bias, lengths)[0]


lstm_encode_last_fused.launches = 0
lstm_last_backward.launches = 0
lstm_all_forward.launches = 0
lstm_all_backward.launches = 0
