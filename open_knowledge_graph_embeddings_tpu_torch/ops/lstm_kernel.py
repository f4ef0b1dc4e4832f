"""Length-aware fused LSTM forward that returns each row's last state.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::
lstm_encode_last_fused`` (forward: ``_fused_fwd_last`` around
``_fused_fwd_last_kernel``).  Two versions of one function:

* :func:`lstm_encode_last_plain` — a loop over t with ``torch.matmul`` that
  repeats the kernel's arithmetic: f32 products of the compute-dtype
  operands (bf16 x bf16 is exact in f32), f32 gate math and cell state, h
  rounded to the weight dtype before the recurrent product.  CPU tensors go
  here, and ``chip_smoke.py`` holds the kernel against it on the card.
* the hand-written CUDA kernel ``csrc/lstm_last_fwd.cu``, one launch per
  step.  Bound on an H100: tensor-core operations, 2·(D+H)·4H per active
  (row, step) against 2·D bytes of token embedding read.  Its design notes
  (weights streamed from L2, one block per BM rows x BN units with all four
  gate columns, length-prefix early exit) are at the top of the source.

:func:`lstm_encode_last_fused` is the wrapper: a CPU tensor takes the plain
version, a CUDA tensor takes the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "lstm_last_fwd.cu"


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


def lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths):
    """``emb_tm`` [L, B, D] (rows sorted by descending length), ``w_ih``
    [4H, D], ``w_hh`` [4H, H] (gate-major, as ``nn.LSTM`` stores them) in
    ``emb_tm``'s dtype, ``bias`` [4H] f32,
    ``lengths`` [B] -> ``last`` [B, H] in ``emb_tm``'s dtype: h at each row's
    step ``max(len, 1)``.  Every row runs all L steps; rows are independent,
    so a row's extra steps never reach another row's output."""
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    dt = emb_tm.dtype
    lens = lengths.clamp(min=1)
    w_ih_t = w_ih.float().t()
    w_hh_t = w_hh.float().t()
    h = torch.zeros(B, H, dtype=torch.float32, device=emb_tm.device)
    c = torch.zeros_like(h)
    last = torch.zeros(B, H, dtype=dt, device=emb_tm.device)
    for t in range(L):
        gates = (
            torch.matmul(emb_tm[t].float(), w_ih_t) + bias
            + torch.matmul(h.to(dt).float(), w_hh_t)
        )
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        last = torch.where((lens == t + 1)[:, None], h.to(dt), last)
    return last


@functools.lru_cache(maxsize=None)
def _step_fn():
    """The kernel's C entry point, built and loaded on first use."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    fn = cuda_build.load(_SOURCE).oket_lstm_last_step_bf16
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_kernel(emb_tm, w_ih, w_hh, bias, lengths):
    L, B, D, H = _check(emb_tm, w_ih, w_hh, bias, lengths)
    if emb_tm.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA LSTM kernel takes bfloat16 inputs, got {emb_tm.dtype}; "
            "run an f32 model with device='cpu'"
        )
    if D % 8 or H % 8:
        raise ValueError(f"the CUDA LSTM kernel takes D and H divisible by 8, got D={D} H={H}")
    for name, x in (("emb_tm", emb_tm), ("w_ih", w_ih), ("w_hh", w_hh)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    fn = _step_fn()
    bias = bias.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    dev = emb_tm.device
    c = torch.empty(B, H, dtype=torch.float32, device=dev)
    h_bufs = (torch.empty(B, H, dtype=emb_tm.dtype, device=dev),
              torch.empty(B, H, dtype=emb_tm.dtype, device=dev))
    last = torch.zeros(B, H, dtype=emb_tm.dtype, device=dev)
    if B == 0 or H == 0:
        return last
    stream = torch.cuda.current_stream(dev).cuda_stream
    for t in range(L):
        err = fn(
            emb_tm[t].data_ptr(), h_bufs[t % 2].data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
            bias.data_ptr(), lens.data_ptr(), c.data_ptr(), h_bufs[(t + 1) % 2].data_ptr(),
            last.data_ptr(), B, D, H, t, stream,
        )
        if err != 0:
            raise RuntimeError(f"lstm_last_fwd launch at step {t} failed: cudaError {err}")
        lstm_encode_last_fused.launches += 1
    return last


def lstm_encode_last_fused(emb_tm, w_ih, w_hh, bias, lengths):
    """Length-aware fused LSTM forward: same contract as
    :func:`lstm_encode_last_plain`.  CUDA tensors launch the kernel (one
    launch per step, counted in ``lstm_encode_last_fused.launches``); CPU
    tensors take the plain version."""
    if emb_tm.is_cuda:
        return _launch_kernel(emb_tm, w_ih, w_hh, bias, lengths)
    if emb_tm.device.type != "cpu":
        raise ValueError(f"no LSTM kernel for device {emb_tm.device}")
    return lstm_encode_last_plain(emb_tm, w_ih, w_hh, bias, lengths)


lstm_encode_last_fused.launches = 0
