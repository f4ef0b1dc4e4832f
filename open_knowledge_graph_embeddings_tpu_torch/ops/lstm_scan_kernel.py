"""Recurrence-only LSTM over a precomputed input projection, with its backward.

Port of ``open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::
lstm_scan_pallas`` (:213-231): the forward ``_lstm_fwd_pallas`` (kernel
``_fwd_kernel``) and the backward ``_lstm_bwd_pallas`` (kernel
``_bwd_kernel``), joined by a custom VJP there and by :class:`_LstmScan`
here.  ``ops/lstm.py::lstm_forward_tm`` runs it after the input projection
whenever the fused encoder does not apply.  Every row runs every step;
``x_proj`` [L, B, 4H] holds ``x·W_ihᵀ + b`` rounded to the compute dtype,
``w_hh`` [4H, H] is gate-major (as ``nn.LSTM`` stores it).  Two versions
of each half:

* the plain PyTorch versions, :func:`lstm_scan_forward_plain` and
  :func:`lstm_scan_backward_plain`: loops over t that repeat the kernels'
  arithmetic (f32 products of compute-dtype operands, f32 gate math, cell
  state and carries, h rounded to the weight dtype before the recurrent
  product; in the backward c read from the compute-dtype residual ``cs`` and
  dgates rounded to the compute dtype before the dh product).  CPU tensors
  go here, and ``chip_smoke.py`` holds the kernels against them on the card;
* the hand-written CUDA kernels of ``csrc/lstm_scan.cu``: one launch per
  forward step; per backward step a gate launch and, from step 1 on, a
  product launch.  In bf16 they run kernel 1's ``wgmma`` loop with D = 0
  (``csrc/lstm_bf16.cuh``; the persistent grids of
  :func:`~.lstm_kernel.forward_grid` and
  :func:`~.lstm_kernel.backward_product_grid_bf16`), in f32 (the ``*_f32``
  entries) the f32 kernels' 3xTF32 loop with D = 0 (``csrc/lstm_tf32.cuh``;
  :func:`~.lstm_kernel.forward_grid` and
  :func:`~.lstm_kernel.backward_product_grid`) after one launch that splits
  W_hh into its TF32 hi and lo parts; so the backward's recomputed gates
  are the forward's bit for bit.  Design notes and bound at the top of the
  source.  They take H in multiples of
  :func:`~.lstm_kernel.kernel_multiple`; any other H is zero-padded per gate
  block on the way in and sliced on the way out (:func:`padded_forward`,
  :func:`padded_backward`), which is exact: a padded unit has zero
  pre-activations, so c = h = 0 at every step, and its zero W_hh column
  adds nothing to the others.

:func:`lstm_scan_forward` and :func:`lstm_scan_backward` are the wrappers: a
CPU tensor takes the plain version, a CUDA tensor takes the kernel or raises.
Each counts its kernel launches in ``.launches``.  ``dW_hh`` is one large
product outside the kernels (:func:`dw_hh_product`), as on the TPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel
from open_knowledge_graph_embeddings_tpu_torch.ops.lstm_kernel import _on_device, _raise_on

_SOURCE = "lstm_scan.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, accumulated and returned in
    f32 (JAX's ``preferred_element_type=float32``).  bf16 operands on the
    card take cuBLAS's bf16 product with f32 output; elsewhere the operands
    are widened to f32 (exact) first."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _check(x_proj, w_hh):
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj must be [L, B, 4H], got {tuple(x_proj.shape)}")
    L, B, H4 = x_proj.shape
    H = w_hh.shape[-1]
    if tuple(w_hh.shape) != (4 * H, H) or H4 != 4 * H:
        raise ValueError(f"w_hh must be [4H, H] with 4H = {H4}, got {tuple(w_hh.shape)}")
    if w_hh.dtype != x_proj.dtype:
        raise ValueError("w_hh must have x_proj's dtype")
    if w_hh.device != x_proj.device:
        raise ValueError(f"all inputs must be on one device, got {x_proj.device} and {w_hh.device}")
    return L, B, H


def _check_residuals(L, B, H, x_proj, **tensors):
    for name, x in tensors.items():
        if tuple(x.shape) != (L, B, H) or x.dtype != x_proj.dtype or x.device != x_proj.device:
            raise ValueError(f"{name} must be {x_proj.dtype} [{L}, {B}, {H}] on {x_proj.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


# ------------------------------------------------------------ plain versions


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan_forward_plain(x_proj, w_hh):
    """``x_proj`` [L, B, 4H] and ``w_hh`` [4H, H] in one dtype -> ``(hs, cs)``
    [L, B, H] in that dtype: ``gates = x_proj[t] + bf16(h_{t-1})·W_hhᵀ`` in
    f32, the cell state carried in f32, every row every step (``_fwd_kernel``
    :47-70)."""
    L, B, H = _check(x_proj, w_hh)
    dt = x_proj.dtype
    w_hh_t = w_hh.float().t()
    h = torch.zeros(B, H, dtype=dt, device=x_proj.device)
    c = torch.zeros(B, H, dtype=torch.float32, device=x_proj.device)
    hs, cs = [], []
    for t in range(L):
        h32, c = _cell(x_proj[t].float() + torch.matmul(h.float(), w_hh_t), c)
        h = h32.to(dt)
        hs.append(h)
        cs.append(c.to(dt))
    return torch.stack(hs), torch.stack(cs)


def lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs):
    """The backward of :func:`lstm_scan_forward_plain` from its residuals
    ``hs``, ``cs`` and the cotangent ``dhs`` [L, B, H] (all in x_proj's
    dtype) -> ``dx_proj`` [L, B, 4H] in that dtype (``_bwd_kernel``
    :110-165): in reverse over t, the gates recomputed from ``x_proj[t]`` and
    ``hs[t-1]`` (zero state at t = 0), ``dh = carry + dhs[t]``, c read from
    ``cs``, ``dx_proj[t] = dtype(dgates)``, the dh carry ``dtype(dgates)·W_hh``
    and the dc carry ``dc·f`` in f32."""
    L, B, H = _check(x_proj, w_hh)
    _check_residuals(L, B, H, x_proj, hs=hs, cs=cs, dhs=dhs)
    dt = x_proj.dtype
    w_hh32 = w_hh.float()
    zeros = torch.zeros(B, H, dtype=torch.float32, device=x_proj.device)
    dh, dc = zeros, zeros
    dxp = torch.empty_like(x_proj)
    for t in reversed(range(L)):
        gates = x_proj[t].float()
        if t > 0:
            gates = gates + torch.matmul(hs[t - 1].float(), w_hh32.t())
        c_prev = cs[t - 1].float() if t > 0 else zeros
        dgates, dc = lstm_kernel._bwd_cell(gates, c_prev, cs[t].float(), dh, dc, dhs[t].float())
        dxp[t] = dgates.to(dt)
        dh = torch.matmul(dxp[t].float(), w_hh32)
    return dxp


# ------------------------------------------------------------ CUDA kernels


@functools.lru_cache(maxsize=None)
def _fns(dtype):
    """The C entry points (forward step, backward gate, backward product) for
    ``dtype``, built and loaded on first use; all take whole arrays, t, a
    persistent grid and (but the bf16 product) a variant."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    lib, sfx = cuda_build.load(_SOURCE), lstm_kernel._SUFFIX[dtype]
    fwd, gate, prod = (getattr(lib, f"oket_lstm_scan_{part}_{sfx}") for part in ("step", "bwd_gate", "bwd_product"))
    fwd.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    gate.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    prod.argtypes = [_P] * 3 + [_I] * (5 if dtype == torch.bfloat16 else 6) + [_P]
    for fn in (fwd, gate, prod):
        fn.restype = _I
    return fwd, gate, prod


@functools.lru_cache(maxsize=None)
def _split_fn():
    """The f32 entries' weight split (W_hh's TF32 hi and lo parts), built and
    loaded on first use."""
    from open_knowledge_graph_embeddings_tpu_torch.utils import cuda_build

    fn = cuda_build.load(_SOURCE).oket_lstm_scan_split_f32
    fn.argtypes = [_P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


def _pad_units(x, Hp, gates=False):
    """``x`` [..., H] (or [..., 4H] with ``gates``: four gate blocks) with
    zeros appended to each block up to Hp units."""
    H = x.shape[-1] // (4 if gates else 1)
    if gates:
        x = x.reshape(*x.shape[:-1], 4, H)
    x = torch.nn.functional.pad(x, (0, Hp - H))
    return x.reshape(*x.shape[:-2], 4 * Hp) if gates else x


def _unpad_units(x, H, gates=False):
    """The inverse of :func:`_pad_units`: the first H units of each block."""
    if gates:
        Hp = x.shape[-1] // 4
        return x.reshape(*x.shape[:-1], 4, Hp)[..., :H].reshape(*x.shape[:-1], 4 * H).contiguous()
    return x[..., :H].contiguous()


def padded_forward(forward, x_proj, w_hh, Hp):
    """``forward`` (kernel 7 or its plain version) over H zero-padded to Hp
    units: x_proj [L, B, 4H] -> [L, B, 4Hp] and w_hh [4H, H] -> [4Hp, Hp] per
    gate block; hs and cs sliced back to H."""
    H = w_hh.shape[-1]
    w_pad = _pad_units(_pad_units(w_hh, Hp).t(), Hp, gates=True).t().contiguous()
    hs, cs = forward(_pad_units(x_proj, Hp, gates=True), w_pad)
    return _unpad_units(hs, H), _unpad_units(cs, H)


def padded_backward(backward, x_proj, w_hh, hs, cs, dhs, Hp):
    """``backward`` (kernel 8 or its plain version) over H zero-padded to Hp
    units (hs, cs and dhs padded with zeros, the padded forward's values);
    dx_proj sliced back to [L, B, 4H]."""
    H = w_hh.shape[-1]
    w_pad = _pad_units(_pad_units(w_hh, Hp).t(), Hp, gates=True).t().contiguous()
    dxp = backward(_pad_units(x_proj, Hp, gates=True), w_pad, *(_pad_units(x, Hp) for x in (hs, cs, dhs)))
    return _unpad_units(dxp, H, gates=True)


def _padded_h(H, dtype):
    m = lstm_kernel.kernel_multiple(dtype)
    return -(-H // m) * m


# what a launch of the f32 kernels computes: the kernel (3xTF32), or for
# chip_smoke.py's checks one TF32 product (1xTF32: hi.hi' alone), which the
# f32 rule must fail; the bf16 kernels have the kernel alone
F32_VARIANTS = {"kernel": 0, "1xTF32": 2}

# the gate launches' measuring variant (kernel 7 and kernel 8's part 1)
# that also stores each step's f32 pre-activation gates, to hold kernel 8's
# recompute to kernel 7's bitwise (chip_smoke.py)
_STORE_GATES = 1


def _variant_code(dtype, variant, gates):
    variants = F32_VARIANTS if dtype == torch.float32 else {"kernel": 0}
    if variant not in variants:
        raise ValueError(f"the {dtype} recurrence has no variant {variant!r}; it has {list(variants)}")
    if gates is not None and variant != "kernel":
        raise ValueError("only the kernel stores its pre-activation gates")
    return variants[variant] if gates is None else _STORE_GATES


def _check_gates_out(gates, L, B, H, x_proj):
    if gates is None:
        return
    if _padded_h(H, x_proj.dtype) != H:
        raise ValueError(f"the gates are stored at an H the kernels take unpadded, got H={H}")
    if gates.shape != (L, B, 4 * H) or gates.dtype != torch.float32 or gates.device != x_proj.device:
        raise ValueError(f"gates must be a float32 [L, B, 4H] = {(L, B, 4 * H)} tensor on {x_proj.device}")
    if not gates.is_contiguous() or gates.data_ptr() % 16:
        raise ValueError("gates must be contiguous and 16-byte aligned")


def _split(w_hh, transposed, counter, stream):
    """The f32 kernels' weight split, one launch counted in ``counter``: W_hh's
    TF32 hi and lo parts gate-major, and with ``transposed`` those of W_hhᵀ
    after them (the backward's product launch reads them)."""
    H = w_hh.shape[1]
    w_split = torch.empty((4 if transposed else 2) * 4 * H * H, dtype=torch.float32, device=w_hh.device)
    _raise_on(_split_fn()(w_hh.data_ptr(), w_split.data_ptr(), H, int(transposed), stream), "lstm_scan f32 split")
    counter.launches += 1
    return w_split


def _launch_forward(x_proj, w_hh, counter=None, gates=None, variant="kernel"):
    """Kernel 7's launches, counted in ``counter`` (``lstm_scan_forward`` by
    default): L steps, and at f32 the weight split before them (L + 1).
    With ``gates`` (an [L, B, 4H] f32 tensor) each step also stores its f32
    pre-activation gates there; ``variant`` is ``"kernel"`` or, at f32,
    ``"1xTF32"``."""
    counter = counter or lstm_scan_forward
    L, B, H = _check(x_proj, w_hh)
    _check_gates_out(gates, L, B, H, x_proj)
    code = _variant_code(x_proj.dtype, variant, gates)
    if _padded_h(H, x_proj.dtype) != H:
        return padded_forward(lambda x, w: _launch_forward(x, w, counter, variant=variant), x_proj, w_hh,
                              _padded_h(H, x_proj.dtype))
    lstm_kernel._check_kernel_inputs(x_proj.dtype, 0, H, x_proj=x_proj, w_hh=w_hh)  # no input part: D = 0
    fwd, _, _ = _fns(x_proj.dtype)
    dev = x_proj.device
    hs = torch.empty(L, B, H, dtype=x_proj.dtype, device=dev)
    cs = torch.empty_like(hs)
    c = torch.empty(B, H, dtype=torch.float32, device=dev)
    if not (B and H):
        return hs, cs
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = lstm_kernel.forward_grid(B, H, lstm_kernel._sm_count(dev.index))
    w = _split(w_hh, False, counter, stream) if x_proj.dtype == torch.float32 else w_hh
    ptrs = [x.data_ptr() for x in (x_proj, hs, w, c, cs)]
    for t in range(L):
        err = fwd(*ptrs, None if gates is None else gates[t].data_ptr(), L, B, H, t, grid, code, stream)
        _raise_on(err, f"lstm_scan forward step {t}")
        counter.launches += 1
    return hs, cs


def _launch_backward(x_proj, w_hh, hs, cs, dhs, counter=None, gates=None, variant="kernel"):
    """Kernel 8's launches, counted in ``counter`` (``lstm_scan_backward``
    by default): a gate launch per step and a product launch from step 1 on
    (2L - 1), and at f32 the weight split before them (2L).  With ``gates``
    (an [L, B, 4H] f32 tensor) each gate launch also stores its recomputed
    f32 pre-activation gates there; ``variant`` as in
    :func:`_launch_forward`."""
    counter = counter or lstm_scan_backward
    L, B, H = _check(x_proj, w_hh)
    _check_residuals(L, B, H, x_proj, hs=hs, cs=cs, dhs=dhs)
    _check_gates_out(gates, L, B, H, x_proj)
    code = _variant_code(x_proj.dtype, variant, gates)
    if _padded_h(H, x_proj.dtype) != H:
        return padded_backward(lambda *a: _launch_backward(*a, counter, variant=variant), x_proj, w_hh, hs, cs, dhs,
                               _padded_h(H, x_proj.dtype))
    lstm_kernel._check_kernel_inputs(x_proj.dtype, 0, H, x_proj=x_proj, w_hh=w_hh, hs=hs, cs=cs, dhs=dhs)
    _, gate, prod = _fns(x_proj.dtype)
    dev = x_proj.device
    dxp = torch.empty_like(x_proj)
    dh = torch.zeros(B, H, dtype=torch.float32, device=dev)
    dc = torch.zeros(B, H, dtype=torch.float32, device=dev)
    if not (B and H):
        return dxp.zero_()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = lstm_kernel._sm_count(dev.index)
    grid_gate = lstm_kernel.forward_grid(B, H, n_sm)
    if x_proj.dtype == torch.float32:
        w = _split(w_hh, True, counter, stream)
        grid_prod, prod_variant = lstm_kernel.backward_product_grid(B, H, 0, n_sm), [code]
    else:
        w, grid_prod, prod_variant = w_hh, lstm_kernel.backward_product_grid_bf16(B, H, 0, n_sm), []
    ptrs = [x.data_ptr() for x in (x_proj, hs, w, cs, dhs, dh, dc, dxp)]
    for t in reversed(range(L)):
        err = gate(*ptrs, None if gates is None else gates[t].data_ptr(), L, B, H, t, grid_gate, code, stream)
        _raise_on(err, f"lstm_scan backward gate step {t}")
        counter.launches += 1
        if t > 0:  # the dh carry into step 0 is never read
            err = prod(dxp.data_ptr(), w.data_ptr(), dh.data_ptr(), L, B, H, t, grid_prod, *prod_variant, stream)
            _raise_on(err, f"lstm_scan backward product step {t}")
            counter.launches += 1
    return dxp


# ------------------------------------------------------------------ wrappers


def lstm_scan_forward(x_proj, w_hh):
    """Kernel 7: same contract as :func:`lstm_scan_forward_plain`, any H.
    CUDA tensors launch the kernel (one launch per step, and at f32 the
    weight split, counted in ``lstm_scan_forward.launches``); CPU tensors
    take the plain version."""
    return _on_device(x_proj, _launch_forward, lstm_scan_forward_plain)(x_proj, w_hh)


def lstm_scan_backward(x_proj, w_hh, hs, cs, dhs):
    """Kernel 8: same contract as :func:`lstm_scan_backward_plain`, any H.
    CUDA tensors launch the kernels (a gate launch per step and a product launch
    per step from step 1 on, ``2L - 1`` in all, and at f32 the weight split,
    ``2L``; counted in ``lstm_scan_backward.launches``); CPU tensors take the
    plain version."""
    return _on_device(x_proj, _launch_backward, lstm_scan_backward_plain)(x_proj, w_hh, hs, cs, dhs)


def dw_hh_product(dxp, hs):
    """``dW_hh`` [4H, H] = Σ_{t≥1} dx_proj[t]ᵀ·hs[t-1], accumulated in f32 and
    rounded to the weight dtype, as JAX's einsum outside the kernel
    (:201-206, :228).  The t = 0 term is absent: h_0 = 0."""
    H4, H = dxp.shape[-1], hs.shape[-1]
    return matmul_f32(dxp[1:].reshape(-1, H4).t(), hs[:-1].reshape(-1, H)).to(dxp.dtype)


class _LstmScan(torch.autograd.Function):
    """The custom VJP of ``lstm_scan_pallas`` (JAX :213-231): the forward
    saves ``(x_proj, w_hh, hs, cs)`` as ``_vjp_fwd`` does; the backward runs
    kernel 8 for ``dx_proj`` and :func:`dw_hh_product` for ``dW_hh``."""

    @staticmethod
    def forward(ctx, x_proj, w_hh):
        hs, cs = lstm_scan_forward(x_proj, w_hh)
        ctx.save_for_backward(x_proj, w_hh, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x_proj, w_hh, hs, cs = ctx.saved_tensors
        dxp = lstm_scan_backward(x_proj, w_hh, hs, cs, dhs.to(x_proj.dtype).contiguous())
        return dxp, dw_hh_product(dxp, hs)


def lstm_scan(x_proj, w_hh):
    """Time-major LSTM recurrence: ``x_proj`` [L, B, 4H] x ``w_hh`` [4H, H]
    -> ``hs`` [L, B, H] in x_proj's dtype, differentiable in both."""
    if torch.is_grad_enabled() and (x_proj.requires_grad or w_hh.requires_grad):
        return _LstmScan.apply(x_proj, w_hh)
    return lstm_scan_forward(x_proj, w_hh)[0]


lstm_scan_forward.launches = 0
lstm_scan_backward.launches = 0
