"""How a result is held against a reference that did the same arithmetic
in another f32 summation order: the CUDA kernel against its plain version,
the port against the JAX package.  Two rules, one per compute dtype.

**bf16.**
Both sides round the same f32 pre-activations to bf16, which differ only at
f32 rounding level.  So nearly every element is bit-equal; where a value
straddles a bf16 rounding boundary one ulp flips, and the flip feeds the next
step.  Two bounds follow, each tight enough to fail a real mistake:

* the largest difference, in bf16 ulps at ``max|want|``: dropping the
  recurrent product or a bias moves the last state by tens of ulps;
* the share of elements that are not bit-equal: a bf16 rounding point put
  in the wrong place (h not rounded before the recurrent product, the input
  projection rounded) changes 4-30 % of an LSTM's last states by an ulp, and
  1.3-2 % of a model's batchnormed encodes at init_std 0.1.  A different
  summation order changes 0.6-0.72 % (the kernel against cuBLAS on an H100,
  d=512) or under 0.03 % (the port against the JAX package on the CPU).

**f32.**  Nothing is rounded to a coarser type, so differences stay at f32
rounding level: the largest difference relative to ``max|want|`` of each
output, bounded by :data:`MAX_REL_ERR_F32`.  Its yardstick is the same
computation with TF32 operands (:func:`round_to_tf32`): the rule must fail
it, as it must fail a dropped bias or recurrent product.  The f32 LSTM
backward on the card takes 3xTF32 products on the tensor cores, which the
rule passes; :func:`matmul_3xtf32` emulates them for the tests.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

MAX_ULPS = 4
#: kernel against its plain version on the card
MAX_UNEQUAL_SHARE = 0.02
#: the port against the JAX package, both on the CPU
MAX_UNEQUAL_SHARE_CPU = 0.005
#: the LSTM backward's bf16 outputs (demb, dW), kernel against plain version
#: on the card.  A one-ulp flip of a rounded dgate feeds the f32 dh carry of
#: every earlier step, so flips compound toward step 0, and the kernel's
#: tensor-core accumulation flips more of them than a plain f32 product
#: does.  chip_smoke.py on an H100 at d=512: the kernel reads 2.2-4.4 % at
#: the training shapes and 6.1 % at B=37 with lengths uniform in 0..10; the
#: plain version with TF32 tensor-core products against itself with f32
#: products 3.5-5.2 %; its planted misplaced rounding points 17-39 % (c_t
#: read in f32, dgates left unrounded), a dropped carry or a skipped
#: injection tens of ulps.
MAX_UNEQUAL_SHARE_BWD = 0.10


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``|x|``: bf16 keeps 8 significant bits, so 2^(e-7)
    for ``|x|`` in [2^e, 2^(e+1))."""
    x = abs(x)
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


class Bf16Agreement(NamedTuple):
    max_abs_err: float
    ulps: float  # max_abs_err in bf16 ulps at max|want|
    unequal_share: float  # share of elements that are not bit-equal

    def ok(self, max_unequal_share: float = MAX_UNEQUAL_SHARE) -> bool:
        return self.ulps <= MAX_ULPS and self.unequal_share <= max_unequal_share

    def __str__(self) -> str:
        return (f"max_abs_err={self.max_abs_err:.3e} ({self.ulps:.2f} bf16 ulps at max|want|, "
                f"tol {MAX_ULPS}), unequal {self.unequal_share:.3%}")


def _f32(x) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32)


def bf16_agreement(got, want) -> Bf16Agreement:
    """Compare two bf16-valued arrays (tensors or numpy, any device)."""
    got = _f32(got)
    want = _f32(want).to(got.device)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return Bf16Agreement(0.0, 0.0, 0.0)
    diff = (got - want).abs()
    err = diff.max().item()
    ulp = bf16_ulp(want.abs().max().item())
    ulps = err / ulp if ulp else (0.0 if err == 0 else math.inf)
    return Bf16Agreement(err, ulps, (diff > 0).float().mean().item())


def assert_bf16_close(got, want, max_unequal_share: float = MAX_UNEQUAL_SHARE) -> Bf16Agreement:
    agreement = bf16_agreement(got, want)
    if not agreement.ok(max_unequal_share):
        raise AssertionError(f"bf16 results disagree: {agreement} (tol {max_unequal_share:.1%})")
    return agreement


# ------------------------------------------------------------------ f32


#: f32 results, kernel against its plain version on the card: the largest
#: difference relative to max|want| of each output (last, hs, cs, demb,
#: dW_ih, dW_hh, db, dx_proj).  Both sides take f32-accurate products in
#: another summation order (true f32, or 3xTF32 in the backward of kernels 2
#: and 6), so they differ at f32 rounding level; the same plain version with
#: its operands rounded to TF32's 10 mantissa bits (what one TF32
#: tensor-core product would give) differs at ~2^-11.  The limit lies
#: between the two: on an H100 (PERF.md, the chip_smoke.py runs) the FFMA
#: kernels read at most 1.85e-6, the 3xTF32 backward up to 1.3e-5 (its
#: dh/demb product: the tensor cores' f32 accumulation drifts over
#: 3 * 4H / 8 accumulating products), and one TF32 product per product at
#: least 1.27e-4 on some output of each kernel.
MAX_REL_ERR_F32 = 3e-5


class F32Agreement(NamedTuple):
    max_abs_err: float
    rel_err: float  # max_abs_err over max|want|

    def ok(self, max_unequal_share: float = MAX_UNEQUAL_SHARE) -> bool:
        """Within the f32 rule; ``max_unequal_share`` is the bf16 rule's and
        is not read (every f32 element may differ in its last bits)."""
        return self.rel_err <= MAX_REL_ERR_F32

    def __str__(self) -> str:
        return (f"max_abs_err={self.max_abs_err:.3e} ({self.rel_err:.2e} of max|want|, "
                f"tol {MAX_REL_ERR_F32:.0e})")


def f32_agreement(got, want) -> F32Agreement:
    """Compare two f32 arrays (tensors or numpy, any device)."""
    got = _f32(got)
    want = _f32(want).to(got.device)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return F32Agreement(0.0, 0.0)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return F32Agreement(err, err / scale if scale else (0.0 if err == 0 else math.inf))


def assert_f32_close(got, want) -> F32Agreement:
    agreement = f32_agreement(got, want)
    if not agreement.ok():
        raise AssertionError(f"f32 results disagree: {agreement}")
    return agreement


def agreement(got, want):
    """The rule of ``got``'s dtype: bf16 results by the bf16 rule, any other
    by the f32 rule."""
    is_bf16 = (got.dtype == torch.bfloat16) if isinstance(got, torch.Tensor) else False
    return bf16_agreement(got, want) if is_bf16 else f32_agreement(got, want)


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its mantissa rounded to nearest even at TF32's 10
    bits: the operand rounding of a TF32 tensor-core product, the yardstick
    the f32 rule must fail."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` (f32) as 3xTF32 tensor-core products compute it, emulated in
    f32: each operand split into ``hi = round_to_tf32(x)`` and ``lo =
    round_to_tf32(x - hi)``, and ``lo·hi' + hi·lo'`` summed before
    ``hi·hi'`` (the small terms first), as the f32 LSTM backward's kernels
    do.  ``passes=1`` keeps ``hi·hi'`` alone: one TF32 product, which the
    f32 rule must fail.  For the tests and ``chip_smoke.py``; the port's
    plain versions take true f32 products."""
    a_hi, b_hi = round_to_tf32(a), round_to_tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    a_lo, b_lo = round_to_tf32(a.float() - a_hi), round_to_tf32(b.float() - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
