"""How a bf16 result is held against a reference that did the same
arithmetic in another f32 summation order: the CUDA kernel against its
plain version, the port against the JAX package.

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
