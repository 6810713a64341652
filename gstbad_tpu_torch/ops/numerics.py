"""The port's float policy, shared by every op family.

Where the JAX package's float32 result must come out the same on the card
and on the CPU:
- convolutions and matrix products run in full float32, never TF32
  (full_fp32);
- exp, log and pow are taken in float64 and rounded to float32 (f32):
  CUDA's and the CPU's float32 transcendentals differ in the last ulp, the
  correctly rounded value does not;
- division by a Python number is one IEEE division by a device scalar
  (true_div);
- where XLA's CPU code contracts `a*b + c` into one FMA, the port rounds
  once too (fma32 on float32 tensors, fma64 on Python floats).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 convolutions and matrix products in full float32 (no TF32)
    inside the block, whatever the caller's setting, as the JAX package
    computes them (matchTemplate pins Precision.HIGHEST; freeverb's and
    digitalzoom's products are float32 on the CPU)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def f32(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (exp, log, pow...) of a float32 tensor, taken in float64 and
    rounded to float32: the same bits on the card and the CPU."""
    return fn(x.to(torch.float64)).to(torch.float32)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d for a Python number d, as one IEEE division on every device
    and in x's dtype (CUDA divides by a host scalar as a product with its
    reciprocal, and `d / x` is a reciprocal times d everywhere)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def fma32(a, b, c):
    """a * b + c for float32 tensors with one rounding, as XLA's CPU code
    contracts it into an FMA: the float64 product of two float32 values is
    exact and the float64 sum rounds once more before the float32 result
    (a difference from the fused rounding only at a float32 midpoint).
    The same separate float64 ops on the card and the CPU."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def fma64(a: float, b: float, c: float) -> float:
    """a * b + c with one rounding, for Python floats: the exact value as
    a ratio of integers (every float is one, with a power-of-two
    denominator), divided once (int / int rounds correctly)."""
    na, da = a.as_integer_ratio()
    nb, db = b.as_integer_ratio()
    nc, dc = c.as_integer_ratio()
    dab = da * db
    den = max(dab, dc)
    return (na * nb * (den // dab) + nc * (den // dc)) / den
