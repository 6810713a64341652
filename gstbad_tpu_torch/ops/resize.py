"""jax.image.resize(x, shape, "linear") for planes, in torch: the Haar
pyramid's resampler (gstbad_tpu/ops/haar.py calls it once a scale).

The weights are jax/_src/image/scale.py's compute_weight_mat with
antialias on (so a downscale widens the triangle kernel by the scale),
computed in float64 as the JAX package (x64) traces them and rounded to
float32, with XLA's CPU contractions: the kernel's 1 - |d| * (1/s) is one
fused rounding (taken exactly here, with fractions, on the few taps that
fall inside the kernel), and the column sums divide.

The two contractions (rows, then columns, jnp.einsum's order) are float32
sums of each output's taps in ascending input order, each tap one fused
multiply-add (ops/numerics.fma32).  XLA's CPU dot sums the row pass's
taps with the same FMAs but splits K across its thread pool (blocks of
96 at K = 720 and 136 at K = 1080 on 8 cores, 240 and 272 on 4) and adds
the partial sums, rounding once more at a block edge, and takes another
kernel path for the column pass when 64 rows or more share it.  Its
rounding therefore depends on the host's core count; the result here is
within 4 ulp of jax.image.resize (tests/test_torch_haar.py), not bit for
bit.  The order here is the same
on the card and the CPU, so the port's planes are equal on both."""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.ops.numerics import fma32


@functools.lru_cache(maxsize=256)
def weights(m: int, n: int):
    """(first tap [n] int64, weights [n, T] float32): output j of a
    length-n resize of a length-m axis is sum_t w[j, t] * x[k0[j] + t]."""
    inv = 1.0 / (n / m)
    ks = max(inv, 1.0)
    r = 1.0 / ks
    sf = (np.arange(n, dtype=np.float64) + 0.5) * inv - 0.5
    d = np.abs(sf[None, :] - np.arange(m, dtype=np.float64)[:, None])
    w = np.zeros((m, n))
    rf = Fraction(r)
    for i, j in zip(*np.nonzero(d * r < 1.0 + 1e-9)):
        w[i, j] = max(float(1 - Fraction(d[i, j]) * rf), 0.0)
    tot = np.zeros(n)
    for i in range(m):                    # XLA's reduce: in row order
        tot = tot + w[i]
    keep = np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(keep[None], w / np.where(tot != 0, tot, 1)[None], 0.0)
    w = np.where(((sf >= -0.5) & (sf <= m - 0.5))[None, :], w, 0.0)
    w = w.astype(np.float32)
    nz = w != 0
    k0 = np.where(nz.any(0), nz.argmax(0), 0)
    k1 = np.where(nz.any(0), m - nz[::-1].argmax(0), 0)
    taps = max(int((k1 - k0).max()), 1)
    k0 = np.minimum(k0, max(m - taps, 0))
    wt = np.zeros((n, taps), np.float32)
    for j in range(n):
        span = w[k0[j]:k0[j] + taps, j]
        wt[j, :len(span)] = span
    return k0.astype(np.int64), wt


def _resize_axis(x, n: int, dim: int):
    m = x.shape[dim]
    if m == n:
        return x
    k0, wt = weights(m, n)
    xm = x.movedim(dim, -1)
    k0 = torch.from_numpy(k0).to(x.device)
    wt = torch.from_numpy(wt).to(x.device)
    acc = torch.zeros(xm.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    for t in range(wt.shape[1]):
        acc = fma32(wt[:, t], xm.index_select(-1, k0 + t), acc)
    return acc.movedim(-1, dim)


def resize_linear(x, sh: int, sw: int):
    """[..., H, W] -> [..., sh, sw] float32, rows first, then columns."""
    x = x.to(torch.float32)
    return _resize_axis(_resize_axis(x, sh, -2), sw, -1)
