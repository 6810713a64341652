"""The port's FFTs, routed by device.

On the card they are torch.fft (cuFFT).  On the CPU they go through
scipy.fft (pocketfft) in float32/complex64: XLA's CPU FFT (ducc) rounds
as pocketfft does, so rfft and irfft equal jnp.fft.rfft/irfft bit for
bit, and fft2/ifft2 do too when the last axis is transformed first, with
ifft2's 1/(H*W) applied in that first pass (scipy.fft.fftn/ifftn over
axes (-1, -2)).  torch.fft on the CPU differs from XLA's FFT by up to
4e-5 at n = 1024..4096, which pitch's unwrapped phase carries on.  This is
a route per device, not a fallback: a CUDA tensor always takes cuFFT."""

from __future__ import annotations

import numpy as np
import scipy.fft
import torch


def _cpu(x) -> np.ndarray:
    return x.detach().numpy()


def rfft(x, dim: int = -1):
    if x.device.type != "cpu":
        return torch.fft.rfft(x, dim=dim)
    return torch.from_numpy(np.ascontiguousarray(
        scipy.fft.rfft(_cpu(x), axis=dim)))


def irfft(x, n: int, dim: int = -1):
    if x.device.type != "cpu":
        return torch.fft.irfft(x, n=n, dim=dim)
    return torch.from_numpy(np.ascontiguousarray(
        scipy.fft.irfft(_cpu(x), n=n, axis=dim)))


def fft2(x):
    """2-D FFT over the last two axes (complex64 out)."""
    if x.device.type != "cpu":
        return torch.fft.fft2(x.to(torch.complex64))
    return torch.from_numpy(np.ascontiguousarray(scipy.fft.fftn(
        _cpu(x.to(torch.complex64)), axes=(-1, -2))))


def ifft2(x):
    """2-D inverse FFT over the last two axes (complex64 out)."""
    if x.device.type != "cpu":
        return torch.fft.ifft2(x.to(torch.complex64))
    return torch.from_numpy(np.ascontiguousarray(scipy.fft.ifftn(
        _cpu(x.to(torch.complex64)), axes=(-1, -2))))
