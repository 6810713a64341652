"""gst_fft_s16 on the device: the Hamming window and the bit-exact
kissfft FIXED_POINT=16 pipeline (ops/kissfft_s16.py), batched over a
window's frames (the torch form of gstbad_tpu/ops/ffts16.py)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gstbad_tpu_torch.ops import kissfft_s16


@lru_cache(maxsize=None)
def _hamming_f64(n: int) -> np.ndarray:
    return np.asarray(0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n))


def window_hamming(s16: torch.Tensor) -> torch.Tensor:
    """Batched gst_fft_s16_window HAMMING: [..., N] int16-valued ->
    windowed int16 values (the C's (gint16) truncation), int32."""
    w = torch.from_numpy(_hamming_f64(s16.shape[-1])).to(s16.device)
    return torch.trunc(s16.to(torch.float64) * w).to(torch.int32)


def fft_s16(s16: torch.Tensor):
    """Batched [..., nfft] int-valued -> (real, imag) int32 pairs
    [..., nfft/2 + 1], bit for bit gst_fft_s16."""
    return kissfft_s16.kiss_fftr_s16(s16, s16.shape[-1])
