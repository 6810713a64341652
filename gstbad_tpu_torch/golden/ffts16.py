"""The parts of gstbad_tpu/golden/ffts16.py the scopes read: kissfft's
factorization, the aggregate fixed-point scale of kiss_fftr, and
synaescope's colour and shade tables (gstsynaescope.c:104-126, 233)."""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.ops.kissfft_s16 import kf_factor  # noqa: F401


def fft_scale(nfft: int) -> float:
    """Aggregate fixed-point scale of kiss_fftr(nfft) against an exact
    rfft: one DIVSCALAR per stage of the nfft/2-point complex transform
    and the real wrapper's DIVSCALAR(, 2)."""
    s = 1.0
    for p in kf_factor(nfft // 2):
        s *= (32767 // p) / 32768.0
    s *= (32767 // 2) / 32768.0      # C_FIXDIV(fpk, 2) in kiss_fftr
    return s


def synaescope_tables():
    """colors + shade LUTs (gstsynaescope.c:104-126)."""
    colors = np.zeros(256, np.uint32)

    def bound(x):
        return 255 if x > 255 else x

    def peakify(x):
        return bound(x - x * (255 - x) // 255 // 2)

    for i in range(256):
        r = peakify(i & (15 * 16))
        g = peakify((i & 15) * 16 + (i & (15 * 16)) // 4)
        b = peakify((i & 15) * 16)
        colors[i] = (r << 16) | (g << 8) | b
    shade = np.array([(i * 200) >> 8 for i in range(256)], np.int32)
    return colors, shade


SYNAE_SL = 30   # gstsynaescope.c:233 (const guint sl)
