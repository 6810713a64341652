"""gaudieffects reference data (gst/gaudieffects/).

Copies of gstbad_tpu/golden/gaudieffects.py:chromium_cos_table and
gaussian_kernel.
"""

from __future__ import annotations

import numpy as np


def chromium_cos_table() -> np.ndarray:
    """setup_cos_table (gstchromium.c:283-293): 1024-entry table of
    (int)(cosf(angle/512 * 3.141582f) * 512) — note the reference's
    typo'd pi constant, computed in C float precision."""
    pi = np.float32(3.141582)
    angle = np.arange(1024, dtype=np.float32)
    rad = (angle / np.float32(512)) * pi  # float expression in C
    # cos() takes the float arg promoted to double; (int) truncates
    return np.trunc(np.cos(rad.astype(np.float64)) * 512.0).astype(np.int32)


def gaussian_kernel(sigma: float):
    """make_gaussian_kernel (gstgaussblur.c:361-422) in C float precision.

    Returns (kernel, prefix_sums) float32 arrays; negative sigma builds the
    sharpen kernel (sum negated, centre += 2*sum, normalize by negated sum).
    """
    sigma = np.float32(sigma)
    center = int(np.ceil(2.5 * np.abs(float(sigma))))
    window = 1 + 2 * center
    if window == 1:
        return (np.ones(1, np.float32), np.ones(1, np.float32))
    # C: `const float fe = -0.5 / (sigma * sigma)` — double expr cast to float
    fe = np.float32(-0.5 / (np.float64(sigma) * np.float64(sigma)))
    dx = np.float32(1.0 / (np.float64(sigma) * np.sqrt(2 * np.pi)))
    kern = np.zeros(window, np.float32)
    kern[center] = dx
    s = dx
    for i in range(1, center + 1):
        # C: `float fx = dx * pow(G_E, fe * i * i)` — (fe*i)*i associates in
        # float, then pow promotes to double
        arg = np.float32(np.float32(fe * np.float32(i)) * np.float32(i))
        fx = np.float32(np.float64(dx) * np.power(np.e, np.float64(arg)))
        kern[center + i] = kern[center - i] = fx
        s = np.float32(s + np.float32(2) * fx)
    if sigma < 0:
        s = np.float32(-s)
        kern[center] = np.float32(kern[center] + np.float32(2.0) * s)
    kern = (kern / s).astype(np.float32)
    ksum = np.cumsum(kern, dtype=np.float32).astype(np.float32)
    return kern, ksum
