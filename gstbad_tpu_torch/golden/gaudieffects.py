"""gaudieffects reference data (gst/gaudieffects/).

A copy of gstbad_tpu/golden/gaudieffects.py:chromium_cos_table.
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
