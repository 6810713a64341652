"""(A copy of gstbad_tpu/golden/qroverlay.py, numpy only.)

Golden transcription of gstbaseqroverlay.c's overlay rasterizer.

draw_overlay (ext/qroverlay/gstbaseqroverlay.c:138-204) paints the QR
module matrix into an ARGB canvas that GStreamer's overlay composition
machinery then blends over the frame.  Quirks reproduced byte-exactly:

- GST_VIDEO_OVERLAY_COMPOSITION_FORMAT_RGB is BGRA on little-endian
  machines, so the three zeroed bytes per dark pixel are B,G,R and the
  fourth (alpha) keeps the 0xff memset background — opaque black on
  opaque white.  (On big-endian the same code would zero A,R,G and
  leave B=0xff: transparent holes.  Little-endian behavior is the one
  every shipping machine sees and the one reproduced here.)
- the horizontal module offset is `x*ps + ps + 4*ps` pixels
  (gstbaseqroverlay.c:170-173): one module MORE than the 4-module quiet
  zone — the code is shifted one module right (left margin 5, right 3).
- `pixel-size` is a float used in integer contexts: each of
  `square_size`, `line_offset`, the per-module offset and the
  `yy < ps*pstride` / `i < ps*pstride` loop bounds truncates its float
  product independently, so fractional sizes give non-uniform module
  geometry (and byte writes that straddle pixel boundaries).  All
  truncation points match the C.
"""

from __future__ import annotations

import numpy as np


def draw_overlay(modules: np.ndarray, pixel_size: float) -> np.ndarray:
    """QR bool matrix -> BGRA byte canvas [square, square, 4]
    (gstbaseqroverlay.c:138-178)."""
    qrw = modules.shape[0]
    ps = float(pixel_size)
    pstride = 4
    square = int((qrw + 4 * 2) * ps)
    stride = square * 4
    pixels = np.full(square * stride, 0xFF, np.uint8)

    line_offset = int(4 * ps * stride)
    for y in range(qrw):
        for x in range(qrw):
            if modules[y, x]:
                yy = 0
                while yy < ps * pstride:
                    offset = int(line_offset + stride * (yy // pstride)
                                 + x * ps * pstride
                                 + ps * pstride + 4 * ps * pstride)
                    i = 0
                    while i < ps * pstride:
                        pixels[offset + i] = 0
                        pixels[offset + i + 1] = 0
                        pixels[offset + i + 2] = 0
                        i += pstride
                    yy += pstride
        line_offset = int(line_offset + stride * ps)
    return pixels.reshape(square, square, 4)


def overlay_position(frame_w: int, frame_h: int, square: int,
                     x_percent: float, y_percent: float) -> tuple:
    """(x, y) of the composition rectangle
    (gstbaseqroverlay.c:180-183): truncate-to-int placement, x rounded
    down to even, y rounded down to a multiple of 4."""
    x = int(int(frame_w - square) * (x_percent / 100.0))
    x &= ~1
    y = int(int(frame_h - square) * (y_percent / 100.0))
    y &= ~3
    return x, y
