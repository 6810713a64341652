"""pnm (gst/pnm/) — P5 (GRAY8) / P6 (RGB) image enc/dec."""

from __future__ import annotations

import io
import re

import numpy as np

from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat


def read_pnm(path_or_bytes):
    """-> (MediaSpec, np.ndarray [H, W] or [H, W, 3])."""
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else open(path_or_bytes, "rb").read())
    m = re.match(rb"(P[56])\s+(?:#[^\n]*\n\s*)*(\d+)\s+(\d+)\s+(\d+)\s",
                 data)
    if not m:
        raise ValueError("not a binary P5/P6 pnm")
    kind, w, h, maxval = (m.group(1), int(m.group(2)), int(m.group(3)),
                          int(m.group(4)))
    if maxval > 255:
        raise ValueError("16-bit pnm unsupported")
    body = data[m.end():]
    if kind == b"P5":
        img = np.frombuffer(body[:w * h], np.uint8).reshape(h, w)
        fmt = VideoFormat.GRAY8
    else:
        img = np.frombuffer(body[:w * h * 3], np.uint8).reshape(h, w, 3)
        fmt = VideoFormat.RGB
    return MediaSpec(kind="video", format=fmt, width=w, height=h), img


def write_pnm(path, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        if img.ndim == 2:
            f.write(f"P5\n{w} {h}\n255\n".encode())
        elif img.shape[2] == 3:
            f.write(f"P6\n{w} {h}\n255\n".encode())
        else:
            raise ValueError("write_pnm wants [H,W] or [H,W,3]")
        f.write(np.ascontiguousarray(img).tobytes())
