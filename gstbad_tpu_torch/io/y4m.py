"""y4m (YUV4MPEG2) reader/writer — the gst/y4m + gst/rawparse analog for
getting real video in and out of the framework without external deps.
numpy only; the header written is byte for byte the JAX package's."""

from __future__ import annotations

import io
from fractions import Fraction
from typing import Tuple

import numpy as np

from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat


def read_y4m(path_or_bytes) -> Tuple[MediaSpec, dict]:
    """Read a whole y4m file -> (spec, {"y": [N,H,W], "u": ..., "v": ...})."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    else:
        f = open(path_or_bytes, "rb")
    with f:
        header = f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m stream")
        w = h = 0
        fr = Fraction(30, 1)
        fmt = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "F":
                n, d = tok[1:].split(":")
                fr = Fraction(int(n), int(d))
            elif tok[0] == "C":
                fmt = tok[1:]
        if not fmt.startswith("420"):
            raise ValueError(f"unsupported y4m chroma {fmt}")
        ys, us, vs = [], [], []
        ysz, csz = w * h, (w // 2) * (h // 2)
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                break
            ys.append(np.frombuffer(buf[:ysz], np.uint8).reshape(h, w))
            us.append(np.frombuffer(buf[ysz:ysz + csz], np.uint8
                                    ).reshape(h // 2, w // 2))
            vs.append(np.frombuffer(buf[ysz + csz:], np.uint8
                                    ).reshape(h // 2, w // 2))
    spec = MediaSpec(kind="video", format=VideoFormat.I420, width=w,
                     height=h, framerate=fr)
    return spec, {"y": np.stack(ys), "u": np.stack(us), "v": np.stack(vs)}


def write_y4m(path, spec: MediaSpec, planes: dict) -> None:
    """Write I420 planes {"y": [N,H,W], "u", "v": [N,H/2,W/2]} as y4m."""
    fr = spec.framerate
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{spec.width} H{spec.height} "
                f"F{fr.numerator}:{fr.denominator} Ip A1:1 C420\n".encode())
        n = planes["y"].shape[0]
        for i in range(n):
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(planes["y"][i]).tobytes())
            f.write(np.ascontiguousarray(planes["u"][i]).tobytes())
            f.write(np.ascontiguousarray(planes["v"][i]).tobytes())
