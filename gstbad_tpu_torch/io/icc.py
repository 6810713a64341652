"""Minimal ICC profile reader/writer for matrix/TRC display profiles
(numpy only; a copy of the JAX package's io/icc.py, so that a profile
parses and serializes byte for byte alike in both packages).

Supports the profile class the lcms element (ext/colormanagement/gstlcms.c)
is used with in practice: RGB display profiles built from per-channel tone
reproduction curves ('curv' gamma/table and 'para' parametric types 0-4)
plus the rXYZ/gXYZ/bXYZ primaries and the wtpt white point.  The writer
makes the profiles that tests and chip_smoke.py feed to lcms.

ICC spec references: ICC.1:2010 (v4.3) sections 10.5 (curveType),
10.16 (parametricCurveType), 10.31 (XYZType).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def _s15f16(v: float) -> int:
    return int(round(v * 65536.0))


def _from_s15f16(raw: int) -> float:
    if raw >= 1 << 31:
        raw -= 1 << 32
    return raw / 65536.0


@dataclass
class Curve:
    """'curv' (gamma g or table) or 'para' (params [g] / [g,a,b] / ...)."""
    kind: str                      # "gamma" | "table" | "para"
    gamma: float = 1.0
    table: Optional[np.ndarray] = None   # float in [0,1]
    para_type: int = 0
    params: Tuple[float, ...] = ()

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Forward curve: encoded [0,1] -> linear [0,1] (float64)."""
        x = np.asarray(x, np.float64)
        if self.kind == "gamma":
            return np.power(x, self.gamma)
        if self.kind == "table":
            t = self.table
            return np.interp(x, np.linspace(0, 1, len(t)), t)
        g = self.params[0]
        if self.para_type == 0:
            return np.power(x, g)
        if self.para_type == 1:          # CIE 122-1966
            _, a, b = self.params
            return np.where(x >= -b / a, np.power(a * x + b, g), 0.0)
        if self.para_type == 2:
            _, a, b, c = self.params
            return np.where(x >= -b / a, np.power(a * x + b, g) + c, c)
        if self.para_type == 3:          # sRGB-style
            _, a, b, c, d = self.params
            return np.where(x >= d, np.power(a * x + b, g), c * x)
        if self.para_type == 4:
            _, a, b, c, d, e, f = self.params
            return np.where(x >= d, np.power(a * x + b, g) + e, c * x + f)
        raise ValueError(f"parametric curve type {self.para_type}")

    def invert(self, y: np.ndarray) -> np.ndarray:
        """Inverse curve: linear [0,1] -> encoded [0,1] (float64)."""
        y = np.asarray(y, np.float64)
        if self.kind == "gamma":
            return np.power(np.clip(y, 0, None), 1.0 / self.gamma)
        if self.kind == "table":
            t = self.table
            xs = np.linspace(0, 1, len(t))
            return np.interp(y, t, xs)  # assumes monotone table
        g = self.params[0]
        if self.para_type == 0:
            return np.power(np.clip(y, 0, None), 1.0 / g)
        if self.para_type == 3:
            _, a, b, c, d = self.params
            lin_knee = c * d
            return np.where(y >= lin_knee,
                            (np.power(np.clip(y, 0, None), 1.0 / g) - b) / a,
                            y / max(c, 1e-12))
        # generic numeric inversion on a dense grid
        xs = np.linspace(0, 1, 4096)
        ys = self.evaluate(xs)
        return np.interp(y, ys, xs)


@dataclass
class IccProfile:
    matrix: np.ndarray              # 3x3, columns = r/g/bXYZ
    trc: List[Curve]                # r, g, b
    white: np.ndarray               # wtpt XYZ


_SRGB_PARA = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)
# sRGB primaries as stored by lcms (D50-adapted, s15f16-rounded)
_SRGB_MATRIX = np.array([
    [0.436066, 0.385147, 0.143066],
    [0.222488, 0.716873, 0.060608],
    [0.013916, 0.097076, 0.714096],
])
_D50 = np.array([0.9642, 1.0, 0.8249])


def srgb_profile() -> IccProfile:
    return IccProfile(matrix=_SRGB_MATRIX.copy(),
                      trc=[Curve("para", para_type=3, params=_SRGB_PARA)] * 3,
                      white=_D50.copy())


def parse_icc(data: bytes) -> IccProfile:
    """Parse a matrix/TRC RGB display profile."""
    if len(data) < 132:
        raise ValueError("truncated ICC profile")
    (n_tags,) = struct.unpack(">I", data[128:132])
    tags: Dict[bytes, Tuple[int, int]] = {}
    for i in range(n_tags):
        sig, off, size = struct.unpack_from(">4sII", data, 132 + 12 * i)
        tags[sig] = (off, size)

    def xyz(sig: bytes) -> np.ndarray:
        off, _ = tags[sig]
        vals = struct.unpack_from(">3i", data, off + 8)
        return np.array([_from_s15f16(v) for v in vals])

    def curve(sig: bytes) -> Curve:
        off, _ = tags[sig]
        typ = data[off:off + 4]
        if typ == b"curv":
            (n,) = struct.unpack_from(">I", data, off + 8)
            if n == 0:
                return Curve("gamma", gamma=1.0)
            if n == 1:
                (raw,) = struct.unpack_from(">H", data, off + 12)
                return Curve("gamma", gamma=raw / 256.0)  # u8Fixed8
            vals = np.frombuffer(data, ">u2", n, off + 12)
            return Curve("table", table=vals.astype(np.float64) / 65535.0)
        if typ == b"para":
            (ptype,) = struct.unpack_from(">H", data, off + 8)
            n_par = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[ptype]
            raw = struct.unpack_from(f">{n_par}i", data, off + 12)
            return Curve("para", para_type=ptype,
                         params=tuple(_from_s15f16(v) for v in raw))
        raise ValueError(f"unsupported TRC tag type {typ!r}")

    for required in (b"rXYZ", b"gXYZ", b"bXYZ", b"rTRC", b"gTRC", b"bTRC"):
        if required not in tags:
            raise ValueError(
                f"not a matrix/TRC profile (missing {required.decode()}); "
                "LUT-based (A2B) profiles are not supported")
    mat = np.stack([xyz(b"rXYZ"), xyz(b"gXYZ"), xyz(b"bXYZ")], axis=1)
    white = xyz(b"wtpt") if b"wtpt" in tags else _D50.copy()
    return IccProfile(matrix=mat,
                      trc=[curve(b"rTRC"), curve(b"gTRC"), curve(b"bTRC")],
                      white=white)


def write_icc(profile: IccProfile, description: str = "gstbad") -> bytes:
    """Serialize a matrix/TRC RGB display profile (v2, accepted by lcms2)."""
    tags = []

    def xyz_tag(v):
        return b"XYZ \x00\x00\x00\x00" + struct.pack(
            ">3i", *[_s15f16(float(x)) for x in v])

    def curve_tag(c: Curve) -> bytes:
        if c.kind == "gamma":
            return (b"curv\x00\x00\x00\x00" + struct.pack(">I", 1)
                    + struct.pack(">H", int(round(c.gamma * 256))))
        if c.kind == "table":
            t = np.clip(np.rint(c.table * 65535), 0, 65535).astype(">u2")
            return (b"curv\x00\x00\x00\x00" + struct.pack(">I", len(t))
                    + t.tobytes())
        n_par = {0: 1, 1: 3, 2: 4, 3: 5, 4: 7}[c.para_type]
        return (b"para\x00\x00\x00\x00" + struct.pack(">HH", c.para_type, 0)
                + struct.pack(f">{n_par}i",
                              *[_s15f16(p) for p in c.params[:n_par]]))

    def desc_tag(text: str) -> bytes:
        raw = text.encode() + b"\x00"
        return (b"desc\x00\x00\x00\x00" + struct.pack(">I", len(raw)) + raw
                + b"\x00" * 78)

    m = profile.matrix
    tags.append((b"desc", desc_tag(description)))
    tags.append((b"wtpt", xyz_tag(profile.white)))
    tags.append((b"rXYZ", xyz_tag(m[:, 0])))
    tags.append((b"gXYZ", xyz_tag(m[:, 1])))
    tags.append((b"bXYZ", xyz_tag(m[:, 2])))
    for sig, c in zip((b"rTRC", b"gTRC", b"bTRC"), profile.trc):
        tags.append((sig, curve_tag(c)))

    table = b""
    body = b""
    off = 128 + 4 + 12 * len(tags)
    for sig, payload in tags:
        pad = (4 - len(payload) % 4) % 4
        table += struct.pack(">4sII", sig, off, len(payload))
        body += payload + b"\x00" * pad
        off += len(payload) + pad

    total = 128 + 4 + 12 * len(tags) + len(body)
    header = struct.pack(
        ">I4sI4s4s4s12x4sIII4sI8x16x28x",
        total, b"lcms", 0x04300000, b"mntr", b"RGB ", b"XYZ ",
        b"acsp", 0, 0, 0, b"    ", 0)
    header = header[:128].ljust(128, b"\x00")
    # white point in header illuminant field (bytes 68-80)
    header = (header[:68]
              + struct.pack(">3i", *[_s15f16(v) for v in _D50])
              + header[80:])
    return header + struct.pack(">I", len(tags)) + table + body
