"""OpenEXR image io (ext/openexr/gstopenexrdec.cpp).

Decode goes through csrc/exrdec.c, a shim over the system
libOpenEXRCore-3_1 — the C API of the same OpenEXR the reference binds
via the C++ RgbaInputFile (gstopenexrdec.cpp:276-345).  The shim decodes
any single-part scanline or tiled EXR (all OpenEXR compressions: none /
RLE / ZIPS / ZIP / PIZ / PXR24 / B44 / DWA) into interleaved float32
RGBA with RgbaInputFile's channel fill semantics (missing RGB = 0,
missing A = 1, lone Y replicates to RGB).

This module adds:
  - decode_exr(data) -> (float32 [H, W, 4] RGBA, pixel aspect ratio)
  - to_argb64(rgba): the reference's exact output conversion
    (gstopenexrdec.cpp:430-441): CLAMP(half * 65536, 0, 65535) per
    component into u16 A,R,G,B order - note the 65536 multiplier (not
    65535), a reference quirk kept byte-exact.
  - split_exr_stream(data): the sink-parse scan
    (gstopenexrdec.cpp:203-250): images split at the next 0x762f3101
    magic whose version is 1 or 2 and whose flags pass
    (!(flags & 0x200) || !(flags & 0x1800)).
  - write_exr(...): a from-spec EXR *writer* (OpenEXR file layout:
    magic, version 2, chlist/compression/dataWindow/displayWindow/
    lineOrder/pixelAspectRatio/screenWindow* attributes, chunk offset
    table, scanline chunks) supporting NONE, ZIPS and ZIP compression
    with the reorder+delta predictor from ImfZip.cpp.  The writer is
    pure numpy - it exists so the tests can cross-validate the library
    decoder against an independent implementation (and vice versa).

A copy of the JAX package's io/exr.py: the shim is the port's own copy,
gstbad_tpu_torch/csrc/exrdec.c, built at first use into
gstbad_tpu_torch/_build/ (io/_native_build.py); the rest differs only in
its imports.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import zlib
from typing import List, Optional, Tuple

import numpy as np

from gstbad_tpu_torch.io import _native_build

_LIB = None

MAGIC = 0x01312F76  # 'v'/'1'\x01 little-endian (gstopenexrdec.cpp:243)
MAGIC_BYTES = b"\x76\x2f\x31\x01"

COMPRESSION_NONE = 0
COMPRESSION_RLE = 1
COMPRESSION_ZIPS = 2
COMPRESSION_ZIP = 3

PIXEL_HALF = 1
PIXEL_FLOAT = 2


def _so_path() -> str:
    return os.path.join(_native_build.build_dir("exrdec", ["exrdec.c"]),
                        "libexrdec.so")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _so_path()
    _native_build.gcc_shared(so, "exrdec.c", "-I/usr/include/OpenEXR",
                             libs=("-lOpenEXRCore-3_1",))
    lib = ctypes.CDLL(so)
    lib.exrdec_decode_rgba.restype = ctypes.c_int
    lib.exrdec_decode_rgba.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class ExrError(ValueError):
    pass


_ERRORS = {-1: "failed to read OpenEXR stream",
           -2: "not a single-part scanline/tiled image",
           -3: "subsampled (luma/chroma) EXR not supported",
           -4: "failed to decode pixels"}


def decode_exr(data: bytes) -> Tuple[np.ndarray, float]:
    """EXR bytes -> (float32 [H, W, 4] RGBA, pixel aspect ratio)."""
    lib = _load()
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    par = ctypes.c_float()
    rc = lib.exrdec_decode_rgba(data, len(data), None,
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(par))
    if rc != 0:
        raise ExrError(_ERRORS.get(rc, f"exrdec error {rc}"))
    planes = np.empty((4, h.value, w.value), np.float32)
    rc = lib.exrdec_decode_rgba(
        data, len(data), planes.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(par))
    if rc != 0:
        raise ExrError(_ERRORS.get(rc, f"exrdec error {rc}"))
    # the shim decodes planar R,G,B,A (OpenEXRCore's interleaved fast
    # path ignores channel pointer order); interleave here
    return np.ascontiguousarray(planes.transpose(1, 2, 0)), \
        float(par.value)


def to_argb64(rgba: np.ndarray) -> np.ndarray:
    """float RGBA -> u16 [H, W, 4] in A,R,G,B order, the reference's
    CLAMP(v * 65536, 0, 65535) (gstopenexrdec.cpp:434-437)."""
    argb = np.stack([rgba[..., 3], rgba[..., 0], rgba[..., 1],
                     rgba[..., 2]], axis=-1)
    return np.clip(argb.astype(np.float64) * 65536, 0, 65535) \
        .astype(np.uint16)


def split_exr_stream(data: bytes) -> List[bytes]:
    """Split a concatenation of EXR images at validated magics
    (gst_openexr_dec_parse, gstopenexrdec.cpp:203-250)."""
    starts = []
    pos = 0
    while True:
        idx = data.find(MAGIC_BYTES, pos)
        if idx < 0:
            break
        if idx + 8 <= len(data):
            flags = struct.unpack_from("<I", data, idx + 4)[0]
            if (flags & 0xFF) in (1, 2) and (
                    not (flags & 0x200) or not (flags & 0x1800)):
                starts.append(idx)
        pos = idx + 4
    return [data[s:e] for s, e in
            zip(starts, starts[1:] + [len(data)])]


# ----------------------------------------------------------------------
# From-spec writer (independent of the library; test oracle)

def _attr(name: str, typ: str, value: bytes) -> bytes:
    return (name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<I", len(value)) + value)


def _chlist(channels: List[str], pixel_type: int) -> bytes:
    out = b""
    for name in sorted(channels):
        out += (name.encode() + b"\x00"
                + struct.pack("<iBBBBii", pixel_type, 0, 0, 0, 0, 1, 1))
    return out + b"\x00"


def _zip_compress(raw: bytes) -> bytes:
    """ImfZip.cpp compress(): byte reorder, delta predictor, deflate."""
    buf = bytearray(len(raw))
    half = (len(raw) + 1) // 2
    buf[0:half] = raw[0::2]
    buf[half:] = raw[1::2]
    arr = np.frombuffer(bytes(buf), np.uint8).astype(np.int16)
    d = np.empty_like(arr)
    d[0] = arr[0]
    d[1:] = arr[1:] - arr[:-1] + 128 + 256
    return zlib.compress(d.astype(np.uint8).tobytes())


def write_exr(path_or_none: Optional[str], planes: dict,
              compression: int = COMPRESSION_ZIP,
              pixel_type: int = PIXEL_HALF,
              pixel_aspect: float = 1.0,
              tile_size: Optional[int] = None) -> bytes:
    """Write an EXR from named channel planes ({"R": [H,W] float, ...}).

    tile_size writes a single-level tiled file (version bit 0x200)
    instead of scanlines.  Returns the bytes; also writes them to
    path_or_none if given."""
    channels = sorted(planes)
    h, w = next(iter(planes.values())).shape
    dtype = np.float16 if pixel_type == PIXEL_HALF else np.float32
    pix = {c: np.asarray(planes[c], dtype) for c in channels}

    version = 2 | (0x200 if tile_size else 0)
    header = MAGIC_BYTES + struct.pack("<I", version)
    header += _attr("channels", "chlist", _chlist(channels, pixel_type))
    header += _attr("compression", "compression",
                    struct.pack("<B", compression))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float",
                    struct.pack("<f", pixel_aspect))
    header += _attr("screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    if tile_size:
        # tiledesc: x size, y size, mode byte (ONE_LEVEL, round down)
        header += _attr("tiles", "tiledesc",
                        struct.pack("<IIB", tile_size, tile_size, 0))
    header += b"\x00"

    def _pack(raw: bytes) -> bytes:
        if compression in (COMPRESSION_ZIP, COMPRESSION_ZIPS):
            packed = _zip_compress(raw)
            return raw if len(packed) >= len(raw) else packed
        return raw

    chunks = []
    if tile_size:
        for ty in range((h + tile_size - 1) // tile_size):
            for tx in range((w + tile_size - 1) // tile_size):
                y0, y1 = ty * tile_size, min((ty + 1) * tile_size, h)
                x0, x1 = tx * tile_size, min((tx + 1) * tile_size, w)
                raw = b"".join(pix[c][y, x0:x1].tobytes()
                               for y in range(y0, y1) for c in channels)
                packed = _pack(raw)
                chunks.append(struct.pack("<iiiii", tx, ty, 0, 0,
                                          len(packed)) + packed)
        n_chunks = len(chunks)
    else:
        lines_per_chunk = {COMPRESSION_NONE: 1, COMPRESSION_RLE: 1,
                           COMPRESSION_ZIPS: 1,
                           COMPRESSION_ZIP: 16}[compression]
        n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
        for ci in range(n_chunks):
            y0 = ci * lines_per_chunk
            y1 = min(y0 + lines_per_chunk, h)
            raw = b"".join(pix[c][y].tobytes()
                           for y in range(y0, y1) for c in channels)
            packed = _pack(raw)
            chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    table_at = len(header) + 8 * n_chunks
    offsets = []
    pos = table_at
    for ch in chunks:
        offsets.append(pos)
        pos += len(ch)
    blob = (header + b"".join(struct.pack("<Q", o) for o in offsets)
            + b"".join(chunks))
    if path_or_none:
        with open(path_or_none, "wb") as f:
            f.write(blob)
    return blob
