"""AIFF / AIFF-C container io (gst/aiff/aiffparse.c, aiffmux.c).

Byte-domain reader/writer for the FORM/AIFF chunk format: COMM (channels,
frame count, depth, IEEE-80 extended-float rate, AIFC compression
fourcc), SSND (offset/blockSize + PCM).  Quirks kept from the reference:
chunk tags compare as little-endian u32 of the ascii (aiffparse.c:788),
chunk payloads pad to even sizes (aiffparse.c:806), width rounds the
depth up to bytes (aiffparse.c:723), the IEEE-80 reader's HUGE_VAL
handling for e == 32767 (aiffparse.c:671-696), and the 'trivial' AIFC
compressions only (NONE big endian, sowt little, FL32/fl32/fl64 float —
aiffparse.c:730-755).  The writer is the aiffmux layout: 54-byte header,
COMM of size 18, SSND offset/blockSize 0 (aiffmux.c:236-249).

Sample arrays are [frames, channels] numpy in native byte order; S24
widens to int32 (sign-extended), S8 stays int8 — the element layer maps
these onto the framework's native AudioFormat set.
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np

from gstbad_tpu_torch.core.spec import MediaSpec


def read_ieee80(buf: bytes) -> float:
    """gst_aiff_parse_read_IEEE80 (aiffparse.c:671-696), exact port."""
    s = buf[0] & 0x80
    e = ((buf[0] & 0x7F) << 8) | (buf[1] & 0xFF)
    if e == 32767:
        if buf[2] & 0x80:
            return math.inf          # "Really NaN" per the reference
        return -math.inf if s else math.inf
    f = float((buf[2] & 0x7F) if e == 0 else (buf[2] | 0x80))
    f = f * (1 << 8) + buf[3]
    f = f * (1 << 8) + buf[4]
    f = f * (1 << 8) + buf[5]
    f = math.ldexp(f, 32)
    f += ((buf[6] & 0xFF) << 24) | ((buf[7] & 0xFF) << 16) \
        | ((buf[8] & 0xFF) << 8) | (buf[9] & 0xFF)
    v = math.ldexp(f, e - 16446)
    return -v if s else v


def write_ieee80(rate: float) -> bytes:
    """gst_aiff_mux_write_ext (aiffmux.c:165-207, the FFmpeg
    av_dbl2ext port): double -> 10-byte extended float."""
    d = rate
    out_e = 0
    m = abs(d)
    if m >= 1e-300:                      # av_dbl2ext's zero test
        f, e = math.frexp(m)
        mant = int(f * (1 << 64))
        if mant >= (1 << 64):            # frexp gives [0.5, 1): mant < 2^64
            mant >>= 1
            e += 1
        out_e = e + 16382
        mantissa = mant
    else:
        mantissa = 0
    if d < 0:
        out_e |= 0x8000
    return struct.pack(">HQ", out_e, mantissa)


_FOURCC_NONE = struct.unpack("<I", b"NONE")[0]
_FOURCC_SOWT = struct.unpack("<I", b"sowt")[0]
_FOURCC_FL32 = struct.unpack("<I", b"FL32")[0]
_FOURCC_fl32 = struct.unpack("<I", b"fl32")[0]
_FOURCC_fl64 = struct.unpack("<I", b"fl64")[0]


def read_aiff(path_or_bytes) -> Tuple[MediaSpec, np.ndarray]:
    """Parse an AIFF/AIFC file -> (audio MediaSpec, samples
    [frames, channels])."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if len(data) < 12 or data[:4] != b"FORM":
        raise ValueError("aiff: no FORM header")
    form_type = data[8:12]
    if form_type == b"AIFF":
        is_aifc = False
    elif form_type == b"AIFC":
        is_aifc = True
    else:
        raise ValueError(f"aiff: not an AIFF form: {form_type!r}")

    channels = total_frames = depth = rate = None
    width = 16
    floating = False
    endian = ">"
    ssnd = None
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4:pos + 8])
        payload = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)       # chunks pad to even
        if tag == b"COMM":
            need = 22 if is_aifc else 18
            if len(payload) < need:
                raise ValueError("aiff: COMM chunk too short")
            channels, total_frames, depth = struct.unpack(
                ">HIH", payload[:8])
            width = (depth + 7) & ~7       # GST_ROUND_UP_8
            rate = int(read_ieee80(payload[8:18]))
            if is_aifc:
                (fourcc,) = struct.unpack("<I", payload[18:22])
                if fourcc == _FOURCC_NONE:
                    endian = ">"
                elif fourcc == _FOURCC_SOWT:
                    endian = "<"
                elif fourcc in (_FOURCC_FL32, _FOURCC_fl32):
                    floating = True
                    width = depth = 32
                elif fourcc == _FOURCC_fl64:
                    floating = True
                    width = depth = 64
                else:
                    raise ValueError(
                        f"aiff: unsupported AIFC compression "
                        f"{payload[18:22]!r}")
        elif tag == b"SSND":
            if len(payload) < 8:
                raise ValueError("aiff: SSND chunk too short")
            offset, _blocksize = struct.unpack(">II", payload[:8])
            ssnd = payload[8 + offset:]
    if channels is None:
        raise ValueError("aiff: no COMM chunk")
    if ssnd is None:
        raise ValueError("aiff: no SSND chunk")

    if floating:
        dt = np.dtype(f"{endian}f{width // 8}")
        arr = np.frombuffer(ssnd, dt)
    elif width == 24:
        raw = np.frombuffer(ssnd[:len(ssnd) // 3 * 3], np.uint8
                            ).reshape(-1, 3)
        if endian == ">":
            v = ((raw[:, 0].astype(np.int32) << 16)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | raw[:, 2].astype(np.int32))
        else:
            v = ((raw[:, 2].astype(np.int32) << 16)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | raw[:, 0].astype(np.int32))
        arr = (v << 8) >> 8                # sign-extend 24 -> 32
    elif width == 8:
        arr = np.frombuffer(ssnd, np.int8)
    else:
        arr = np.frombuffer(ssnd, np.dtype(f"{endian}i{width // 8}"))
    n = arr.shape[0] // channels
    samples = (arr[:n * channels].reshape(n, channels)
               .astype(arr.dtype.newbyteorder("=")))
    fmt = {("i", 16): "S16", ("i", 32): "S32", ("i", 8): "S8",
           ("f", 32): "F32", ("f", 64): "F64"}[
        ("f" if floating else "i", 32 if width == 24 else width)]
    spec = MediaSpec(kind="audio", format=fmt, rate=rate or 44100,
                     channels=channels)
    return spec, samples


def write_aiff(path, spec: MediaSpec, samples: np.ndarray) -> None:
    """aiffmux layout (aiffmux.c:213-249): FORM/AIFF + COMM(18) +
    SSND(offset=0, blockSize=0) with big-endian PCM.  F32/F64 write the
    AIFC fl32/fl64 form (COMM of 24 with the compression fourcc)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    floating = samples.dtype.kind == "f"
    width = samples.dtype.itemsize * 8
    body = samples.astype(samples.dtype.newbyteorder(">")).tobytes()
    if floating:
        comp = b"fl32\x00" if width == 32 else b"fl64\x00"
        comm = (struct.pack(">HIH", channels, frames, width)
                + write_ieee80(spec.rate) + comp[:4] + b"\x00\x00")
        # (AIFC compression name pstring: empty)
        form_type = b"AIFC"
        fver = b"FVER" + struct.pack(">I", 4) + struct.pack(">I", 0xA2805140)
    else:
        comm = (struct.pack(">HIH", channels, frames, width)
                + write_ieee80(spec.rate))
        form_type = b"AIFF"
        fver = b""
    ssnd_hdr = struct.pack(">II", 0, 0)
    chunks = (fver
              + b"COMM" + struct.pack(">I", len(comm)) + comm
              + (b"\x00" if len(comm) & 1 else b"")
              + b"SSND" + struct.pack(">I", len(ssnd_hdr) + len(body))
              + ssnd_hdr + body)
    form = b"FORM" + struct.pack(">I", 4 + len(chunks)) + form_type + chunks
    with open(path, "wb") as f:
        f.write(form)
