"""jpegparse analog (gst/jpegformat/gstjpegparse.c) — JPEG stream framing.

The reference element splices a byte stream into single complete JPEG
images and caps them with width/height/format parsed from the headers
(it does NOT decode).  Decoding is codec territory (out of scope); this
module is the byte-domain parser feeding the host I/O layer, like
io/chop.py.

Framing rules transcribed from the reference:
- resync to SOI: scan for ff d8 ff (gst_jpeg_parse_skip_to_jpeg_header,
  gstjpegparse.c:158-176);
- segments are marker (ff xx) + 16-bit big-endian length; fill 0xff
  bytes before a marker are skipped (gstjpegparse.c:238-243);
- entropy-coded data after SOS runs until the next marker whose second
  byte is neither 0x00 (byte stuffing) nor RST0-7
  (gstjpegparse.c:296-312);
- SOF: precision, height, width, component count, per-component
  subsampling mapped to I420/Y41B/UYVY/YV12 exactly as
  gst_jpeg_parse_sof (gstjpegparse.c:340-416).

A copy of the JAX package's io/jpeg.py: only its imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# JPEG marker bytes (gstjpegformat.h:34-82)
SOF_MARKERS = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}  # SOFn
SOI, EOI, SOS = 0xD8, 0xD9, 0xDA
RST_RANGE = range(0xD0, 0xD8)
STANDALONE = set(RST_RANGE) | {SOI, EOI, 0x01}  # TEM + RST have no length


@dataclasses.dataclass
class JpegImage:
    data: bytes
    width: int = 0
    height: int = 0
    precision: int = 0
    n_components: int = 0
    format: str = ""  # subsampling name per the reference mapping


def _parse_sof(seg: bytes) -> Tuple[int, int, int, int, str]:
    """seg: segment payload after the length field."""
    precision = seg[0]
    height = (seg[1] << 8) | seg[2]
    width = (seg[3] << 8) | seg[4]
    numcomps = seg[5]
    fmt = ""
    if numcomps == 3:
        bw, bh = [], []
        for i in range(3):
            v = seg[6 + 3 * i + 1]
            bw.append((v & 0xF0) >> 4)
            bh.append(v & 0x0F)
        temp = (bw[0] * bh[0]) // max(bw[1] * bh[1], 1)
        if temp == 4 and bh[0] == 2:
            fmt = "I420"
        elif temp == 4 and bh[0] == 4:
            fmt = "Y41B"
        elif temp == 2:
            fmt = "UYVY"
        elif temp == 1:
            fmt = "YV12"
    return width, height, precision, numcomps, fmt


class JpegParse:
    """Incremental parser: push bytes, pull complete images."""

    def __init__(self):
        self._buf = bytearray()

    def push(self, data: bytes) -> List[JpegImage]:
        self._buf += data
        out = []
        while True:
            img = self._try_parse_one()
            if img is None:
                return out
            out.append(img)

    def _try_parse_one(self) -> Optional[JpegImage]:
        buf = self._buf
        # resync to SOI followed by another marker (ff d8 ff)
        start = -1
        for i in range(len(buf) - 2):
            if buf[i] == 0xFF and buf[i + 1] == SOI and buf[i + 2] == 0xFF:
                start = i
                break
        if start < 0:
            # keep at most 2 trailing bytes for a split SOI
            del self._buf[: max(0, len(buf) - 2)]
            return None
        info = JpegImage(b"")
        pos = start + 2
        while True:
            # skip fill bytes, find the marker byte
            while pos < len(buf) and buf[pos] == 0xFF:
                pos += 1
            if pos >= len(buf):
                del self._buf[:start]
                return None  # need more data
            if buf[pos - 1] != 0xFF:
                # lost sync: drop through this SOI and retry
                del self._buf[: start + 2]
                return self._try_parse_one()
            marker = buf[pos]
            pos += 1
            if marker == EOI:
                info.data = bytes(buf[start:pos])
                del self._buf[:pos]
                return info
            if marker in STANDALONE:
                continue
            if pos + 2 > len(buf):
                del self._buf[:start]
                return None
            seglen = (buf[pos] << 8) | buf[pos + 1]
            if pos + seglen > len(buf):
                del self._buf[:start]
                return None
            seg = bytes(buf[pos + 2: pos + seglen])
            if marker in SOF_MARKERS and len(seg) >= 6:
                (info.width, info.height, info.precision,
                 info.n_components, info.format) = _parse_sof(seg)
            pos += seglen
            if marker == SOS:
                # entropy-coded data: run to the next real marker
                while True:
                    nxt = buf.find(b"\xff", pos)
                    if nxt < 0 or nxt + 1 >= len(buf):
                        del self._buf[:start]
                        return None
                    m2 = buf[nxt + 1]
                    if m2 == 0xFF:
                        # fill byte: the second ff may start the marker
                        pos = nxt + 1
                        continue
                    if m2 == 0x00 or m2 in RST_RANGE:
                        pos = nxt + 2
                        continue
                    pos = nxt  # points at ff of the next marker
                    break


def jif_mux(jpeg: bytes, comment: Optional[str] = None,
            exif: Optional[bytes] = None,
            xmp: Optional[bytes] = None) -> bytes:
    """jifmux analog (gst/jpegformat/gstjifmux.c): rewrite the JPEG header
    markers — JFIF APP0 first, then Exif APP1, XMP APP1, then COM, then
    the rest (gstjifmux.c:372-460 marker ordering).  Tag payloads come in
    directly instead of through GstTagList/taginject."""
    if jpeg[:2] != b"\xff" + bytes([SOI]):
        raise ValueError("jif_mux: not a JPEG (no SOI)")
    import struct as _struct

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + _struct.pack(
            ">H", len(payload) + 2) + payload

    # split the existing stream into (marker, raw segment) units
    pos = 2
    units = []
    while pos + 1 < len(jpeg):
        if jpeg[pos] != 0xFF:
            break
        marker = jpeg[pos + 1]
        if marker == SOS:
            units.append((marker, jpeg[pos:]))  # SOS + entropy + EOI
            break
        if marker in STANDALONE:
            units.append((marker, jpeg[pos:pos + 2]))
            pos += 2
            continue
        seglen = (jpeg[pos + 2] << 8) | jpeg[pos + 3]
        units.append((marker, jpeg[pos:pos + 2 + seglen]))
        pos += 2 + seglen

    app0 = [u for u in units if u[0] == 0xE0]
    keep = [u for u in units
            if u[0] not in (0xE0, 0xE1, 0xFE)]  # strip APP0/APP1/COM
    # no APP14 Adobe RGB marker -> YUV/grayscale; synthesize the JFIF
    # APP0 when the image has none (gstjifmux.c:476-500 jfif_data:
    # version 1.2, density unit 0, 0/1 aspect, no thumbnail)
    rgb = any(m == 0xEE and raw[4:10] == b"Adobe\x00" and
              len(raw) >= 16 and raw[15] == 0 for m, raw in units)
    if not app0 and not rgb:
        app0 = [(0xE0, seg(0xE0, b"JFIF\x00\x01\x02\x00"
                           b"\x00\x01\x00\x01\x00\x00"))]
    out = [jpeg[:2]]
    out += [raw for _, raw in app0]             # JFIF APP0 first
    if exif is not None:
        out.append(seg(0xE1, b"Exif\x00\x00" + exif))
    if xmp is not None:
        out.append(seg(0xE1, b"http://ns.adobe.com/xap/1.0/\x00" + xmp))
    if comment is not None:
        out.append(seg(0xFE, comment.encode() + b"\x00"))
    out += [raw for _, raw in keep]
    return b"".join(out)
