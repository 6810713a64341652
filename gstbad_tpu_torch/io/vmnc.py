"""VMnc (VMware capture / RFB FramebufferUpdate) decoder — the
byte-level spec for the vmncdec element (gst/vmnc/vmncdec.c).

Transcribed from vmncdec.c:
- the packet walk: type-0 FramebufferUpdate, u16 rectangle count, 12-byte
  rectangle headers (x, y, w, h u16 BE + u32 BE type)
  (vmnc_handle_packet, vmncdec.c:742-852);
- WMVi format descriptor (bpp/depth/endian/truecolour + RGB max/shift),
  including the 13-byte no-change comparison and the rejection of
  paletted streams (vmncdec.c:158-273);
- RAW, COPY (forward/backward memmove order by source/dest overlap
  direction) and HEXTILE (16x16 tiles: raw flag, bg/fg carry ACROSS
  tiles, subrect nibble geometry, per-subrect bounds check) rectangle
  renderers (vmncdec.c:511-739);
- the VMware pseudo-rectangles: WMVd cursor define (colour cursors as
  (dst & src) ^ mask AND/XOR planes; alpha cursors parsed but not
  rendered — the reference's own TODO at vmncdec.c:363-366), WMVe
  cursor state (visible flag), WMVf cursor position (hotspot applied
  at render), WMVg/WMVh keyboard and WMVj VM-state skips;
- cursor compositing onto the output copy only (the stored framebuffer
  stays clean, vmnc_fill_buffer, vmncdec.c:369-390).

Pixels are kept as raw little/host-endian framebuffer bytes exactly as
the C memcpy does ("this is wrong-endian currently" included); the
element maps 32-bit streams onto the framework's packed-RGB formats
and 8-bit onto GRAY8 (16-bit RGB15/565 streams decode here but have no
VideoFormat in this build — documented).

A copy of the JAX package's io/vmnc.py: only its imports differ.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

TYPE_RAW = 0
TYPE_COPY = 1
TYPE_HEXTILE = 5


def _mk(tag: str) -> int:
    a, b, c, d = (ord(ch) for ch in tag)
    return (a << 24) | (b << 16) | (c << 8) | d


TYPE_WMVd = _mk("WMVd")
TYPE_WMVe = _mk("WMVe")
TYPE_WMVf = _mk("WMVf")
TYPE_WMVg = _mk("WMVg")
TYPE_WMVh = _mk("WMVh")
TYPE_WMVi = _mk("WMVi")
TYPE_WMVj = _mk("WMVj")

CURSOR_COLOUR = 0
CURSOR_ALPHA = 1

ERROR_INVALID = -1
ERROR_INSUFFICIENT_DATA = -2


class VMncDecoder:
    """One stream's decoder state (GstVMncDec analog)."""

    def __init__(self):
        self.have_format = False
        self.descriptor = b""
        self.width = 0
        self.height = 0
        self.bytes_per_pixel = 0
        self.depth = 0
        self.big_endian = 0
        self.red_mask = self.green_mask = self.blue_mask = 0
        self.red_shift = self.green_shift = self.blue_shift = 0
        self.imagedata: Optional[np.ndarray] = None   # flat u8
        self.cursor = {"visible": False, "type": 0, "x": 0, "y": 0,
                       "hot_x": 0, "hot_y": 0, "width": 0, "height": 0,
                       "data": None, "mask": None}

    # -- rectangle handlers ------------------------------------------------

    def _wmvi(self, r, data: bytes) -> int:
        if len(data) < 16:
            return ERROR_INSUFFICIENT_DATA
        if self.have_format and data[:13] == self.descriptor[:13]:
            return 16
        self.descriptor = bytes(data[:16])
        if r[0] != 0 or r[1] != 0:
            return ERROR_INVALID
        bpp = data[0]
        if bpp not in (8, 16, 32):
            return ERROR_INVALID
        if not data[3]:
            return ERROR_INVALID                # paletted unsupported
        self.depth = data[1]
        self.big_endian = data[2]
        self.bytes_per_pixel = bpp // 8
        self.width, self.height = r[2], r[3]
        self.red_mask = struct.unpack(">H", data[4:6])[0]
        self.green_mask = struct.unpack(">H", data[6:8])[0]
        self.blue_mask = struct.unpack(">H", data[8:10])[0]
        self.red_shift = data[10]
        self.green_shift = data[11]
        self.blue_shift = data[12]
        self.have_format = True
        self.imagedata = np.zeros(
            self.width * self.height * self.bytes_per_pixel, np.uint8)
        return 16

    def _stride(self) -> int:
        return self.width * self.bytes_per_pixel

    def _render_raw(self, data: bytes, x, y, w, h) -> None:
        bpp = self.bytes_per_pixel
        line = w * bpp
        img = self.imagedata
        for i in range(h):
            dst = self._stride() * (y + i) + bpp * x
            img[dst:dst + line] = np.frombuffer(
                data[i * line:(i + 1) * line], np.uint8)

    def _render_subrect(self, x, y, w, h, colour: bytes) -> None:
        bpp = self.bytes_per_pixel
        row = np.frombuffer(colour * w, np.uint8)
        img = self.imagedata
        for i in range(h):
            dst = self._stride() * (y + i) + bpp * x
            img[dst:dst + w * bpp] = row

    def _raw(self, r, data: bytes) -> int:
        x, y, w, h = r[:4]
        n = w * h * self.bytes_per_pixel
        if len(data) < n:
            return ERROR_INSUFFICIENT_DATA
        self._render_raw(data, x, y, w, h)
        return n

    def _copy(self, r, data: bytes) -> int:
        if len(data) < 4:
            return ERROR_INSUFFICIENT_DATA
        x, y, w, h = r[:4]
        src_x, src_y = struct.unpack(">HH", data[:4])
        if src_x + w > self.width or src_y + h > self.height:
            return ERROR_INVALID
        bpp = self.bytes_per_pixel
        img = self.imagedata
        line = w * bpp
        rows = range(h) if (src_y > y or src_x > x) else \
            range(h - 1, -1, -1)
        for i in rows:
            s = self._stride() * (src_y + i) + bpp * src_x
            d = self._stride() * (y + i) + bpp * x
            img[d:d + line] = img[s:s + line].copy()
        return 4

    def _read_pixel(self, data: bytes, off: int):
        bpp = self.bytes_per_pixel
        if off + bpp > len(data):
            return None, off
        return bytes(data[off:off + bpp]), off + bpp

    def _hextile(self, r, data: bytes) -> int:
        x0, y0, w0, h0 = r[:4]
        tilesx = (w0 + 15) // 16
        tilesy = (h0 + 15) // 16
        off = 0
        bpp = self.bytes_per_pixel
        fg = bg = b"\x00" * bpp
        for ty in range(tilesy):
            h = h0 - (tilesy - 1) * 16 if ty == tilesy - 1 else 16
            for tx in range(tilesx):
                w = w0 - (tilesx - 1) * 16 if tx == tilesx - 1 else 16
                if off >= len(data):
                    return ERROR_INSUFFICIENT_DATA
                flags = data[off]
                off += 1
                if flags & 0x1:
                    n = w * h * bpp
                    if off + n > len(data):
                        return ERROR_INSUFFICIENT_DATA
                    self._render_raw(data[off:off + n],
                                     x0 + tx * 16, y0 + ty * 16, w, h)
                    off += n
                    continue
                if flags & 0x2:
                    bg, off = self._read_pixel(data, off)
                    if bg is None:
                        return ERROR_INSUFFICIENT_DATA
                if flags & 0x4:
                    fg, off = self._read_pixel(data, off)
                    if fg is None:
                        return ERROR_INSUFFICIENT_DATA
                subrects = 0
                if flags & 0x8:
                    if off >= len(data):
                        return ERROR_INSUFFICIENT_DATA
                    subrects = data[off]
                    off += 1
                self._render_subrect(x0 + tx * 16, y0 + ty * 16, w, h, bg)
                coloured = flags & 0x10
                for _ in range(subrects):
                    if coloured:
                        colour, off = self._read_pixel(data, off)
                        if colour is None:
                            return ERROR_INSUFFICIENT_DATA
                    else:
                        colour = fg
                    if off + 2 > len(data):
                        return ERROR_INSUFFICIENT_DATA
                    off_x = (data[off] & 0xF0) >> 4
                    off_y = data[off] & 0x0F
                    sw = ((data[off + 1] & 0xF0) >> 4) + 1
                    sh = (data[off + 1] & 0x0F) + 1
                    off += 2
                    if off_x + sw > w or off_y + sh > h:
                        return ERROR_INVALID
                    self._render_subrect(x0 + tx * 16 + off_x,
                                         y0 + ty * 16 + off_y,
                                         sw, sh, colour)
        return off

    def _wmvd(self, r, data: bytes) -> int:
        if len(data) < 2:
            return ERROR_INSUFFICIENT_DATA
        ctype = data[0]
        x, y, w, h = r[:4]
        if ctype == CURSOR_COLOUR:
            datalen = 2 + w * h * self.bytes_per_pixel * 2
        elif ctype == CURSOR_ALPHA:
            datalen = 2 + w * h * 4
        else:
            return ERROR_INVALID
        if len(data) < datalen:
            return ERROR_INSUFFICIENT_DATA
        c = self.cursor
        c["type"] = ctype
        c["width"], c["height"] = w, h
        c["hot_x"], c["hot_y"] = x, y
        if ctype == CURSOR_COLOUR:
            size = w * h * self.bytes_per_pixel
            c["data"] = np.frombuffer(data[2:2 + size], np.uint8).copy()
            c["mask"] = np.frombuffer(data[2 + size:2 + 2 * size],
                                      np.uint8).copy()
        else:
            c["data"] = np.frombuffer(data[2:2 + w * h * 4],
                                      np.uint8).copy()
            c["mask"] = None
        return datalen

    def _wmve(self, r, data: bytes) -> int:
        if len(data) < 2:
            return ERROR_INSUFFICIENT_DATA
        flags = struct.unpack(">H", data[:2])[0]
        self.cursor["visible"] = bool(flags & 0x01)
        return 2

    def _wmvf(self, r, data: bytes) -> int:
        self.cursor["x"], self.cursor["y"] = r[0], r[1]
        return 0

    # -- packet walk -------------------------------------------------------

    def feed_packet(self, data: bytes) -> int:
        """One buffer (vmnc_handle_packet, decode mode).  Returns bytes
        consumed or ERROR_*."""
        if len(data) < 4:
            return ERROR_INSUFFICIENT_DATA
        if data[0] != 0:
            return ERROR_INVALID
        numrect = struct.unpack(">H", data[2:4])[0]
        offset = 4
        for _ in range(numrect):
            if len(data) < offset + 12:
                return ERROR_INSUFFICIENT_DATA
            x, y, w, h = struct.unpack(">HHHH", data[offset:offset + 8])
            rtype = struct.unpack(">I", data[offset + 8:offset + 12])[0]
            r = (x, y, w, h)
            if rtype != TYPE_WMVi:
                if not self.have_format:
                    return ERROR_INVALID
                if x > self.width or y > self.height \
                        or x + w > self.width or y + h > self.height:
                    return ERROR_INVALID
            elif w > 16384 or h > 16384:
                return ERROR_INVALID
            body = data[offset + 12:]
            if rtype == TYPE_WMVd:
                read = self._wmvd(r, body)
            elif rtype == TYPE_WMVe:
                read = self._wmve(r, body)
            elif rtype == TYPE_WMVf:
                read = self._wmvf(r, body)
            elif rtype == TYPE_WMVg:
                read = 10 if len(body) >= 10 else ERROR_INSUFFICIENT_DATA
            elif rtype == TYPE_WMVh:
                read = 4 if len(body) >= 4 else ERROR_INSUFFICIENT_DATA
            elif rtype == TYPE_WMVi:
                read = self._wmvi(r, body)
            elif rtype == TYPE_WMVj:
                read = 2 if len(body) >= 2 else ERROR_INSUFFICIENT_DATA
            elif rtype == TYPE_RAW:
                read = self._raw(r, body)
            elif rtype == TYPE_COPY:
                read = self._copy(r, body)
            elif rtype == TYPE_HEXTILE:
                read = self._hextile(r, body)
            else:
                return ERROR_INVALID
            if read < 0:
                return read
            offset += 12 + read
        return offset

    # -- output ------------------------------------------------------------

    def output_frame(self) -> np.ndarray:
        """Framebuffer copy with the cursor composited
        (vmnc_fill_buffer): [H, W, bpp] u8 raw bytes."""
        out = self.imagedata.copy()
        c = self.cursor
        if c["visible"] and c["data"] is not None \
                and c["type"] == CURSOR_COLOUR:
            bpp = self.bytes_per_pixel
            x = c["x"] - c["hot_x"]
            y = c["y"] - c["hot_y"]
            w, h = c["width"], c["height"]
            off_x = off_y = 0
            if x < 0:
                off_x, w, x = -x, w + x, 0
            if x + w > self.width:
                w = self.width - x
            if y < 0:
                off_y, h, y = -y, h + y, 0
            if y + h > self.height:
                h = self.height - y
            if w > 0 and h > 0:
                src = c["data"].reshape(c["height"], c["width"] * bpp)
                msk = c["mask"].reshape(c["height"], c["width"] * bpp)
                img = out.reshape(self.height, self.width * bpp)
                sx = off_x * bpp
                region = img[y:y + h, x * bpp:(x + w) * bpp]
                s = src[off_y:off_y + h, sx:sx + w * bpp]
                m = msk[off_y:off_y + h, sx:sx + w * bpp]
                img[y:y + h, x * bpp:(x + w) * bpp] = (region & s) ^ m
        return out.reshape(self.height, self.width, self.bytes_per_pixel)
