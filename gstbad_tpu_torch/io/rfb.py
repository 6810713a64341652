"""RFB (VNC) client — the gst/librfb rfbdecoder.c + gstrfbsrc.c rebuild.

The reference's librfb is a blocking state machine over a GIO socket:
protocol-version negotiation (3.3/3.7/3.8, rfbdecoder.c:343-386),
security negotiation (none / VNC DES auth, :416-545), security result
(:549-571), client/server initialisation (:643-743), SetEncodings
(:583-641), then framebuffer-update requests (:278-302) answered by
update rectangles in raw / copyrect / RRE / CoRRE / hextile encodings
(:858-1100).  This client runs the same states over an INJECTED
transport (any object with read(n)/write(bytes)) so tests drive it from
a scripted mock server (the io/festival.py pattern) — a real TCP socket
wraps trivially.

The framebuffer is a numpy u8 [rect_h, rect_w * bytespp] matching the
reference's malloc'd frame; rectangle math (offset-x/y cropping, the
line_size walks) is transcribed 1:1.

Divergence (documented): rfb_decoder_fill_rectangle (:919-936) stores a
full guint32 per pixel while stepping geometry by bytespp — corrupting
16/24-bpp frames; this fill writes exactly bytespp bytes per pixel.
32-bpp sessions (every mainstream server default) are byte-identical.

VNC authentication uses the d3des variant of DES: the key schedule
consumes each password byte most-significant-bit-ignored, i.e. standard
DES over bit-reversed key bytes (d3des.c header comment).

A copy of the JAX package's io/rfb.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

SECURITY_FAIL = 0
SECURITY_NONE = 1
SECURITY_VNC = 2

ENCODING_RAW = 0
ENCODING_COPYRECT = 1
ENCODING_RRE = 2
ENCODING_CORRE = 4
ENCODING_HEXTILE = 5

MESSAGE_FRAMEBUFFER_UPDATE = 0

# hextile subencoding bits (rfbdecoder.c SUBENCODING_*)
SUB_RAW = 0x01
SUB_BACKGROUND = 0x02
SUB_FOREGROUND = 0x04
SUB_ANYSUBRECTS = 0x08
SUB_SUBRECTSCOLORED = 0x10


class RfbError(RuntimeError):
    pass


# ---------------------------------------------------------------- DES
# Standard single-DES encryption (FIPS 46-3 tables), used for the VNC
# challenge with each key byte's bits reversed (the d3des key-schedule
# order).  Encrypt-only — that is all the protocol needs on both sides.

_IP = [58, 50, 42, 34, 26, 18, 10, 2, 60, 52, 44, 36, 28, 20, 12, 4,
       62, 54, 46, 38, 30, 22, 14, 6, 64, 56, 48, 40, 32, 24, 16, 8,
       57, 49, 41, 33, 25, 17, 9, 1, 59, 51, 43, 35, 27, 19, 11, 3,
       61, 53, 45, 37, 29, 21, 13, 5, 63, 55, 47, 39, 31, 23, 15, 7]
_FP = [40, 8, 48, 16, 56, 24, 64, 32, 39, 7, 47, 15, 55, 23, 63, 31,
       38, 6, 46, 14, 54, 22, 62, 30, 37, 5, 45, 13, 53, 21, 61, 29,
       36, 4, 44, 12, 52, 20, 60, 28, 35, 3, 43, 11, 51, 19, 59, 27,
       34, 2, 42, 10, 50, 18, 58, 26, 33, 1, 41, 9, 49, 17, 57, 25]
_E = [32, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 8, 9, 10, 11, 12, 13,
      12, 13, 14, 15, 16, 17, 16, 17, 18, 19, 20, 21, 20, 21, 22, 23,
      24, 25, 24, 25, 26, 27, 28, 29, 28, 29, 30, 31, 32, 1]
_P = [16, 7, 20, 21, 29, 12, 28, 17, 1, 15, 23, 26, 5, 18, 31, 10,
      2, 8, 24, 14, 32, 27, 3, 9, 19, 13, 30, 6, 22, 11, 4, 25]
_PC1 = [57, 49, 41, 33, 25, 17, 9, 1, 58, 50, 42, 34, 26, 18,
        10, 2, 59, 51, 43, 35, 27, 19, 11, 3, 60, 52, 44, 36,
        63, 55, 47, 39, 31, 23, 15, 7, 62, 54, 46, 38, 30, 22,
        14, 6, 61, 53, 45, 37, 29, 21, 13, 5, 28, 20, 12, 4]
_PC2 = [14, 17, 11, 24, 1, 5, 3, 28, 15, 6, 21, 10,
        23, 19, 12, 4, 26, 8, 16, 7, 27, 20, 13, 2,
        41, 52, 31, 37, 47, 55, 30, 40, 51, 45, 33, 48,
        44, 49, 39, 56, 34, 53, 46, 42, 50, 36, 29, 32]
_SHIFTS = [1, 1, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 1]
_SBOX = [
    [14, 4, 13, 1, 2, 15, 11, 8, 3, 10, 6, 12, 5, 9, 0, 7,
     0, 15, 7, 4, 14, 2, 13, 1, 10, 6, 12, 11, 9, 5, 3, 8,
     4, 1, 14, 8, 13, 6, 2, 11, 15, 12, 9, 7, 3, 10, 5, 0,
     15, 12, 8, 2, 4, 9, 1, 7, 5, 11, 3, 14, 10, 0, 6, 13],
    [15, 1, 8, 14, 6, 11, 3, 4, 9, 7, 2, 13, 12, 0, 5, 10,
     3, 13, 4, 7, 15, 2, 8, 14, 12, 0, 1, 10, 6, 9, 11, 5,
     0, 14, 7, 11, 10, 4, 13, 1, 5, 8, 12, 6, 9, 3, 2, 15,
     13, 8, 10, 1, 3, 15, 4, 2, 11, 6, 7, 12, 0, 5, 14, 9],
    [10, 0, 9, 14, 6, 3, 15, 5, 1, 13, 12, 7, 11, 4, 2, 8,
     13, 7, 0, 9, 3, 4, 6, 10, 2, 8, 5, 14, 12, 11, 15, 1,
     13, 6, 4, 9, 8, 15, 3, 0, 11, 1, 2, 12, 5, 10, 14, 7,
     1, 10, 13, 0, 6, 9, 8, 7, 4, 15, 14, 3, 11, 5, 2, 12],
    [7, 13, 14, 3, 0, 6, 9, 10, 1, 2, 8, 5, 11, 12, 4, 15,
     13, 8, 11, 5, 6, 15, 0, 3, 4, 7, 2, 12, 1, 10, 14, 9,
     10, 6, 9, 0, 12, 11, 7, 13, 15, 1, 3, 14, 5, 2, 8, 4,
     3, 15, 0, 6, 10, 1, 13, 8, 9, 4, 5, 11, 12, 7, 2, 14],
    [2, 12, 4, 1, 7, 10, 11, 6, 8, 5, 3, 15, 13, 0, 14, 9,
     14, 11, 2, 12, 4, 7, 13, 1, 5, 0, 15, 10, 3, 9, 8, 6,
     4, 2, 1, 11, 10, 13, 7, 8, 15, 9, 12, 5, 6, 3, 0, 14,
     11, 8, 12, 7, 1, 14, 2, 13, 6, 15, 0, 9, 10, 4, 5, 3],
    [12, 1, 10, 15, 9, 2, 6, 8, 0, 13, 3, 4, 14, 7, 5, 11,
     10, 15, 4, 2, 7, 12, 9, 5, 6, 1, 13, 14, 0, 11, 3, 8,
     9, 14, 15, 5, 2, 8, 12, 3, 7, 0, 4, 10, 1, 13, 11, 6,
     4, 3, 2, 12, 9, 5, 15, 10, 11, 14, 1, 7, 6, 0, 8, 13],
    [4, 11, 2, 14, 15, 0, 8, 13, 3, 12, 9, 7, 5, 10, 6, 1,
     13, 0, 11, 7, 4, 9, 1, 10, 14, 3, 5, 12, 2, 15, 8, 6,
     1, 4, 11, 13, 12, 3, 7, 14, 10, 15, 6, 8, 0, 5, 9, 2,
     6, 11, 13, 8, 1, 4, 10, 7, 9, 5, 0, 15, 14, 2, 3, 12],
    [13, 2, 8, 4, 6, 15, 11, 1, 10, 9, 3, 14, 5, 0, 12, 7,
     1, 15, 13, 8, 10, 3, 7, 4, 12, 5, 6, 11, 0, 14, 9, 2,
     7, 11, 4, 1, 9, 12, 14, 2, 0, 6, 10, 13, 15, 3, 5, 8,
     2, 1, 14, 7, 4, 10, 8, 13, 15, 12, 9, 0, 3, 5, 6, 11]]


def _permute(value: int, width: int, table) -> int:
    out = 0
    for pos in table:
        out = (out << 1) | ((value >> (width - pos)) & 1)
    return out


def _des_subkeys(key: bytes):
    k = int.from_bytes(key, "big")
    cd = _permute(k, 64, _PC1)
    c, d = cd >> 28, cd & 0x0FFFFFFF
    keys = []
    for sh in _SHIFTS:
        c = ((c << sh) | (c >> (28 - sh))) & 0x0FFFFFFF
        d = ((d << sh) | (d >> (28 - sh))) & 0x0FFFFFFF
        keys.append(_permute((c << 28) | d, 56, _PC2))
    return keys


def _des_encrypt_block(block: bytes, subkeys) -> bytes:
    v = _permute(int.from_bytes(block, "big"), 64, _IP)
    left, right = v >> 32, v & 0xFFFFFFFF
    for sk in subkeys:
        e = _permute(right, 32, _E) ^ sk
        s = 0
        for i in range(8):
            chunk = (e >> (42 - 6 * i)) & 0x3F
            row = ((chunk & 0x20) >> 4) | (chunk & 1)
            col = (chunk >> 1) & 0xF
            s = (s << 4) | _SBOX[i][row * 16 + col]
        left, right = right, left ^ _permute(s, 32, _P)
    return _permute((right << 32) | left, 64, _FP).to_bytes(8, "big")


def vnc_auth_response(password: str, challenge: bytes) -> bytes:
    """DES-encrypt the 16-byte challenge with the password key, each
    key byte bit-reversed (rfbdecoder.c:494-527 + d3des.c)."""
    key = password.encode("latin-1")[:8].ljust(8, b"\x00")
    key = bytes(int(f"{b:08b}"[::-1], 2) for b in key)
    sub = _des_subkeys(key)
    return (_des_encrypt_block(challenge[:8], sub)
            + _des_encrypt_block(challenge[8:16], sub))


# ------------------------------------------------------------- formats

def format_from_masks(bpp: int, big_endian: bool, red_shift: int,
                      green_shift: int, blue_shift: int) -> str:
    """gst_video_format_from_masks for the template's six formats
    (gstrfbsrc.c:58-67,460-466): derive the memory byte order of
    R/G/B from the shifts + endianness."""
    bytespp = bpp // 8
    order = ["x"] * bytespp
    for ch, shift in (("R", red_shift), ("G", green_shift),
                      ("B", blue_shift)):
        byte = (bytespp - 1 - shift // 8) if big_endian else shift // 8
        if not 0 <= byte < bytespp:
            raise RfbError(f"shift {shift} outside {bpp}bpp pixel")
        order[byte] = ch
    name = "".join(order)
    table = {"BGRx": "BGRx", "RGBx": "RGBx", "xRGB": "xRGB",
             "xBGR": "xBGR", "RGB": "RGB", "BGR": "BGR"}
    if name not in table:
        raise RfbError(f"unsupported pixel layout {name!r}")
    return table[name]


# -------------------------------------------------------------- client

@dataclass
class ServerInit:
    width: int = 0
    height: int = 0
    bpp: int = 32
    depth: int = 24
    big_endian: bool = False
    true_colour: bool = True
    red_max: int = 255
    green_max: int = 255
    blue_max: int = 255
    red_shift: int = 16
    green_shift: int = 8
    blue_shift: int = 0
    name: str = ""


class RfbClient:
    """The rfbdecoder state machine over an injected transport
    (read(n) -> exactly-n bytes, write(bytes))."""

    def __init__(self, transport, version: str = "3.8",
                 password: Optional[str] = None, shared: bool = True,
                 offset_x: int = 0, offset_y: int = 0,
                 width: int = 0, height: int = 0,
                 use_copyrect: bool = False):
        self.t = transport
        major, minor = version.split(".")
        self.protocol_major = int(major)
        self.protocol_minor = int(minor)
        self.password = password
        self.shared = shared
        self.offset_x = offset_x
        self.offset_y = offset_y
        self.rect_width = width
        self.rect_height = height
        self.use_copyrect = use_copyrect
        self.inited = False
        self.security_type = SECURITY_FAIL
        self.info = ServerInit()
        self.frame: Optional[np.ndarray] = None
        self.prev_frame: Optional[np.ndarray] = None
        self.bytespp = 4
        self.format = "BGRx"

    # -- helpers ---------------------------------------------------

    def _read(self, n: int) -> bytes:
        data = self.t.read(n)
        if len(data) != n:
            raise RfbError(f"short read ({len(data)}/{n})")
        return data

    # -- handshake states (rfbdecoder.c:338-743) -------------------

    def handshake(self) -> None:
        self._state_protocol_version()
        self._state_security()
        self._state_client_init()
        self._state_server_init()
        self._state_set_encodings()
        self.inited = True

    def _state_protocol_version(self) -> None:
        data = self._read(12)
        if data[:8] != b"RFB 003." or data[11] != 0x0A:
            raise RfbError(f"bad protocol version {data!r}")
        server_minor = int(data[8:11])
        # client answers with min(requested, supported) like the
        # reference's fallback walk (rfbdecoder.c:361-380)
        minor = self.protocol_minor
        if server_minor < minor:
            minor = server_minor
        if minor not in (3, 7, 8):
            minor = 3
        self.protocol_minor = minor
        self.t.write(b"RFB 003.00%d\n" % minor)

    def _state_reason(self) -> None:
        (n,) = struct.unpack(">I", self._read(4))
        reason = self._read(n).decode("latin-1", "replace")
        raise RfbError(f"VNC server error: {reason}")

    def _state_security(self) -> None:
        if self.protocol_minor == 3:
            (sec,) = struct.unpack(">I", self._read(4))
            if sec == SECURITY_FAIL:
                self._state_reason()
            if sec >= 3:
                raise RfbError(f"security type {sec} out of range")
            self.security_type = sec
        else:
            num = self._read(1)[0]
            if num == 0:
                self._state_reason()
            types = self._read(num)
            self.security_type = SECURITY_FAIL
            for val in types:   # first supported wins (:457-470)
                if val in (SECURITY_NONE, SECURITY_VNC):
                    self.security_type = val
                    break
            if self.security_type == SECURITY_FAIL:
                raise RfbError("server requires unsupported security")
            self.t.write(bytes([self.security_type]))

        if self.security_type == SECURITY_NONE:
            if self.protocol_minor == 8:
                self._state_security_result()
        elif self.security_type == SECURITY_VNC:
            if not self.password:
                raise RfbError("server needs authentication, "
                               "but no password set")
            challenge = self._read(16)
            self.t.write(vnc_auth_response(self.password, challenge))
            self._state_security_result()
        else:
            raise RfbError("connection failed")

    def _state_security_result(self) -> None:
        (res,) = struct.unpack(">I", self._read(4))
        if res != 0:
            if self.protocol_minor == 8:
                self._state_reason()
            raise RfbError("authentication failed")

    def _state_client_init(self) -> None:
        self.t.write(bytes([1 if self.shared else 0]))

    def _state_server_init(self) -> None:
        data = self._read(24)
        i = self.info
        i.width, i.height = struct.unpack_from(">HH", data, 0)
        i.bpp, i.depth, be, tc = data[4:8]
        i.big_endian, i.true_colour = bool(be), bool(tc)
        i.red_max, i.green_max, i.blue_max = struct.unpack_from(
            ">HHH", data, 8)
        i.red_shift, i.green_shift, i.blue_shift = data[14:17]
        (name_len,) = struct.unpack_from(">I", data, 20)
        i.name = self._read(name_len).decode("latin-1", "replace")

        # offset/size cropping (gstrfbsrc negotiate + rfbdecoder
        # server-init tail, rfbdecoder.c:700-742)
        width, height = i.width, i.height
        if self.offset_x > 0:
            if self.offset_x > width:
                self.offset_x = 0
            else:
                width -= self.offset_x
        if self.offset_y > 0:
            if self.offset_y > height:
                self.offset_y = 0
            else:
                height -= self.offset_y
        if self.rect_width > 0:
            self.rect_width = min(self.rect_width, width)
        else:
            self.rect_width = width
        if self.rect_height > 0:
            self.rect_height = min(self.rect_height, height)
        else:
            self.rect_height = height

        self.bytespp = i.bpp // 8
        self.format = format_from_masks(
            i.bpp, i.big_endian, i.red_shift, i.green_shift,
            i.blue_shift)
        size = self.rect_height * self.rect_width * self.bytespp
        self.frame = np.zeros(size, np.uint8)
        if self.use_copyrect:
            self.prev_frame = np.zeros(size, np.uint8)

    def _state_set_encodings(self) -> None:
        # hextile, corre, rre, [copyrect], raw — the reference's
        # preference order (rfbdecoder.c:605-620)
        encs = [ENCODING_HEXTILE, ENCODING_CORRE, ENCODING_RRE]
        if self.use_copyrect:
            encs.append(ENCODING_COPYRECT)
        encs.append(ENCODING_RAW)
        msg = struct.pack(">BBH", 2, 0, len(encs))
        msg += b"".join(struct.pack(">i", e) for e in encs)
        self.t.write(msg)

    # -- steady state ----------------------------------------------

    def send_update_request(self, incremental: bool = True) -> None:
        """FramebufferUpdateRequest over the cropped rectangle
        (rfb_decoder_send_update_request, rfbdecoder.c:278-302)."""
        self.t.write(struct.pack(
            ">BBHHHH", 3, 1 if incremental else 0, self.offset_x,
            self.offset_y, self.rect_width, self.rect_height))
        if self.use_copyrect:
            self.prev_frame = self.frame.copy()

    def send_key_event(self, key: int, down: bool) -> None:
        self.t.write(struct.pack(">BBHI", 4, 1 if down else 0, 0, key))

    def send_pointer_event(self, button_mask: int, x: int,
                           y: int) -> None:
        self.t.write(struct.pack(">BBHH", 5, button_mask, x, y))

    def handle_message(self) -> bool:
        """One server message; True when it was a framebuffer update
        (rfb_decoder_state_normal, rfbdecoder.c:744-777)."""
        mtype = self._read(1)[0]
        if mtype == MESSAGE_FRAMEBUFFER_UPDATE:
            self._framebuffer_update()
            return True
        if mtype == 1:
            raise RfbError("SetColourMapEntries is not implemented "
                           "(matches the reference, "
                           "rfbdecoder.c:1103-1108)")
        if mtype == 2:
            return False    # bell, ignored
        if mtype == 3:
            pad_len = self._read(7)
            (n,) = struct.unpack_from(">I", pad_len, 3)
            self._read(n)   # server cut text: thrown away
            return False
        raise RfbError(f"unknown message type {mtype}")

    def pull_update(self) -> np.ndarray:
        """Block until one framebuffer update lands; returns the frame
        as [H, W, bytespp] (the gst_rfb_src_fill copy)."""
        while not self.handle_message():
            pass
        return self.frame.reshape(self.rect_height, self.rect_width,
                                  self.bytespp)

    # -- update rectangle decode (rfbdecoder.c:780-1100) ------------

    def _framebuffer_update(self) -> None:
        n_rects = struct.unpack(">xH", self._read(3))[0]
        for _ in range(n_rects):
            hdr = self._read(12)
            x = struct.unpack_from(">H", hdr, 0)[0] - self.offset_x
            y = struct.unpack_from(">H", hdr, 2)[0] - self.offset_y
            w, h = struct.unpack_from(">HH", hdr, 4)
            (encoding,) = struct.unpack_from(">i", hdr, 8)
            if (w * h) + (x * y) > self.rect_width * self.rect_height:
                raise RfbError("desktop resize is unsupported")
            if encoding == ENCODING_RAW:
                self._raw(x, y, w, h)
            elif encoding == ENCODING_COPYRECT:
                self._copyrect(x, y, w, h)
            elif encoding == ENCODING_RRE:
                self._rre(x, y, w, h)
            elif encoding == ENCODING_CORRE:
                self._corre(x, y, w, h)
            elif encoding == ENCODING_HEXTILE:
                self._hextile(x, y, w, h)
            else:
                raise RfbError(f"unimplemented encoding {encoding}")

    def _fill_rect(self, x: int, y: int, w: int, h: int,
                   color: bytes) -> None:
        px = np.frombuffer(color[:self.bytespp], np.uint8)
        fb = self.frame.reshape(self.rect_height,
                                self.rect_width, self.bytespp)
        fb[y:y + h, x:x + w] = px

    def _raw(self, x: int, y: int, w: int, h: int) -> None:
        data = np.frombuffer(self._read(h * w * self.bytespp),
                             np.uint8)
        fb = self.frame.reshape(self.rect_height,
                                self.rect_width, self.bytespp)
        fb[y:y + h, x:x + w] = data.reshape(h, w, self.bytespp)

    def _copyrect(self, x: int, y: int, w: int, h: int) -> None:
        sx, sy = struct.unpack(">HH", self._read(4))
        sx -= self.offset_x
        sy -= self.offset_y
        if self.prev_frame is None:
            raise RfbError("copyrect without use-copyrect")
        src = self.prev_frame.reshape(self.rect_height,
                                      self.rect_width, self.bytespp)
        fb = self.frame.reshape(self.rect_height,
                                self.rect_width, self.bytespp)
        fb[y:y + h, x:x + w] = src[sy:sy + h, sx:sx + w]

    def _rre(self, x: int, y: int, w: int, h: int) -> None:
        head = self._read(4 + self.bytespp)
        (n,) = struct.unpack_from(">I", head, 0)
        self._fill_rect(x, y, w, h, head[4:])
        for _ in range(n):
            sub = self._read(self.bytespp + 8)
            color = sub[:self.bytespp]
            rx, ry, rw, rh = struct.unpack_from(">HHHH", sub,
                                                self.bytespp)
            self._fill_rect(x + rx, y + ry, rw, rh, color)

    def _corre(self, x: int, y: int, w: int, h: int) -> None:
        head = self._read(4 + self.bytespp)
        (n,) = struct.unpack_from(">I", head, 0)
        self._fill_rect(x, y, w, h, head[4:])
        for _ in range(n):
            sub = self._read(self.bytespp + 4)
            color = sub[:self.bytespp]
            rx, ry, rw, rh = sub[self.bytespp:self.bytespp + 4]
            self._fill_rect(x + rx, y + ry, rw, rh, color)

    def _hextile(self, x: int, y: int, w: int, h: int) -> None:
        x_end, y_end = w % 16, h % 16
        x_max, y_max = x + w, y + h
        background = b"\x00" * 4
        foreground = b"\x00" * 4
        for ty in range(y, y_max, 16):
            th = 16 if ty <= y_max - 16 else y_end
            for tx in range(x, x_max, 16):
                tw = 16 if tx <= x_max - 16 else x_end
                sub = self._read(1)[0]
                if sub & SUB_RAW:
                    self._raw(tx, ty, tw, th)
                    continue
                if sub & SUB_BACKGROUND:
                    background = self._read(self.bytespp)
                self._fill_rect(tx, ty, tw, th, background)
                if sub & SUB_FOREGROUND:
                    foreground = self._read(self.bytespp)
                if not sub & SUB_ANYSUBRECTS:
                    continue
                n = self._read(1)[0]
                if sub & SUB_SUBRECTSCOLORED:
                    data = self._read(n * (2 + self.bytespp))
                    off = 0
                    for _ in range(n):
                        foreground = data[off:off + self.bytespp]
                        off += self.bytespp
                        xy, wh = data[off], data[off + 1]
                        off += 2
                        self._fill_rect(tx + (xy >> 4), ty + (xy & 0xF),
                                        1 + (wh >> 4), 1 + (wh & 0xF),
                                        foreground)
                else:
                    data = self._read(2 * n)
                    for i in range(n):
                        xy, wh = data[2 * i], data[2 * i + 1]
                        self._fill_rect(tx + (xy >> 4), ty + (xy & 0xF),
                                        1 + (wh >> 4), 1 + (wh & 0xF),
                                        foreground)
