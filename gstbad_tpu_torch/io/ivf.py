"""IVF container framing (gst/ivfparse/gstivfparse.c) — byte-domain.

32-byte file header (gstivfparse.c:29-40): "DKIF", version u16, header
size u16, fourcc u32, width u16, height u16, framerate num/den u32,
frame count u32, reserved u32.  12-byte frame headers: size u32 +
pts u64 (gstivfparse.c:42-45).  All little-endian.  Fourcc -> media type
per fourcc_to_media_type (gstivfparse.c:197-213).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

MEDIA_TYPES = {b"VP80": "video/x-vp8", b"VP90": "video/x-vp9",
               b"AV01": "video/x-av1"}

_FILE_HDR = struct.Struct("<4sHH4sHHIIII")
_FRAME_HDR = struct.Struct("<IQ")


@dataclasses.dataclass
class IvfHeader:
    fourcc: bytes
    width: int
    height: int
    fps_n: int
    fps_d: int
    frame_count: int

    @property
    def media_type(self) -> Optional[str]:
        return MEDIA_TYPES.get(bytes(self.fourcc))


class IvfParse:
    """Incremental parser: push bytes, pull (pts, payload) frames."""

    def __init__(self):
        self._buf = bytearray()
        self.header: Optional[IvfHeader] = None

    def push(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf += data
        out = []
        if self.header is None:
            if len(self._buf) < _FILE_HDR.size:
                return out
            (magic, _ver, hdr_size, fourcc, w, h, fps_n, fps_d,
             count, _res) = _FILE_HDR.unpack_from(self._buf)
            if magic != b"DKIF":
                raise ValueError("ivfparse: bad magic "
                                 f"{magic!r} (want DKIF)")
            self.header = IvfHeader(fourcc, w, h, fps_n, fps_d, count)
            del self._buf[: max(hdr_size, _FILE_HDR.size)]
        while len(self._buf) >= _FRAME_HDR.size:
            size, pts = _FRAME_HDR.unpack_from(self._buf)
            if len(self._buf) < _FRAME_HDR.size + size:
                break
            out.append((pts, bytes(self._buf[_FRAME_HDR.size:
                                             _FRAME_HDR.size + size])))
            del self._buf[: _FRAME_HDR.size + size]
        return out


def write_ivf(path, fourcc: bytes, width: int, height: int,
              fps_n: int, fps_d: int, frames) -> None:
    """frames: iterable of (pts, payload) — the mux direction for tests."""
    frames = list(frames)
    with open(path, "wb") as f:
        f.write(_FILE_HDR.pack(b"DKIF", 0, 32, fourcc, width, height,
                               fps_n, fps_d, len(frames), 0))
        for pts, payload in frames:
            f.write(_FRAME_HDR.pack(len(payload), pts))
            f.write(payload)
