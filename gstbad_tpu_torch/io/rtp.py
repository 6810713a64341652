"""Minimal RTP packet model (RFC 3550) — what gstrtpbuffer provides to
the gst/onvif elements: header parse/serialize and the one-header
extension (16-bit profile id + 16-bit word length + data).

A copy of the JAX package's io/rtp.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class RtpPacket:
    version: int = 2
    padding: bool = False
    marker: bool = False
    payload_type: int = 0
    seq: int = 0
    timestamp: int = 0
    ssrc: int = 0
    csrcs: List[int] = field(default_factory=list)
    extension: Optional[Tuple[int, bytes]] = None  # (id, data words)
    payload: bytes = b""

    def serialize(self) -> bytes:
        b0 = (self.version << 6) | (0x20 if self.padding else 0) \
            | (0x10 if self.extension is not None else 0) \
            | len(self.csrcs)
        b1 = (0x80 if self.marker else 0) | self.payload_type
        out = struct.pack(">BBHII", b0, b1, self.seq,
                          self.timestamp & 0xFFFFFFFF, self.ssrc)
        for c in self.csrcs:
            out += struct.pack(">I", c)
        if self.extension is not None:
            ext_id, data = self.extension
            if len(data) % 4:
                data = data + b"\x00" * (4 - len(data) % 4)
            out += struct.pack(">HH", ext_id, len(data) // 4) + data
        return out + self.payload

    @classmethod
    def parse(cls, data: bytes) -> "RtpPacket":
        b0, b1, seq, ts, ssrc = struct.unpack_from(">BBHII", data, 0)
        p = cls(version=b0 >> 6, padding=bool(b0 & 0x20),
                marker=bool(b1 & 0x80), payload_type=b1 & 0x7F,
                seq=seq, timestamp=ts, ssrc=ssrc)
        pos = 12
        for _ in range(b0 & 0x0F):
            p.csrcs.append(struct.unpack_from(">I", data, pos)[0])
            pos += 4
        if b0 & 0x10:
            ext_id, words = struct.unpack_from(">HH", data, pos)
            pos += 4
            p.extension = (ext_id, data[pos:pos + 4 * words])
            pos += 4 * words
        p.payload = data[pos:]
        return p

    def set_extension_data(self, ext_id: int, wordlen: int) -> bytes:
        """gst_rtp_buffer_set_extension_data: allocate a zeroed
        extension; returns the mutable data (reassign .extension to
        persist edits)."""
        data = bytearray(4 * wordlen)
        self.extension = (ext_id, bytes(data))
        return bytes(data)
