"""UVC H.264 auxiliary-stream demux (sys/uvch264/
gstuvch264_mjpgdemux.c).

UVC H.264 cameras (the Logitech C920 family) mux auxiliary streams
into their MJPEG output as APP4 (0xFFE4) JPEG segments placed before
SOS: the first APP4 of a frame carries the 22-byte packed
AuxiliaryStreamHeader (version - read big-endian "but it looks more
like BE", header length LE, fourcc, width/height LE, frame interval in
100 ns LE, delay ms LE, pts LE) followed by a 32-bit payload size;
payloads larger than one segment continue across further APP4s.  The
demux strips the APP4 segments out of the JPEG and reassembles each
auxiliary payload (H264 / YUY2 / NV12).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class AuxFrame:
    fourcc: str
    width: int
    height: int
    frame_interval: int   # 100 ns units
    delay_ms: int
    pts: int
    data: bytes


def demux_mjpg(data: bytes) -> Tuple[bytes, List[AuxFrame]]:
    """One MJPEG buffer -> (jpeg without APP4s, auxiliary frames);
    transcribes gst_uvc_h264_mjpg_demux_chain's walk exactly incl. the
    APP4-before-SOS rule and multi-segment reassembly."""
    jpeg = bytearray()
    out: List[AuxFrame] = []
    aux: Optional[AuxFrame] = None
    aux_remaining = 0
    aux_buf = bytearray()
    last_offset = 0
    i = 0
    n = len(data)
    while i < n - 1:
        if data[i] == 0xFF and data[i + 1] == 0xE4:
            if i + 4 >= n:
                raise ValueError("truncated APP4 marker size")
            segment_size = struct.unpack_from(">H", data, i + 2)[0]
            if i + segment_size + 2 >= n:
                raise ValueError("truncated APP4 content")
            if i - last_offset > 0:
                jpeg += data[last_offset:i]
            last_offset = i + 2 + segment_size
            i += 4
            segment_size -= 2
            if aux is None:
                if segment_size < 22 + 4:
                    raise ValueError("aux header truncated")
                (version,) = struct.unpack_from(">H", data, i)
                (header_len,) = struct.unpack_from("<H", data, i + 2)
                fourcc = data[i + 4:i + 8].decode("latin1")
                w, h = struct.unpack_from("<HH", data, i + 8)
                (interval,) = struct.unpack_from("<I", data, i + 12)
                (delay,) = struct.unpack_from("<H", data, i + 16)
                (pts,) = struct.unpack_from("<I", data, i + 18)
                (aux_remaining,) = struct.unpack_from(
                    "<I", data, i + header_len)
                aux = AuxFrame(fourcc, w, h, interval, delay, pts, b"")
                aux_buf = bytearray()
                i += 22 + 4
                segment_size -= 22 + 4
                if fourcc not in ("H264", "YUY2", "NV12"):
                    raise ValueError(
                        f"unknown auxiliary stream {fourcc!r}")
            if segment_size > aux_remaining:
                raise ValueError("more auxiliary data than announced")
            if segment_size > 0:
                aux_buf += data[i:i + segment_size]
                aux_remaining -= segment_size
                if aux_remaining == 0:
                    aux.data = bytes(aux_buf)
                    out.append(aux)
                    aux = None
            i += segment_size - 1
        elif data[i] == 0xFF and data[i + 1] == 0xDA:
            # APP4s come before SOS: the rest is jpeg
            jpeg += data[last_offset:]
            last_offset = n
            break
        i += 1
    if last_offset < n:
        jpeg += data[last_offset:]
    if aux is not None:
        # C920 missing-segment bug tolerance (the reference warns and
        # drops the partial aux frame)
        pass
    return bytes(jpeg), out
