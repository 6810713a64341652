"""ASF container mux + parse (gst/asfmux/).

From-spec ASF writer transcribing gstasfmux.c/gstasfobjects.c:

  - the reference GUID table verbatim (gstasfobjects.c:24-57; GUIDs
    serialize u32le + u16le + u16le + u64be);
  - header object = file properties (broadcast flag 0x1 so sizes/counts
    may be streamed as 0, preroll in ms, min=max packet size —
    gstasfmux.c:654-671), per-stream stream properties (WAVEFORMATEX
    for audio, the ASF video-info + BITMAPINFOHEADER for video), and a
    header extension object carrying nothing (reserved GUID + 6);
  - data object with fixed-size packets: payload parsing information
    (no error correction, DWORD/WORD length fields chosen exactly like
    gstasfmux.c:1616-1646 — 16-bit packet/padding fields when they fit,
    send time ms, duration 0) and multiple payloads (0x2 << 6 | count,
    gstasfmux.c:1662), each payload being stream-number(|0x80 keyframe),
    media object number, offset, 8-byte replicated data (object size +
    presentation time ms), 16-bit length (gst_asf_put_payload,
    gstasfobjects.c:333-346); payloads that don't fit split into
    subpayloads (gst_asf_put_subpayload);
  - defaults: packet size 4800, preroll 5000 ms (gstasfmux.c:127-128);
    presentation time = ts in ms + preroll (ASF semantics).

AsfParse mirrors gstasfparse.c: sniff the header object GUID, walk
top-level objects, then chunk the data object into packet-size packets.

Cross-validated in tests against libavformat's ASF demuxer.

A copy of the JAX package's io/asf.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEFAULT_PACKET_SIZE = 4800   # gstasfmux.c:127
DEFAULT_PREROLL = 5000       # gstasfmux.c:128
MAX_PAYLOADS_IN_A_PACKET = 63
MULTIPLE_PAYLOAD_HEADER_SIZE = 17

MILI_TO_100NANO = 10000


def _guid(v1: int, v2: int, v3: int, v4: int) -> bytes:
    """gst_asf_put_guid: v1 le32, v2 le16, v3 le16, v4 be64."""
    return struct.pack("<IHH", v1, v2, v3) + struct.pack(">Q", v4)


# gstasfobjects.c:24-57
GUID_HEADER = _guid(0x75B22630, 0x668E, 0x11CF, 0xA6D900AA0062CE6C)
GUID_FILE_PROPERTIES = _guid(0x8CABDCA1, 0xA947, 0x11CF,
                             0x8EE400C00C205365)
GUID_STREAM_PROPERTIES = _guid(0xB7DC0791, 0xA9B7, 0x11CF,
                               0x8EE600C00C205365)
GUID_AUDIO_MEDIA = _guid(0xF8699E40, 0x5B4D, 0x11CF,
                         0xA8FD00805F5C442B)
GUID_NO_ERROR_CORRECTION = _guid(0x20FB5700, 0x5B55, 0x11CF,
                                 0xA8FD00805F5C442B)
GUID_HEADER_EXTENSION = _guid(0x5FBF03B5, 0xA92E, 0x11CF,
                              0x8EE300C00C205365)
GUID_RESERVED_1 = _guid(0xABD3D211, 0xA9BA, 0x11CF, 0x8EE600C00C205365)
GUID_DATA = _guid(0x75B22636, 0x668E, 0x11CF, 0xA6D900AA0062CE6C)
GUID_VIDEO_MEDIA = _guid(0xBC19EFC0, 0x5B4D, 0x11CF,
                         0xA8FD00805F5C442B)
GUID_SIMPLE_INDEX = _guid(0x33000890, 0xE5B1, 0x11CF,
                          0x89F400A0C90349CB)

FILETIME_EPOCH_OFFSET = 116444736000000000  # 1601->1970 in 100ns


@dataclass
class AsfStream:
    stream_number: int
    is_audio: bool
    type_data: bytes     # WAVEFORMATEX / video info blob
    media_obj_num: int = 0


class AsfMux:
    """Streaming ASF writer (broadcast-flagged like the reference)."""

    def __init__(self, packet_size: int = DEFAULT_PACKET_SIZE,
                 preroll_ms: int = DEFAULT_PREROLL,
                 file_id: bytes = b"\x00" * 16, ecc: bool = False):
        self.packet_size = packet_size
        self.preroll = preroll_ms
        self.file_id = file_id
        # the reference writes NO error-correction block
        # (gstasfmux.c:1616 "(0x0 << 7) no error correction"); ecc=True
        # prepends the standard 0x82 00 00 ECC block that ffmpeg's asf
        # demuxer insists on ("Invalid ECC byte is not implemented")
        self.ecc = ecc
        self.streams: List[AsfStream] = []
        self._payloads: List[dict] = []
        self.total_data_packets = 0
        # flags DWORD packet len + DWORD padding shrink to WORD below
        # 65536 (gstasfmux.c:1616-1646) -> parsing info size
        self.ppi_size = (3 if ecc else 0) + 1 + 1 \
            + (4 if packet_size > 65535 else 2) \
            + (4 if packet_size > 65535 else 2) + 4 + 2

    # -- streams -----------------------------------------------------------

    def add_audio_stream(self, format_tag: int, channels: int, rate: int,
                         bitrate: int = 128000, block_align: int = 1,
                         bits_per_sample: int = 16,
                         codec_data: bytes = b"") -> AsfStream:
        """WAVEFORMATEX type-specific data."""
        wfx = struct.pack("<HHIIHHH", format_tag, channels, rate,
                          bitrate // 8, block_align, bits_per_sample,
                          len(codec_data)) + codec_data
        st = AsfStream(len(self.streams) + 1, True, wfx)
        self.streams.append(st)
        return st

    def add_video_stream(self, fourcc: bytes, width: int, height: int,
                         codec_data: bytes = b"") -> AsfStream:
        """ASF video info: w, h, reserved, data-size, BITMAPINFOHEADER."""
        bmih = struct.pack("<IiiHH4sIiiII", 40 + len(codec_data), width,
                           height, 1, 24, fourcc, 0, 0, 0, 0, 0) \
            + codec_data
        vinfo = struct.pack("<IIBH", width, height, 2, len(bmih)) + bmih
        st = AsfStream(len(self.streams) + 1, False, vinfo)
        self.streams.append(st)
        return st

    # -- header --------------------------------------------------------------

    def _obj(self, guid: bytes, body: bytes) -> bytes:
        return guid + struct.pack("<Q", 24 + len(body)) + body

    def _file_properties(self) -> bytes:
        """gstasfmux.c:654-671 (broadcast flag: sizes stay 0)."""
        body = self.file_id
        body += struct.pack("<Q", 0)          # file size
        body += struct.pack("<Q", 0)          # creation time
        body += struct.pack("<Q", 0)          # data packet count
        body += struct.pack("<Q", 0)          # play duration
        body += struct.pack("<Q", 0)          # send duration
        body += struct.pack("<Q", self.preroll)
        body += struct.pack("<I", 0x1)        # broadcast flag
        body += struct.pack("<I", self.packet_size)
        body += struct.pack("<I", self.packet_size)
        body += struct.pack("<I", 0)          # max bitrate
        return self._obj(GUID_FILE_PROPERTIES, body)

    def _stream_properties(self, st: AsfStream) -> bytes:
        body = (GUID_AUDIO_MEDIA if st.is_audio else GUID_VIDEO_MEDIA)
        body += GUID_NO_ERROR_CORRECTION
        body += struct.pack("<Q", 0)  # time offset
        body += struct.pack("<I", len(st.type_data))
        body += struct.pack("<I", 0)  # error correction data length
        body += struct.pack("<H", st.stream_number & 0x7F)
        body += struct.pack("<I", 0)  # reserved
        body += st.type_data
        return self._obj(GUID_STREAM_PROPERTIES, body)

    def _header_extension(self) -> bytes:
        body = GUID_RESERVED_1 + struct.pack("<H", 6) \
            + struct.pack("<I", 0)
        return self._obj(GUID_HEADER_EXTENSION, body)

    def header(self) -> bytes:
        objs = [self._file_properties(), self._header_extension()]
        objs += [self._stream_properties(s) for s in self.streams]
        inner = b"".join(objs)
        hdr = (GUID_HEADER
               + struct.pack("<Q", 30 + len(inner))
               + struct.pack("<I", len(objs))
               + bytes([0x01, 0x02])
               + inner)
        # data object header: size/count 0 in broadcast mode
        data_obj = (GUID_DATA + struct.pack("<Q", 0) + self.file_id
                    + struct.pack("<Q", 0) + bytes([0x01, 0x01]))
        return hdr + data_obj

    # -- payloads --------------------------------------------------------------

    def add_buffer(self, st: AsfStream, data: bytes, pts_ms: int,
                   keyframe: bool = False) -> bytes:
        """Queue one media object; returns any full packets flushed."""
        self._payloads.append(dict(
            stream_number=(st.stream_number & 0x7F)
            | (0x80 if keyframe else 0),
            media_obj_num=st.media_obj_num & 0xFF,
            offset=0,
            media_object_size=len(data),
            presentation_time=pts_ms + self.preroll,
            data=data))
        st.media_obj_num += 1
        out = b""
        while self._queued_size() + self.ppi_size + 1 \
                >= self.packet_size:
            out += self._flush_packet()
        return out

    def _queued_size(self) -> int:
        return sum(MULTIPLE_PAYLOAD_HEADER_SIZE + len(p["data"])
                   for p in self._payloads)

    def finish(self) -> bytes:
        out = b""
        while self._payloads:
            out += self._flush_packet()
        return out

    def _flush_packet(self) -> bytes:
        """gst_asf_mux_flush_payloads (gstasfmux.c:1462-1674)."""
        payload_area = bytearray()
        size_left = self.packet_size - self.ppi_size - 1
        count = 0
        send_ts = None
        while self._payloads and count < MAX_PAYLOADS_IN_A_PACKET:
            p = self._payloads[0]
            need = MULTIPLE_PAYLOAD_HEADER_SIZE + len(p["data"])
            if size_left < need:
                break
            if send_ts is None:
                send_ts = p["presentation_time"]
            payload_area += self._put_payload(p, p["data"])
            size_left -= need
            count += 1
            self._payloads.pop(0)
        # partial next payload (gst_asf_put_subpayload)
        if self._payloads \
                and size_left > MULTIPLE_PAYLOAD_HEADER_SIZE:
            p = self._payloads[0]
            if send_ts is None:
                send_ts = p["presentation_time"]
            chunk = p["data"][:size_left
                              - MULTIPLE_PAYLOAD_HEADER_SIZE]
            payload_area += self._put_payload(p, chunk)
            p["data"] = p["data"][len(chunk):]
            p["offset"] += len(chunk)
            size_left -= MULTIPLE_PAYLOAD_HEADER_SIZE + len(chunk)
            count += 1

        ppi = bytearray()
        if self.ecc:
            ppi += b"\x82\x00\x00"
        flags = 0x1  # multiple payloads
        plen_word = self.packet_size <= 65535
        flags |= (0x2 if plen_word else 0x4) << 5  # packet length type
        flags |= (0x2 if plen_word else 0x4) << 3  # padding length type
        ppi.append(flags)
        ppi.append((0x1 << 6) | (0x1 << 4) | (0x3 << 2) | 0x1)
        fmt = "<H" if plen_word else "<I"
        if self.ecc:
            # standard/ffmpeg reading: packet length = the WHOLE packet
            # (padding included); ffmpeg pads the shortfall otherwise
            # and rejects the double-counted padding
            ppi += struct.pack(fmt, self.packet_size)
        else:
            # the reference writes the USED byte count
            # (gstasfmux.c:1633 "packet_size - size_left")
            ppi += struct.pack(fmt, self.packet_size - size_left)
        ppi += struct.pack(fmt, size_left)
        ppi += struct.pack("<I", send_ts if send_ts is not None else 0)
        ppi += struct.pack("<H", 0)  # duration
        ppi.append((0x2 << 6) | count)

        pkt = bytes(ppi) + bytes(payload_area)
        pkt += b"\x00" * (self.packet_size - len(pkt))
        self.total_data_packets += 1
        return pkt

    @staticmethod
    def _put_payload(p: dict, data: bytes) -> bytes:
        return (bytes([p["stream_number"], p["media_obj_num"]])
                + struct.pack("<I", p["offset"])
                + bytes([8])
                + struct.pack("<I", p["media_object_size"])
                + struct.pack("<I", p["presentation_time"])
                + struct.pack("<H", len(data)) + data)


def finalize(mux: AsfMux, stream: bytes,
             play_duration_ms: int = 0) -> bytes:
    """Non-streamable finish (gst_asf_mux_stop_file,
    gstasfmux.c:1781-1878): patch the file-properties object (file
    size, packet count, play/send duration, flags -> 0x2 seekable) and
    the data object (size + packet count) in the emitted stream."""
    out = bytearray(stream)
    p = out.find(GUID_FILE_PROPERTIES)
    if p >= 0:
        struct.pack_into("<Q", out, p + 40, len(out))
        struct.pack_into("<Q", out, p + 56, mux.total_data_packets)
        dur100ns = play_duration_ms * MILI_TO_100NANO
        struct.pack_into("<Q", out, p + 64,
                         dur100ns + mux.preroll * MILI_TO_100NANO)
        struct.pack_into("<Q", out, p + 72, dur100ns)
        struct.pack_into("<I", out, p + 88, 0x2)  # seekable
    d = out.find(GUID_DATA)
    if d >= 0:
        struct.pack_into("<Q", out, d + 16,
                         50 + mux.total_data_packets * mux.packet_size)
        struct.pack_into("<Q", out, d + 40, mux.total_data_packets)
    return bytes(out)


class AsfParse:
    """gstasfparse.c: align an ASF byte stream into header + packets."""

    def __init__(self):
        self._buf = b""
        self.packet_size: Optional[int] = None
        self.header: Optional[bytes] = None
        self._in_data = False

    def push(self, data: bytes) -> List[bytes]:
        self._buf += data
        out: List[bytes] = []
        while True:
            if not self._in_data:
                if len(self._buf) < 30:
                    break
                if self._buf[:16] != GUID_HEADER:
                    raise ValueError("not an ASF stream")
                (hsize,) = struct.unpack_from("<Q", self._buf, 16)
                # header + the 50-byte data object header
                if len(self._buf) < hsize + 50:
                    break
                self.header = self._buf[:hsize + 50]
                self._parse_header(self._buf[:hsize])
                self._buf = self._buf[hsize + 50:]
                self._in_data = True
                out.append(self.header)
            else:
                if self.packet_size is None \
                        or len(self._buf) < self.packet_size:
                    break
                out.append(self._buf[:self.packet_size])
                self._buf = self._buf[self.packet_size:]
        return out

    def _parse_header(self, hdr: bytes) -> None:
        pos = 30
        while pos + 24 <= len(hdr):
            guid = hdr[pos:pos + 16]
            (size,) = struct.unpack_from("<Q", hdr, pos + 16)
            if size < 24:
                break
            if guid == GUID_FILE_PROPERTIES:
                (self.packet_size,) = struct.unpack_from(
                    "<I", hdr, pos + 24 + 68)
            pos += size
