"""MPEG program stream mux/demux (gst/mpegpsmux, gst/mpegdemux).

From-spec (ISO 13818-1 program stream) implementation with the
reference psmux library's identities:

  - pack header 0xBA (MPEG-2 form: '01' marker, 33-bit SCR with marker
    bits, 9-bit SCR extension 0 "like what VLC does", 22-bit
    program_mux_rate, stuffing 0) — psmux_write_pack_header
    (psmux.c:300-339);
  - system header 0xBB (rate/audio/video bounds + per-stream
    buffer_bound entries, psmux.c:341-396) and program stream map 0xBC
    (stream type/id pairs + CRC32-MPEG2, psmux.c:398-460), re-emitted
    with the reference's cadence constants (pack every 30 PES or 0.7 s,
    system header/PSM every 300 PES — psmuxcommon.h:54-64);
  - stream ids allocated like psmux_stream_new (psmuxstream.c:68-145):
    MPEG audio from 0xC0, MPEG/H.264 video from 0xE0, private data
    0xBD;
  - PES packets identical to the TS layer's (bounded, max payload
    65500 per PES — PSMUX_PES_MAX_PAYLOAD; oversized buffers split
    into continuation PES without timestamps);
  - program end code 0x000001B9.

The demux side transcribes gstpesfilter.c/gstmpegdemux.c: start-code
scan, MPEG-1 and MPEG-2 pack header forms, system header/PSM skip or
parse, MPEG-1 (stuffing + 0x40 + 0x2/0x3 marker) and MPEG-2 (flag
bytes) PES headers, SCR observation.  Cross-validated against
libavformat's "vob" muxer / PS demuxer in tests.
A copy of the JAX package's io/mpegps.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional

from gstbad_tpu_torch.io.mpegts import (NO_TS, TsError, crc32_mpeg, _put_ts,
                                  _get_ts)

PACK_HEADER = 0xBA
SYSTEM_HEADER = 0xBB
PSM = 0xBC
PRIVATE_1 = 0xBD
PADDING = 0xBE
PRIVATE_2 = 0xBF
PROGRAM_END = 0xB9

PES_MAX_PAYLOAD = 65500       # PSMUX_PES_MAX_PAYLOAD (psmuxcommon.h:58)
PACK_HDR_FREQ = 30            # psmuxcommon.h:54
SYS_HDR_FREQ = 300
PSM_FREQ = 300
PACK_HDR_INTERVAL = int(0.7 * 90000)  # psmuxcommon.h:63

# PsMuxStreamType (psmuxcommon.h; same coding as TS stream types)
ST_VIDEO_MPEG1 = 0x01
ST_VIDEO_MPEG2 = 0x02
ST_AUDIO_MPEG1 = 0x03
ST_AUDIO_MPEG2 = 0x04
ST_PRIVATE_DATA = 0x06
ST_AUDIO_AAC = 0x0F
ST_VIDEO_H264 = 0x1B

_VIDEO = (ST_VIDEO_MPEG1, ST_VIDEO_MPEG2, ST_VIDEO_H264)
_AUDIO = (ST_AUDIO_MPEG1, ST_AUDIO_MPEG2, ST_AUDIO_AAC)


class PsMuxStream:
    """psmux_stream_new (psmuxstream.c:68-145)."""

    def __init__(self, stream_id: int, stream_type: int):
        self.stream_id = stream_id
        self.stream_type = stream_type
        self.is_video = stream_type in _VIDEO

    def pes_packet(self, payload: bytes, pts: int, dts: int) -> bytes:
        write_pts = pts != NO_TS
        write_dts = write_pts and dts != NO_TS and dts != pts
        opt = b""
        flags2 = 0
        if write_pts and write_dts:
            flags2 = 0xC0
            opt = _put_ts(0x3, pts) + _put_ts(0x1, dts)
        elif write_pts:
            flags2 = 0x80
            opt = _put_ts(0x2, pts)
        total = 3 + len(opt) + len(payload)
        return (b"\x00\x00\x01" + bytes([self.stream_id])
                + struct.pack(">H", total)
                + bytes([0x81, flags2, len(opt)]) + opt + payload)


class PsMux:
    def __init__(self):
        self.streams: List[PsMuxStream] = []
        self._next_audio = 0xC0  # info->id_mpga (psmuxstream.c:87)
        self._next_video = 0xE0  # info->id_mpgv (psmuxstream.c:98)
        self.pes_cnt = 0
        self.pts = NO_TS
        self._last_pack_pts = None
        self.bit_rate = 1000 * 8 * 50  # PSMUX_PES_BITRATE_DEFAULT scale

    def add_stream(self, stream_type: int) -> PsMuxStream:
        if stream_type in _VIDEO:
            sid = self._next_video
            self._next_video += 1
        elif stream_type in _AUDIO:
            sid = self._next_audio
            self._next_audio += 1
        else:
            sid = PRIVATE_1
        st = PsMuxStream(sid, stream_type)
        self.streams.append(st)
        return st

    # -- headers -----------------------------------------------------------

    def _pack_header(self) -> bytes:
        """psmux_write_pack_header (psmux.c:300-339), 14 bytes."""
        scr = self.pts if self.pts != NO_TS else 0
        scr &= (1 << 33) - 1
        v = 0
        v = (v << 2) | 0x1
        v = (v << 3) | ((scr >> 30) & 0x7)
        v = (v << 1) | 1
        v = (v << 15) | ((scr >> 15) & 0x7FFF)
        v = (v << 1) | 1
        v = (v << 15) | (scr & 0x7FFF)
        v = (v << 1) | 1
        v = (v << 9) | 0  # scr extension (0 like VLC)
        v = (v << 1) | 1
        mux_rate = (self.bit_rate + 8 * 50 - 1) // (8 * 50)
        v = (v << 22) | (mux_rate & 0x3FFFFF)
        v = (v << 2) | 3
        # 72 content bits + 5 reserved + 3 stuffing-length(0) = 80
        body = ((v << 8) | 0xF8).to_bytes(10, "big")
        return b"\x00\x00\x01" + bytes([PACK_HEADER]) + body

    def _system_header(self) -> bytes:
        """psmux_ensure_system_header (psmux.c:341-396)."""
        n_priv = sum(1 for s in self.streams
                     if s.stream_id == PRIVATE_1)
        entries = [s for s in self.streams]
        length = 12 + len(entries) * 3
        out = bytearray(b"\x00\x00\x01" + bytes([SYSTEM_HEADER]))
        out += struct.pack(">H", length - 6)
        mux_rate = (self.bit_rate + 8 * 50 - 1) // (8 * 50)
        rate_bound = mux_rate * 2
        out.append(0x80 | ((rate_bound >> 15) & 0x7F))
        out += struct.pack(">H",
                           ((rate_bound & 0x7FFF) << 1) | 1)
        audio_bound = sum(1 for s in self.streams if not s.is_video)
        video_bound = sum(1 for s in self.streams if s.is_video)
        out.append((audio_bound << 2) | 0x0)
        out.append(0x20 | video_bound)
        out.append(0x7F)
        for s in entries:
            buf_size = 232 * 1024 if s.is_video else 4 * 1024
            scale = 1 if s.is_video else 0
            bound = buf_size // (1024 if s.is_video else 128)
            out.append(s.stream_id)
            out += struct.pack(
                ">H", 0xC000 | (scale << 13) | (bound & 0x1FFF))
        return bytes(out)

    def _psm(self) -> bytes:
        """psmux_ensure_program_stream_map (psmux.c:398-460)."""
        es = bytearray()
        for s in self.streams:
            es.append(s.stream_type)
            es.append(s.stream_id)
            es += struct.pack(">H", 0)  # es_info_length
        body = bytearray()
        body.append(0xE0)  # current_next=1, version=0
        body.append(0xFF)  # reserved + marker
        body += struct.pack(">H", 0)  # program_stream_info_length
        body += struct.pack(">H", len(es))
        body += es
        sec = (b"\x00\x00\x01" + bytes([PSM])
               + struct.pack(">H", len(body) + 4) + bytes(body))
        return sec + struct.pack(">I", crc32_mpeg(sec))

    # -- data ----------------------------------------------------------------

    def add_data(self, st: PsMuxStream, data: bytes, pts: int = NO_TS,
                 dts: int = NO_TS) -> bytes:
        """One buffer -> pack/system/psm (as due) + PES packets."""
        if pts != NO_TS:
            self.pts = pts
        out = bytearray()
        if (self.pes_cnt % PACK_HDR_FREQ) == 0 or (
                pts != NO_TS and self._last_pack_pts is not None
                and pts - self._last_pack_pts > PACK_HDR_INTERVAL):
            out += self._pack_header()
            self._last_pack_pts = self.pts
        if (self.pes_cnt % SYS_HDR_FREQ) == 0:
            out += self._system_header()
        if (self.pes_cnt % PSM_FREQ) == 0:
            out += self._psm()
        pos = 0
        first = True
        while pos < len(data) or first:
            chunk = data[pos:pos + PES_MAX_PAYLOAD]
            out += st.pes_packet(chunk,
                                 pts if first else NO_TS,
                                 dts if first else NO_TS)
            self.pes_cnt += 1
            pos += len(chunk)
            first = False
        return bytes(out)

    def finish(self) -> bytes:
        return b"\x00\x00\x01" + bytes([PROGRAM_END])


# ----------------------------------------------------------------------
# Demux

@dataclass
class PsPacketOut:
    stream_id: int
    stream_type: int
    data: bytes
    pts: int = NO_TS
    dts: int = NO_TS


class PsDemux:
    """gstpesfilter.c + gstmpegdemux.c essentials."""

    def __init__(self):
        self._buf = b""
        self.stream_types: Dict[int, int] = {}  # stream_id -> type
        self.last_scr = None
        self.saw_end = False

    def push(self, data: bytes) -> List[PsPacketOut]:
        self._buf += data
        out: List[PsPacketOut] = []
        while True:
            idx = self._buf.find(b"\x00\x00\x01")
            if idx < 0:
                self._buf = self._buf[-2:] if len(self._buf) > 2 else \
                    self._buf
                break
            if idx:
                self._buf = self._buf[idx:]
            if len(self._buf) < 4:
                break
            code = self._buf[3]
            if code == PACK_HEADER:
                n = self._pack(self._buf)
                if n == 0:
                    break
                self._buf = self._buf[n:]
            elif code == PROGRAM_END:
                self.saw_end = True
                self._buf = self._buf[4:]
            elif code in (SYSTEM_HEADER, PSM, PADDING, PRIVATE_2) \
                    or 0xBD <= code <= 0xEF:
                if len(self._buf) < 6:
                    break
                (length,) = struct.unpack_from(">H", self._buf, 4)
                if len(self._buf) < 6 + length:
                    break
                pkt = self._buf[:6 + length]
                self._buf = self._buf[6 + length:]
                if code == PSM:
                    self._parse_psm(pkt)
                elif code == PRIVATE_1 or 0xC0 <= code <= 0xEF:
                    got = self._parse_pes(pkt)
                    if got is not None:
                        out.append(got)
            else:
                self._buf = self._buf[3:]
        return out

    def _pack(self, buf: bytes) -> int:
        """Pack header: MPEG-2 ('01' prefix, 14+stuffing) or MPEG-1
        ('0010', 12 bytes) — gstpesfilter's two forms."""
        if len(buf) < 5:
            return 0
        b4 = buf[4]
        if (b4 >> 6) == 0x1:  # MPEG-2
            if len(buf) < 14:
                return 0
            v = int.from_bytes(buf[4:14], "big")
            # 80-bit body: 2 prefix, 3 scr_hi, m, 15 scr_mid, m,
            # 15 scr_lo, m, 9 ext, m, 22 rate, 2, 5 reserved, 3 stuffing
            scr_base = (((v >> 75) & 0x7) << 30) \
                | (((v >> 59) & 0x7FFF) << 15) | ((v >> 43) & 0x7FFF)
            self.last_scr = scr_base
            stuffing = buf[13] & 0x7
            return 14 + stuffing if len(buf) >= 14 + stuffing else 0
        if (b4 >> 4) == 0x2:  # MPEG-1
            if len(buf) < 12:
                return 0
            self.last_scr = (((b4 >> 1) & 0x7) << 30) \
                | ((int.from_bytes(buf[5:7], "big") >> 1) << 15) \
                | (int.from_bytes(buf[7:9], "big") >> 1)
            return 12
        return 4  # malformed: skip the code

    def _parse_psm(self, pkt: bytes) -> None:
        if crc32_mpeg(pkt) != 0:
            return
        (info_len,) = struct.unpack_from(">H", pkt, 8)
        pos = 10 + info_len
        (es_len,) = struct.unpack_from(">H", pkt, pos)
        pos += 2
        end = pos + es_len
        while pos + 4 <= end:
            stype, sid = pkt[pos], pkt[pos + 1]
            (ei,) = struct.unpack_from(">H", pkt, pos + 2)
            self.stream_types[sid] = stype
            pos += 4 + ei

    def _parse_pes(self, pkt: bytes) -> Optional[PsPacketOut]:
        sid = pkt[3]
        body = pkt[6:]
        pts = dts = NO_TS
        if not body:
            return None
        if (body[0] >> 6) == 0x2:  # MPEG-2 PES
            if len(body) < 3:
                return None
            flags2 = body[1]
            hdr_len = body[2]
            pos = 3
            if flags2 & 0x80:
                pts = _get_ts(body[pos:pos + 5])
                pos += 5
            if flags2 & 0x40:
                dts = _get_ts(body[pos:pos + 5])
            payload = body[3 + hdr_len:]
        else:  # MPEG-1 PES (gstpesfilter.c MPEG-1 walk)
            pos = 0
            while pos < len(body) and body[pos] == 0xFF:
                pos += 1  # stuffing
            if pos < len(body) and (body[pos] >> 6) == 0x1:
                pos += 2  # STD buffer size
            if pos < len(body) and (body[pos] >> 4) == 0x2:
                pts = _get_ts(body[pos:pos + 5])
                pos += 5
            elif pos < len(body) and (body[pos] >> 4) == 0x3:
                pts = _get_ts(body[pos:pos + 5])
                dts = _get_ts(body[pos + 5:pos + 10])
                pos += 10
            elif pos < len(body) and body[pos] == 0x0F:
                pos += 1
            payload = body[pos:]
        return PsPacketOut(
            stream_id=sid,
            stream_type=self.stream_types.get(sid, 0),
            data=payload, pts=pts, dts=dts)
