"""RTP over real sockets — the gst/rtp/ bin pair's session layer.

The reference rtpsrc/rtpsink (gst/rtp/gstrtpsrc.c, gstrtpsink.c) are thin
bins wiring udpsrc/udpsink into rtpbin: URI handling with query-string
property setting (gstrtp-utils.c:41-75), RTP on the (even) port and RTCP
on port+1 (gstrtpsrc.c:221-230), pt->caps resolution preferring explicit
caps, then encoding-name, then the static RFC 3551 table
(gst_rtp_src_rtpbin_request_pt_map_cb, gstrtpsrc.c:118-160), and a
jitterbuffer with a 200 ms default latency (DEFAULT_PROP_LATENCY,
gstrtpsrc.c:63).  This module rebuilds that session layer natively:

  - the static payload-type table (RFC 3551 tables 4/5 — the data behind
    gst-libs' gstrtppayloads.c);
  - a wrap-aware jitter buffer (16-bit seqnum unwrap + latency-bounded
    reordering, the rtpjitterbuffer contract rtpsrc relies on);
  - payloaders/depayloaders for the formats this framework carries
    natively: L16 audio (RFC 3551 4.5.11), MP2T (RFC 2250 section 2),
    and raw video per RFC 4175 (RGB/BGR/RGBA/BGRA and YCbCr-4:2:2,
    which is this package's UYVY byte order);
  - minimal RTCP: SR/RR/SDES/BYE pack+parse (RFC 3550 section 6) so the
    sink can emit sender reports and the source can map RTP time to NTP.

The elements over this live in gstbad_tpu_torch/elements/rtp.py.
A copy of the JAX package's io/rtpnet.py, but for its imports and one
correction: RawVideoDepayloader makes a frame's buffer once, where the
JAX module's setdefault zeroes a new whole-frame buffer for every packet
(about 2.9 s a 1080p BGRA frame on one core); the frames are the same.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlparse

import numpy as np

from gstbad_tpu_torch.io.rtp import RtpPacket

# ---------------------------------------------------------------------------
# Static payload types (RFC 3551 tables 4 and 5; gstrtppayloads.c data)
# ---------------------------------------------------------------------------

# pt -> (media, encoding-name, clock-rate, channels or None)
STATIC_PAYLOAD_TYPES: Dict[int, Tuple[str, str, int, Optional[int]]] = {
    0: ("audio", "PCMU", 8000, 1),
    3: ("audio", "GSM", 8000, 1),
    4: ("audio", "G723", 8000, 1),
    5: ("audio", "DVI4", 8000, 1),
    6: ("audio", "DVI4", 16000, 1),
    7: ("audio", "LPC", 8000, 1),
    8: ("audio", "PCMA", 8000, 1),
    9: ("audio", "G722", 8000, 1),
    10: ("audio", "L16", 44100, 2),
    11: ("audio", "L16", 44100, 1),
    12: ("audio", "QCELP", 8000, 1),
    13: ("audio", "CN", 8000, 1),
    14: ("audio", "MPA", 90000, None),
    15: ("audio", "G728", 8000, 1),
    16: ("audio", "DVI4", 11025, 1),
    17: ("audio", "DVI4", 22050, 1),
    18: ("audio", "G729", 8000, 1),
    25: ("video", "CelB", 90000, None),
    26: ("video", "JPEG", 90000, None),
    28: ("video", "nv", 90000, None),
    31: ("video", "H261", 90000, None),
    32: ("video", "MPV", 90000, None),
    33: ("video", "MP2T", 90000, None),
    34: ("video", "H263", 90000, None),
}

DYNAMIC_PT_MIN = 96  # GST_RTP_PAYLOAD_IS_DYNAMIC


def payload_info_for_pt(pt: int):
    """gst_rtp_payload_info_for_pt: static table lookup."""
    return STATIC_PAYLOAD_TYPES.get(pt)


def payload_info_for_name(encoding_name: str):
    """gst_rtp_payload_info_for_name, tried for video then audio like
    gstrtpsrc.c:134-141 (media unknown at lookup time)."""
    name = encoding_name.upper()
    for media_pref in ("video", "audio"):
        for pt, (media, enc, rate, ch) in STATIC_PAYLOAD_TYPES.items():
            if media == media_pref and enc.upper() == name:
                return (media, enc, rate, ch)
    # dynamic-only encodings this module payloads
    if name == "RAW":
        return ("video", "RAW", 90000, None)
    if name == "L16":
        return ("audio", "L16", 44100, 2)
    if name == "L24":
        return ("audio", "L24", 44100, 2)
    return None


def parse_rtp_uri(uri: str) -> Tuple[str, int, Dict[str, str]]:
    """rtp://host:port?prop=value&...  (gstrtp-utils.c: every query key
    is applied as a property)."""
    u = urlparse(uri)
    if u.scheme != "rtp":
        raise ValueError(f"rtpnet: not an rtp:// uri: {uri}")
    host = u.hostname or "0.0.0.0"
    port = u.port or 5004
    query = dict(parse_qsl(u.query))
    return host, port, query


# ---------------------------------------------------------------------------
# Jitter buffer (seqnum unwrap + latency-bounded reordering)
# ---------------------------------------------------------------------------


class JitterBuffer:
    """Wrap-aware reordering queue with a latency deadline.

    Packets insert keyed by UNWRAPPED sequence number (16-bit seq
    unwrapped against the last seen value with the standard +/-32768
    window).  pop_ready() releases consecutive packets immediately; a gap
    is skipped only once the first packet past it has waited `latency`
    ms (the rtpjitterbuffer "do-lost" contract).  The first SSRC seen
    locks the session; other SSRCs are dropped and counted."""

    def __init__(self, latency_ms: int = 200):
        self.latency = latency_ms / 1000.0
        self._buf: Dict[int, Tuple[float, RtpPacket]] = {}
        self._base: Optional[int] = None    # next ext-seq to release
        self._released = False              # anything popped yet?
        self._last_ext: Optional[int] = None
        self.ssrc: Optional[int] = None
        self.num_late = 0
        self.num_lost = 0
        self.num_foreign = 0
        self.num_duplicate = 0

    def _unwrap(self, seq: int) -> int:
        if self._last_ext is None:
            self._last_ext = seq
            return seq
        last = self._last_ext
        delta = ((seq - last + 0x8000) & 0xFFFF) - 0x8000
        ext = last + delta
        if delta > 0:
            self._last_ext = ext
        return ext

    def insert(self, pkt: RtpPacket, now: Optional[float] = None) -> None:
        if self.ssrc is None:
            self.ssrc = pkt.ssrc
        elif pkt.ssrc != self.ssrc:
            self.num_foreign += 1
            return
        now = time.monotonic() if now is None else now
        ext = self._unwrap(pkt.seq)
        if self._base is None:
            self._base = ext
        elif ext < self._base:
            if self._released:
                self.num_late += 1
                return
            # nothing released yet: reordered delivery of an earlier
            # seq just extends the window downward
            self._base = ext
        if ext in self._buf:
            self.num_duplicate += 1
            return
        self._buf[ext] = (now, pkt)

    def pop_ready(self, now: Optional[float] = None) -> List[RtpPacket]:
        now = time.monotonic() if now is None else now
        out: List[RtpPacket] = []
        while self._buf:
            if self._base in self._buf:
                out.append(self._buf.pop(self._base)[1])
                self._base += 1
                self._released = True
                continue
            # gap: release past it only once something beyond has aged out
            future = [e for e in self._buf if e > self._base]
            if not future:
                break
            first = min(future)
            arrival = self._buf[first][0]
            if now - arrival < self.latency:
                break
            self.num_lost += first - self._base
            self._base = first
        return out

    def flush(self) -> List[RtpPacket]:
        """EOS: drain everything in order, counting the gaps lost."""
        out = []
        for ext in sorted(self._buf):
            if self._base is not None and ext > self._base:
                self.num_lost += ext - self._base
            out.append(self._buf[ext][1])
            self._base = ext + 1
        self._buf.clear()
        return out


# ---------------------------------------------------------------------------
# L16 (RFC 3551 4.5.11): 16-bit linear PCM, network byte order
# ---------------------------------------------------------------------------


class L16Payloader:
    def __init__(self, rate: int, channels: int, pt: int = 96,
                 ssrc: int = 0x12345678, mtu: int = 1400,
                 base_seq: int = 0, base_ts: int = 0):
        self.rate = rate
        self.channels = channels
        self.pt = pt
        self.ssrc = ssrc
        self.mtu = mtu
        self.seq = base_seq & 0xFFFF
        self.ts = base_ts & 0xFFFFFFFF
        self.packet_count = 0
        self.octet_count = 0

    def pay(self, samples: np.ndarray) -> List[RtpPacket]:
        """samples: [S, channels] int16 -> packets (timestamp advances by
        the sample clock; frames never split mid-sample-frame)."""
        samples = np.asarray(samples, np.int16).reshape(
            -1, self.channels)
        frame_bytes = 2 * self.channels
        per_pkt = max(1, (self.mtu - 12) // frame_bytes)
        pkts = []
        for off in range(0, samples.shape[0], per_pkt):
            chunk = samples[off:off + per_pkt]
            payload = chunk.astype(">i2").tobytes()
            pkts.append(RtpPacket(payload_type=self.pt, seq=self.seq,
                                  timestamp=self.ts, ssrc=self.ssrc,
                                  payload=payload))
            self.seq = (self.seq + 1) & 0xFFFF
            self.ts = (self.ts + chunk.shape[0]) & 0xFFFFFFFF
            self.packet_count += 1
            self.octet_count += len(payload)
        return pkts


class L16Depayloader:
    def __init__(self, channels: int):
        self.channels = channels

    def depay(self, pkt: RtpPacket) -> np.ndarray:
        return np.frombuffer(pkt.payload, ">i2").astype(
            np.int16).reshape(-1, self.channels)


# ---------------------------------------------------------------------------
# MP2T (RFC 2250 section 2): integral TS packets per datagram, PT 33
# ---------------------------------------------------------------------------

TS_PACKET = 188


class Mp2tPayloader:
    def __init__(self, pt: int = 33, ssrc: int = 0x4d503254,
                 mtu: int = 1400, base_seq: int = 0):
        self.pt = pt
        self.ssrc = ssrc
        self.per_pkt = max(1, (mtu - 12) // TS_PACKET)  # 7 at mtu 1400
        self.seq = base_seq & 0xFFFF
        self._partial = b""
        self.packet_count = 0
        self.octet_count = 0

    def pay(self, data: bytes, ts90: int = 0) -> List[RtpPacket]:
        data = self._partial + data
        whole = len(data) - len(data) % TS_PACKET
        data, self._partial = data[:whole], data[whole:]
        pkts = []
        step = self.per_pkt * TS_PACKET
        for off in range(0, len(data), step):
            payload = data[off:off + step]
            pkts.append(RtpPacket(payload_type=self.pt, seq=self.seq,
                                  timestamp=ts90 & 0xFFFFFFFF,
                                  ssrc=self.ssrc, payload=payload))
            self.seq = (self.seq + 1) & 0xFFFF
            self.packet_count += 1
            self.octet_count += len(payload)
        return pkts


class Mp2tDepayloader:
    def depay(self, pkt: RtpPacket) -> bytes:
        n = len(pkt.payload) - len(pkt.payload) % TS_PACKET
        return pkt.payload[:n]


# ---------------------------------------------------------------------------
# Raw video (RFC 4175)
# ---------------------------------------------------------------------------

# sampling -> (pgroup bytes, pixels per pgroup)
RAW_SAMPLINGS: Dict[str, Tuple[int, int]] = {
    "RGB": (3, 1),
    "BGR": (3, 1),
    "RGBA": (4, 1),
    "BGRA": (4, 1),
    "YCbCr-4:2:2": (4, 2),   # Cb0 Y0 Cr0 Y1 == this package's UYVY bytes
}

# this framework's VideoFormat -> RFC 4175 sampling
FORMAT_TO_SAMPLING = {
    "RGB": "RGB", "BGR": "BGR", "RGBA": "RGBA", "BGRA": "BGRA",
    "UYVY": "YCbCr-4:2:2",
}
SAMPLING_TO_FORMAT = {v: k for k, v in FORMAT_TO_SAMPLING.items()}


def _frame_rows(frame: np.ndarray, sampling: str, width: int) -> np.ndarray:
    """[H, ...] frame -> [H, row_bytes] uint8 view in wire order."""
    pgroup, px = RAW_SAMPLINGS[sampling]
    row_bytes = width * pgroup // px
    return np.ascontiguousarray(frame).reshape(frame.shape[0], row_bytes)


class RawVideoPayloader:
    """RFC 4175 sections 4.2/4.3: 2-byte extended seqnum + per-segment
    line headers (length, F|line, C|offset), marker on frame end."""

    def __init__(self, sampling: str, width: int, height: int,
                 pt: int = 96, ssrc: int = 0x52415756, mtu: int = 1400,
                 base_seq: int = 0):
        if sampling not in RAW_SAMPLINGS:
            raise ValueError(f"rtpnet: unsupported sampling {sampling}")
        self.sampling = sampling
        self.width = width
        self.height = height
        self.pt = pt
        self.ssrc = ssrc
        self.mtu = mtu
        self.seq32 = base_seq & 0xFFFFFFFF
        self.packet_count = 0
        self.octet_count = 0
        self.pgroup, self.px_per_group = RAW_SAMPLINGS[sampling]
        self.row_bytes = width * self.pgroup // self.px_per_group

    def pay_frame(self, frame: np.ndarray, ts90: int) -> List[RtpPacket]:
        rows = _frame_rows(frame, self.sampling, self.width)
        assert rows.shape == (self.height, self.row_bytes)
        pkts = []
        line = 0
        offset_px = 0
        budget = self.mtu - 12 - 2  # rtp header + extended seq
        while line < self.height:
            segs: List[Tuple[int, int, int]] = []  # (line, off_px, length)
            room = budget
            while line < self.height:
                # each further segment costs a 6-byte header
                room_here = room - 6
                if room_here < self.pgroup:
                    break
                left_px = self.width - offset_px
                left_bytes = left_px * self.pgroup // self.px_per_group
                take = min(room_here, left_bytes)
                take -= take % self.pgroup
                if take <= 0:
                    break
                segs.append((line, offset_px, take))
                room -= 6 + take
                taken_px = take * self.px_per_group // self.pgroup
                offset_px += taken_px
                if offset_px >= self.width:
                    offset_px = 0
                    line += 1
            if not segs:
                raise ValueError("rtpnet: mtu too small for one pgroup")
            hdr = struct.pack(">H", (self.seq32 >> 16) & 0xFFFF)
            body = b""
            for i, (ln, off, length) in enumerate(segs):
                cont = 0x8000 if i + 1 < len(segs) else 0
                hdr += struct.pack(">HHH", length, ln & 0x7FFF,
                                   cont | (off & 0x7FFF))
                start = off * self.pgroup // self.px_per_group
                body += rows[ln, start:start + length].tobytes()
            payload = hdr + body
            pkts.append(RtpPacket(payload_type=self.pt,
                                  seq=self.seq32 & 0xFFFF,
                                  timestamp=ts90 & 0xFFFFFFFF,
                                  ssrc=self.ssrc,
                                  marker=line >= self.height,
                                  payload=payload))
            self.seq32 = (self.seq32 + 1) & 0xFFFFFFFF
            self.packet_count += 1
            self.octet_count += len(payload)
        return pkts


class RawVideoDepayloader:
    """Reassembles frames keyed by RTP timestamp; a frame completes on
    its marker packet.  Incomplete frames (loss) are dropped and counted
    when a newer timestamp completes."""

    def __init__(self, sampling: str, width: int, height: int):
        self.sampling = sampling
        self.width = width
        self.height = height
        self.pgroup, self.px_per_group = RAW_SAMPLINGS[sampling]
        self.row_bytes = width * self.pgroup // self.px_per_group
        self._frames: Dict[int, Tuple[np.ndarray, int]] = {}
        self.num_dropped = 0

    def depay(self, pkt: RtpPacket) -> List[Tuple[int, np.ndarray]]:
        # a frame's buffer is made once, by its first packet
        entry = self._frames.get(pkt.timestamp)
        if entry is None:
            entry = (np.zeros((self.height, self.row_bytes), np.uint8), 0)
        buf, filled = entry
        data = pkt.payload
        pos = 2  # extended seqnum
        segs = []
        while True:
            length, fline, coff = struct.unpack_from(">HHH", data, pos)
            pos += 6
            segs.append((length, fline & 0x7FFF, coff & 0x7FFF))
            if not coff & 0x8000:
                break
        for length, line, off_px in segs:
            start = off_px * self.pgroup // self.px_per_group
            if line < self.height and start + length <= self.row_bytes:
                buf[line, start:start + length] = np.frombuffer(
                    data, np.uint8, length, pos)
                filled += length
            pos += length
        self._frames[pkt.timestamp] = (buf, filled)
        if not pkt.marker:
            return []
        total = self.height * self.row_bytes
        done: List[Tuple[int, np.ndarray]] = []
        if filled >= total:
            done.append((pkt.timestamp, buf))
        else:
            self.num_dropped += 1
        # discard this frame + stale partials older than it
        for ts in [t for t in self._frames
                   if ((pkt.timestamp - t) & 0xFFFFFFFF) < 0x80000000]:
            if ts != pkt.timestamp and self._frames[ts][1] < total:
                self.num_dropped += 1
            self._frames.pop(ts, None)
        return done


# ---------------------------------------------------------------------------
# RTCP (RFC 3550 section 6): SR / RR / SDES / BYE
# ---------------------------------------------------------------------------

NTP_EPOCH_OFFSET = 2208988800  # 1900 -> 1970


def unix_to_ntp64(t: float) -> int:
    sec = int(t) + NTP_EPOCH_OFFSET
    frac = int((t - int(t)) * (1 << 32)) & 0xFFFFFFFF
    return (sec << 32) | frac


@dataclass
class RtcpSR:
    ssrc: int = 0
    ntp: int = 0
    rtp_ts: int = 0
    packet_count: int = 0
    octet_count: int = 0

    def serialize(self) -> bytes:
        return struct.pack(">BBHIQIII", 0x80, 200, 6, self.ssrc,
                           self.ntp, self.rtp_ts & 0xFFFFFFFF,
                           self.packet_count, self.octet_count)


@dataclass
class RtcpRR:
    ssrc: int = 0
    source_ssrc: int = 0
    fraction_lost: int = 0
    cum_lost: int = 0
    ext_highest_seq: int = 0
    jitter: int = 0
    lsr: int = 0
    dlsr: int = 0

    def serialize(self) -> bytes:
        lost24 = self.cum_lost & 0xFFFFFF
        return struct.pack(">BBH I IIIIII", 0x81, 201, 7, self.ssrc,
                           self.source_ssrc,
                           (self.fraction_lost << 24) | lost24,
                           self.ext_highest_seq, self.jitter,
                           self.lsr, self.dlsr)


def rtcp_sdes_cname(ssrc: int, cname: str) -> bytes:
    item = bytes([1, len(cname)]) + cname.encode()
    chunk = struct.pack(">I", ssrc) + item + b"\x00"
    while len(chunk) % 4:
        chunk += b"\x00"
    return struct.pack(">BBH", 0x81, 202, len(chunk) // 4) + chunk


def rtcp_bye(ssrc: int) -> bytes:
    return struct.pack(">BBH I", 0x81, 203, 1, ssrc)


def parse_rtcp(data: bytes) -> List[dict]:
    """Compound RTCP packet -> list of dicts (type: sr/rr/sdes/bye)."""
    out = []
    pos = 0
    while pos + 4 <= len(data):
        b0, pt, words = struct.unpack_from(">BBH", data, pos)
        plen = 4 * (words + 1)
        body = data[pos + 4:pos + plen]
        rc = b0 & 0x1F
        if pt == 200 and len(body) >= 24:
            ssrc, ntp, rtp_ts, pc, oc = struct.unpack_from(">IQIII",
                                                           body, 0)
            out.append({"type": "sr", "ssrc": ssrc, "ntp": ntp,
                        "rtp_ts": rtp_ts, "packet_count": pc,
                        "octet_count": oc})
        elif pt == 201:
            rep = []
            for i in range(rc):
                (sssrc, lost, hseq, jit, lsr, dlsr
                 ) = struct.unpack_from(">IIIIII", body, 4 + 24 * i)
                rep.append({"source_ssrc": sssrc,
                            "fraction_lost": lost >> 24,
                            "cum_lost": lost & 0xFFFFFF,
                            "ext_highest_seq": hseq, "jitter": jit,
                            "lsr": lsr, "dlsr": dlsr})
            out.append({"type": "rr",
                        "ssrc": struct.unpack_from(">I", body)[0],
                        "reports": rep})
        elif pt == 202:
            p = 0
            for _ in range(rc):
                if p + 4 > len(body):
                    break
                items = {}
                ssrc = struct.unpack_from(">I", body, p)[0]
                p += 4
                while p < len(body) and body[p] != 0:
                    t, ln = body[p], body[p + 1]
                    items[t] = body[p + 2:p + 2 + ln]
                    p += 2 + ln
                p += 1
                while p % 4:
                    p += 1
                out.append({"type": "sdes", "ssrc": ssrc,
                            "cname": items.get(1, b"").decode("utf-8",
                                                              "replace")})
        elif pt == 203:
            for i in range(rc):
                out.append({"type": "bye", "ssrc": struct.unpack_from(
                    ">I", body, 4 * i)[0]})
        pos += plen
    return out


# ---------------------------------------------------------------------------
# RIST TR-06-1 simple profile (gst/rist/): NACKs + verbatim rtx
# ---------------------------------------------------------------------------
# Retransmissions resend the original packet VERBATIM with SSRC+1 — the
# default SSRCs keep the LSB 0 so rtx is distinguishable
# (gstristrtxsend.c:355-370).  Receivers request losses as either RTCP
# APP packets named "RIST" whose data words are (seq16 << 16 |
# range_size), or RFC 4585 generic NACK (RTPFB FMT=1, PID+BLP pairs) —
# whichever takes fewer entries (gst_rist_src_on_sending_nacks,
# gstristsrc.c:264-352).  NACK receivers clear the SSRC LSB before the
# lookup (gstristsink.c:341-344).


def rtcp_app_rist_nack(media_ssrc: int, ranges: List[Tuple[int, int]]
                       ) -> bytes:
    """APP 'RIST' subtype-0 range NACK: (first_seq, range_size) pairs —
    range_size EXTRA packets after first_seq."""
    data = b"".join(struct.pack(">I", ((s & 0xFFFF) << 16) | (r & 0xFFFF))
                    for s, r in ranges)
    words = 2 + len(ranges)  # ssrc + name + data
    return struct.pack(">BBH", 0x80, 204, words) + \
        struct.pack(">I", media_ssrc) + b"RIST" + data


def rtcp_rtpfb_nack(sender_ssrc: int, media_ssrc: int,
                    pairs: List[Tuple[int, int]]) -> bytes:
    """RFC 4585 transport-layer NACK: (PID, BLP bitmask) pairs."""
    fci = b"".join(struct.pack(">HH", pid & 0xFFFF, blp & 0xFFFF)
                   for pid, blp in pairs)
    words = 2 + len(pairs)
    return struct.pack(">BBH", 0x81, 205, words) + \
        struct.pack(">II", sender_ssrc, media_ssrc) + fci


def parse_rist_nacks(data: bytes) -> List[Tuple[int, List[int]]]:
    """All NACKed seqnums per media ssrc (LSB cleared) in a compound
    RTCP datagram — both the RIST range form and generic NACK."""
    out: List[Tuple[int, List[int]]] = []
    pos = 0
    while pos + 4 <= len(data):
        b0, pt, words = struct.unpack_from(">BBH", data, pos)
        plen = 4 * (words + 1)
        body = data[pos + 4:pos + plen]
        if pt == 204 and len(body) >= 8 and body[4:8] == b"RIST" \
                and (b0 & 0x1F) == 0:
            ssrc = struct.unpack_from(">I", body)[0] & 0xFFFFFFFE
            seqs = []
            for off in range(8, len(body) - 3, 4):
                w = struct.unpack_from(">I", body, off)[0]
                first, rng = w >> 16, w & 0xFFFF
                seqs += [(first + k) & 0xFFFF for k in range(rng + 1)]
            out.append((ssrc, seqs))
        elif pt == 205 and (b0 & 0x1F) == 1 and len(body) >= 8:
            ssrc = struct.unpack_from(">I", body, 4)[0] & 0xFFFFFFFE
            seqs = []
            for off in range(8, len(body) - 3, 4):
                pid, blp = struct.unpack_from(">HH", body, off)
                seqs.append(pid)
                for bit in range(16):
                    if blp & (1 << bit):
                        seqs.append((pid + bit + 1) & 0xFFFF)
            out.append((ssrc, seqs))
        pos += plen
    return out


def build_nacks(sender_ssrc: int, media_ssrc: int,
                seqs: List[int]) -> bytes:
    """The receiver's chooser (gstristsrc.c:264-352): encode `seqs`
    (ascending 16-bit, consecutive-aware) as range NACKs unless the
    generic-NACK encoding takes no more entries."""
    if not seqs:
        return b""
    # range nacks
    ranges: List[Tuple[int, int]] = []
    start = prev = seqs[0]
    for s in seqs[1:]:
        if ((s - prev) & 0xFFFF) == 1:
            prev = s
            continue
        ranges.append((start, (prev - start) & 0xFFFF))
        start = prev = s
    ranges.append((start, (prev - start) & 0xFFFF))
    # generic nacks it would take (16-seq windows; gstristsrc.c:329-338)
    n_fb = 1
    base = seqs[0]
    for s in seqs[1:]:
        if ((s - base) & 0xFFFF) > 16:
            n_fb += 1
            base = s
    if n_fb <= len(ranges):
        pairs: List[Tuple[int, int]] = []
        base = None
        blp = 0
        for s in seqs:
            if base is None or ((s - base) & 0xFFFF) > 16:
                if base is not None:
                    pairs.append((base, blp))
                base, blp = s, 0
            elif s != base:
                blp |= 1 << (((s - base) & 0xFFFF) - 1)
        pairs.append((base, blp))
        return rtcp_rtpfb_nack(sender_ssrc, media_ssrc, pairs)
    return rtcp_app_rist_nack(media_ssrc, ranges)


class RistRtxHistory:
    """Sender-side packet history (gstristrtxsend.c SSRCRtxData): keeps
    the serialized original packets by extended seqnum, bounded by
    max_packets; answers NACKs with the verbatim datagram, SSRC+1."""

    def __init__(self, max_packets: int = 4096):
        self.max_packets = max_packets
        self._q: Dict[int, bytes] = {}
        self._ext = 0
        self._last_seq: Optional[int] = None
        self.num_rtx_requests = 0
        self.num_rtx_packets = 0

    def store(self, pkt: RtpPacket) -> None:
        if self._last_seq is not None:
            self._ext += (pkt.seq - self._last_seq) & 0xFFFF
        self._last_seq = pkt.seq
        self._q[self._ext] = pkt.serialize()
        if len(self._q) > self.max_packets:
            del self._q[min(self._q)]

    def lookup(self, seq: int) -> Optional[bytes]:
        """Verbatim retransmission datagram with SSRC+1, or None if the
        seq has aged out of the history."""
        self.num_rtx_requests += 1
        # unwrap against the newest stored ext seq
        delta = ((seq - (self._ext & 0xFFFF) + 0x8000) & 0xFFFF) - 0x8000
        ext = self._ext + delta
        raw = self._q.get(ext)
        if raw is None:
            return None
        self.num_rtx_packets += 1
        ssrc = struct.unpack_from(">I", raw, 8)[0]
        return raw[:8] + struct.pack(">I", (ssrc + 1) & 0xFFFFFFFF) \
            + raw[12:]


class RistNackTracker:
    """Receiver-side loss tracker: missing ext-seqs age `reorder_section`
    ms before their first NACK, then re-request at the same spacing up to
    max_retries (gstristsrc.c receiver properties)."""

    def __init__(self, reorder_section_ms: int = 70, max_retries: int = 7):
        self.reorder = reorder_section_ms / 1000.0
        self.max_retries = max_retries
        self._missing: Dict[int, Tuple[float, int]] = {}  # ext -> (t, n)
        self.num_lost_recovered = 0

    def observe_gap(self, ext_seqs: List[int],
                    now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        for e in ext_seqs:
            self._missing.setdefault(e, (now, 0))

    def observe_arrival(self, ext_seq: int) -> None:
        if ext_seq in self._missing:
            self.num_lost_recovered += 1
            del self._missing[ext_seq]

    def due(self, now: Optional[float] = None) -> List[int]:
        """Ext seqs whose (next) NACK is due; bumps retry counters and
        drops entries past max_retries."""
        now = time.monotonic() if now is None else now
        out = []
        for e in sorted(self._missing):
            t, n = self._missing[e]
            if now - t >= self.reorder:
                if n >= self.max_retries:
                    del self._missing[e]
                    continue
                out.append(e)
                self._missing[e] = (now, n + 1)
        return out
