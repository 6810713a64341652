"""rtpsrc / rtpsink — gst/rtp/gstrtpsrc.c + gstrtpsink.c over real UDP.

The reference pair are URI-handler bins (rtp://host:port?prop=value)
wiring udpsrc/udpsink into rtpbin: RTP rides the configured (even) port,
RTCP the next one (gstrtpsrc.c:221-230 — an odd RTP port only warns),
query-string keys set properties (gstrtp-utils.c:41-75), the source
resolves pt->caps as explicit caps > encoding-name > static table
(gstrtpsrc.c:118-160) and reorders through a jitterbuffer
(latency default 200 ms, gstrtpsrc.c:63); the sink payloads upstream
buffers and emits RTCP sender reports.

Here rtpsink is a HOST sink (payload + sendto happen on the host thread
after each device window) and rtpsrc a host source (drain socket ->
jitter buffer -> depayload -> one upload of the window to the
pipeline's device).  The payload formats are L16 audio, RFC 4175 raw
video (RGB/BGR/RGBA/BGRA/UYVY) and MP2T bytes for the mpegtsmux/tsdemux
pairing (gstbad_tpu_torch/io/rtpnet.py).  Multicast addresses join the
group with the ttl-mc TTL like udpsrc/udpsink.

A port of the JAX package's elements/rtp.py, with two corrections: each
rtp:// query value is coerced through its Property (gstrtp-utils.c sets
it as a GObject property, so "timeout=2.0" is a float), and the RTCP
sender report of raw video carries the 90 kHz RTP timestamp of the last
frame sent (RFC 3550 6.4.1), not a packet counter.
"""

from __future__ import annotations

import socket
import struct
import time
from fractions import Fraction
from typing import List, Optional

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import (AudioFormat, MediaSpec, VideoFormat,
                                  require)
from gstbad_tpu_torch.io import rtpnet
from gstbad_tpu_torch.io.rtp import RtpPacket


def _is_multicast(addr: str) -> bool:
    try:
        first = int(addr.split(".")[0])
    except ValueError:
        return False
    return 224 <= first <= 239


def _apply_uri(el: Element) -> None:
    """PROP_URI semantics (gstrtpsrc.c:195-209): host/port from the
    authority, every query key set as a property, coerced as
    g_object_set would (through the element's Property)."""
    props = el.props
    uri = props.get("uri")
    if not uri:
        return
    host, port, query = rtpnet.parse_rtp_uri(uri)
    props["address"] = host
    props["port"] = port
    for k, v in query.items():
        if k in el._propspecs:
            props[k] = el._propspecs[k].coerce(v)
        elif k == "pt":
            props[k] = int(v)
        elif k in ("encoding-name", "caps"):
            props[k] = v


class _RtpIo:
    """Socket pair (RTP on port, RTCP on port+1) with an injectable
    transport for tests."""

    def __init__(self):
        self.rtp_sock: Optional[socket.socket] = None
        self.rtcp_sock: Optional[socket.socket] = None

    def open_recv(self, address: str, port: int):
        for which, p in (("rtp", port), ("rtcp", port + 1)):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if _is_multicast(address):
                s.bind(("", p))
                mreq = struct.pack("4s4s", socket.inet_aton(address),
                                   socket.inet_aton("0.0.0.0"))
                s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                             mreq)
            else:
                s.bind((address, p))
            s.setblocking(False)
            setattr(self, f"{which}_sock", s)

    def open_send(self, address: str, port: int, ttl: int, ttl_mc: int):
        for which in ("rtp", "rtcp"):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            if _is_multicast(address):
                s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                             ttl_mc)
            else:
                s.setsockopt(socket.IPPROTO_IP, socket.IP_TTL, ttl)
            setattr(self, f"{which}_sock", s)
        self.dest = (address, port)
        self.rtcp_dest = (address, port + 1)

    def close(self):
        for s in (self.rtp_sock, self.rtcp_sock):
            if s is not None:
                s.close()
        self.rtp_sock = self.rtcp_sock = None


@register
class RtpSink(Element):
    NAME = "rtpsink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (
        Property("uri", str, "", static=True),
        Property("address", str, "0.0.0.0", static=True),
        Property("port", int, 5004, 1, 65535, static=True),
        Property("ttl", int, 64, 0, 255, static=True),
        Property("ttl-mc", int, 1, 0, 255, static=True),
        Property("multicast-iface", str, "", static=True),
        Property("pt", int, 96, 0, 127, static=True),
        Property("ssrc", int, 0, 0, None, static=True),
        Property("mtu", int, 1400, 64, 65535, static=True),
        Property("rtcp-interval", float, 5.0, 0.0, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        _apply_uri(self)
        self._io = _RtpIo()
        self._pay = None
        self._opened = False
        self._last_sr = 0.0
        self._clock_rate = 90000
        self._ssrc = self.props["ssrc"] or 0x47535442
        self._last_ts90 = 0

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = in_spec
        if spec.kind == "video":
            require(spec.format in rtpnet.FORMAT_TO_SAMPLING,
                    f"rtpsink: no RFC 4175 sampling for {spec.format} "
                    "(use videoconvert to RGB/BGR/RGBA/BGRA/UYVY)")
            sampling = rtpnet.FORMAT_TO_SAMPLING[spec.format]
            self._pay = rtpnet.RawVideoPayloader(
                sampling, spec.width, spec.height, pt=self.props["pt"],
                ssrc=self._ssrc, mtu=self.props["mtu"])
            self._clock_rate = 90000
        else:
            require(spec.kind == "audio"
                    and spec.format == AudioFormat.S16,
                    "rtpsink: audio must be S16 (L16 on the wire)")
            self._pay = rtpnet.L16Payloader(
                spec.rate, spec.channels, pt=self.props["pt"],
                ssrc=self._ssrc, mtu=self.props["mtu"])
            self._clock_rate = spec.rate
        return spec

    def _ensure_open(self):
        if not self._opened:
            self._io.open_send(self.props["address"], self.props["port"],
                               self.props["ttl"], self.props["ttl-mc"])
            self._opened = True

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        self._ensure_open()
        valid = np.asarray(np_batch.valid)
        pts = np.asarray(np_batch.pts)
        pkts: List[RtpPacket] = []
        if isinstance(self._pay, rtpnet.RawVideoPayloader):
            data = np.asarray(np_batch.data)
            for i in np.nonzero(valid)[0]:
                ts90 = int(pts[i]) * 90000 // 1_000_000_000
                pkts += self._pay.pay_frame(data[i], ts90)
                self._last_ts90 = ts90 & 0xFFFFFFFF
        else:
            data = np.asarray(np_batch.data)
            for i in np.nonzero(valid)[0]:
                pkts += self._pay.pay(data[i])
        for p in pkts:
            self._io.rtp_sock.sendto(p.serialize(), self._io.dest)
        now = time.monotonic()
        if now - self._last_sr >= self.props["rtcp-interval"]:
            self._send_sr()
            self._last_sr = now

    def _send_sr(self):
        sr = rtpnet.RtcpSR(
            ssrc=self._ssrc, ntp=rtpnet.unix_to_ntp64(time.time()),
            rtp_ts=getattr(self._pay, "ts", self._last_ts90),
            packet_count=self._pay.packet_count,
            octet_count=self._pay.octet_count)
        pkt = sr.serialize() + rtpnet.rtcp_sdes_cname(
            self._ssrc, "gstbad-tpu@rtpsink")
        self._io.rtcp_sock.sendto(pkt, self._io.rtcp_dest)

    def close(self):
        if self._opened:
            try:
                self._io.rtcp_sock.sendto(rtpnet.rtcp_bye(self._ssrc),
                                          self._io.rtcp_dest)
            except OSError:
                pass
            self._io.close()
            self._opened = False


@register
class RtpSrc(Element):
    NAME = "rtpsrc"
    KIND = "host-source"
    PROPERTIES = (
        Property("uri", str, "", static=True),
        Property("address", str, "0.0.0.0", static=True),
        Property("port", int, 5004, 1, 65535, static=True),
        Property("ttl", int, 64, 0, 255, static=True),
        Property("ttl-mc", int, 1, 0, 255, static=True),
        Property("multicast-iface", str, "", static=True),
        Property("encoding-name", str, "", static=True),
        Property("caps", str, "", static=True),
        Property("latency", int, 200, 0, None, static=True),
        Property("timeout", float, 5.0, 0.0, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        _apply_uri(self)
        self._io = _RtpIo()
        self._jb = rtpnet.JitterBuffer(self.props["latency"])
        self._depay = None
        self._opened = False
        self._caps = self._parse_caps(self.props["caps"])
        self._frames: List[np.ndarray] = []
        self._pts: List[int] = []
        self._samples: List[np.ndarray] = []
        self._audio_pos = 0
        self._bytes_out: List[bytes] = []
        self._spec: Optional[MediaSpec] = None
        self._eos = False
        self.last_sr: Optional[dict] = None

    @staticmethod
    def _parse_caps(text: str) -> dict:
        """application/x-rtp,media=...,encoding-name=...,clock-rate=...
        (the PROP_CAPS full-caps override, gstrtpsrc.c:128-132)."""
        out = {}
        for part in text.split(","):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    def negotiate(self, in_spec) -> MediaSpec:
        caps = dict(self._caps)
        enc = caps.get("encoding-name", self.props["encoding-name"])
        if not enc:
            info = rtpnet.payload_info_for_pt(int(caps.get("payload", -1))
                                              ) if caps.get("payload") \
                else None
            require(info is not None,
                    "rtpsrc: need encoding-name or caps to negotiate")
            media, enc, rate, ch = info
            caps.setdefault("clock-rate", str(rate))
            if ch:
                caps.setdefault("channels", str(ch))
        enc = enc.upper()
        fr = Fraction(caps.get("framerate", "30/1").replace(":", "/"))
        if enc == "RAW":
            sampling = caps.get("sampling", "RGB")
            require(sampling in rtpnet.SAMPLING_TO_FORMAT,
                    f"rtpsrc: unsupported sampling {sampling}")
            w = int(caps.get("width", 0))
            h = int(caps.get("height", 0))
            require(w > 0 and h > 0,
                    "rtpsrc: RAW needs width/height in caps")
            self._depay = rtpnet.RawVideoDepayloader(sampling, w, h)
            self._spec = MediaSpec(
                kind="video", format=rtpnet.SAMPLING_TO_FORMAT[sampling],
                width=w, height=h, framerate=fr)
        elif enc == "L16":
            info = rtpnet.payload_info_for_name("L16")
            rate = int(caps.get("clock-rate", info[2]))
            ch = int(caps.get("channels", info[3]))
            self._depay = rtpnet.L16Depayloader(ch)
            self._spec = MediaSpec(kind="audio", format=AudioFormat.S16,
                                   rate=rate, channels=ch)
            self._block = int(caps.get("samplesperbuffer", 1024))
        elif enc == "MP2T":
            self._depay = rtpnet.Mp2tDepayloader()
            self._spec = MediaSpec(kind="bytes", format="video/mpegts")
        else:
            raise ValueError(f"rtpsrc: no native depayloader for {enc} "
                             "(L16, RAW, MP2T)")
        self._enc = enc
        return self._spec

    def open(self):
        if not self._opened:
            self._io.open_recv(self.props["address"], self.props["port"])
            self._opened = True

    def push_packet(self, pkt: RtpPacket) -> None:
        """Injected delivery (tests / non-socket transports)."""
        self._jb.insert(pkt)

    def event_eos(self):
        self._eos = True

    def _drain_socket(self, deadline: float) -> None:
        if not self._opened:
            return
        got_any = False
        while True:
            try:
                data, _ = self._io.rtp_sock.recvfrom(65536)
                self._jb.insert(RtpPacket.parse(data))
                got_any = True
            except BlockingIOError:
                if got_any or time.monotonic() >= deadline:
                    break
                time.sleep(0.002)
        try:
            while True:
                d, _ = self._io.rtcp_sock.recvfrom(65536)
                for item in rtpnet.parse_rtcp(d):
                    if item["type"] == "sr":
                        self.last_sr = item
                    elif item["type"] == "bye":
                        self._eos = True
        except BlockingIOError:
            pass

    def _depay_ready(self) -> None:
        pkts = self._jb.flush() if self._eos else self._jb.pop_ready()
        for p in pkts:
            if isinstance(self._depay, rtpnet.RawVideoDepayloader):
                for ts90, frame in self._depay.depay(p):
                    self._frames.append(frame)
                    self._pts.append(ts90 * 1_000_000_000 // 90000)
            elif isinstance(self._depay, rtpnet.L16Depayloader):
                self._samples.append(self._depay.depay(p))
            else:
                self._bytes_out.append(self._depay.depay(p))

    def pull_bytes(self) -> bytes:
        """MP2T mode: drained TS bytes (pairs with tsdemux.push_bytes)."""
        self._drain_socket(time.monotonic() + self.props["timeout"])
        self._depay_ready()
        out = b"".join(self._bytes_out)
        self._bytes_out = []
        return out

    def pull_window(self, window: int):
        deadline = time.monotonic() + self.props["timeout"]
        spec = self._spec
        if spec.kind == "video":
            while (len(self._frames) < window and not self._eos
                   and time.monotonic() < deadline):
                self._drain_socket(deadline)
                self._depay_ready()
            if not self._frames:
                return None
            n = min(window, len(self._frames))
            fshape = (spec.height, spec.width,
                      VideoFormat.n_channels(spec.format)) \
                if spec.format != VideoFormat.UYVY \
                else (spec.height, 2 * spec.width)
            frames = [f.reshape(fshape) for f in self._frames[:n]]
            pts = np.asarray(self._pts[:n], np.int64)
            del self._frames[:n], self._pts[:n]
            return upload_frames(self.device, frames, pts=pts,
                                 flags=np.zeros(n, np.int32),
                                 valid=np.ones(n, bool))
        # audio: re-block the sample stream into fixed windows
        need = self._block * window
        while (sum(s.shape[0] for s in self._samples) < need
               and not self._eos and time.monotonic() < deadline):
            self._drain_socket(deadline)
            self._depay_ready()
        if not self._samples:
            return None
        cat = np.concatenate(self._samples, axis=0)
        if cat.shape[0] == 0 or (cat.shape[0] < self._block
                                 and not self._eos):
            self._samples = [cat]
            return None
        n = min(window, max(1, cat.shape[0] // self._block)
                if not self._eos else -(-cat.shape[0] // self._block))
        take = min(cat.shape[0], n * self._block)
        used = cat[:take]
        pad = n * self._block - take
        if pad:
            used = np.concatenate(
                [used, np.zeros((pad, used.shape[1]), np.int16)])
        self._samples = [cat[take:]]
        data = used.reshape(n, self._block, -1)
        dur = self._block * 1_000_000_000 // spec.rate
        pts = np.arange(n, dtype=np.int64) * dur + self._audio_pos * dur
        self._audio_pos += n
        return upload_frames(self.device, list(data), pts=pts,
                             flags=np.zeros(n, np.int32),
                             valid=np.ones(n, bool))

    def process(self, params, state, batch):
        return state, batch

    def close(self):
        if self._opened:
            self._io.close()
            self._opened = False
