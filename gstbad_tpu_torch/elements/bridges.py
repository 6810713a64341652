"""Pipeline-to-pipeline bridges — appsrc, inter* and proxy elements
(gst/inter/, gst/proxy/).

inter{video,audio}sink/src pairs bridge two pipelines in-process through a
named channel queue; proxysink/proxysrc do the same.  An appsrc is a
host-fed source the runner pulls outside the window step; it stacks each
window on the host and sends it to the pipeline's device in one copy.
gdppay/gdpdepay speak GDP 1.0 on bytes, on the host.
"""

from __future__ import annotations

import collections
import threading
from fractions import Fraction
from typing import Deque, Dict, Optional

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.io import gdp as _gdp


class Channel:
    """Named in-process frame queue (the inter/proxy transport)."""

    _registry: Dict[str, "Channel"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str, maxlen: Optional[int] = None):
        self.name = name
        self.queue: Deque[FrameBatch] = collections.deque(
            maxlen=maxlen) if maxlen else collections.deque()
        self.spec: Optional[MediaSpec] = None
        self.cv = threading.Condition()

    @classmethod
    def get(cls, name: str, maxlen: Optional[int] = None) -> "Channel":
        with cls._lock:
            if name not in cls._registry:
                cls._registry[name] = Channel(name, maxlen)
            return cls._registry[name]

    def push(self, batch: FrameBatch, spec: MediaSpec) -> None:
        with self.cv:
            self.spec = spec
            self.queue.append(batch)
            self.cv.notify_all()

    def pull(self, timeout: Optional[float] = None) -> Optional[FrameBatch]:
        with self.cv:
            if not self.queue and timeout:
                self.cv.wait(timeout)
            return self.queue.popleft() if self.queue else None


@register
class AppSrc(Element):
    """Host-fed source: push_frames() enqueues numpy frames; the runner
    pulls one window per step outside the window step."""

    NAME = "appsrc"
    KIND = "host-source"
    ELEMENTWISE = True
    PROPERTIES = (
        Property("format", str, "BGRx", static=True),
        Property("width", int, 320, static=True),
        Property("height", int, 240, static=True),
        Property("framerate", str, "30/1", static=True),
        Property("kind", str, "video", static=True),
        Property("rate", int, 48000, static=True),
        Property("channels", int, 2, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._frames = collections.deque()
        self._pts = 0

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        if self.props["kind"] == "audio":
            return MediaSpec(kind="audio", format=self.props["format"],
                             rate=self.props["rate"],
                             channels=self.props["channels"])
        num, _, den = self.props["framerate"].partition("/")
        return MediaSpec(kind="video", format=self.props["format"],
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(int(num), int(den or "1")))

    def push_frames(self, data, pts=None, flags=None) -> None:
        """Queue frames: a numpy [N, ...] array or {plane: [N, ...]}."""
        n = (next(iter(data.values())) if isinstance(data, dict)
             else data).shape[0]
        if pts is None:
            dur = self.out_spec.frame_duration_ns if self.out_spec else \
                int(1e9 / 30)
            pts = np.arange(self._pts, self._pts + n) * dur
            self._pts += n
        if flags is None:
            flags = np.zeros(n, np.int32)
        for i in range(n):
            frame = ({k: v[i] for k, v in data.items()}
                     if isinstance(data, dict) else data[i])
            self._frames.append((frame, int(pts[i]), int(flags[i])))

    # checkpoint/resume: the frame-index counter; the host-fed queue itself
    # is not serialized (the feeder pushes again after a restore)
    def save_position(self):
        return self._pts

    def restore_position(self, pos) -> None:
        self._pts = pos

    def pull_window(self, window: int) -> Optional[FrameBatch]:
        """Called by the runner: the next `window` frames on the device,
        a short last window padded with invalid copies of its last frame
        (None when nothing is queued)."""
        if not self._frames:
            return None
        taken = []
        while self._frames and len(taken) < window:
            taken.append(self._frames.popleft())
        n = len(taken)
        pad = window - n
        last = taken[-1]
        return upload_frames(
            self.device, [t[0] for t in taken] + [last[0]] * pad,
            pts=[t[1] for t in taken] + [last[1]] * pad,
            flags=[t[2] for t in taken] + [0] * pad,
            valid=[True] * n + [False] * pad)

    def process(self, params, state, batch):
        return state, batch


class _ChannelSink(Element):
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("channel", str, "default", static=True),)

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        Channel.get(self.props["channel"]).push(np_batch, self.out_spec)


class _ChannelSrc(AppSrc):
    PROPERTIES = AppSrc.PROPERTIES + (
        Property("channel", str, "default", static=True),)

    def pull_window(self, window: int) -> Optional[FrameBatch]:
        batch = Channel.get(self.props["channel"]).pull()
        if batch is None:
            return None
        self.push_frames(batch.data, pts=batch.pts, flags=batch.flags)
        return super().pull_window(window)


@register
class InterVideoSink(_ChannelSink):
    NAME = "intervideosink"


@register
class InterVideoSrc(_ChannelSrc):
    NAME = "intervideosrc"


@register
class InterAudioSink(_ChannelSink):
    NAME = "interaudiosink"


@register
class InterAudioSrc(_ChannelSrc):
    NAME = "interaudiosrc"


class SubSurface:
    """The inter sub channel surface (gst/inter/gstintersurface.c): a
    ONE-DEEP latest-value latch, not a queue — intersubsink's render
    replaces surface->sub_buffer (gstintersubsink.c render), and
    intersubsrc's create takes-and-clears it
    (gstintersubsrc.c:225-245)."""

    _registry: Dict[str, "SubSurface"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.sub_buffer: Optional[bytes] = None
        self.mutex = threading.Lock()

    @classmethod
    def get(cls, name: str) -> "SubSurface":
        with cls._lock:
            if name not in cls._registry:
                cls._registry[name] = SubSurface(name)
            return cls._registry[name]


@register
class InterSubSink(Element):
    """intersubsink (gst/inter/gstintersubsink.c): latches the latest
    text/plain buffer onto the named sub surface; an intersubsrc on the
    same channel picks it up.  Byte/host-domain element: feed with
    render()."""

    NAME = "intersubsink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("channel", str, "default", static=True),)

    def render(self, text) -> None:
        data = text.encode() if isinstance(text, str) else bytes(text)
        surface = SubSurface.get(self.props["channel"])
        with surface.mutex:
            surface.sub_buffer = data      # replace, never queue

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        # in-graph use: latch the bytes of the last valid frame
        mask = np.asarray(np_batch.valid)
        if mask.any():
            self.render(np.ascontiguousarray(
                np_batch.data[mask][-1]).tobytes())


@register
class InterSubSrc(Element):
    """intersubsrc (gst/inter/gstintersubsrc.c): pulls the latched
    buffer off the named sub surface, clearing the latch; when nothing
    is latched it emits a 1-byte zero buffer exactly like the
    reference's create (gstintersubsrc.c:247-256)."""

    NAME = "intersubsrc"
    KIND = "host-source"
    PROPERTIES = (Property("channel", str, "default", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self.n_frames = 0

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        return MediaSpec(kind="text", format="utf8")

    def create(self) -> bytes:
        surface = SubSurface.get(self.props["channel"])
        with surface.mutex:
            buffer = surface.sub_buffer
            surface.sub_buffer = None
        if buffer is None:
            buffer = b"\x00"               # gstintersubsrc.c:247-253
        self.n_frames += 1                 # buffer offset counter
        return buffer

    def process(self, params, state, batch):
        return state, batch


@register
class ProxySink(_ChannelSink):
    NAME = "proxysink"


@register
class ProxySrc(_ChannelSrc):
    NAME = "proxysrc"


@register
class GdpPay(Element):
    """gdppay (gst/gdp/gstgdppay.c) speaking REAL GDP 1.0: the first
    buffer is preceded by the caps packet; every buffer becomes a
    62-byte header + payload with optional header/payload CRCs
    (crc-header/crc-payload properties, the reference defaults TRUE
    header / FALSE payload).  A host byte element: io/gdp.py builds the
    packets."""

    NAME = "gdppay"
    KIND = "host-source"
    PROPERTIES = (
        Property("crc-header", bool, True, static=True),
        Property("crc-payload", bool, False, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._caps_sent = False
        self.caps = "application/x-gdp"

    def _flags(self) -> int:
        f = 0
        if self.props["crc-header"]:
            f |= _gdp.DP_FLAG_CRC_HEADER
        if self.props["crc-payload"]:
            f |= _gdp.DP_FLAG_CRC_PAYLOAD
        return f

    def set_caps(self, caps: str) -> None:
        self.caps = caps
        self._caps_sent = False

    def chain(self, data: bytes, pts: int = _gdp.CLOCK_TIME_NONE,
              duration: int = _gdp.CLOCK_TIME_NONE,
              buf_flags: int = 0) -> bytes:
        out = b""
        if not self._caps_sent:
            out += _gdp.dp_payload_caps(self.caps, self._flags())
            self._caps_sent = True
        out += _gdp.dp_payload_buffer(data, pts=pts, duration=duration,
                                      buf_flags=buf_flags,
                                      flags=self._flags())
        return out

    def event_eos(self) -> bytes:
        # GST_EVENT_EOS numeric group: gdppay serializes events as
        # payload type 64 + type; EOS keeps an empty structure
        return _gdp.dp_payload_event(1, "", flags=self._flags())

    def process(self, params, state, batch):
        return state, batch


@register
class GdpDepay(Element):
    """gdpdepay: incremental GDP 1.0 parser with CRC validation."""

    NAME = "gdpdepay"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self.caps = None
        self.events = []

    def chain(self, data: bytes):
        """Returns buffer packets; caps land in .caps, events in
        .events."""
        self._buf += data
        out = []
        consumed = 0
        try:
            pos = 0
            for pkt in _gdp.dp_depay(self._buf):
                pos += _gdp.DP_HEADER_LENGTH + len(pkt["payload"])
                consumed = pos
                if pkt["type"] == _gdp.DP_PAYLOAD_CAPS:
                    self.caps = pkt["payload"].rstrip(b"\x00").decode()
                elif pkt["type"] >= _gdp.DP_PAYLOAD_EVENT_NONE:
                    self.events.append(
                        pkt["type"] - _gdp.DP_PAYLOAD_EVENT_NONE)
                else:
                    out.append(pkt)
        finally:
            self._buf = self._buf[consumed:]
        return out

    def process(self, params, state, batch):
        return state, batch
