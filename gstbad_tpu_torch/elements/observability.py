"""Observability elements — fpsdisplaysink, videocodectestsink and
debugspy (gst/debugutils/)."""

from __future__ import annotations

import hashlib
import time

import numpy as np

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register


def frame_bytes(data, i: int) -> bytes:
    """The bytes of frame i of host data: planar planes in sorted key
    order, packed frames as they are (the flow log and checksum order)."""
    if isinstance(data, dict):
        return b"".join(np.ascontiguousarray(data[k][i]).tobytes()
                        for k in sorted(data))
    return np.ascontiguousarray(data[i]).tobytes()


@register
class FpsDisplaySink(Element):
    """fpsdisplaysink (gst/debugutils/fpsdisplaysink.c:80-91): rendered/
    dropped counts and min/max/avg fps, posted as `fps-measurements`."""

    NAME = "fpsdisplaysink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("fps-update-interval", int, 500),)  # ms

    def __init__(self, **props):
        super().__init__(**props)
        self.frames_rendered = 0
        self.frames_dropped = 0
        self._t0 = None
        self._last_update = None
        self._last_frames = 0
        self.min_fps = float("inf")
        self.max_fps = 0.0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = self._last_update = now
        self.frames_rendered += np_batch.batch
        interval = self.props["fps-update-interval"] / 1000.0
        if now - self._last_update >= interval:
            fps = ((self.frames_rendered - self._last_frames)
                   / (now - self._last_update))
            self.min_fps = min(self.min_fps, fps)
            self.max_fps = max(self.max_fps, fps)
            self._last_update = now
            self._last_frames = self.frames_rendered
            if bus is not None:
                elapsed = now - self._t0
                bus.post(Message(self.NAME, "fps-measurements",
                                 int(np_batch.pts[-1]),
                                 {"fps": fps,
                                  "drop-rate": 0.0,
                                  "avg-fps": self.frames_rendered / elapsed
                                  if elapsed else 0.0}))

    @property
    def average_fps(self):
        elapsed = time.monotonic() - self._t0 if self._t0 else 0
        return self.frames_rendered / elapsed if elapsed else 0.0


@register
class VideoCodecTestSink(Element):
    """videocodectestsink (gstvideocodectestsink.c:33-46,193-230): per-frame
    and whole-stream MD5 conformance checksums posted as `conformance`
    messages."""

    NAME = "videocodectestsink"
    KIND = "sink"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self._stream_md5 = hashlib.md5()
        self.frame_checksums = []

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        for i in range(np_batch.batch):
            blob = frame_bytes(np_batch.data, i)
            digest = hashlib.md5(blob).hexdigest()
            self._stream_md5.update(blob)
            self.frame_checksums.append(digest)
            if bus is not None:
                bus.post(Message(self.NAME, "conformance",
                                 int(np_batch.pts[i]),
                                 {"checksum": digest}))

    @property
    def stream_checksum(self) -> str:
        return self._stream_md5.hexdigest()


@register
class DebugSpy(Element):
    """debugspy: posts a buffer-info message per frame (PTS, flags,
    checksum-free)."""

    NAME = "debugspy"
    PROPERTIES = (Property("silent", bool, False),)

    def process(self, params, state, batch: FrameBatch):
        msgs = {"buffer-info": {
            "_emit": (~params["silent"]).expand(batch.batch),
            "flags": batch.flags,
        }}
        return state, batch, msgs
