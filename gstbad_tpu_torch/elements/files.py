"""File endpoints — filesink (raw), multifilesink (one file per frame),
y4mfilesrc and y4mfilesink (YUV4MPEG2 through io/y4m.py)."""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.io import y4m


@register
class FileSink(Element):
    """Write raw frame bytes (videoparse/audioparse-compatible)."""

    NAME = "filesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.raw", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._fh = None

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        if self._fh is None:
            self._fh = open(self.props["location"], "wb")
        data = np_batch.data
        for i in range(np_batch.batch):
            if isinstance(data, dict):
                for k in ("y", "u", "v", "a"):
                    if k in data:
                        self._fh.write(np.ascontiguousarray(
                            data[k][i]).tobytes())
            else:
                self._fh.write(np.ascontiguousarray(data[i]).tobytes())
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@register
class MultiFileSink(Element):
    """multifilesink analog: location printf-pattern, one file per frame."""

    NAME = "multifilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "frame%05d.raw", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._index = 0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        data = np_batch.data
        for i in range(np_batch.batch):
            path = self.props["location"] % self._index
            with open(path, "wb") as f:
                if isinstance(data, dict):
                    for k in sorted(data):
                        f.write(np.ascontiguousarray(data[k][i]).tobytes())
                else:
                    f.write(np.ascontiguousarray(data[i]).tobytes())
            self._index += 1


@register
class Y4mFileSrc(Element):
    """y4mdec analog (gst/y4m/gsty4mdec.c) as a file source: parse the
    YUV4MPEG2 header into the MediaSpec (caps) and emit I420 planar
    windows (io/y4m.py parses the bytes; a window goes to the device in
    one copy)."""

    NAME = "y4mfilesrc"
    KIND = "host-source"
    PROPERTIES = (Property("location", str, "in.y4m", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._planes = None
        self._pos = 0

    def negotiate(self, in_spec):
        spec, self._planes = y4m.read_y4m(self.props["location"])
        self._n = next(iter(self._planes.values())).shape[0]
        self._dur = spec.frame_duration_ns
        return spec

    def pull_window(self, window: int):
        if self._pos >= self._n:
            return None
        n = min(window, self._n - self._pos)
        frames = [{k: v[i] for k, v in self._planes.items()}
                  for i in range(self._pos, self._pos + n)]
        pts = (self._pos + np.arange(n, dtype=np.int64)) * self._dur
        self._pos += n
        return upload_frames(self.device, frames, pts=pts,
                             flags=np.zeros(n, np.int32),
                             valid=np.ones(n, bool))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos

    def process(self, params, state, batch):
        return state, batch


@register
class Y4mFileSink(Element):
    """y4m writer endpoint (the gst-good y4menc ! filesink chain analog;
    pairs with y4mfilesrc for launch-string y4m io).  The file is written
    at close()."""

    NAME = "y4mfilesink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("location", str, "out.y4m", static=True),)

    def __init__(self, **props):
        super().__init__(**props)
        self._frames = []

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "y4mfilesink: needs I420 (use videoconvert)")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        valid = np.asarray(np_batch.valid)
        data = {k: np.asarray(v)[valid] for k, v in np_batch.data.items()}
        if data["y"].shape[0]:
            self._frames.append(data)

    def close(self):
        if self._frames:
            merged = {k: np.concatenate([f[k] for f in self._frames])
                      for k in self._frames[0]}
            y4m.write_y4m(self.props["location"], self.out_spec, merged)
            self._frames = []
