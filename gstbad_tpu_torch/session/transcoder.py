"""Transcoder — the GstTranscoder analog (gst-libs/gst/transcoder/).

The reference wraps uritranscodebin (decodebin3 -> profile encoders -> mux)
with position signals; the output shape is chosen by a serialized
GstEncodingProfile ("container:videocaps[:audiocaps]").  Here the profile
string selects the output:

    "y4m"            I420 YUV4MPEG2 (default)
    "y4m:FMT"        force an output format (appends videoconvert)

The pnm, gdp, hevc and av1 profiles of the JAX package are not ported yet
and raise.  Input: .y4m files, fed through an appsrc; the graph runs on
`device` ("cuda", the default, or "cpu"; a CUDA request without a card
raises).  Progress posts `position` messages and calls the optional
on_position callback, like GstTranscoder's signals.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.pipeline import parse_launch
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.io import y4m

NOT_PORTED = ("pnm", "gdp", "hevc", "av1")


class Transcoder:
    def __init__(self, src_uri: str, dest_uri: str, filters: str = "",
                 window: int = 8, profile: str = "y4m",
                 on_position: Optional[Callable[[int, int], None]] = None,
                 device="cuda"):
        self.src_uri = src_uri
        self.dest_uri = dest_uri
        self.filters = filters.strip()
        self.window = window
        self.on_position = on_position
        container, _, fmt = profile.partition(":")
        self.container = container or "y4m"
        if self.container in NOT_PORTED:
            raise ValueError(f"profile container {self.container!r} is not "
                             "ported yet (not yet ported: "
                             f"{', '.join(NOT_PORTED)}); use y4m[:FMT]")
        if self.container != "y4m":
            raise ValueError(f"unknown profile container {container!r}; "
                             "known: y4m")
        if not src_uri.endswith(".y4m"):
            raise ValueError("transcoder reads .y4m input")
        self.out_format = fmt or None
        desc = "appsrc name=tsrc"
        if self.filters:
            desc += " ! " + self.filters
        if self.out_format:
            desc += f" ! videoconvert format={self.out_format}"
        desc += " ! appsink"
        self.pipeline = parse_launch(desc, device=device)

    @property
    def bus(self):
        return self.pipeline.bus

    def _read_input(self):
        spec, planes = y4m.read_y4m(self.src_uri)
        src = self.pipeline.get_by_name("tsrc")
        src.props["kind"] = "video"
        src.props["format"] = VideoFormat.I420
        src.props["width"] = spec.width
        src.props["height"] = spec.height
        src.props["framerate"] = (f"{spec.framerate.numerator}/"
                                  f"{spec.framerate.denominator}")
        src.push_frames(planes)
        return spec, planes["y"].shape[0]

    def run(self) -> int:
        """Transcode to completion; returns the number of frames written."""
        spec, n = self._read_input()
        out_spec = self.pipeline.negotiate()
        total_ns = int(n * spec.frame_duration_ns)
        outs = self.pipeline.run(window=self.window)
        batches = outs if isinstance(outs, list) else outs[0]
        written = 0
        sink_planes = {"y": [], "u": [], "v": []}
        for b in batches:
            if not isinstance(b.data, dict):
                raise ValueError(
                    f"y4m profile needs planar output; pipeline "
                    f"produced {out_spec}; add `videoconvert format=I420`")
            for k in sink_planes:
                sink_planes[k].append(b.data[k])
            written += b.batch
            pos = int(b.pts[-1]) if b.batch else 0
            if self.on_position:
                self.on_position(pos, total_ns)
            self.bus.post(Message("transcoder", "position", pos,
                                  {"position": pos, "duration": total_ns}))
        merged = {k: np.concatenate(v) for k, v in sink_planes.items()}
        y4m.write_y4m(self.dest_uri, out_spec, merged)
        return written
