"""Transcoder — the GstTranscoder analog (gst-libs/gst/transcoder/).

The reference wraps uritranscodebin (decodebin3 -> profile encoders -> mux)
with position signals; the output shape is chosen by a serialized
GstEncodingProfile ("container:videocaps[:audiocaps]").  Here the profile
string selects the output:

    "y4m"            I420 YUV4MPEG2 (default)
    "y4m:FMT"        force an output format (appends videoconvert)
    "pnm"            P5/P6 image sequence (dest must contain a %d
                     pattern); "pnm:FMT" forces a GRAY8 or packed RGB
                     output format
    "gdp"            GDP packet stream (any negotiated format, caps on
                     the wire; "gdp:FMT" forces one)
    "hevc"           H.265 annex-B elementary stream via x265enc (libx265,
                     speed-preset ultrafast, tune zerolatency); options
                     "hevc:qp=N" or "hevc:lossless"; needs I420 reaching
                     the encoder
    "av1"            AV1 in an IVF container via av1enc (libaom, realtime
                     usage at cpu-used 8); option "av1:bitrate=N" (kbit/s)

The encoders run on the host over the windows the graph hands back, as in
the JAX package.  Inputs: .y4m files,
fed through an appsrc, or .gdp files, read by gdpfilesrc; the graph runs
on `device` ("cuda", the default, or "cpu"; a CUDA request without a card
raises).  Progress posts `position` messages and calls the optional
on_position callback, like GstTranscoder's signals.  Every output is byte
for byte the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.pipeline import parse_launch
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.io import gdp, y4m
from gstbad_tpu_torch.io.ivf import write_ivf
from gstbad_tpu_torch.io.pnm import write_pnm

PROFILES = ("y4m", "pnm", "gdp", "hevc", "av1")
CODECS = ("hevc", "av1")


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
        if self.container not in PROFILES:
            raise ValueError(f"unknown profile container {container!r}; "
                             f"known: {', '.join(PROFILES)}")
        if self.container == "pnm" and "%" not in dest_uri:
            raise ValueError("pnm profile writes an image sequence; "
                             "dest must contain a %d pattern")
        if not src_uri.endswith((".y4m", ".gdp")):
            raise ValueError("transcoder reads .y4m or .gdp input")
        codec = self.container in CODECS
        self.codec_opt = fmt if codec else None
        self.out_format = None if codec else (fmt or None)
        desc = ("gdpfilesrc name=tsrc location=" + src_uri
                if src_uri.endswith(".gdp") else "appsrc name=tsrc")
        if self.filters:
            desc += " ! " + self.filters
        if self.out_format:
            desc += f" ! videoconvert format={self.out_format}"
        if self.container == "hevc":
            enc = "x265enc name=tenc speed-preset=ultrafast " \
                  "tune=zerolatency"
            if self.codec_opt == "lossless":
                enc += " lossless=true"
            elif self.codec_opt and self.codec_opt.startswith("qp="):
                enc += f" qp={int(self.codec_opt[3:])}"
            desc += " ! " + enc
        elif self.container == "av1":
            enc = "av1enc name=tenc usage-profile=realtime cpu-used=8"
            if self.codec_opt and self.codec_opt.startswith("bitrate="):
                enc += f" target-bitrate={int(self.codec_opt[8:])}"
            desc += " ! " + enc
        desc += " ! appsink"
        self.pipeline = parse_launch(desc, device=device)

    @property
    def bus(self):
        return self.pipeline.bus

    def _read_input(self):
        """(input spec, frames) of a y4m input pushed into the appsrc;
        (None, None) for a .gdp input, whose length the stream gives."""
        if self.src_uri.endswith(".gdp"):
            return None, None
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
        total_ns = int(n * spec.frame_duration_ns) if spec is not None \
            else 0
        outs = self.pipeline.run(window=self.window)
        self.pipeline.close()        # drains an encoder's lookahead
        batches = outs if isinstance(outs, list) else outs[0]
        written = 0
        sink_planes = {"y": [], "u": [], "v": []}
        packed_frames = []
        gdp_blobs = []
        for b in batches:
            if self.container in CODECS:
                pass                 # the encoder keeps its packets
            elif self.container == "y4m":
                if not isinstance(b.data, dict):
                    raise ValueError(
                        f"y4m profile needs planar output; pipeline "
                        f"produced {out_spec}; add `videoconvert "
                        "format=I420` or use profile='gdp'/'pnm'")
                for k in sink_planes:
                    sink_planes[k].append(b.data[k])
            elif self.container == "pnm":
                if isinstance(b.data, dict):
                    raise ValueError("pnm profile needs GRAY8 or packed "
                                     "RGB output")
                packed_frames.append(b.data)
            else:
                gdp_blobs.append(gdp.pay(b, out_spec))
            written += b.batch
            pos = int(b.pts[-1]) if b.batch else 0
            if self.on_position:
                self.on_position(pos, total_ns)
            self.bus.post(Message("transcoder", "position", pos,
                                  {"position": pos, "duration": total_ns}))
        if self.container == "hevc":
            with open(self.dest_uri, "wb") as f:
                for _pts, d in self.pipeline.get_by_name("tenc").packets:
                    f.write(d)
        elif self.container == "av1":
            fr = out_spec.framerate
            write_ivf(self.dest_uri, b"AV01", out_spec.width,
                      out_spec.height, fr.numerator, fr.denominator,
                      [(i, d) for i, (_p, d) in enumerate(
                          self.pipeline.get_by_name("tenc").packets)])
        elif self.container == "y4m":
            merged = {k: np.concatenate(v) for k, v in sink_planes.items()}
            y4m.write_y4m(self.dest_uri, out_spec, merged)
        elif self.container == "pnm":
            offs = None
            if out_spec.format in VideoFormat.PACKED_RGB4 \
                    or out_spec.format in VideoFormat.PACKED_RGB3:
                offs = list(VideoFormat.rgb_offsets(out_spec.format)[:3])
            i = 0
            for chunk in packed_frames:
                for frame in chunk:
                    img = frame[..., offs] if offs and frame.ndim == 3 \
                        else frame
                    write_pnm(self.dest_uri % i, img)
                    i += 1
        else:
            with open(self.dest_uri, "wb") as f:
                for blob in gdp_blobs:
                    # gdpfilesink's framing: a length, then the packet
                    f.write(struct.pack("<Q", len(blob)))
                    f.write(blob)
        return written
