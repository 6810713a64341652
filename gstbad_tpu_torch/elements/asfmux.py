"""asfmux + asfparse elements (gst/asfmux/) over io/asf.py.

asfmux: request streams (connect_audio/connect_video), push timestamped
buffers, collect the ASF byte stream.  streamable=true keeps the
broadcast-flagged header as emitted (the reference's streamable mode,
gstasfmux.c:49-58); with streamable=false event_eos() returns the
FINALIZED stream with the header rewrite the reference performs by
seeking back (gst_asf_mux_stop_file, gstasfmux.c:1781-1878).

asfparse: aligns an ASF byte stream into the header blob + fixed-size
data packets (gstasfparse.c).

A port of the JAX package's elements/asfmux.py, on the host as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import asf as asf_io

NSEC = 1_000_000_000
MSEC = 1_000_000


@register
class AsfMuxElement(Element):
    NAME = "asfmux"
    KIND = "host-source"
    PROPERTIES = (
        Property("packet-size", int, asf_io.DEFAULT_PACKET_SIZE,
                 18, 2 ** 31 - 1, static=True),
        Property("preroll", int, asf_io.DEFAULT_PREROLL, 0, None,
                 static=True),
        Property("streamable", bool, False, static=True),
        Property("ecc", bool, False, static=True,
                 doc="write the standard 0x82 ECC block + whole-packet "
                     "length (ffmpeg-strict) instead of the "
                     "reference's bare layout"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._mux = asf_io.AsfMux(
            packet_size=self.props["packet-size"],
            preroll_ms=self.props["preroll"],
            ecc=self.props["ecc"])
        self._header_sent = False
        self._stream = b""  # retained for non-streamable finalize
        self._max_pts_ms = 0

    def connect_audio(self, format_tag: int, channels: int, rate: int,
                      **kw) -> asf_io.AsfStream:
        return self._mux.add_audio_stream(format_tag, channels, rate,
                                          **kw)

    def connect_video(self, fourcc: bytes, width: int,
                      height: int, **kw) -> asf_io.AsfStream:
        return self._mux.add_video_stream(fourcc, width, height, **kw)

    def chain(self, stream: asf_io.AsfStream, data: bytes,
              pts_ns: int = 0, keyframe: bool = False) -> bytes:
        out = b""
        if not self._header_sent:
            out += self._mux.header()
            self._header_sent = True
        pts_ms = pts_ns // MSEC
        self._max_pts_ms = max(self._max_pts_ms, pts_ms)
        out += self._mux.add_buffer(stream, data, pts_ms, keyframe)
        self._stream += out
        return out

    def event_eos(self) -> bytes:
        """Returns the remaining bytes (streamable) or the whole
        finalized stream (non-streamable)."""
        tail = self._mux.finish()
        self._stream += tail
        if self.props["streamable"]:
            return tail
        return asf_io.finalize(self._mux, self._stream,
                               self._max_pts_ms)

    def process(self, params, state, batch):
        return state, batch


@register
class AsfParseElement(Element):
    NAME = "asfparse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._parse = asf_io.AsfParse()

    def chain(self, data: bytes) -> List[bytes]:
        return self._parse.push(data)

    @property
    def packet_size(self) -> Optional[int]:
        return self._parse.packet_size

    def process(self, params, state, batch):
        return state, batch
