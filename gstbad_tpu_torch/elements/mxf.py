"""mxfmux / mxfdemux elements (gst/mxf/) over io/mxf.py.

mxfmux: OP1a writer — connect video (MPEG-ES wrapped) and/or audio
(AES3/PCM) tracks, push frames, event_eos() returns the complete file
(header metadata carries the final duration, the reference's
non-streamable path).  mxfdemux: incremental KLV walk emitting
per-track essence frames with edit-rate timestamps.

A port of the JAX package's elements/mxf.py, on the host as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import mxf as mxf_io


@register
class MxfMuxElement(Element):
    NAME = "mxfmux"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._cfg = dict(edit_rate=(25, 1), width=0, height=0,
                         audio_rate=48000, channels=0, bits=16)
        self._mux: Optional[mxf_io.MxfMux] = None

    def connect_video(self, width: int, height: int,
                      edit_rate=(25, 1)) -> None:
        self._cfg.update(width=width, height=height,
                         edit_rate=tuple(edit_rate))

    def connect_audio(self, rate: int = 48000, channels: int = 2,
                      bits: int = 16) -> None:
        self._cfg.update(audio_rate=rate, channels=channels, bits=bits)

    def _ensure(self) -> mxf_io.MxfMux:
        if self._mux is None:
            self._mux = mxf_io.MxfMux(**self._cfg)
        return self._mux

    def chain_video(self, data: bytes) -> None:
        self._ensure().add_video(data)

    def chain_audio(self, data: bytes) -> None:
        self._ensure().add_audio(data)

    def event_eos(self) -> bytes:
        return self._ensure().finish()

    def process(self, params, state, batch):
        return state, batch


@register
class MxfDemuxElement(Element):
    NAME = "mxfdemux"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._dmx = mxf_io.MxfDemux()

    def push_bytes(self, data: bytes) -> List[Dict]:
        return [dict(track_number=f.track_number, kind=f.kind,
                     data=f.data, position=f.position,
                     pts=(f.pts_ns if f.pts_ns >= 0 else None))
                for f in self._dmx.push(data)]

    @property
    def tracks(self) -> Dict[int, mxf_io.MxfTrack]:
        return dict(self._dmx.tracks)

    def process(self, params, state, batch):
        return state, batch
