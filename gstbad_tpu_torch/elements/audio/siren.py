"""sirendec / sirenenc — Siren7 (G.722.1) audio codec elements
(gst/siren/gstsirendec.c, gstsirenenc.c).

The reference elements wrap the in-tree Siren7 DSP library at fixed
16 kHz mono (gstsirendec.c caps: audio/x-siren, dct-length 320): 40-byte
frames <-> 320 S16 samples.  The codec engine is the io/siren.py
transcription; the huffman bitstream walk is inherently bit-serial, so
framing/decode run host-side (the vmncdec/adpcmdec host-source pattern)
and the decoded PCM flows on-device from there.

A port of the JAX package's elements/audio/siren.py: both directions run on
the host, as there, and each window goes to the pipeline's device in one
copy (core/frame.upload_frames).
"""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec
from gstbad_tpu_torch.io import siren as siren_io

FRAME_BYTES = 40
FRAME_SAMPLES = 320
RATE = 16000


@register
class SirenDec(Element):
    """Siren7 decoder: 40-byte frames in (push_bytes), S16 mono out
    (gstsirendec.c:183-247 handle_frame)."""

    NAME = "sirendec"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0
        self._dec = siren_io.SirenDecoder(RATE)

    def negotiate(self, in_spec):
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=RATE, channels=1)

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def pull_window(self, window: int):
        n = min(len(self._buf) // FRAME_BYTES, window)
        if n == 0:
            return None
        frames = np.empty((n, FRAME_SAMPLES, 1), np.int16)
        for i in range(n):
            frames[i, :, 0] = self._dec.decode_frame(
                self._buf[i * FRAME_BYTES:(i + 1) * FRAME_BYTES])
        self._buf = self._buf[n * FRAME_BYTES:]
        dur = FRAME_SAMPLES * 1_000_000_000 // RATE
        pts = (self._n + np.arange(n, dtype=np.int64)) * dur
        self._n += n
        return upload_frames(self.device, list(frames), pts=pts,
                             flags=np.zeros(n, np.int32),
                             valid=np.ones(n, bool))

    def process(self, params, state, batch: FrameBatch):
        return state, batch


@register
class SirenEnc(Element):
    """Siren7 encoder: S16 mono PCM in (push_bytes, little-endian),
    40-byte frames out (gstsirenenc.c:148-230 handle_frame)."""

    NAME = "sirenenc"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0
        self._enc = siren_io.SirenEncoder(RATE)

    def negotiate(self, in_spec):
        return MediaSpec(kind="bytes", format="audio/x-siren",
                         rate=RATE, channels=1)

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def push_samples(self, samples: np.ndarray) -> None:
        self.push_bytes(np.asarray(samples, "<i2").tobytes())

    def pull_window(self, window: int):
        frame_in = FRAME_SAMPLES * 2
        n = min(len(self._buf) // frame_in, window)
        if n == 0:
            return None
        out = np.empty((n, FRAME_BYTES), np.uint8)
        for i in range(n):
            pcm = np.frombuffer(self._buf[i * frame_in:(i + 1) * frame_in],
                                "<i2")
            out[i] = np.frombuffer(self._enc.encode_frame(pcm), np.uint8)
        self._buf = self._buf[n * frame_in:]
        dur = FRAME_SAMPLES * 1_000_000_000 // RATE
        pts = (self._n + np.arange(n, dtype=np.int64)) * dur
        self._n += n
        return upload_frames(self.device, list(out), pts=pts,
                             flags=np.zeros(n, np.int32),
                             valid=np.ones(n, bool))

    def process(self, params, state, batch: FrameBatch):
        return state, batch
