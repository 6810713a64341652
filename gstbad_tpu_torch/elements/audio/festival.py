"""festival (gst/festival/gstfestival.c): text-to-speech via a
festival server, exact wire protocol in io/festival.py.

Host-source shape: push_text() UTF-8 strings (the reference's
text/x-raw sink pad), negotiate connects to the server and
synthesizes each string through `(tts_textall ...)`; the returned
audio/x-wav buffers are kept verbatim in `.wav_packets` (what the
reference pushes downstream) and ALSO parsed to S16 PCM blocks so the
framework's audio graph can consume them directly (the reference
relies on a downstream wavparse from -base, which has no analog
here).

A port of the JAX package's elements/audio/festival.py: the synthesis runs
on the server and the WAV parse on the host, as there, and each window goes
to the pipeline's device in one copy (core/frame.upload_frames).
"""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.io import festival as fest


@register
class Festival(Element):
    NAME = "festival"
    KIND = "host-source"
    PROPERTIES = (
        Property("host", str, fest.DEFAULT_HOST, static=True),
        Property("port", int, fest.DEFAULT_PORT, 1, 65535,
                 static=True),
        Property("text-mode", str, fest.DEFAULT_TEXT_MODE,
                 static=True),
        Property("samplesperbuffer", int, 1024, 1, 65536,
                 static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._texts = []
        self.wav_packets = []        # raw audio/x-wav server replies
        self._pcm = None
        self._pos = 0

    def push_text(self, text: str) -> None:
        self._texts.append(str(text))

    def push_packet(self, data: bytes) -> None:
        self.push_text(bytes(data).decode("utf-8"))

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(self._texts, "festival: push_text() first")
        client = fest.FestivalClient(
            host=self.props["host"], port=self.props["port"],
            text_mode=self.props["text-mode"])
        try:
            chunks = []
            rate = channels = None
            for text in self._texts:
                for wav in client.talk(text):
                    self.wav_packets.append(wav)
                    r, c, pcm = fest.parse_wav(wav)
                    require(rate in (None, r) and channels in (None, c),
                            "festival: server changed wav format "
                            "mid-stream")
                    rate, channels = r, c
                    chunks.append(pcm)
        finally:
            client.close()
        require(chunks, "festival: server returned no waveforms")
        self._pcm = np.concatenate(chunks)
        self._rate = rate
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=rate, channels=channels)

    def pull_window(self, window: int):
        s = self.props["samplesperbuffer"]
        total = self._pcm.shape[0]
        if self._pos >= total:
            return None
        blocks, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < total:
                chunk = self._pcm[self._pos:self._pos + s]
                if chunk.shape[0] < s:
                    chunk = np.pad(chunk,
                                   ((0, s - chunk.shape[0]), (0, 0)))
                blocks.append(chunk)
                pts.append(self._pos * 10 ** 9 // self._rate)
                valid.append(True)
                self._pos += s
            else:
                blocks.append(np.zeros_like(blocks[-1]))
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
        return upload_frames(self.device, blocks,
                             pts=np.asarray(pts, np.int64),
                             flags=np.zeros(len(blocks), np.int32),
                             valid=np.asarray(valid, bool))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
