"""gsmenc / gsmdec (ext/gsm) over the REAL libgsm (io/gsmcodec.py).

- gsmenc: S16 8000 Hz mono in; every 160-sample slice encodes to one
  33-byte frame (gst_audio_encoder_set_frame_samples 160,
  gstgsmenc.c:143-144, 175-186), posted as `gsm-frame` bus messages
  and mirrored in `.packets`; a carried remainder spans window
  boundaries like the base-class adapter.
- gsmdec: host-source; push 33-byte GSM frames (or concatenated
  streams), 160 S16 samples out per frame at 8000 Hz mono
  (gstgsmdec.c:56, ENCODED_SAMPLES).

A port of the JAX package's elements/audio/gsmcodec.py: gsmenc encodes the
windows the runner downloads, as there; gsmdec decodes on the host, and each
window goes to the pipeline's device in one copy (core/frame.upload_frames).
"""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.io import gsmcodec


@register
class GsmEnc(Element):
    NAME = "gsmenc"
    HOST = True
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.packets = []            # (pts_ns, 33 bytes)
        self._carry = np.zeros((0,), np.int16)
        self._carry_pts = 0
        self._codec = None

    def negotiate(self, in_spec):
        require(gsmcodec.available(), "gsmenc: libgsm not available")
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16
                and in_spec.rate == 8000 and in_spec.channels == 1,
                "gsmenc: needs S16 8000 Hz mono "
                "(gstgsmenc.c sink caps)")
        self._codec = gsmcodec.GsmCodec()
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad_tpu_torch.core.bus import Message
        F = gsmcodec.FRAME_SAMPLES
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            samples = np.asarray(np_batch.data[i]).reshape(-1)
            pts = int(np.asarray(np_batch.pts)[i])
            if self._carry.size == 0:
                self._carry_pts = pts
            self._carry = np.concatenate([self._carry, samples])
            while self._carry.size >= F:
                frame = self._codec.encode_frame(self._carry[:F])
                self._carry = self._carry[F:]
                self.packets.append((self._carry_pts, frame))
                if bus is not None:
                    bus.post(Message(self.NAME, "gsm-frame",
                                     self._carry_pts,
                                     {"data": frame}))
                self._carry_pts += F * 10 ** 9 // 8000


@register
class GsmDec(Element):
    NAME = "gsmdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("samplesperbuffer", int, 160, 160, 16000,
                 static=True,
                 doc="multiple of 160 (one GSM frame per 20 ms)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._stream = b""
        self._frames = None
        self._pos = 0        # frame index

    def push_packet(self, data: bytes) -> None:
        self._stream += bytes(data)

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def negotiate(self, in_spec):
        require(gsmcodec.available(), "gsmdec: libgsm not available")
        require(self._stream and len(self._stream) % 33 == 0,
                "gsmdec: push 33-byte GSM frames first")
        self._codec = gsmcodec.GsmCodec()
        self._frames = [self._stream[k:k + 33]
                        for k in range(0, len(self._stream), 33)]
        require(self.props["samplesperbuffer"] % 160 == 0,
                "gsmdec: samplesperbuffer must be a multiple of 160")
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=8000, channels=1)

    def pull_window(self, window: int):
        if self._pos >= len(self._frames):
            return None
        per = self.props["samplesperbuffer"] // 160
        blocks, pts, valid = [], [], []
        spb = per * 160
        for _ in range(window):
            if self._pos < len(self._frames):
                chunks = []
                for _k in range(per):
                    if self._pos < len(self._frames):
                        chunks.append(self._codec.decode_frame(
                            self._frames[self._pos]))
                        self._pos += 1
                    else:
                        chunks.append(np.zeros(160, np.int16))
                blocks.append(np.concatenate(chunks)[:, None])
                pts.append((self._pos - per) * 160 * 10 ** 9 // 8000)
                valid.append(True)
            else:
                blocks.append(np.zeros((spb, 1), np.int16))
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
