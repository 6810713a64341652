"""pitch (ext/soundtouch/gstpitch.cc): pitch, tempo and rate shifter.

A Hann phase vocoder (ops/audio.phase_vocoder): analysis hop 256 of a
1024 frame, synthesis hop round(256 * pitch / tempo), then a linear
resample by 1 / (pitch * rate).  The properties fix the output length,
so they are static; a live change goes through
Pipeline.set_static_property, which rebuilds and carries the vocoder's
state across (migrate_state), as the reference's mid-stream
setTempo/setRate (gstpitch.cc:248-258).
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.ops import audio as ops

FRAME = 1024
HA = 256


@register
class Pitch(AudioFilter):
    NAME = "pitch"
    FORMATS = (AudioFormat.F32,)
    CHANNELS = (1, 64)
    PROPERTIES = (
        Property("pitch", float, 1.0, 0.1, 10.0, static=True),
        Property("tempo", float, 1.0, 0.1, 10.0, static=True),
        Property("rate", float, 1.0, 0.1, 10.0, static=True),
        Property("output-rate", float, 1.0, 0.1, 10.0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        pitch, tempo, rate = (self.props["pitch"], self.props["tempo"],
                              self.props["rate"])
        # the stretch gives duration 1/(tempo*rate) and, once resampled
        # by 1/(pitch*rate), the pitch factor pitch*rate
        self._hs = max(1, round(HA * pitch / tempo))
        self._resample = pitch * rate
        return spec

    def init_state(self, batch: int):
        return ops.pv_init_state(FRAME, HA, self._hs, self.in_spec.channels,
                                 self.device)

    def migrate_state(self, old_state, window: int):
        """A live hop change: the analysis tail and the phases carry over;
        the overlap-add tail (frame - hs long) is cropped or zero-padded
        to the new hop."""
        fresh = self.init_state(window)
        out = dict(old_state)
        old_ola = old_state["ola"]
        keep = min(fresh["ola"].shape[0], old_ola.shape[0])
        ola = fresh["ola"].clone()
        ola[:keep] = old_ola[:keep]
        out["ola"] = ola
        return out

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        n = b * s
        require(n % HA == 0,
                f"pitch: window samples {n} must be a multiple of {HA}")
        x = batch.data.reshape(n, c).to(torch.float32)
        stretched, state = ops.phase_vocoder(x, state, FRAME, HA, self._hs)
        n_out = max(1, round(stretched.shape[0] / self._resample))
        y = ops.resample_linear(stretched, n_out)
        # the output spans the input's time / (tempo * rate)
        scale = 1.0 / (self.props["tempo"] * self.props["rate"]
                       * self.props["output-rate"])
        pts = (batch.pts[:1].to(torch.float64) * scale).to(torch.int64)
        return state, FrameBatch(data=y[None], pts=pts,
                                 flags=batch.flags[:1],
                                 valid=batch.valid[:1])
