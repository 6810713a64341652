"""freeverb (gst/freeverb/gstfreeverb.c) — Schroeder/Moorer reverb."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec
from gstbad_tpu_torch.ops import audio as ops


@register
class Freeverb(AudioFilter):
    """room-size/damping/width/level all default per the reference
    (gstfreeverb.c:403-421); mono or stereo in, stereo out; S16 or F32.
    Rates below 32 kHz are not ported yet (ops.freeverb_process raises)."""

    NAME = "freeverb"
    FORMATS = (AudioFormat.F32, AudioFormat.S16)
    CHANNELS = (1, 2)
    PROPERTIES = (
        Property("room-size", float, 0.5, 0.0, 1.0, controllable=True),
        Property("damping", float, 0.2, 0.0, 1.0, controllable=True),
        Property("width", float, 1.0, 0.0, 1.0, controllable=True),
        Property("level", float, 0.5, 0.0, 1.0, controllable=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        # output is always stereo (gstfreeverb.c:612-621 transform_caps)
        return spec.with_(channels=2)

    def dynamic_params(self):
        # property -> model coefficients (gstfreeverb.c:536-570), float32 on
        # the host like the C, then 0-d tensors
        rs = np.float32(self.props["room-size"])
        damping = np.float32(self.props["damping"])
        width = np.float32(self.props["width"])
        level = np.float32(self.props["level"])
        wet = np.float32(level * np.float32(1.0))
        coeffs = {
            "feedback": np.float32(rs * np.float32(0.28)) + np.float32(0.7),
            "damp1": damping,
            "damp2": np.float32(1) - damping,
            "wet1": wet * (width / np.float32(2) + np.float32(0.5)),
            "wet2": wet * ((np.float32(1) - width) / np.float32(2)),
            "dry": (np.float32(1.0 - self.props["level"])
                    * np.float32(1.0)),
            "gain": np.float32(0.015),
        }
        return {k: torch.tensor(np.float32(v), device=self.device)
                for k, v in coeffs.items()}

    def init_state(self, batch: int):
        return ops.freeverb_init_state(self.in_spec.rate, self.device)

    def process(self, params, state, batch: FrameBatch):
        x = batch.data
        b, s = x.shape[0], x.shape[1]
        mono = self.in_spec.channels == 1
        flat = x.reshape((b * s,) if mono else (b * s, 2))
        state, y = ops.freeverb_process(state, flat.to(torch.float32), params,
                                        self.in_spec.rate, mono)
        if self.in_spec.format == AudioFormat.S16:
            y = y.clamp(-32768.0, 32767.0).to(torch.int16)
        return state, batch.with_data(y.reshape(b, s, 2))
