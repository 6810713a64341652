"""audiomixmatrix (gst/audiomixmatrix/) and audiochannelmix
(gst/audiofxbad/)."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.ops import audio as ops


def parse_matrix(text: str) -> np.ndarray:
    """Parse `<<1.0,0.0>,<0.0,1.0>>` (gst-launch GstValueArray style) or
    plain `1,0;0,1` rows."""
    text = text.strip()
    if text.startswith("<"):
        rows = []
        depth = 0
        cur = ""
        for ch in text[1:-1]:
            if ch == "<":
                depth += 1
                cur = ""
            elif ch == ">":
                depth -= 1
                rows.append([float(v) for v in cur.replace("(double)", "")
                             .split(",") if v.strip()])
            elif depth > 0:
                cur += ch
        return np.array(rows, np.float64)
    return np.array([[float(v) for v in row.split(",") if v.strip()]
                     for row in text.split(";")], np.float64)


@register
class AudioMixMatrix(Element):
    """N x M channel mixer (gstaudiomixmatrix.c).

    modes: manual (explicit in/out channels + matrix) or first-channels
    (truncated identity).  Formats F32/F64/S16/S32; the integer paths use the
    reference's fixed-point conversion with its shift computation
    (gstaudiomixmatrix.c:253-284).
    """

    NAME = "audiomixmatrix"
    PROPERTIES = (
        Property("mode", str, "manual", static=True),
        Property("in-channels", int, 0, 0, 64, static=True),
        Property("out-channels", int, 0, 0, 64, static=True),
        Property("matrix", str, "", static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio")
        require(in_spec.format in AudioFormat.ALL,
                f"{self.NAME}: bad format {in_spec.format}")
        if self.props["mode"] == "first-channels":
            out_ch = self.props["out-channels"] or in_spec.channels
            self._matrix = np.zeros((out_ch, in_spec.channels))
            for i in range(min(out_ch, in_spec.channels)):
                self._matrix[i, i] = 1.0
        else:
            require(bool(self.props["matrix"]),
                    f"{self.NAME}: manual mode needs a matrix")
            self._matrix = parse_matrix(self.props["matrix"])
            in_ch = self.props["in-channels"] or in_spec.channels
            out_ch = self.props["out-channels"] or self._matrix.shape[0]
            require(self._matrix.shape == (out_ch, in_ch),
                    f"{self.NAME}: matrix shape {self._matrix.shape} != "
                    f"({out_ch},{in_ch})")
            require(in_ch == in_spec.channels,
                    f"{self.NAME}: in-channels {in_ch} != spec "
                    f"{in_spec.channels}")
        return in_spec.with_(channels=self._matrix.shape[0])

    def prepare(self):
        m = self._matrix
        in_ch = m.shape[1]
        fmt = self.in_spec.format
        if fmt == AudioFormat.S16:
            # gstaudiomixmatrix.c:256-264
            self._shift = 32 - 16 - 1 - int(np.ceil(np.log(in_ch)
                                                    / np.log(2)))
            conv = (m * (1 << self._shift)).astype(np.int32)
        elif fmt == AudioFormat.S32:
            # gstaudiomixmatrix.c:274-282 (truncating log2)
            self._shift = 64 - 32 - 1 - int(np.log(in_ch) / np.log(2))
            conv = (m * (1 << self._shift)).astype(np.int64)
        else:
            conv = m
        self._conv = torch.as_tensor(conv, device=self.device)

    def process(self, params, state, batch: FrameBatch):
        fmt = self.in_spec.format
        x = batch.data
        if fmt == AudioFormat.S16:
            out = ops.mix_s16(x, self._conv, self._shift)
        elif fmt == AudioFormat.S32:
            out = ops.mix_s32(x, self._conv, self._shift)
        elif fmt == AudioFormat.F64:
            out = ops.mix_f64(x, self._conv)
        else:
            out = ops.mix_f32(x, self._conv)
        return state, batch.with_data(out)


@register
class AudioChannelMix(AudioFilter):
    """2x2 stereo gain mixer, S16 interleaved (gstaudiochannelmix.c)."""

    NAME = "audiochannelmix"
    FORMATS = (AudioFormat.S16,)
    CHANNELS = (2, 2)
    PROPERTIES = (
        Property("left-to-left", float, 1.0, controllable=True),
        Property("left-to-right", float, 0.0, controllable=True),
        Property("right-to-left", float, 0.0, controllable=True),
        Property("right-to-right", float, 1.0, controllable=True),
    )

    def dynamic_params(self):
        # the C uses doubles (gstaudiochannelmix.c:228-233)
        return {p.name: torch.tensor(self.props[p.name], dtype=torch.float64,
                                     device=self.device)
                for p in self.PROPERTIES}

    def process(self, params, state, batch: FrameBatch):
        out = ops.channelmix_s16(
            batch.data, params["left-to-left"], params["left-to-right"],
            params["right-to-left"], params["right-to-right"])
        return state, batch.with_data(out)
