"""bs2b (ext/bs2b/gstbs2b.c, DSP from libbs2b): Bauer
stereophonic-to-binaural headphone crossfeed.

Each output channel is its own input through a first-order high boost
plus the opposite channel through a first-order lowpass at `fcut`,
renormalized by a gain term.  The two first-order recurrences run as the
JAX package's associative scans over the whole window
(ops/audio.first_order_iir), in float64 for every sample format.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.golden.audio import BS2B_PRESETS
from gstbad_tpu_torch.ops import audio as ops

# libbs2b bs2b.h range macros (caps at gstbs2b.c:49-54)
MINFCUT, MAXFCUT = 300, 2000
MINFEED, MAXFEED = 10, 150
MINSRATE, MAXSRATE = 2000, 384000

_CLIP = {AudioFormat.S16: (-32768.0, 32767.0),
         AudioFormat.S32: (-2147483648.0, 2147483647.0),
         AudioFormat.F32: (-1.0, 1.0),
         AudioFormat.F64: (-1.0, 1.0)}
_DTYPES = {AudioFormat.S16: torch.int16, AudioFormat.S32: torch.int32,
           AudioFormat.F32: torch.float32, AudioFormat.F64: torch.float64}


@register
class Bs2b(AudioFilter):
    """fcut/feed with libbs2b's ranges and defaults (700 Hz, 4.5 dB);
    `preset` loads default/cmoy/jmeier (gstbs2b.c:85-98).  Mono input
    passes through (gstbs2b.c:252-254)."""

    NAME = "bs2b"
    FORMATS = (AudioFormat.F32, AudioFormat.F64,
               AudioFormat.S16, AudioFormat.S32)
    CHANNELS = (1, 2)
    PROPERTIES = (
        Property("fcut", int, 700, MINFCUT, MAXFCUT, controllable=True),
        Property("feed", int, 45, MINFEED, MAXFEED, controllable=True),
        Property("preset", str, "", static=True),
    )

    def __init__(self, **props):
        preset = props.get("preset", "")
        if preset:
            require(preset in BS2B_PRESETS,
                    f"bs2b: unknown preset {preset!r} "
                    f"(have {sorted(BS2B_PRESETS)})")
            fcut, feed = BS2B_PRESETS[preset]
            props.setdefault("fcut", fcut)
            props.setdefault("feed", feed)
        super().__init__(**props)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        require(MINSRATE <= spec.rate <= MAXSRATE,
                f"bs2b: rate {spec.rate} outside [{MINSRATE},{MAXSRATE}]")
        return spec

    def init_state(self, batch: int):
        def z():
            return torch.zeros(2, dtype=torch.float64, device=self.device)

        return {"lo": z(), "hi": z(), "asis": z()}

    def dynamic_params(self):
        return ops.bs2b_coefficients(self.props["fcut"], self.props["feed"],
                                     self.in_spec.rate, self.device)

    def process(self, params, state, batch: FrameBatch):
        if self.in_spec.channels == 1:
            return state, batch
        x = batch.data
        b, s = x.shape[0], x.shape[1]
        fmt = self.in_spec.format
        state, y = ops.bs2b_cross_feed(
            state, x.reshape(b * s, 2).to(torch.float64), params)
        lo, hi = _CLIP[fmt]
        y = y.clamp(lo, hi)   # libbs2b clips overloaded samples
        return state, batch.with_data(y.reshape(b, s, 2).to(_DTYPES[fmt]))
