"""gaudieffects — burn, chromium, dilate, dodge, exclusion, solarize
(reference: gst/gaudieffects/).  gaussianblur is not ported yet.

The word-based effects view each pixel as a little-endian guint32, so their
"red/green/blue" are memory bytes 2/1/0 and the fill byte is 3 regardless of
whether the format is BGRx or RGBx — exactly like the C (gstburn.c:80-84).
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core import tablefuse
from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.golden.gaudieffects import chromium_cos_table
from gstbad_tpu_torch.ops import lut, pointops

_WORD_RGB = (2, 1, 0)
_WORD_FILL = 3


class _GuintWordFilter(VideoFilter):
    FORMATS = (VideoFormat.BGRx, VideoFormat.RGBx)


def _rgb_zero_fill(t: torch.Tensor) -> torch.Tensor:
    """[*, 4, 256] byte map: t on the three colour bytes, the rebuilt
    fill byte zero."""
    t = t.to(torch.int32)
    return torch.stack([t, t, t, torch.zeros_like(t)], dim=-2)


@register
class Burn(_GuintWordFilter):
    """gstburn.c; adjustment 0..256 default 175 (gstburn.c:94-100)."""

    NAME = "burn"
    PROPERTIES = (
        Property("adjustment", int, 175, 0, 256, controllable=True),
    )

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(
            pointops.burn(batch.data, params["adjustment"]))

    def byte_map(self, params):
        t = lut.burn_table(params["adjustment"]).to(torch.int32)
        return torch.stack([t, t, t, t], dim=-2)  # all 4 bytes processed


@register
class Chromium(_GuintWordFilter):
    """gstchromium.c; edge-a/edge-b defaults 200/1 (gstchromium.c:96-100)."""

    NAME = "chromium"
    PROPERTIES = (
        Property("edge-a", int, 200, 0, 256, controllable=True),
        Property("edge-b", int, 1, 0, 256, controllable=True),
    )

    def prepare(self):
        self._table = torch.as_tensor(chromium_cos_table(), device=self.device)

    def process(self, params, state, batch: FrameBatch):
        out = pointops.chromium(batch.data, params["edge-a"],
                                params["edge-b"], self._table,
                                _WORD_RGB, _WORD_FILL)
        return state, batch.with_data(out)

    def byte_map(self, params):
        # the fill byte is rebuilt as 0 (gstchromium.c word)
        return _rgb_zero_fill(lut.chromium_table(
            params["edge-a"], params["edge-b"], self._table))

    def byte_map_kinds(self):
        return ("map", "map", "map", "zero")


@register
class Dilate(_GuintWordFilter):
    """gstdilate.c; erode=false default (gstdilate.c:92-98)."""

    NAME = "dilate"
    PROPERTIES = (Property("erode", bool, False, controllable=True),)

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(
            pointops.dilate(batch.data, params["erode"], _WORD_RGB))

    def index_stencil(self, params):
        """Dilate only MOVES whole pixels by luminance comparison, so under
        table fusion it runs on the 8-bit index plane (core/tablefuse.py):
        the 90r+115g+51b key is built per TABLE ENTRY and compared via an
        order-preserving rank lookup."""

        def key_fn(bytes_):
            def col(c):
                kind, t = bytes_[c]
                if kind == tablefuse.CONST:
                    v = t.to(torch.int32)
                    return v[..., None] if v.ndim else v
                return t.to(torch.int32)
            return (90 * col(_WORD_RGB[0]) + 115 * col(_WORD_RGB[1])
                    + 51 * col(_WORD_RGB[2]))

        def move_fn(idx, key, params):
            # the same down/right/left sequential walk as pointops.dilate
            # (gstdilate.c:273-350), with luminance replaced by its rank
            erode = pointops._per_frame(params["erode"], idx.ndim)
            out_i, out_k = idx, key
            for shift in (pointops.shift_down, pointops.shift_right,
                          pointops.shift_left):
                n_i, n_k = shift(idx), shift(key)
                take = torch.where(erode, n_k < out_k, n_k > out_k)
                out_i = torch.where(take, n_i, out_i)
                out_k = torch.where(take, n_k, out_k)
            return out_i

        # the "dilate3" tag lets a downstream fused tail run this stencil
        # inside one kernel (ops/chainfuse.py): a sequential
        # down/right/left best-key walk parameterized by `erode`
        return key_fn, move_fn, "dilate3"


@register
class Dodge(_GuintWordFilter):
    """gstdodge.c (no properties)."""

    NAME = "dodge"

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(
            pointops.dodge(batch.data, _WORD_RGB, _WORD_FILL))

    def byte_map(self, params):
        return _rgb_zero_fill(lut.dodge_table(self.device))

    def byte_map_kinds(self):
        return ("map", "map", "map", "zero")


@register
class Exclusion(_GuintWordFilter):
    """gstexclusion.c; factor 1..175 default 175 (gstexclusion.c:94,154-156)."""

    NAME = "exclusion"
    PROPERTIES = (Property("factor", int, 175, 1, 175, controllable=True),)

    def process(self, params, state, batch: FrameBatch):
        out = pointops.exclusion(batch.data, params["factor"],
                                 _WORD_RGB, _WORD_FILL)
        return state, batch.with_data(out)

    def word_map(self, params):
        f = params["factor"]
        return lambda w: pointops.exclusion_word(w, f, _WORD_RGB)


@register
class Solarize(_GuintWordFilter):
    """gstsolarize.c; threshold/start/end 127/50/185 (gstsolarize.c:92-96)."""

    NAME = "solarize"
    PROPERTIES = (
        Property("threshold", int, 127, 0, 256, controllable=True),
        Property("start", int, 50, 0, 256, controllable=True),
        Property("end", int, 185, 0, 256, controllable=True),
    )

    def process(self, params, state, batch: FrameBatch):
        out = pointops.solarize(batch.data, params["threshold"],
                                params["start"], params["end"],
                                _WORD_RGB, _WORD_FILL)
        return state, batch.with_data(out)

    def byte_map(self, params):
        return _rgb_zero_fill(lut.solarize_table(
            params["threshold"], params["start"], params["end"]))

    def byte_map_kinds(self):
        return ("map", "map", "map", "zero")
