"""coloreffects + chromahold (reference: gst/coloreffects/)."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core import tablefuse
from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.elements.video._coloreffects_tables import TABLES
from gstbad_tpu_torch.golden.coloreffects import LUMA_PRESETS
from gstbad_tpu_torch.ops import pointops


@register
class ColorEffects(VideoFilter):
    """gstcoloreffects.c: preset LUT mapping.

    Presets heat/sepia/xray map BT.709 luma through the LUT; xpro/yellowblue
    map each channel through its own LUT column (gstcoloreffects.c:509-541).
    AYUV frames round-trip through the fixed-point SDTV matrices
    (gstcoloreffects.c:286-301).
    """

    NAME = "coloreffects"
    FORMATS = VideoFormat.PACKED_RGB4 + (VideoFormat.AYUV,) \
        + VideoFormat.PACKED_RGB3
    PROPERTIES = (Property("preset", str, "none", static=True),)

    def prepare(self):
        preset = self.props["preset"]
        if preset == "none":
            self._table = None
            return
        if preset not in TABLES:
            raise ValueError(f"unknown preset {preset!r}; "
                             f"known: none,{','.join(TABLES)}")
        self._table = torch.as_tensor(TABLES[preset].astype(np.int32),
                                      device=self.device)
        self._map_luma = LUMA_PRESETS[preset]
        self._is_ayuv = self.out_spec.format == VideoFormat.AYUV
        if not self._is_ayuv:
            self._rgb = VideoFormat.rgb_offsets(self.out_spec.format)[:3]

    def process(self, params, state, batch: FrameBatch):
        if self._table is None:
            return state, batch
        if self._is_ayuv:
            out = pointops.lut_ayuv(batch.data, self._table, self._map_luma)
        else:
            out = pointops.lut_rgb(batch.data, self._table, self._map_luma,
                                   self._rgb)
        return state, batch.with_data(out)

    def byte_map(self, params):
        # luma presets read ALL channels per pixel (cross-channel), AYUV
        # goes through the SDTV matrices, RGB3 isn't a packed word — only
        # the per-channel RGB4 path is a byte map
        if (self._table is None or self._is_ayuv or self._map_luma
                or self.out_spec.format not in VideoFormat.PACKED_RGB4):
            return None
        chans = [pointops.identity_table(self.device)] * 4
        for i, c in enumerate(self._rgb):
            chans[c] = self._table[:, i]
        return torch.stack(chans, dim=-2)

    def byte_map_kinds(self):
        kinds = ["id"] * 4
        if (self._table is not None and not self._map_luma
                and not self._is_ayuv):
            for c in self._rgb:
                kinds[c] = "map"
        return tuple(kinds)

    def table_head(self, params):
        """Luma presets (heat/sepia/xray) are table[luma(pixel)] — the
        canonical table-fusion head (gstcoloreffects.c:509-541: the preset
        LUT is routed through BT.709 luma on the RGB path).  The luma
        ((r<<8)*54 + (g<<8)*183 + (b<<8)*19) >> 16 (gstcoloreffects.c:
        334-341, pointops.lut_rgb) is a LinearIndex over the byte
        positions of r, g, b."""
        if (self._table is None or self._is_ayuv or not self._map_luma
                or self.out_spec.format not in VideoFormat.PACKED_RGB4):
            return None
        weights = [0] * 4
        for c, wgt in zip(self._rgb, (54, 183, 19)):
            weights[c] = wgt
        index = tablefuse.LinearIndex(tuple(weights), 8, 16)
        specs = [(tablefuse.SRC, None)] * 4
        for i, c in enumerate(self._rgb):
            specs[c] = (tablefuse.IDX, self._table[:, i].contiguous())
        return index, specs


@register
class ChromaHold(VideoFilter):
    """gstchromahold.c: keep pixels near the target hue, grey the rest.

    target-r/g/b default 255/0/0, tolerance 0..180 default 30
    (gstchromahold.c:52-55).  The target hue is recomputed per window so
    the targets stay controllable.
    """

    NAME = "chromahold"
    FORMATS = VideoFormat.PACKED_RGB4
    PROPERTIES = (
        Property("target-r", int, 255, 0, 255, controllable=True),
        Property("target-g", int, 0, 0, 255, controllable=True),
        Property("target-b", int, 0, 0, 255, controllable=True),
        Property("tolerance", int, 30, 0, 180, controllable=True),
    )

    def prepare(self):
        self._rgb = VideoFormat.rgb_offsets(self.out_spec.format)[:3]

    @staticmethod
    def _hue(params):
        return pointops.rgb_to_hue(params["target-r"].to(torch.int32),
                                   params["target-g"].to(torch.int32),
                                   params["target-b"].to(torch.int32))

    def process(self, params, state, batch: FrameBatch):
        out = pointops.chromahold(batch.data, self._hue(params),
                                  params["tolerance"], self._rgb)
        return state, batch.with_data(out)

    def word_map(self, params):
        hue = self._hue(params)
        tol = params["tolerance"]
        rgb = self._rgb
        return lambda w: pointops.chromahold_word(w, hue, tol, rgb)
