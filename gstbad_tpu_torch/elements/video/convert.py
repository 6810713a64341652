"""videoconvert — format conversion (the gst-plugins-base videoconvert
dependency every reference launch line assumes).

Conversions use the same fixed-point 8-bit SDTV matrices the in-tree
coloreffects AYUV path uses (gstcoloreffects.c:286-301), so converted
pipelines stay consistent with the in-tree color math.  The port covers
the packed 4-byte routes (packed RGB4 and AYUV, either way); the other
formats fail negotiation until they are ported.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops import pointops
from gstbad_tpu_torch.ops.pointops import _apply_matrix, _RGB2YCBCR, \
    _YCBCR2RGB


def _to_ayuv(data, fmt):
    """Packed RGB4 or AYUV [B, H, W, 4] -> AYUV [B, H, W, 4]."""
    if fmt == VideoFormat.AYUV:
        return data
    offs = VideoFormat.rgb_offsets(fmt)
    r = data[..., offs[0]].to(torch.int32)
    g = data[..., offs[1]].to(torch.int32)
    b = data[..., offs[2]].to(torch.int32)
    a = (data[..., offs[3]] if VideoFormat.has_alpha(fmt)
         else torch.full_like(data[..., 0], 255))
    y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
    return torch.stack([a,
                        y.clamp(0, 255).to(torch.uint8),
                        u.clamp(0, 255).to(torch.uint8),
                        v.clamp(0, 255).to(torch.uint8)], dim=-1)


def _from_ayuv(ayuv, fmt):
    """AYUV [B, H, W, 4] -> packed RGB4 or AYUV [B, H, W, 4]."""
    if fmt == VideoFormat.AYUV:
        return ayuv
    y = ayuv[..., 1].to(torch.int32)
    u = ayuv[..., 2].to(torch.int32)
    v = ayuv[..., 3].to(torch.int32)
    r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
    offs = VideoFormat.rgb_offsets(fmt)
    out = torch.empty(ayuv.shape[:-1] + (4,), dtype=torch.uint8,
                      device=ayuv.device)
    out[..., offs[0]] = r.clamp(0, 255).to(torch.uint8)
    out[..., offs[1]] = g.clamp(0, 255).to(torch.uint8)
    out[..., offs[2]] = b.clamp(0, 255).to(torch.uint8)
    out[..., offs[3]] = ayuv[..., 0]
    return out


_ALL = VideoFormat.PACKED_RGB4 + (VideoFormat.AYUV,)


@register
class VideoConvert(Element):
    NAME = "videoconvert"
    PROPERTIES = (Property("format", str, VideoFormat.AYUV, static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "videoconvert: needs video")
        require(in_spec.format in _ALL,
                f"videoconvert: unsupported source {in_spec.format} "
                f"(gstbad_tpu_torch converts {_ALL})")
        require(self.props["format"] in _ALL,
                f"videoconvert: unsupported target {self.props['format']} "
                f"(gstbad_tpu_torch converts {_ALL})")
        return in_spec.with_(format=self.props["format"])

    def process(self, params, state, batch: FrameBatch):
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return state, batch
        data = batch.data
        # pure packed-RGB permutation fast path
        if VideoFormat.is_rgb(src) and VideoFormat.is_rgb(dst):
            s_off = VideoFormat.rgb_offsets(src)
            d_off = VideoFormat.rgb_offsets(dst)
            out = torch.empty(data.shape, dtype=torch.uint8,
                              device=data.device)
            for i in range(3):
                out[..., d_off[i]] = data[..., s_off[i]]
            out[..., d_off[3]] = (data[..., s_off[3]]
                                  if VideoFormat.has_alpha(src) else 255)
            return state, batch.with_data(out)
        return state, batch.with_data(_from_ayuv(_to_ayuv(data, src), dst))

    def word_map(self, params):
        """Packed-4 -> packed-4 conversions are pure word functions, so the
        table-fusion pass can run them on 256-entry tables."""
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return lambda w: w
        if not VideoFormat.is_rgb(src):
            return None
        s_off = VideoFormat.rgb_offsets(src)
        has_a = VideoFormat.has_alpha(src)
        if dst == VideoFormat.AYUV:
            return lambda w: pointops.rgb_word_to_ayuv_word(w, s_off, has_a)
        d_off = VideoFormat.rgb_offsets(dst)
        return lambda w: pointops.rgb_word_permute(w, s_off, d_off, has_a)
