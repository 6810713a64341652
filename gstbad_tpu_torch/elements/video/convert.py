"""videoconvert — format conversion (the gst-plugins-base videoconvert
dependency every reference launch line assumes).

Conversions use the same fixed-point 8-bit SDTV matrices the in-tree
coloreffects AYUV path uses (gstcoloreffects.c:286-301), so converted
pipelines stay consistent with the in-tree color math.  Every format goes
through AYUV but for the routes that stay in the RGB domain (8-bit RGB
permutations, 16-bit RGB and ARGB64 to and from 8-bit RGB).  torch has no
shifts on uint16, so the 16-bit formats are unpacked and packed in int32.
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

_U8 = torch.uint8


def _u8(x):
    return x.clamp(0, 255).to(_U8)


def _up2(c, h, w):
    """A 4:2:0 chroma plane repeated 2x2, cropped to [.., h, w]."""
    c = c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return c[..., :h, :w]


def _ayuv(y, u, v, a=None):
    """Stack 8-bit planes into AYUV [..., 4] (alpha 255 when a is None)."""
    if a is None:
        a = torch.full_like(y, 255)
    return torch.stack([a, y, u, v], dim=-1)


def _rgb16_unpack(data, fmt):
    """16-bit bit fields -> 8-bit (r, g, b) int32 by bit replication
    (GStreamer video-format.c's RGB16/RGB15 unpack)."""
    rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
    p = data.to(torch.int32)

    def expand(shift, bits):
        v = (p >> shift) & ((1 << bits) - 1)
        return (v << (8 - bits)) | (v >> (2 * bits - 8))
    return expand(rs, rb), expand(gs, gb), expand(bs, bb)


def _rgb16_pack(r, g, b, fmt):
    """8-bit (r, g, b) int32 in [0, 255] -> 16-bit fields, truncating."""
    rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
    p = ((r >> (8 - rb)) << rs | (g >> (8 - gb)) << gs
         | (b >> (8 - bb)) << bs)
    return p.to(torch.uint16)


def _rgb_channels(data, fmt):
    """(r, g, b, a) int32 planes of packed 8-bit RGB (a = 255 without
    alpha)."""
    offs = VideoFormat.rgb_offsets(fmt)
    r, g, b = (data[..., offs[i]].to(torch.int32) for i in range(3))
    a = (data[..., offs[3]].to(torch.int32) if VideoFormat.has_alpha(fmt)
         else torch.full_like(r, 255))
    return r, g, b, a


def _pack_rgb(r, g, b, a, fmt):
    """8-bit planes -> packed RGB [..., n_channels(fmt)] u8; the fill or
    alpha byte takes `a` where the format has one."""
    offs = VideoFormat.rgb_offsets(fmt)
    out = torch.empty(r.shape + (VideoFormat.n_channels(fmt),), dtype=_U8,
                      device=r.device)
    for i, ch in enumerate((r, g, b)):
        out[..., offs[i]] = ch.to(_U8)
    if offs[3] is not None:
        out[..., offs[3]] = a.to(_U8)
    return out


def _to_ayuv(data, fmt):
    """Any supported format -> AYUV [B, H, W, 4]."""
    if fmt == VideoFormat.AYUV:
        return data
    if fmt == VideoFormat.GRAY8:
        return _ayuv(data, torch.full_like(data, 128),
                     torch.full_like(data, 128))
    if fmt in (VideoFormat.I420, VideoFormat.YV12):
        y = data["y"]
        h, w = y.shape[-2:]
        return _ayuv(y, _up2(data["u"], h, w), _up2(data["v"], h, w))
    if fmt == VideoFormat.Y444:
        return _ayuv(data["y"], data["u"], data["v"])
    if fmt in (VideoFormat.Y42B, VideoFormat.Y41B):
        rep = 2 if fmt == VideoFormat.Y42B else 4
        y = data["y"]
        w = y.shape[-1]
        return _ayuv(y, data["u"].repeat_interleave(rep, dim=-1)[..., :w],
                     data["v"].repeat_interleave(rep, dim=-1)[..., :w])
    if fmt in VideoFormat.SEMIPLANAR_YUV:
        y = data["y"]
        h, w = y.shape[-2:]
        c0, c1 = data["uv"][..., 0::2], data["uv"][..., 1::2]
        u2, v2 = (c0, c1) if fmt == VideoFormat.NV12 else (c1, c0)
        return _ayuv(y, _up2(u2, h, w), _up2(v2, h, w))
    if fmt in VideoFormat.PACKED_YUV422:
        # [B, H, 2W] raw line bytes
        if fmt == VideoFormat.YUY2:
            y, u2, v2 = data[..., 0::2], data[..., 1::4], data[..., 3::4]
        else:  # UYVY
            y, u2, v2 = data[..., 1::2], data[..., 0::4], data[..., 2::4]
        w = y.shape[-1]
        return _ayuv(y, u2.repeat_interleave(2, dim=-1)[..., :w],
                     v2.repeat_interleave(2, dim=-1)[..., :w])
    if fmt in VideoFormat.PACKED_RGB16:
        r, g, b = _rgb16_unpack(data, fmt)
        a = None
    elif fmt == VideoFormat.ARGB64:
        # 16 -> 8 bit per component: the high byte (GStreamer's ARGB64
        # unpack v >> 8), then the usual RGB -> YCbCr
        p = data.to(torch.int32) >> 8
        r, g, b, a = p[..., 1], p[..., 2], p[..., 3], p[..., 0].to(_U8)
    else:   # packed 8-bit RGB
        r, g, b, _ = _rgb_channels(data, fmt)
        offs = VideoFormat.rgb_offsets(fmt)
        a = data[..., offs[3]] if VideoFormat.has_alpha(fmt) else None
    y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
    return _ayuv(_u8(y), _u8(u), _u8(v), a)


def _sub420(c):
    """2x2 rounded average subsample of a chroma plane."""
    c = c.to(torch.int32)
    return ((c[..., ::2, ::2] + c[..., ::2, 1::2] + c[..., 1::2, ::2]
             + c[..., 1::2, 1::2] + 2) >> 2).to(_U8)


def _sub422(c):
    """2x1 rounded average horizontal subsample."""
    c = c.to(torch.int32)
    return ((c[..., 0::2] + c[..., 1::2] + 1) >> 1).to(_U8)


def _sub411(c):
    """4x1 rounded average horizontal subsample."""
    c = c.to(torch.int32)
    return ((c[..., 0::4] + c[..., 1::4] + c[..., 2::4] + c[..., 3::4]
             + 2) >> 2).to(_U8)


def _from_ayuv(ayuv, fmt):
    """AYUV [B, H, W, 4] -> format `fmt`."""
    if fmt == VideoFormat.AYUV:
        return ayuv
    y, u, v = ayuv[..., 1], ayuv[..., 2], ayuv[..., 3]
    if fmt == VideoFormat.GRAY8:
        return y
    if fmt in (VideoFormat.I420, VideoFormat.YV12):
        return {"y": y, "u": _sub420(u), "v": _sub420(v)}
    if fmt == VideoFormat.Y444:
        return {"y": y, "u": u, "v": v}
    if fmt == VideoFormat.Y42B:
        return {"y": y, "u": _sub422(u), "v": _sub422(v)}
    if fmt == VideoFormat.Y41B:
        return {"y": y, "u": _sub411(u), "v": _sub411(v)}
    if fmt in VideoFormat.SEMIPLANAR_YUV:
        u, v = _sub420(u), _sub420(v)
        first, second = (u, v) if fmt == VideoFormat.NV12 else (v, u)
        uv = torch.stack([first, second], dim=-1)
        return {"y": y, "uv": uv.reshape(uv.shape[:-2] + (-1,))}
    if fmt in VideoFormat.PACKED_YUV422:
        out = torch.empty(y.shape[:-1] + (2 * y.shape[-1],), dtype=_U8,
                          device=y.device)
        yo, uo, vo = (0, 1, 3) if fmt == VideoFormat.YUY2 else (1, 0, 2)
        out[..., yo::2] = y
        out[..., uo::4] = _sub422(u)
        out[..., vo::4] = _sub422(v)
        return out
    r, g, b = (c.clamp(0, 255) for c in _apply_matrix(
        _YCBCR2RGB, y.to(torch.int32), u.to(torch.int32), v.to(torch.int32)))
    if fmt in VideoFormat.PACKED_RGB16:
        return _rgb16_pack(r, g, b, fmt)
    if fmt == VideoFormat.ARGB64:
        # 8 -> 16 bit: v * 257 = (v << 8) | v (GStreamer's pack)
        return (torch.stack([ayuv[..., 0].to(torch.int32), r, g, b], dim=-1)
                * 257).to(torch.uint16)
    return _pack_rgb(r, g, b, ayuv[..., 0], fmt)


def _rgb_domain(data, src, dst):
    """Conversions that stay in the RGB domain (no YUV round trip), or
    None: 16-bit RGB to and from 8-bit RGB (bit-replicating expansion,
    truncating field pack), ARGB64 to and from 8-bit RGB (high byte down,
    (v << 8) | v up, GStreamer's ARGB64 pack and unpack), and the packed
    8-bit RGB permutations (the alpha or fill byte is the source's alpha,
    else 255)."""
    rgb16 = VideoFormat.PACKED_RGB16
    src_rgb = VideoFormat.is_rgb(src)
    dst_rgb = VideoFormat.is_rgb(dst)
    if src in rgb16 and (dst_rgb or dst in rgb16):
        r, g, b = _rgb16_unpack(data, src)
        a = torch.full_like(r, 255)
    elif src == VideoFormat.ARGB64 and dst_rgb:
        p = data.to(torch.int32) >> 8
        r, g, b, a = p[..., 1], p[..., 2], p[..., 3], p[..., 0]
    elif src_rgb and (dst_rgb or dst in rgb16 or dst == VideoFormat.ARGB64):
        r, g, b, a = _rgb_channels(data, src)
    else:
        return None
    if dst in rgb16:
        return _rgb16_pack(r, g, b, dst)
    if dst == VideoFormat.ARGB64:
        return (torch.stack([a, r, g, b], dim=-1) * 257).to(torch.uint16)
    return _pack_rgb(r, g, b, a, dst)


_ALL = (VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
        + VideoFormat.PACKED_RGB16 + (VideoFormat.ARGB64,)
        + (VideoFormat.AYUV, VideoFormat.GRAY8)
        + VideoFormat.PLANAR_YUV + VideoFormat.SEMIPLANAR_YUV
        + VideoFormat.PACKED_YUV422)


@register
class VideoConvert(Element):
    NAME = "videoconvert"
    PROPERTIES = (Property("format", str, VideoFormat.AYUV, static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "videoconvert: needs video")
        require(in_spec.format in _ALL,
                f"videoconvert: unsupported source {in_spec.format}")
        dst = self.props["format"]
        require(dst in _ALL, f"videoconvert: unsupported target {dst}")
        if dst in (VideoFormat.I420, VideoFormat.YV12) \
                or dst in VideoFormat.SEMIPLANAR_YUV:
            require(in_spec.width % 2 == 0 and in_spec.height % 2 == 0,
                    f"videoconvert: {dst} needs even dimensions")
        elif dst == VideoFormat.Y42B or dst in VideoFormat.PACKED_YUV422:
            require(in_spec.width % 2 == 0,
                    f"videoconvert: {dst} needs even width")
        elif dst == VideoFormat.Y41B:
            require(in_spec.width % 4 == 0,
                    "videoconvert: Y41B needs width % 4 == 0")
        return in_spec.with_(format=dst)

    def process(self, params, state, batch: FrameBatch):
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return state, batch
        out = _rgb_domain(batch.data, src, dst)
        if out is None:
            out = _from_ayuv(_to_ayuv(batch.data, src), dst)
        return state, batch.with_data(out)

    def word_map(self, params):
        """Packed-4 -> packed-4 conversions are pure word functions, so the
        table-fusion pass can run them on 256-entry tables.  A chain only
        carries 4-byte words, so any other target (3-byte RGB, planar)
        ends it."""
        src = self.in_spec.format
        dst = self.out_spec.format
        if src == dst:
            return lambda w: w
        if src not in VideoFormat.PACKED_RGB4:
            return None
        s_off = VideoFormat.rgb_offsets(src)
        has_a = VideoFormat.has_alpha(src)
        if dst == VideoFormat.AYUV:
            return lambda w: pointops.rgb_word_to_ayuv_word(w, s_off, has_a)
        if dst in VideoFormat.PACKED_RGB4:
            d_off = VideoFormat.rgb_offsets(dst)
            return lambda w: pointops.rgb_word_permute(w, s_off, d_off,
                                                       has_a)
        return None
