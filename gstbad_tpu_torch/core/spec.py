"""MediaSpec — the static format contract between elements.

The reference negotiates formats at runtime through GstCaps on pad templates
(e.g. gst/gaudieffects/gstgaussblur.c:93-108 pins AYUV;
gst/coloreffects/gstcoloreffects.c:57-58 lists 11 RGB/AYUV formats).  Here the
same contract is a frozen dataclass unified once at pipeline build time:
elements declare the format sets they accept, and `fixate` picks a concrete
MediaSpec before the first window runs, so every step sees static shapes.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple


class VideoFormat:
    """8-bit video formats, named as the reference names them.

    Packed 4-byte RGB formats store channels in memory byte order, so a
    [B, H, W, 4] uint8 tensor with channel k = memory byte k matches the C
    view of the frame exactly.  On little-endian, a guint32 load of a BGRx
    pixel yields red = (word >> 16) & 0xff = byte 2 (gstburn.c CAPS_STR).
    """

    # packed RGB, 4 bytes/pixel (byte order = channel order)
    RGBA = "RGBA"
    BGRA = "BGRA"
    ARGB = "ARGB"
    ABGR = "ABGR"
    RGBx = "RGBx"
    BGRx = "BGRx"
    xRGB = "xRGB"
    xBGR = "xBGR"
    # packed RGB, 3 bytes/pixel
    RGB = "RGB"
    BGR = "BGR"
    # packed YUV, 4 bytes/pixel: A, Y, U(Cb), V(Cr)
    AYUV = "AYUV"
    # packed YUV 4:2:2, 2 bytes/pixel macropixels ([B, H, 2W] raw bytes,
    # memory order exactly as the C sees the line)
    YUY2 = "YUY2"   # Y0 U Y1 V
    UYVY = "UYVY"   # U Y0 V Y1
    # planar YUV (represented as a dict of planes)
    I420 = "I420"   # 4:2:0, planes y / u / v
    YV12 = "YV12"   # 4:2:0, v plane before u in memory (io layer swaps;
                    # in-graph the dict stays semantic y/u/v)
    Y42B = "Y42B"   # 4:2:2, u/v half width full height
    Y444 = "Y444"   # 4:4:4, u/v full resolution
    Y41B = "Y41B"   # 4:1:1, u/v quarter width full height
    # semi-planar 4:2:0: y plane + one interleaved chroma plane
    # ({"y": [B,H,W], "uv": [B,H/2,W]} raw byte order)
    NV12 = "NV12"   # uv plane bytes U V U V ...
    NV21 = "NV21"   # uv plane bytes V U V U ...
    # grayscale single plane
    GRAY8 = "GRAY8"
    # packed 16-bit RGB, one little-endian uint16 per pixel ([B, H, W]
    # u16, the C's guint16 line layout): 5-6-5 and x-5-5-5 bit fields
    RGB16 = "RGB16"   # rrrrrggg gggbbbbb
    BGR16 = "BGR16"   # bbbbbggg gggrrrrr
    RGB15 = "RGB15"   # xrrrrrgg gggbbbbb
    BGR15 = "BGR15"   # xbbbbbgg gggrrrrr
    # deep color: 16 bits per component, [B, H, W, 4] uint16 in
    # A,R,G,B channel order (GStreamer ARGB64; what openexrdec emits,
    # gstopenexrdec.cpp:285)
    ARGB64 = "ARGB64"

    PACKED_RGB4 = (RGBA, BGRA, ARGB, ABGR, RGBx, BGRx, xRGB, xBGR)
    PACKED_RGB3 = (RGB, BGR)
    PACKED_RGB16 = (RGB16, BGR16, RGB15, BGR15)
    PACKED_4 = PACKED_RGB4 + (AYUV,)
    PACKED_YUV422 = (YUY2, UYVY)
    PLANAR_YUV = (I420, YV12, Y42B, Y444, Y41B)
    SEMIPLANAR_YUV = (NV12, NV21)
    # the reference zebrastripe format list (gstzebrastripe.c:145-148)
    YUV_WITH_LUMA = ((AYUV, I420, YV12, Y42B, Y444, Y41B, NV12, NV21)
                     + PACKED_YUV422)

    # Channel positions of R, G, B (or Y, U, V for AYUV) and the fill byte.
    _RGB_OFFSETS = {
        RGBA: (0, 1, 2, 3), BGRA: (2, 1, 0, 3),
        ARGB: (1, 2, 3, 0), ABGR: (3, 2, 1, 0),
        RGBx: (0, 1, 2, 3), BGRx: (2, 1, 0, 3),
        xRGB: (1, 2, 3, 0), xBGR: (3, 2, 1, 0),
        RGB: (0, 1, 2, None), BGR: (2, 1, 0, None),
    }
    AYUV_OFFSETS = (1, 2, 3, 0)  # Y, U, V, A

    # (r_shift, r_bits, g_shift, g_bits, b_shift, b_bits) per 16-bit format
    _RGB16_FIELDS = {
        RGB16: (11, 5, 5, 6, 0, 5), BGR16: (0, 5, 5, 6, 11, 5),
        RGB15: (10, 5, 5, 5, 0, 5), BGR15: (0, 5, 5, 5, 10, 5),
    }

    @staticmethod
    def rgb_offsets(fmt: str) -> Tuple[int, int, int, Optional[int]]:
        """(r, g, b, alpha_or_fill) channel indices for an RGB format."""
        return VideoFormat._RGB_OFFSETS[fmt]

    @staticmethod
    def rgb16_fields(fmt: str) -> Tuple[int, int, int, int, int, int]:
        """(r_shift, r_bits, g_shift, g_bits, b_shift, b_bits) for a
        16-bit packed format (GStreamer video-format.c bit layouts)."""
        return VideoFormat._RGB16_FIELDS[fmt]

    @staticmethod
    def is_rgb(fmt: str) -> bool:
        return fmt in VideoFormat._RGB_OFFSETS

    @staticmethod
    def has_alpha(fmt: str) -> bool:
        return fmt in (VideoFormat.RGBA, VideoFormat.BGRA, VideoFormat.ARGB,
                       VideoFormat.ABGR, VideoFormat.AYUV)

    @staticmethod
    def n_channels(fmt: str) -> int:
        if fmt in VideoFormat.PACKED_4:
            return 4
        if fmt in VideoFormat.PACKED_RGB3:
            return 3
        if fmt == VideoFormat.GRAY8:
            return 1
        raise ValueError(f"n_channels undefined for planar format {fmt}")

    @staticmethod
    def luma_view(fmt: str, data):
        """The luma component of `data` in format `fmt` (a strided view:
        writes go back via luma_set)."""
        if isinstance(data, dict):
            return data["y"]
        if fmt == VideoFormat.AYUV:
            return data[..., 1]
        if fmt == VideoFormat.YUY2:
            return data[..., 0::2]
        if fmt == VideoFormat.UYVY:
            return data[..., 1::2]
        return data  # GRAY8

    @staticmethod
    def luma_set(fmt: str, data, y):
        """A copy of `data` with its luma replaced by `y` (the input is
        never written: it may be a broadcast view shared across frames)."""
        if isinstance(data, dict):
            return {**data, "y": y}
        if fmt == VideoFormat.AYUV:
            sel = (Ellipsis, 1)
        elif fmt == VideoFormat.YUY2:
            sel = (Ellipsis, slice(0, None, 2))
        elif fmt == VideoFormat.UYVY:
            sel = (Ellipsis, slice(1, None, 2))
        else:
            return y
        out = data.clone()
        out[sel] = y
        return out


class AudioFormat:
    S16 = "S16"
    S32 = "S32"
    F32 = "F32"
    F64 = "F64"
    ALL = (S16, S32, F32, F64)

    _DTYPES = {S16: "int16", S32: "int32", F32: "float32", F64: "float64"}

    @staticmethod
    def dtype(fmt: str) -> str:
        return AudioFormat._DTYPES[fmt]


class BayerFormat:
    BGGR = "bggr"
    GBRG = "gbrg"
    GRBG = "grbg"
    RGGB = "rggb"
    ALL = (BGGR, GBRG, GRBG, RGGB)


class InterlaceMode:
    PROGRESSIVE = "progressive"
    INTERLEAVED = "interleaved"
    MIXED = "mixed"


@dataclasses.dataclass(frozen=True)
class MediaSpec:
    """Concrete media format; the fixated-caps analog.

    kind: 'video' | 'audio' | 'bayer'
    """

    kind: str = "video"
    # video / bayer
    format: Optional[str] = None
    width: int = 0
    height: int = 0
    framerate: Fraction = Fraction(30, 1)
    interlace_mode: str = InterlaceMode.PROGRESSIVE
    # audio
    rate: int = 48000
    channels: int = 0
    layout: str = "interleaved"

    def with_(self, **kw) -> "MediaSpec":
        return dataclasses.replace(self, **kw)

    @property
    def frame_duration_ns(self) -> int:
        fr = self.framerate
        return int(round(1e9 * fr.denominator / fr.numerator))

    def __str__(self) -> str:  # caps-style rendering for logs
        if self.kind == "video":
            return (f"video/x-raw,format={self.format},width={self.width},"
                    f"height={self.height},framerate={self.framerate},"
                    f"interlace-mode={self.interlace_mode}")
        if self.kind == "bayer":
            return (f"video/x-bayer,format={self.format},width={self.width},"
                    f"height={self.height},framerate={self.framerate}")
        return (f"audio/x-raw,format={self.format},rate={self.rate},"
                f"channels={self.channels},layout={self.layout}")


class SpecError(Exception):
    """Negotiation failure (the GST_FLOW_NOT_NEGOTIATED analog)."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SpecError(msg)


def fixate_format(spec: MediaSpec, allowed, element: str) -> MediaSpec:
    """Check/select the format of `spec` against an element's allowed set.

    Mirrors caps intersection + fixation: if the incoming spec already names a
    format it must be in `allowed`; if it doesn't (None), the first entry of
    `allowed` is picked (gst fixation picks the first structure).
    """
    if spec.format is None:
        return spec.with_(format=allowed[0])
    require(spec.format in allowed,
            f"{element}: format {spec.format} not in {allowed}")
    return spec
