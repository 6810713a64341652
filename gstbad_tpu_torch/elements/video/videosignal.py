"""videosignal — videoanalyse, simplevideomark, simplevideomarkdetect
(gst/videosignal/)."""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require


class _LumaPlanarFilter(VideoFilter):
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8, VideoFormat.AYUV)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video")
        require(in_spec.format in self.FORMATS,
                f"{self.NAME}: format {in_spec.format} unsupported")
        return in_spec

    def _luma(self, data):
        if isinstance(data, dict):
            return data["y"]
        if self.out_spec.format == VideoFormat.AYUV:
            return data[..., 1]
        return data

    def _set_luma(self, data, y):
        if isinstance(data, dict):
            return {**data, "y": y}
        if self.out_spec.format == VideoFormat.AYUV:
            out = data.clone()
            out[..., 1] = y
            return out
        return y


@register
class VideoAnalyse(_LumaPlanarFilter):
    """gstvideoanalyse.c: per-frame luma average/variance message.

    Keeps the reference's integer-average quirk: the variance is computed
    against avg = sum // (w*h) (gstvideoanalyse.c:228-242)."""

    NAME = "videoanalyse"
    PROPERTIES = (Property("message", bool, True),)

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data).to(torch.int64)
        h, w = y.shape[-2], y.shape[-1]
        area = h * w
        s = y.sum(dim=(-2, -1))
        avg_int = s // area
        # the JAX package's compiled window multiplies by the reciprocal
        # of each constant divisor (XLA's rewrite); so does the port
        luma_average = s.to(torch.float64) * (1.0 / (255.0 * area))
        diff = avg_int[:, None, None] - y
        var = (diff * diff).sum(dim=(-2, -1))
        luma_variance = var.to(torch.float64) * (
            1.0 / (255.0 * 255.0 * area))
        msgs = {"GstVideoAnalyse": {
            "_emit": params["message"].expand(y.shape[0]),
            "luma-average": luma_average,
            "luma-variance": luma_variance,
        }}
        return state, batch, msgs


def _pattern_geometry(width, height, pattern_width, pattern_height,
                      pattern_count, pattern_data_count, left_offset,
                      bottom_offset):
    """Watermark block layout (gstsimplevideomark.c draw loop)."""
    total = pattern_count + pattern_data_count
    x0 = left_offset
    y0 = height - bottom_offset - pattern_height
    return [(x0 + i * pattern_width, y0) for i in range(total)]


def _blocks(el, h, w):
    """(x0, row start, row end) of each square: a square that starts above
    the frame's first row is clipped at the top, as one that runs past the
    last column is clipped at the right by the slice."""
    p = el.props
    ph = p["pattern-height"]
    return [(bx, max(by, 0), by + ph) for bx, by in _pattern_geometry(
        w, h, p["pattern-width"], ph, p["pattern-count"],
        p["pattern-data-count"], p["left-offset"], p["bottom-offset"])]


@register
class SimpleVideoMark(_LumaPlanarFilter):
    """gstsimplevideomark.c: stamp machine-readable corner squares.

    pattern-count solid sync squares (alternating bright/dark) followed by
    pattern-data-count squares encoding `pattern-data` bits (LSB first:
    bit set -> bright square).
    """

    NAME = "simplevideomark"
    PROPERTIES = (
        Property("pattern-width", int, 4, 1, None),
        Property("pattern-height", int, 16, 1, None),
        Property("pattern-count", int, 4, 0, None),
        Property("pattern-data-count", int, 5, 0, 64),
        Property("pattern-data", int, 10, 0, None),
        Property("enabled", bool, True),
        Property("left-offset", int, 0, 0, None),
        Property("bottom-offset", int, 0, 0, None),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data)
        h, w = y.shape[-2], y.shape[-1]
        pw = self.props["pattern-width"]
        pc = self.props["pattern-count"]
        data_bits = params["pattern-data"].to(torch.int64)
        out = y.clone()
        for i, (bx, y0, y1) in enumerate(_blocks(self, h, w)):
            if i < pc:
                bright = torch.tensor(i % 2 == 0, device=y.device)
            else:
                bright = ((data_bits >> (i - pc)) & 1) == 1
            out[..., y0:y1, bx:bx + pw] = torch.where(
                bright, 255, 0).to(torch.uint8)
        out = torch.where(params["enabled"], out, y)
        return state, batch.with_data(self._set_luma(batch.data, out))


@register
class SimpleVideoMarkDetect(_LumaPlanarFilter):
    """gstsimplevideomarkdetect.c: read the squares back; posts a
    simplevideomarkdetect message with the decoded data per frame."""

    NAME = "simplevideomarkdetect"
    PROPERTIES = (
        Property("pattern-width", int, 4, 1, None),
        Property("pattern-height", int, 16, 1, None),
        Property("pattern-count", int, 4, 0, None),
        Property("pattern-data-count", int, 5, 0, 64),
        Property("pattern-center", float, 0.5, 0.0, 1.0),
        Property("pattern-sensitivity", float, 0.3, 0.0, 1.0),
        Property("left-offset", int, 0, 0, None),
        Property("bottom-offset", int, 0, 0, None),
        Property("message", bool, True),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._luma(batch.data)
        h, w = y.shape[-2], y.shape[-1]
        pw = self.props["pattern-width"]
        pc = self.props["pattern-count"]
        pdc = self.props["pattern-data-count"]
        center = params["pattern-center"].to(torch.float64) * 255.0
        means = torch.stack(
            [y[..., y0:y1, bx:bx + pw].to(torch.float64)
             .mean(dim=(-2, -1)) for bx, y0, y1 in _blocks(self, h, w)],
            dim=-1)   # [B, pc + pdc]
        bright = means > center
        # the sync pattern must alternate, starting bright
        expect = torch.tensor([i % 2 == 0 for i in range(pc)],
                              dtype=torch.bool, device=y.device)
        found = (bright[..., :pc] == expect[None, :]).all(dim=-1)
        bits = bright[..., pc:].to(torch.int64)
        weights = 2 ** torch.arange(pdc, dtype=torch.int64, device=y.device)
        data = (bits * weights[None, :]).sum(dim=-1)
        msgs = {"simplevideomarkdetect": {
            "_emit": params["message"].expand(y.shape[0]),
            "have-pattern": found,
            "pattern-data": data,
        }}
        return state, batch, msgs
