"""opencv element family, the per-pixel filters (reference: ext/opencv/).

The reference wraps OpenCV behind GstOpencvVideoFilter; here each element is
the same composition (gray conversion, the cv op, the mask/display logic)
over ops/cv.py's torch implementations, the JAX package's
(gstbad_tpu/elements/cv/filters.py) element for element.

Caps follow the reference: the gray-analysis elements take RGB
(gstcvsobel.cpp:66-76), equalizehist takes GRAY8
(gstcvequalizehist.cpp:69-76); dilate/erode/smooth accept any packed video.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops.numerics import f32
from gstbad_tpu_torch.ops import pointops


class _RGBFilter(VideoFilter):
    FORMATS = (VideoFormat.RGB,)


def _mask_or_gray(batch: FrameBatch, edge: torch.Tensor, mask: bool):
    """mask ? img.copyTo(out, edge) : gray2rgb(edge)."""
    if mask:
        return cvops.apply_mask_rgb(batch.data, edge)
    return cvops.gray2rgb(edge)


@register
class CvSobel(_RGBFilter):
    """cvsobel (gstcvsobel.cpp:258-273): RGB -> gray -> cv::Sobel(CV_8U)
    -> mask ? img.copyTo(out, sobel) : gray2rgb(sobel)."""

    NAME = "cvsobel"
    PROPERTIES = (
        Property("x-order", int, 1, 0, 2, static=True),
        Property("y-order", int, 0, 0, 2, static=True),
        Property("aperture-size", int, 3, 1, 7, static=True,
                 doc="1, 3, 5 or 7 (gstcvsobel.cpp:156)"),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        edge = cvops.sobel_u8(gray, self.props["x-order"],
                              self.props["y-order"],
                              self.props["aperture-size"])
        return state, batch.with_data(
            _mask_or_gray(batch, edge, self.props["mask"]))


@register
class CvLaplace(_RGBFilter):
    """cvlaplace (gstcvlaplace.cpp:261-280): gray -> Laplacian(CV_16S)
    -> convertTo(CV_8U, scale, shift) -> mask/gray2rgb."""

    NAME = "cvlaplace"
    PROPERTIES = (
        Property("aperture-size", int, 3, 1, 7, static=True),
        Property("scale", float, 1.0, controllable=True),
        Property("shift", float, 0.0, controllable=True),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        lap = cvops.laplacian_i16(gray, self.props["aperture-size"])
        lap8 = cvops.convert_scale_u8(
            lap, pointops._per_frame(params["scale"], 3),
            pointops._per_frame(params["shift"], 3))
        return state, batch.with_data(
            _mask_or_gray(batch, lap8, self.props["mask"]))


@register
class CvSmooth(VideoFilter):
    """cvsmooth (gstcvsmooth.cpp:385-430): blur/gaussian/median/bilateral,
    optionally restricted to a position/width/height ROI (the reference
    smooths the ROI in place and leaves the rest untouched)."""

    NAME = "cvsmooth"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (
        Property("type", str, "gaussian", static=True,
                 doc="blur | gaussian | median | bilateral"),
        Property("kernel-width", int, 3, 1, None, static=True),
        Property("kernel-height", int, 3, 0, None, static=True),
        Property("color", float, 0.0, 0.0, None, static=True),
        Property("spatial", float, 0.0, 0.0, None, static=True),
        Property("position-x", int, 0, 0, None, static=True),
        Property("position-y", int, 0, 0, None, static=True),
        Property("width", int, 1 << 30, 0, None, static=True),
        Property("height", int, 1 << 30, 0, None, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        # cv::blur asserts ksize.width > 0 && ksize.height > 0; the
        # gaussian takes kernel-height 0 as kernel-width
        require(self.props["type"] != "blur"
                or self.props["kernel-height"] > 0,
                "cvsmooth: type=blur needs kernel-height > 0")
        return spec

    def _smooth(self, img):
        kind = self.props["type"]
        kw = self.props["kernel-width"]
        kh = self.props["kernel-height"]
        if kind == "blur":
            return cvops.box_blur_u8(img, kw, kh)
        if kind == "gaussian":
            return cvops.gaussian_blur_u8(img, kw, kh, self.props["color"])
        if kind == "median":
            return cvops.median_blur_u8(img, kw)
        if kind == "bilateral":
            return cvops.bilateral_u8(img, self.props["color"],
                                      self.props["spatial"])
        raise ValueError(f"cvsmooth: unknown type {kind!r}")

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        gray = img.ndim == 3  # GRAY8 [B, H, W]
        if gray:
            img = img.unsqueeze(-1)
        h, w = img.shape[1], img.shape[2]
        px, py = self.props["position-x"], self.props["position-y"]
        rw = min(self.props["width"], w - px)
        rh = min(self.props["height"], h - py)
        full_roi = px == 0 and py == 0 and rw == w and rh == h
        if px >= w or py >= h or rw <= 0 or rh <= 0:
            out = img  # effect entirely outside (gstcvsmooth.cpp:394-400)
        elif full_roi:
            out = self._smooth(img)
        else:
            # the reference smooths the ROI as its own Mat view: borders
            # reflect at the ROI edges, not the frame edges
            out = img.clone()
            out[:, py:py + rh, px:px + rw] = self._smooth(
                img[:, py:py + rh, px:px + rw])
        if gray:
            out = out[..., 0]
        return state, batch.with_data(out)


@register
class CvDilate(VideoFilter):
    """cvdilate (gstcvdilate.cpp:104-111): cv::dilate, default 3x3 kernel."""

    NAME = "cvdilate"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (Property("iterations", int, 1, 1, 64, static=True),)
    _OP = staticmethod(cvops.dilate_u8)

    def process(self, params, state, batch: FrameBatch):
        # the 3x3 rect op is the same on [B, H, W] and [B, H, W, C]
        return state, batch.with_data(
            self._OP(batch.data, self.props["iterations"]))


@register
class CvErode(CvDilate):
    """cverode (gstcverode.cpp): cv::erode."""

    NAME = "cverode"
    _OP = staticmethod(cvops.erode_u8)


@register
class CvEqualizeHist(VideoFilter):
    """cvequalizehist (gstcvequalizehist.cpp:117-121): cv::equalizeHist on
    GRAY8."""

    NAME = "cvequalizehist"
    FORMATS = (VideoFormat.GRAY8,)

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(cvops.equalize_hist_u8(batch.data))


@register
class EdgeDetect(_RGBFilter):
    """edgedetect (gstedgedetect.cpp:259-276): gray -> cv::Canny ->
    mask/gray2rgb.  threshold1/2 defaults 50/150 (gstedgedetect.cpp:184-185).
    """

    NAME = "edgedetect"
    PROPERTIES = (
        Property("threshold1", int, 50, 0, 1000, static=True),
        Property("threshold2", int, 150, 0, 1000, static=True),
        Property("aperture-size", int, 3, 3, 7, static=True),
        Property("mask", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        gray = cvops.rgb2gray_u8(batch.data)
        edge = cvops.canny_u8(gray, self.props["threshold1"],
                              self.props["threshold2"],
                              self.props["aperture-size"])
        return state, batch.with_data(
            _mask_or_gray(batch, edge, self.props["mask"]))


@register
class Retinex(_RGBFilter):
    """retinex (gstretinex.cpp:333-411): basic (single-scale) or multiscale
    log-domain enhancement; multiscale uses weights 1/scales and sigmas
    10+4*scales as the reference computes them (:374-386)."""

    NAME = "retinex"
    PROPERTIES = (
        Property("method", str, "basic", static=True,
                 doc="basic | multiscale"),
        Property("scales", int, 3, 1, 4, static=True),
        Property("sigma", float, 14.0, 0.0, None, static=True),
        Property("gain", int, 128, 0, None, static=True),
        Property("offset", int, 128, 0, None, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        if self.props["method"] == "multiscale":
            out = cvops.retinex_multiscale(batch.data, self.props["scales"],
                                           self.props["gain"],
                                           self.props["offset"])
        else:
            out = cvops.retinex_basic(batch.data, self.props["sigma"],
                                      self.props["gain"],
                                      self.props["offset"])
        return state, batch.with_data(out)


@register
class TemplateMatch(_RGBFilter):
    """templatematch (gsttemplatematch.cpp:289-386): cv::matchTemplate +
    minMaxLoc per frame, posts a `template_match` message {x, y, width,
    height, result}; display draws a 3px rectangle at the best match.

    The template property is a .npy of shape [th, tw, 3], or an image path
    read with OpenCV (cv2 is imported only then, and its ImportError
    propagates where OpenCV is missing); set_template(ndarray) sets one in
    code.
    """

    NAME = "templatematch"
    PROPERTIES = (
        Property("method", str, "ccorr-normed", static=True,
                 doc="sqdiff | sqdiff-normed | ccorr | ccorr-normed | "
                     "ccoeff | ccoeff-normed (gsttemplatematch.cpp:212-233)"),
        Property("template", str, "", static=True),
        Property("display", bool, True, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._templ: np.ndarray | None = None
        self._templ_dev: torch.Tensor | None = None
        if self.props["template"]:
            self.set_template(self._load(self.props["template"]))

    @staticmethod
    def _load(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path)
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"templatematch: cannot read {path!r}")
        return img[..., ::-1]  # BGR -> RGB

    def set_template(self, templ: np.ndarray) -> None:
        if templ.ndim != 3 or templ.shape[-1] != 3:
            raise ValueError("template must be [th, tw, 3] u8")
        self._templ = np.ascontiguousarray(templ.astype(np.uint8))
        self._templ_dev = None

    def prepare(self):
        self._templ_dev = None

    def process(self, params, state, batch: FrameBatch):
        if self._templ is None:
            return state, batch
        method = self.props["method"].replace("-", "_")
        img = batch.data
        dev = img.device
        if self._templ_dev is None or self._templ_dev.device != dev:
            self._templ_dev = torch.from_numpy(self._templ).to(dev)
        b, h, w, _ = img.shape
        score = cvops.match_template(img, self._templ_dev, method)
        th, tw, _ = self._templ.shape
        flat = score.reshape(b, -1)
        if method.startswith("sqdiff"):
            idx = torch.argmin(flat, dim=1)
        else:
            idx = torch.argmax(flat, dim=1)
        best = torch.gather(flat, 1, idx[:, None])[:, 0]
        if method == "sqdiff_normed":
            best = 1.0 - best  # gsttemplatematch.cpp:299-301
        sw = score.shape[2]
        ys = (idx // sw).to(torch.int32)
        xs = (idx % sw).to(torch.int32)
        out = img
        if self.props["display"]:
            # cv::rectangle(img, best_pos, best_pos+templ_size, color, 3):
            # a 3px border centered on the rectangle edges
            ii = torch.arange(h, device=dev)[None, :, None]
            jj = torch.arange(w, device=dev)[None, None, :]
            y0 = ys[:, None, None]
            x0 = xs[:, None, None]
            y1 = y0 + th
            x1 = x0 + tw
            on_h = ((torch.abs(ii - y0) <= 1) | (torch.abs(ii - y1) <= 1)) & \
                   (jj >= x0 - 1) & (jj <= x1 + 1)
            on_v = ((torch.abs(jj - x0) <= 1) | (torch.abs(jj - x1) <= 1)) & \
                   (ii >= y0 - 1) & (ii <= y1 + 1)
            border = on_h | on_v
            full = torch.full((b,), 255, dtype=torch.uint8, device=dev)
            if method.endswith("_normed"):
                # yellow growing redder as certainty -> 1 (":365-369")
                g = torch.clamp(255.0 - f32(
                    lambda t: torch.pow(255.0, t), best), 0, 255
                ).to(torch.uint8)
            else:
                g = torch.full((b,), 32, dtype=torch.uint8, device=dev)
            color = torch.stack([full, g, torch.full_like(full, 32)], -1)
            out = torch.where(border.unsqueeze(-1), color[:, None, None, :],
                              img)
        msgs = {"template_match": {
            "x": xs, "y": ys,
            "width": torch.full((b,), tw, dtype=torch.int32, device=dev),
            "height": torch.full((b,), th, dtype=torch.int32, device=dev),
            "result": best.to(torch.float64),
        }}
        return state, batch.with_data(out), msgs
