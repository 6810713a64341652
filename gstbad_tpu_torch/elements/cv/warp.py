"""Remap-engine clients of the opencv family: cameraundistort + dewarp.

Both build float maps on the host when the caps are set (the reference
builds CV_16SC2 fixed-point maps, gstcameraundistort.cpp:341-357 /
gstdewarp.cpp:438-478), turn them into the four taps of cv::remap's
fixed-point bilinear path once (ops/remap.bilinear_taps) and put those on
the pipeline's device; each window is then four gathers
(ops/remap.remap_taps), exact and equal to the JAX package's
remap_bilinear.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat
from gstbad_tpu_torch.ops import remap as remap_ops


def _device_taps(map_x, map_y, h, w, device):
    flat, weights = remap_ops.bilinear_taps(map_x, map_y, h, w)
    return (torch.from_numpy(flat).to(device),
            torch.from_numpy(weights).to(device), map_x.shape)


@register
class CameraUndistort(VideoFilter):
    """cameraundistort (gstcameraundistort.cpp): lens-distortion correction.

    The reference receives its calibration as a serialized GstStructure
    ("settings", from cameracalibrate's event); here the calibration is
    given directly as camera-matrix ("fx 0 cx 0 fy cy 0 0 1") and
    distortion-coeffs ("k1 k2 p1 p2 k3") properties, or via
    set_calibration(K, dist).  alpha blends the inscribed/bounding
    rectangles of getOptimalNewCameraMatrix; crop draws the valid-pixel ROI
    rectangle (the reference only draws it too — gstcameraundistort.cpp:
    330-334 "TODO do the cropping").
    """

    NAME = "cameraundistort"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3 + (
        VideoFormat.GRAY8,)
    PROPERTIES = (
        Property("show-undistorted", bool, True, static=True),
        Property("alpha", float, 0.0, 0.0, 1.0, static=True),
        Property("crop", bool, False, static=True),
        Property("camera-matrix", str, "", static=True),
        Property("distortion-coeffs", str, "", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._K = None
        self._dist = None
        self._taps = None
        if self.props["camera-matrix"]:
            vals = [float(v) for v in
                    self.props["camera-matrix"].replace(",", " ").split()]
            if len(vals) != 9:
                raise ValueError("camera-matrix needs 9 values")
            K = np.array(vals).reshape(3, 3)
            d = [float(v) for v in
                 self.props["distortion-coeffs"].replace(",", " ").split()
                 ] if self.props["distortion-coeffs"] else [0.0] * 5
            self.set_calibration(K, d)

    def set_calibration(self, K: np.ndarray, dist) -> None:
        """The cameracalibrate-event analog; like the JAX package's, it
        takes effect at the next caps negotiation (until then the element
        passes frames through)."""
        self._K = np.asarray(K, np.float64)
        self._dist = list(dist)
        self._taps = None

    def prepare(self):
        self._taps = None
        if self._K is None or not self.props["show-undistorted"]:
            return
        spec = self.out_spec
        size = (spec.width, spec.height)
        newK = remap_ops.get_optimal_new_camera_matrix(
            self._K, self._dist, size, self.props["alpha"])
        mx, my = remap_ops.init_undistort_map(self._K, self._dist, newK, size)
        self._taps = _device_taps(mx.astype(np.float32),
                                  my.astype(np.float32), spec.height,
                                  spec.width, self.device)
        # valid-pixel ROI from the inner rectangle mapped through newK
        inner, _ = remap_ops._get_rectangles(self._K, self._dist, size)
        x0 = int(np.ceil(inner[0] * newK[0, 0] + newK[0, 2]))
        y0 = int(np.ceil(inner[1] * newK[1, 1] + newK[1, 2]))
        x1 = int(np.floor((inner[0] + inner[2]) * newK[0, 0] + newK[0, 2]))
        y1 = int(np.floor((inner[1] + inner[3]) * newK[1, 1] + newK[1, 2]))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, spec.width - 1), min(y1, spec.height - 1)
        # the green valid-ROI rectangle (CROP_COLOR, :331-333) as a mask
        ii = np.arange(spec.height)[:, None]
        jj = np.arange(spec.width)[None, :]
        border = ((((ii == y0) | (ii == y1)) & (jj >= x0) & (jj <= x1))
                  | (((jj == x0) | (jj == x1)) & (ii >= y0) & (ii <= y1)))
        nch = VideoFormat.n_channels(spec.format)
        color = np.zeros(nch, np.uint8)
        color[1 if nch >= 3 else 0] = 255
        self._crop = (torch.from_numpy(border).to(self.device),
                      torch.from_numpy(color).to(self.device))

    def process(self, params, state, batch: FrameBatch):
        if self._taps is None:
            return state, batch  # passthrough (gstcameraundistort.cpp:336)
        img = batch.data
        gray = img.ndim == 3
        if gray:
            img = img.unsqueeze(-1)
        out = remap_ops.remap_taps(img, *self._taps)
        if self.props["crop"]:
            border, color = self._crop
            out = torch.where(border[None, :, :, None], color, out)
        if gray:
            out = out[..., 0]
        return state, batch.with_data(out)


def _round_up_8(v: int) -> int:
    return (v + 7) & ~7


@register
class Dewarp(VideoFilter):
    """dewarp (gstdewarp.cpp): 360-degree fisheye-donut unwrap.

    Output dims = ROUND_UP_8(2*pi*(r2+r1)/2) x ROUND_UP_8(r2-r1)
    (gst_dewarp_calculate_dimensions:481-527); display modes split the
    panorama into stacked halves or a 2x2 quad (:663-708).  Passthrough
    when outer-radius <= inner-radius.  interpolation-method bilinear and
    nearest are supported; the reference's bicubic/lanczos modes fall back
    to bilinear (documented divergence).

    nearest gathers with fix_map's map of the panorama's own length
    straight into the panorama's shape.  (The JAX package's nearest mode
    goes through its remap, which reshapes to the input's H x W, and
    raises whenever the panorama's size differs from the input's.)
    """

    NAME = "dewarp"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("x-center", float, 0.5, 0.0, 1.0, static=True),
        Property("y-center", float, 0.5, 0.0, 1.0, static=True),
        Property("inner-radius", float, 0.0, 0.0, 1.0, static=True),
        Property("outer-radius", float, 0.0, 0.0, 1.0, static=True),
        Property("remap-x-correction", float, 1.0, 0.1, 10.0, static=True),
        Property("remap-y-correction", float, 1.0, 0.1, 10.0, static=True),
        Property("display-mode", str, "single-panorama", static=True,
                 doc="single-panorama | double-panorama | quad-view"),
        Property("interpolation-method", str, "bilinear", static=True,
                 doc="nearest | bilinear"),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        r1 = in_spec.width * self.props["inner-radius"]
        r2 = in_spec.width * self.props["outer-radius"]
        if self.props["outer-radius"] <= self.props["inner-radius"]:
            self._passthrough = True
            return spec
        self._passthrough = False
        out_w = _round_up_8(int((2.0 * np.pi) * ((r2 + r1) / 2.0)))
        out_h = _round_up_8(int(r2 - r1))
        if self.props["display-mode"] != "single-panorama":
            out_w //= 2
            out_h *= 2
        if out_w == 0 or out_h == 0:
            self._passthrough = True
            return spec
        self._in_w, self._in_h = in_spec.width, in_spec.height
        return spec.with_(width=out_w, height=out_h)

    def prepare(self):
        if self._passthrough:
            return
        spec = self.out_spec
        if self.props["display-mode"] == "single-panorama":
            map_w, map_h = spec.width, spec.height
        else:
            map_w, map_h = spec.width * 2, spec.height // 2
        mx, my = remap_ops.dewarp_map(
            self._in_w, self._in_h, map_w, map_h,
            self.props["x-center"], self.props["y-center"],
            self.props["inner-radius"], self.props["outer-radius"],
            self.props["remap-x-correction"], self.props["remap-y-correction"])
        if self.props["interpolation-method"] == "nearest":
            flat, valid = remap_ops.fix_map(np.stack([mx, my], -1),
                                            self._in_w, self._in_h, "ignore")
            self._nearest = (torch.from_numpy(flat).to(self.device),
                             torch.from_numpy(valid).to(self.device),
                             mx.shape)
        else:
            self._taps = _device_taps(mx, my, self._in_h, self._in_w,
                                      self.device)

    def process(self, params, state, batch: FrameBatch):
        if self._passthrough:
            return state, batch
        img = batch.data
        b, h, w, c = img.shape
        if self.props["interpolation-method"] == "nearest":
            flat, valid, (ph, pw) = self._nearest
            pano = img.reshape(b, h * w, c).index_select(1, flat)
            pano = torch.where(valid[None, :, None], pano,
                               torch.zeros((), dtype=img.dtype,
                                           device=img.device))
            pano = pano.reshape(b, ph, pw, c)
        else:
            pano = remap_ops.remap_taps(img, *self._taps)
        mode = self.props["display-mode"]
        if mode == "single-panorama":
            out = pano
        elif mode == "double-panorama":
            w2 = pano.shape[2] // 2
            out = torch.cat([pano[:, :, :w2], pano[:, :, w2:]], dim=1)
        else:  # quad-view (gstdewarp.cpp:682-707)
            vw = pano.shape[2] // 4
            v = [pano[:, :, i * vw:(i + 1) * vw] for i in range(4)]
            left = torch.cat([v[0], v[1]], dim=1)
            right = torch.cat([v[2], v[3]], dim=1)
            out = torch.cat([left, right], dim=2)
        return state, batch.with_data(out)
