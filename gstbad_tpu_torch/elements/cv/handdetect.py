"""handdetect (ext/opencv/gsthanddetect.cpp): Haar-cascade hand gestures
with the reference's own fist.xml / palm.xml models, the torch form of
gstbad_tpu/elements/cv/handdetect.py.

Per frame: gray, the FIST cascade and, when no fist is confirmed, PALM;
the best detection is the confirmed window nearest (top-left distance) to
the previous frame's best, a walk over the window's frames carried across
windows; a `hand-gesture` message when the gesture centre falls in the
ROI (or the ROI is the 0,0,0,0 default); display draws the
CV_RGB(0,0,200) circle of radius (w+h)/4.  Both cascades hold tilted
features, so each pyramid scale takes the rotated table (H2) and the
unrolled form of the cascade walk (H1) on the card.  The divergences are
the JAX package's (the 1.1 pyramid, 3x3 confirmation, single windows
rather than cluster averages, a ring for Bresenham's circle, gesture ids
1 = fist and 2 = palm)."""

from __future__ import annotations

import os

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.io.haarcascade import parse_cascade
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops import haar
from gstbad_tpu_torch.ops.numerics import fma32

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data")
MIN_NEIGHBORS = 2          # detectMultiScale(..., 1.1, 2, ...)


def _candidates(gray, packed):
    """Every pyramid window of [B, H, W] frames: (confirmed [B, N],
    x, y float32 [N], w, h float64 [N]), in the JAX package's order."""
    dev = gray.device
    ok, xs, ys, ws, hs = [], [], [], [], []
    for s in haar.detect_multi_scale(gray, packed):
        conf = s["passed"] & (s["counts"] >= MIN_NEIGHBORS)
        ny, nx = conf.shape[1:]
        f = s["factor"]
        ygrid, xgrid = np.meshgrid(np.arange(ny) * haar.STRIDE * f,
                                   np.arange(nx) * haar.STRIDE * f,
                                   indexing="ij")
        ok.append(conf.reshape(conf.shape[0], -1))
        xs.append(torch.from_numpy(xgrid.reshape(-1).astype(np.float32)))
        ys.append(torch.from_numpy(ygrid.reshape(-1).astype(np.float32)))
        ww, wh = s["size"]
        ws.append(torch.full((ny * nx,), float(ww), dtype=torch.float64))
        hs.append(torch.full((ny * nx,), float(wh), dtype=torch.float64))
    return (torch.cat(ok, 1), torch.cat(xs).to(dev), torch.cat(ys).to(dev),
            torch.cat(ws).to(dev), torch.cat(hs).to(dev))


@register
class HandDetect(VideoFilter):
    NAME = "handdetect"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        # the reference spells these profile_fist/ROI_X etc. (a marked
        # FIXME in gsthanddetect.cpp); set_property normalizes _ to -
        Property("display", bool, True, static=True),
        Property("profile-fist", str,
                 os.path.normpath(os.path.join(_DATA, "fist.xml")),
                 static=True),
        Property("profile-palm", str,
                 os.path.normpath(os.path.join(_DATA, "palm.xml")),
                 static=True),
        Property("roi-x", int, 0, 0, None, static=True),
        Property("roi-y", int, 0, 0, None, static=True),
        Property("roi-width", int, 0, 0, None, static=True),
        Property("roi-height", int, 0, 0, None, static=True),
    )

    def prepare(self):
        self._fist = haar.pack(parse_cascade(self.props["profile-fist"]),
                               "unrolled")
        self._palm = haar.pack(parse_cascade(self.props["profile-palm"]),
                               "unrolled")

    def init_state(self, window: int):
        # prev_r starts as Rect(0, 0, 0, 0) (gsthanddetect.cpp temp_r)
        return torch.zeros(2, dtype=torch.float32, device=self.device)

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, h, w, _ = img.shape
        dev = img.device
        gray = cvops.rgb2gray_u8(img)
        fv, fx, fy, fw, fh = _candidates(gray, self._fist)
        pv, px, py, pw, ph = _candidates(gray, self._palm)

        # the nearest-box walk over the window's frames (the JAX scan):
        # which cascade each frame takes comes to the host once a window
        has_fist = fv.any(1)
        has_palm = pv.any(1)
        prev = state
        outs = []
        inf = torch.full((), float("inf"), device=dev)
        for i, use_fist in enumerate(has_fist.tolist()):
            valid, x_, y_, w_, h_ = ((fv[i], fx, fy, fw, fh) if use_fist
                                     else (pv[i], px, py, pw, ph))
            dx = x_ - prev[0]
            dy = y_ - prev[1]
            k = torch.argmin(torch.where(valid, fma32(dx, dx, dy * dy), inf))
            found = has_fist[i] | has_palm[i]
            prev = torch.where(found, torch.stack([x_[k], y_[k]]), prev)
            outs.append((x_[k], y_[k], w_[k], h_[k], found))
        bx, by, bw, bh, found = (torch.stack(v) for v in zip(*outs))
        gesture = torch.where(has_fist, 1, torch.where(has_palm, 2, 0)
                              ).to(torch.int32)

        bx64 = bx.to(torch.float64)
        by64 = by.to(torch.float64)
        cx = bx64 + bw * 0.5
        cy = by64 + bh * 0.5
        rx, ry = self.props["roi-x"], self.props["roi-y"]
        rw, rh = self.props["roi-width"], self.props["roi-height"]
        roi_default = rx == 0 and ry == 0 and rw == 0 and rh == 0
        in_roi = ((cx >= rx) & (cx <= rx + rw) & (cy >= ry)
                  & (cy <= ry + rh)) | bool(roi_default)
        msgs = {"hand-gesture": {
            "gesture": gesture,
            "x": cx.to(torch.int32), "y": cy.to(torch.int32),
            "width": bw.to(torch.int32), "height": bh.to(torch.int32),
            "_emit": found & in_roi}}

        out = img
        if self.props["display"]:
            yy = torch.arange(h, dtype=torch.float64, device=dev)[None, :,
                                                                 None]
            xx = torch.arange(w, dtype=torch.float64, device=dev)[None, None,
                                                                 :]
            cxr = torch.round(cx)[:, None, None]
            cyr = torch.round(cy)[:, None, None]
            radius = torch.round((bw + bh) * 0.25)[:, None, None]
            dist = torch.sqrt((xx - cxr) ** 2 + (yy - cyr) ** 2)
            ring = (torch.abs(dist - radius) <= 0.5) & found[:, None, None]
            marker = torch.tensor([0, 0, 200], dtype=torch.uint8, device=dev)
            out = torch.where(ring[..., None], marker, img)
        return prev, batch.with_data(out), msgs
