"""cvtracker (ext/opencv/gstcvtracker.cpp) over the MOSSE engine
(ops/mosse.py), the torch form of gstbad_tpu/elements/cv/tracker.py.

The first frame initialises the tracker on the object-initial-* box;
every later frame updates it: on success an `object` message posts the
box and draw-rect paints the cv::Scalar(255, 0, 0) rectangle of
thickness 2; a lost track posts nothing and keeps trying.  `algorithm`
accepts only "mosse" (the reference's other trackers are opencv_contrib
classes).  The box keeps its size.  The per-frame walk is the JAX scan's;
its box decision is read on the host each frame."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops import mosse


@register
class CvTracker(VideoFilter):
    NAME = "cvtracker"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("object-initial-x", int, 50, 0, None, static=True),
        Property("object-initial-y", int, 50, 0, None, static=True),
        Property("object-initial-width", int, 50, 1, None, static=True),
        Property("object-initial-height", int, 50, 1, None, static=True),
        Property("algorithm", str, "mosse", static=True),
        Property("draw-rect", bool, True, static=True),
    )

    def negotiate(self, in_spec):
        require(self.props["algorithm"] == "mosse",
                "cvtracker: only the mosse algorithm is available here "
                "(the reference's other trackers are opencv_contrib "
                "classes absent from this environment)")
        return super().negotiate(in_spec)

    def _box(self):
        return (self.props["object-initial-x"],
                self.props["object-initial-y"],
                self.props["object-initial-width"],
                self.props["object-initial-height"])

    def init_state(self, window: int):
        x, y, w, h = self._box()
        z = torch.zeros((h, w), dtype=torch.complex64, device=self.device)
        return {"a": z, "b": z.clone(), "cy": 0.0, "cx": 0.0, "ok": True,
                "inited": False}

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, ih, iw, _ = img.shape
        dev = img.device
        x, y, w, h = self._box()
        gray = cvops.rgb2gray_u8(img)
        oks, cys, cxs = [], [], []
        for t in range(b):
            if state["inited"]:
                model, ok, cy, cx = mosse.update(state, gray[t], h, w)
            else:
                model = mosse.init_state(gray[t], (x, y, w, h))
                ok, cy, cx = False, model["cy"], model["cx"]
            state = {**model, "inited": True}
            oks.append(ok)
            cys.append(cy)
            cxs.append(cx)
        ok = torch.tensor(oks, dtype=torch.bool, device=dev)
        bx = torch.tensor([int(np.float32(c) - np.float32(w / 2))
                           for c in cxs], dtype=torch.int32, device=dev)
        by = torch.tensor([int(np.float32(c) - np.float32(h / 2))
                           for c in cys], dtype=torch.int32, device=dev)
        msgs = {"object": {"x": bx, "y": by,
                           "width": torch.full((b,), w, dtype=torch.int32,
                                               device=dev),
                           "height": torch.full((b,), h, dtype=torch.int32,
                                                device=dev),
                           "_emit": ok}}
        out = img
        if self.props["draw-rect"]:
            yy = torch.arange(ih, dtype=torch.int32, device=dev)[None, :, None]
            xx = torch.arange(iw, dtype=torch.int32, device=dev)[None, None, :]
            x0 = bx[:, None, None]
            y0 = by[:, None, None]
            x1 = x0 + w
            y1 = y0 + h
            # the thickness-2 rectangle (cv::rectangle .., 2, ..)
            near_v = (((torch.abs(xx - x0) <= 1) | (torch.abs(xx - x1) <= 1))
                      & (yy >= y0 - 1) & (yy <= y1 + 1))
            near_h = (((torch.abs(yy - y0) <= 1) | (torch.abs(yy - y1) <= 1))
                      & (xx >= x0 - 1) & (xx <= x1 + 1))
            border = (near_v | near_h) & ok[:, None, None]
            color = torch.tensor([255, 0, 0], dtype=torch.uint8, device=dev)
            out = torch.where(border[..., None], color, img)
        return state, batch.with_data(out), msgs
