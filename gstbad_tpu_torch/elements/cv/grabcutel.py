"""grabcut (ext/opencv/gstgrabcut.cpp) over ops/grabcut.py, the torch form
of gstbad_tpu/elements/cv/grabcutel.py.

RGBA in; the alpha plane is the GrabCut seed mask when it has content
(values clamped to GC_PR_FGD); otherwise the bbox properties (the
reference's RegionOfInterest meta, grown by `scale`) seed
GC_INIT_WITH_RECT; with neither the frame passes untouched.  test-mode
ANDs the (FGD|PR_FGD) mask into RGB and draws the CV_RGB(255,0,255) bbox.
The refined mask is not written to alpha, as in the reference.  Each frame
is its own GrabCut run; which frames run is a host decision."""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.ops import grabcut as gcops


@register
class GrabCut(VideoFilter):
    NAME = "grabcut"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("test-mode", bool, False, static=True),
        Property("scale", float, 1.6, 1.0, 4.0, static=True),
        # bbox analog of the RegionOfInterest meta (x, y, w, h)
        Property("bbox-x", int, 0, 0, None, static=True),
        Property("bbox-y", int, 0, 0, None, static=True),
        Property("bbox-width", int, 0, 0, None, static=True),
        Property("bbox-height", int, 0, 0, None, static=True),
    )

    def _facepos(self):
        """The scale-grown box (gstgrabcut.cpp:300-303)."""
        s = self.props["scale"]
        mx, my = self.props["bbox-x"], self.props["bbox-y"]
        mw, mh = self.props["bbox-width"], self.props["bbox-height"]
        return (int(mx - (s - 1) * mw / 2), int(my - (s - 1) * mh / 2),
                int(mw * s * 0.9), int(mh * s * 1.1))

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b, h, w, _ = img.shape
        dev = img.device
        rgb = img[..., :3]
        alpha = img[..., 3]
        fx, fy, fw, fh = self._facepos()
        have_bbox = abs(fw) > 2 and abs(fh) > 2
        rect_mask = (gcops.init_mask_from_rect(h, w, (fx, fy, fw, fh), dev)
                     if have_bbox else None)
        n_alpha = (alpha != 0).reshape(b, -1).sum(1).tolist()
        fgs, ran = [], []
        for t in range(b):
            use_alpha = 0 < n_alpha[t] < h * w
            runnable = use_alpha or rect_mask is not None
            init = (torch.clamp(alpha[t], max=gcops.GC_PR_FGD)
                    if use_alpha or rect_mask is None else rect_mask)
            refined = gcops.grabcut(rgb[t], init, iterations=1)
            fgs.append(((refined & 1) == 1) & runnable)
            ran.append(runnable)
        fgmask = torch.stack(fgs)
        ran = torch.tensor(ran, dtype=torch.bool, device=dev)

        out = img
        if self.props["test-mode"]:
            new_rgb = torch.where(fgmask[..., None], rgb,
                                  torch.zeros((), dtype=torch.uint8,
                                              device=dev))
            out = img.clone()
            out[..., :3] = torch.where(ran[:, None, None, None], new_rgb, rgb)
            if have_bbox:
                yy = torch.arange(h, device=dev)[:, None]
                xx = torch.arange(w, device=dev)[None, :]
                on_edge = ((((yy == fy) | (yy == fy + fh))
                            & (xx >= fx) & (xx <= fx + fw))
                           | (((xx == fx) | (xx == fx + fw))
                              & (yy >= fy) & (yy <= fy + fh)))
                magenta = torch.tensor([255, 0, 255], dtype=torch.uint8,
                                       device=dev)
                out[..., :3] = torch.where(on_edge[None, ..., None], magenta,
                                           out[..., :3])
        msgs = {"grabcut": {"fg-pixels": fgmask.reshape(b, -1).sum(1).to(
            torch.int32), "_emit": ran}}
        return state, batch.with_data(out), msgs
