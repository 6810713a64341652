"""Detection elements of the opencv family: skindetect + motioncells.

skindetect is stateless per-pixel classification; motioncells carries the
previous half-resolution gray frame in its state and emits per-frame
`motion` messages with the motion-cell grid — the reference's string
encoding ("i:j,i:j") is available via MotionCells.indices_string().
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.ops import cv as cvops


@register
class SkinDetect(VideoFilter):
    """skindetect (gstskindetect.cpp:299-396): HSV or RGB rule-based skin
    mask, optional opening-closing postprocess (erode, 2x dilate, erode),
    output = GRAY2RGB of the mask."""

    NAME = "skindetect"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("postprocess", bool, True, static=True),
        Property("method", str, "hsv", static=True, doc="hsv | rgb"),
    )

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        if self.props["method"] == "hsv":
            hsv = cvops.rgb2hsv_u8(img)
            h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
            h2 = cvops.threshold_binary(h, 10)            # hue > 10
            hm = cvops.threshold_binary(h, 20, inverse=True)  # hue <= 20
            sm = cvops.threshold_binary(s, 48)
            vm = cvops.threshold_binary(v, 80)
            # erode the HUE mask once (gstskindetect.cpp:324)
            hm = cvops.erode_u8(hm, 1)
            mask = hm & sm & h2 & vm
        else:  # RGB rules (gstskindetect.cpp:334-369)
            r = img[..., 0].to(torch.float32)
            g = img[..., 1].to(torch.float32)
            b = img[..., 2].to(torch.float32)
            # the reference adds into a CV_32F dst, so no u8 saturation
            allc = r + g + b
            # cv::divide yields 0 where the divisor is 0
            zero = torch.zeros((), dtype=torch.float32, device=img.device)
            rp = torch.where(allc > 0, r / allc, zero)
            gp = torch.where(allc > 0, g / allc, zero)
            m = ((r > 60) & (rp > np.float32(0.42)) & (rp <= np.float32(0.6))
                 & (gp > np.float32(0.28)) & (gp <= np.float32(0.4)))
            mask = torch.where(m, 255, 0).to(torch.uint8)
        if self.props["postprocess"]:
            mask = cvops.erode_u8(mask, 1)
            mask = cvops.dilate_u8(mask, 2)
            mask = cvops.erode_u8(mask, 1)
        return state, batch.with_data(cvops.gray2rgb(mask))


@register
class MotionCells(VideoFilter):
    """motioncells (gstmotioncells.cpp + MotionCells.cpp:105-425):
    grid-based motion detection.

    Per frame: pyrDown to half size, gray, absdiff vs the previous
    half-gray frame, adaptiveThreshold(GAUSSIAN, INV, 7, 5), dilate x2 +
    erode x2, per-cell motion ratio vs (1 - sensitivity)
    (calculateMotionPercentInCell, MotionCells.cpp:390-425 — the
    reference's early-exit floor quirks are not reproduced; the decision is
    the exact ratio > 1-sensitivity).  Emits a `motion` message per frame
    with the boolean cell grid and has_motion (cells beyond `threshold`
    fraction); display paints cell rectangles.

    The previous half-res gray frame and whether there was one ("primed")
    are the carried state, so windows chain and checkpoints resume;
    framerate-based frame skipping (sumframecnt, MotionCells.cpp:119-128)
    is not applied (every frame is analyzed).
    """

    NAME = "motioncells"
    FORMATS = (VideoFormat.RGB,)
    PROPERTIES = (
        Property("gridx", int, 10, 1, 32, static=True),
        Property("gridy", int, 10, 1, 32, static=True),
        Property("sensitivity", float, 0.5, 0.0, 1.0, controllable=True),
        Property("threshold", float, 0.01, 0.0, 1.0, controllable=True),
        Property("display", bool, True, static=True),
        Property("postallmotion", bool, False, static=True),
        Property("cellscolor", str, "255,0,0", static=True),
    )

    def init_state(self, window: int):
        spec = self.out_spec
        hh, hw = spec.height // 2, spec.width // 2
        return {"prev": torch.zeros((hh, hw), dtype=torch.uint8,
                                    device=self.device),
                "primed": torch.zeros((), dtype=torch.bool,
                                      device=self.device)}

    def prepare(self):
        spec = self.out_spec
        gx, gy = self.props["gridx"], self.props["gridy"]
        h, w = spec.height, spec.width
        hh, hw = (h + 1) // 2, (w + 1) // 2     # pyrDown's output
        # per-cell ids on the half-res image; cell bounds floor(j*cw)
        cw = hw / gx
        ch = hh / gy
        col_of = (np.arange(hw)[None, :] >= np.floor(
            np.arange(gx)[:, None] * cw)).sum(0) - 1
        row_of = (np.arange(hh)[None, :] >= np.floor(
            np.arange(gy)[:, None] * ch)).sum(0) - 1
        cell_id = (row_of[:, None] * gx + col_of[None, :]).astype(np.int64)
        dev = self.device
        self._ids = torch.from_numpy(cell_id.reshape(-1)).to(dev)
        self._areas = torch.from_numpy(np.bincount(
            cell_id.reshape(-1), minlength=gy * gx).astype(np.int32)).to(dev)
        # the full-res cell of each row and column (cell bounds * 2) and
        # the 1px border of each cell
        ys = np.repeat(row_of, 2)[:h]
        xs = np.repeat(col_of, 2)[:w]
        edge_y = (np.concatenate([[True], ys[1:] != ys[:-1]])
                  | np.concatenate([ys[1:] != ys[:-1], [True]]))
        edge_x = (np.concatenate([[True], xs[1:] != xs[:-1]])
                  | np.concatenate([xs[1:] != xs[:-1], [True]]))
        self._paint = tuple(torch.from_numpy(a).to(dev)
                            for a in (ys, xs, edge_y, edge_x))
        self._color = torch.tensor(
            [int(v) for v in self.props["cellscolor"].split(",")],
            dtype=torch.uint8, device=dev)

    @staticmethod
    def indices_string(grid: np.ndarray) -> str:
        """The reference's motioncellsidx encoding "line:col,line:col"
        (MotionCells.cpp:209-222)."""
        ys, xs = np.nonzero(np.asarray(grid))
        return ",".join(f"{i}:{j}" for i, j in zip(ys, xs)) or " "

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b = img.shape[0]
        gx, gy = self.props["gridx"], self.props["gridy"]
        gray = cvops.rgb2gray_u8(cvops.pyr_down_u8(img))

        # sequential prev-frame chain across the window
        prevs = torch.cat([state["prev"][None], gray[:-1]], dim=0)
        diff = torch.abs(gray.to(torch.int32) - prevs.to(torch.int32)
                         ).to(torch.uint8)
        bw = cvops.adaptive_threshold_gaussian_inv(diff, 7, 5)
        bw = cvops.erode_u8(cvops.dilate_u8(bw, 2), 2)
        moving = bw > 0

        counts = torch.zeros((b, gy * gx), dtype=torch.int32,
                             device=img.device).index_add_(
            1, self._ids, moving.reshape(b, -1).to(torch.int32))
        ratio = counts.to(torch.float64) / torch.clamp(
            self._areas, min=1).to(torch.float64)
        sens = 1.0 - params["sensitivity"]
        if sens.ndim:
            sens = sens[:, None]
        has = (ratio > sens).reshape(b, gy, gx)
        # the reference only scores cells when the bw image is nonzero at
        # all (MotionCells.cpp:174)
        any_moving = moving.reshape(b, -1).any(dim=1)
        has = has & any_moving[:, None, None]
        n_motion = has.reshape(b, -1).sum(dim=1)
        frame_motion = n_motion > params["threshold"] * (gx * gy)

        out = img
        if self.props["display"]:
            ys, xs, edge_y, edge_x = self._paint
            cell_full = has[:, ys][:, :, xs]
            border = cell_full & (edge_y[None, :, None]
                                  | edge_x[None, None, :])
            out = torch.where(border.unsqueeze(-1), self._color, img)

        new_state = {"prev": gray[-1],
                     "primed": torch.ones((), dtype=torch.bool,
                                          device=img.device)}
        emit = frame_motion | bool(self.props["postallmotion"])
        # the first ever frame has no previous frame to diff against
        first = ~state["primed"]
        emit = emit & ~(first & (torch.arange(b, device=img.device) == 0))
        msgs = {"motion": {"cells": has, "n_motion": n_motion,
                           "has_motion": frame_motion,
                           "_emit": emit}}
        return new_state, batch.with_data(out), msgs
