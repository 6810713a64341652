"""facedetect / faceblur (ext/opencv/gstfacedetect.cpp, gstfaceblur.cpp):
Haar-cascade face detection over OpenCV's model files, the torch form of
gstbad_tpu/elements/cv/facedetect.py.

facedetect: gray conversion, the min-stddev gate, the pyramid (ops/haar.py
over a window of frames at once, the H1 kernel on the card), a
`facedetect` message per frame with up to MAX_FACES boxes posted per the
updates mode, the nose/mouth/eyes sub-detections where their profiles
exist, and display ellipses in the reference's per-face colours.
faceblur: each detected box gets blur(11x11) then GaussianBlur(11x11, 0).

The confirmation is the JAX package's 3x3 neighbour count and greedy
top-score pick with centre-inside suppression (its documented divergence
from cv::groupRectangles).  The `profile` default is the reference's
/usr/share/opencv4 path; gstbad_tpu_torch/data/ holds a copy of
haarcascade_frontalface_alt2.xml for hosts without opencv4's data."""

from __future__ import annotations

import os

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.io.haarcascade import parse_cascade
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops import haar
from gstbad_tpu_torch.ops.numerics import fma32

HAAR_DIR = "/usr/share/opencv4/haarcascades/"
MAX_FACES = 8
UPDATES = ("every-frame", "on-change", "on-face", "none")


def _load(profile: str):
    """The packed cascade of a profile path, or None when it is absent or
    unparsable (the references warn and skip that detector)."""
    if not profile or not os.path.exists(profile):
        return None
    try:
        return haar.pack(parse_cascade(profile), "arrays")
    except Exception:  # noqa: BLE001 — unparsable profile = disabled
        return None


def detect_faces(gray, packed, scale_factor, min_neighbors, min_w, min_h):
    """[B, H, W] float32 -> (boxes [B, MAX_FACES, 4] int32 (x, y, w, h),
    valid [B, MAX_FACES]): confirmed windows (pass and 3x3 count >=
    min_neighbors) over the pyramid, picked greedily by count + score/1000
    with the windows whose centre falls in a picked box suppressed."""
    b = gray.shape[0]
    dev = gray.device
    cand_score, cand_box = [], []
    for s in haar.detect_multi_scale(gray, packed, scale_factor):
        fw, fh = s["size"]
        if (min_w and fw < min_w) or (min_h and fh < min_h):
            continue
        ok = s["passed"] & (s["counts"] >= min_neighbors)
        ny, nx = ok.shape[1:]
        f = s["factor"]
        xs = (torch.arange(nx, device=dev, dtype=torch.float64)
              * haar.STRIDE * f).to(torch.int32)
        ys = (torch.arange(ny, device=dev, dtype=torch.float64)
              * haar.STRIDE * f).to(torch.int32)
        thousandth = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        score = torch.where(
            ok, fma32(s["score"], thousandth,
                       s["counts"].to(torch.float32)),
            torch.full((), -float("inf"), device=dev))
        cand_score.append(score.reshape(b, -1))
        cand_box.append(torch.stack([
            xs[None, :].expand(ny, nx).reshape(-1),
            ys[:, None].expand(ny, nx).reshape(-1),
            torch.full((ny * nx,), fw, dtype=torch.int32, device=dev),
            torch.full((ny * nx,), fh, dtype=torch.int32, device=dev)], -1))
    out = torch.zeros((b, MAX_FACES, 4), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, MAX_FACES), dtype=torch.bool, device=dev)
    if not cand_score:
        return out, valid
    score = torch.cat(cand_score, 1)
    boxes = torch.cat(cand_box, 0)                     # [N, 4]
    cx = boxes[:, 0] + boxes[:, 2] // 2
    cy = boxes[:, 1] + boxes[:, 3] // 2
    rows = torch.arange(b, device=dev)
    for k in range(MAX_FACES):
        i = torch.argmax(score, 1)
        take = torch.isfinite(score[rows, i])
        box = boxes[i]                                 # [B, 4]
        out[:, k] = torch.where(take[:, None], box, out[:, k])
        valid[:, k] = take
        inside = ((cx[None] >= box[:, 0:1]) & (cx[None] < box[:, 0:1]
                                                + box[:, 2:3])
                  & (cy[None] >= box[:, 1:2]) & (cy[None] < box[:, 1:2]
                                                 + box[:, 3:4]))
        score = torch.where(take[:, None] & inside,
                            torch.full((), -float("inf"), device=dev), score)
    return out, valid


def _ellipse_ring(h, w, cx, cy, ax, ay, thickness):
    """|normalised radius - 1| <= eps, eps = thickness / (2 min axis): a
    ring like cv::ellipse's.  cx, cy, ax, ay float32 [B]; [B, H, W]."""
    dev = cx.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    axf = torch.clamp(ax, min=1.0)[:, None, None]
    ayf = torch.clamp(ay, min=1.0)[:, None, None]
    u = (xx - cx[:, None, None]) / axf
    v = (yy - cy[:, None, None]) / ayf
    r = torch.sqrt(fma32(u, u, v * v).to(torch.float64)).to(torch.float32)
    two = torch.full((), 2.0, dtype=torch.float32, device=dev)
    eps = thickness / (two * torch.minimum(axf, ayf))
    return torch.abs(r - 1.0) <= eps


class _CascadeFilter(VideoFilter):
    FORMATS = (VideoFormat.RGB,)

    def _gray(self, data):
        return cvops.rgb2gray_u8(data).to(torch.float32)

    def _detect(self, data):
        return detect_faces(self._gray(data), self._face,
                            self.props["scale-factor"],
                            self.props["min-neighbors"],
                            self.props["min-size-width"],
                            self.props["min-size-height"])


@register
class FaceDetect(_CascadeFilter):
    NAME = "facedetect"
    PROPERTIES = (
        Property("display", bool, True, static=True),
        Property("profile", str,
                 HAAR_DIR + "haarcascade_frontalface_default.xml",
                 static=True),
        Property("nose-profile", str,
                 HAAR_DIR + "haarcascade_mcs_nose.xml", static=True),
        Property("mouth-profile", str,
                 HAAR_DIR + "haarcascade_mcs_mouth.xml", static=True),
        Property("eyes-profile", str,
                 HAAR_DIR + "haarcascade_mcs_eyepair_small.xml",
                 static=True),
        Property("scale-factor", float, 1.25, 1.1, 10.0, static=True),
        Property("min-neighbors", int, 3, 0, None, static=True),
        Property("min-size-width", int, 30, 0, None, static=True),
        Property("min-size-height", int, 30, 0, None, static=True),
        Property("min-stddev", int, 0, 0, 255, static=True),
        Property("updates", str, "every-frame", static=True),
    )

    def prepare(self):
        if self.props["updates"] not in UPDATES:
            raise ValueError(f"facedetect: bad updates "
                             f"{self.props['updates']!r}")
        self._face = _load(self.props["profile"])
        if self._face is None:
            raise ValueError("facedetect: missing faces profile file "
                             f"{self.props['profile']}")
        self._subs = [(name, _load(self.props[name + "-profile"]), roi)
                      for name, roi in (
                          ("nose", lambda r: (r[..., 0] + r[..., 2] // 4,
                                              r[..., 1] + r[..., 3] // 4,
                                              r[..., 2] // 2,
                                              r[..., 3] // 2)),
                          ("mouth", lambda r: (r[..., 0],
                                               r[..., 1] + r[..., 3] // 2,
                                               r[..., 2], r[..., 3] // 2)),
                          ("eyes", lambda r: (r[..., 0], r[..., 1],
                                              r[..., 2], r[..., 3] // 2)))]

    def init_state(self, window: int):
        return {"face_detected": torch.zeros((), dtype=torch.bool,
                                             device=self.device)}

    def _sub_boxes(self, gray, packed, roi_fn, boxes, valid):
        """Per face: the first confirmed sub-detection (scanned over the
        whole frame, as the JAX package does) whose centre lies in the
        face's reference ROI.  -> (boxes [B, F, 4], hit [B, F])."""
        mw = self.props["min-size-width"] // 8
        mh = self.props["min-size-height"] // 8
        sub, sub_ok = detect_faces(gray, packed, 1.25, 2, mw, mh)
        cx = (sub[..., 0] + sub[..., 2] // 2)[:, None, :]     # [B, 1, S]
        cy = (sub[..., 1] + sub[..., 3] // 2)[:, None, :]
        rx, ry, rw, rh = (v[..., None] for v in roi_fn(boxes))  # [B, F, 1]
        inside = (sub_ok[:, None, :] & (cx >= rx) & (cx < rx + rw)
                  & (cy >= ry) & (cy < ry + rh))               # [B, F, S]
        hit = inside.any(-1)
        first = torch.argmax(inside.to(torch.int32), -1)
        picked = torch.gather(sub, 1, first[..., None].expand(
            *first.shape, 4))
        picked = torch.where(hit[..., None], picked,
                             torch.zeros_like(picked))
        return picked, hit & valid

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b, h, w, _ = data.shape
        dev = data.device
        gray = self._gray(data)
        boxes, valid = self._detect(data)
        if self.props["min-stddev"] > 0:
            mean = gray.mean(dim=(1, 2))
            std = torch.sqrt(((gray - mean[:, None, None]) ** 2).mean(
                dim=(1, 2)))
            valid = valid & (std >= self.props["min-stddev"])[:, None]

        n_faces = valid.sum(1)
        have = n_faces > 0
        prev = torch.cat([state["face_detected"][None], have[:-1]])
        mode = self.props["updates"]
        if mode == "every-frame":
            post = torch.ones(b, dtype=torch.bool, device=dev)
        elif mode == "on-change":
            post = have != prev
        elif mode == "on-face":
            post = have
        else:
            post = torch.zeros(b, dtype=torch.bool, device=dev)
        fields = {"_emit": post, "x": boxes[..., 0], "y": boxes[..., 1],
                  "width": boxes[..., 2], "height": boxes[..., 3],
                  "n_faces": n_faces}
        # per-face sub-feature ROIs (gstfacedetect.cpp:652-688)
        for name, packed, roi_fn in self._subs:
            if packed is None:
                continue
            sub, sub_ok = self._sub_boxes(gray, packed, roi_fn, boxes, valid)
            fields[name + "_x"] = sub[..., 0]
            fields[name + "_y"] = sub[..., 1]
            fields[name + "_width"] = sub[..., 2]
            fields[name + "_height"] = sub[..., 3]
            fields["have_" + name] = sub_ok

        out = data
        if self.props["display"]:
            for i in range(MAX_FACES):
                r = boxes[:, i].to(torch.float32)
                two = torch.full((), 2.0, dtype=torch.float32, device=dev)
                wf = r[:, 2] / two
                hf = r[:, 3] / two
                ring = _ellipse_ring(h, w, r[:, 0] + wf, r[:, 1] + hf, wf,
                                     hf * 1.25, 3.0) & valid[:, i, None, None]
                # cv::Scalar saturates the reference's negative channels
                color = torch.tensor(
                    [max(0, 255 - ((i & 48) << 3)),
                     max(0, 255 - ((i & 12) << 5)),
                     max(0, 255 - ((i & 3) << 7))],
                    dtype=torch.uint8, device=dev)
                out = torch.where(ring[..., None], color, out)
        return ({"face_detected": have[-1]}, batch.with_data(out),
                {"facedetect": fields})


@register
class FaceBlur(_CascadeFilter):
    NAME = "faceblur"
    PROPERTIES = (
        Property("profile", str,
                 HAAR_DIR + "haarcascade_frontalface_default.xml",
                 static=True),
        Property("scale-factor", float, 1.25, 1.1, 10.0, static=True),
        Property("min-neighbors", int, 3, 0, None, static=True),
        Property("min-size-width", int, 30, 0, None, static=True),
        Property("min-size-height", int, 30, 0, None, static=True),
    )

    def prepare(self):
        self._face = _load(self.props["profile"])
        if self._face is None:
            raise ValueError("faceblur: missing profile file "
                             f"{self.props['profile']}")

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b, h, w, _ = data.shape
        boxes, valid = self._detect(data)
        # blur(11,11) then GaussianBlur(11,11,0), both, like the reference
        # (gstfaceblur.cpp:372-373)
        blurred = cvops.gaussian_blur_u8(cvops.box_blur_u8(data, 11, 11),
                                         11, 11, 0.0)
        yy = torch.arange(h, device=data.device)[None, :, None]
        xx = torch.arange(w, device=data.device)[None, None, :]
        mask = torch.zeros((b, h, w), dtype=torch.bool, device=data.device)
        for i in range(MAX_FACES):
            r = boxes[:, i, :, None, None]
            mask = mask | (valid[:, i, None, None]
                           & (yy >= r[:, 1]) & (yy < r[:, 1] + r[:, 3])
                           & (xx >= r[:, 0]) & (xx < r[:, 0] + r[:, 2]))
        return state, batch.with_data(torch.where(mask[..., None], blurred,
                                                  data))
