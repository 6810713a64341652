"""faceoverlay (gst/faceoverlay/gstfaceoverlay.c): an overlay image over
the detected face, the torch form of
gstbad_tpu/elements/video/faceoverlay.py.

The reference is a bin `facedetect ! videoconvert ! rsvgoverlay`: the
first face rectangle positions the image at (face.x + x*face.w, face.y +
y*face.h) scaled to (w*face.w, h*face.h) (gstfaceoverlay.c:196-250).  As
in the JAX package, the box snaps to the nearest of four static window
scales, and the overlay is rendered once per scale on the host: an SVG
through librsvg (io/rsvg.py), unpremultiplied, or a raster through PIL,
imported only then.

Detection: the frontal-face Haar cascade through the port's facedetect
machinery (elements/cv/facedetect.detect_faces: the pyramid, H1 on the
card), or `detector=skin`, the skin-density window search (HSV skin mask,
its summed-area table, the densest window of each scale).  A `face`
message (x, y, width, height) posts for every frame with a face.

Composite: the float32 region*(1-a) + over*a, + 0.5, clipped, with the
rounding of the JAX package's compiled window on the CPU (a = alpha *
float32(1/255), and the add fused into over*a as one FMA:
ops/numerics.fma32).  One box a frame, so it stays in plain ops: the
window's boxes come to the host once, and each frame with a face blends
the part of its box inside the frame, which is what the JAX package's
pad, dynamic_slice and dynamic_update_slice keep (their start clamped to
the padded frame, as XLA clamps it).
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops.numerics import fma32

# detection window heights as fractions of the frame height (the static
# scale pyramid); windows are square-ish like frontal-face cascades
_SCALES = (0.5, 0.35, 0.25, 0.18)
_MIN_DENSITY = 0.35   # a window must be at least this skin-dense
_STRIDE = 4           # window search stride in pixels


def _unpremultiply(bgra: np.ndarray) -> np.ndarray:
    """cairo premultiplied B,G,R,A -> straight RGBA (round-half-up),
    matching the straight-alpha composite the raster path uses."""
    a = bgra[..., 3:4].astype(np.uint32)
    rgb = bgra[..., [2, 1, 0]].astype(np.uint32)
    straight = np.where(a > 0, np.minimum(
        (rgb * 255 + a // 2) // np.maximum(a, 1), 255), 0)
    return np.concatenate([straight, a], axis=-1).astype(np.uint8)


def _recip(n: int) -> np.float32:
    """float32 1/n, the reciprocal XLA folds a division by n into."""
    return np.float32(1) / np.float32(n)


@register
class FaceOverlay(VideoFilter):
    NAME = "faceoverlay"
    FORMATS = VideoFormat.PACKED_RGB4
    PROPERTIES = (
        Property("location", str, "", static=True,
                 doc="overlay image file (SVG, or PNG/PNM; RGBA "
                     "respected)"),
        Property("profile", str,
                 "/usr/share/opencv4/haarcascades/"
                 "haarcascade_frontalface_default.xml", static=True),
        Property("detector", str, "auto", static=True,
                 doc="auto | haar | skin"),
        Property("scale-factor", float, 1.25, 1.1, 10.0, static=True),
        Property("x", float, 0.0, static=True),
        Property("y", float, 0.0, static=True),
        Property("w", float, 1.0, 0.0, None, static=True),
        Property("h", float, 1.0, 0.0, None, static=True),
    )

    def prepare(self):
        spec = self.out_spec
        H, W = spec.height, spec.width
        self._rgb = VideoFormat.rgb_offsets(spec.format)[:3]
        from gstbad_tpu_torch.elements.cv.facedetect import _load
        mode = self.props["detector"]
        self._face = (_load(self.props["profile"])
                      if mode in ("auto", "haar") else None)
        if mode == "haar" and self._face is None:
            raise ValueError("faceoverlay: detector=haar but profile "
                             f"{self.props['profile']} is missing")
        # face windows per scale (static shapes)
        self._wins = []
        for s in _SCALES:
            fh = max(8, int(H * s))
            fw = max(8, int(fh * 0.8))  # faces are taller than wide
            if fh <= H and fw <= W:
                self._wins.append((fh, fw))
        if not self._wins:
            self._wins = [(min(8, H), min(8, W))]
        loc = self.props["location"]
        self._overlays = None
        if loc and self._is_svg(loc):
            from gstbad_tpu_torch.io import rsvg as iorsvg
            svg = iorsvg.Svg.from_file(loc)
            imgs = []
            for (fh, fw) in self._wins:
                sw = max(1, int(self.props["w"] * fw))
                sh = max(1, int(self.props["h"] * fh))
                imgs.append(_unpremultiply(svg.render(
                    sw, sh, sx=sw / max(svg.width, 1),
                    sy=sh / max(svg.height, 1))))
        elif loc:
            from PIL import Image
            img = Image.open(loc).convert("RGBA")
            imgs = []
            for (fh, fw) in self._wins:
                sw = max(1, int(self.props["w"] * fw))
                sh = max(1, int(self.props["h"] * fh))
                imgs.append(np.array(img.resize((sw, sh), Image.BILINEAR),
                                     np.uint8))
        if loc:
            self._overlays = [torch.from_numpy(np.ascontiguousarray(o)).to(
                self.device) for o in imgs]

    @staticmethod
    def _is_svg(loc: str) -> bool:
        from gstbad_tpu_torch.io import rsvg as iorsvg
        if not iorsvg.available():
            return False
        if loc.lower().endswith((".svg", ".svgz")):
            return True
        try:
            with open(loc, "rb") as f:
                return iorsvg.looks_like_svg(f.read(4096))
        except OSError:
            return False

    def _channels(self, data):
        return [data[..., c].to(torch.float32) for c in self._rgb]

    def _detect_haar(self, data):
        """The first Haar face box of each frame, snapped to the nearest
        overlay scale -> (found, fy, fx, scale index), each [B]."""
        from gstbad_tpu_torch.elements.cv.facedetect import detect_faces
        r, g, b = self._channels(data)
        gray = torch.clamp((r * 4899 + g * 9617 + b * 1868 + 8192)
                           / 16384.0, 0, 255)
        boxes, valid = detect_faces(gray, self._face,
                                    self.props["scale-factor"], 3, 30, 30)
        first = torch.argmax(valid.to(torch.int32), 1)
        box = boxes[torch.arange(boxes.shape[0], device=boxes.device), first]
        hs = torch.tensor([wn[0] for wn in self._wins], dtype=torch.int32,
                          device=data.device)
        k = torch.argmin(torch.abs(hs[None, :] - box[:, 3:4]), 1)
        return valid.any(1), box[:, 1], box[:, 0], k

    def _detect_skin(self, data):
        """Skin-density window search -> (found, fy, fx, scale index)."""
        r, g, b = self._channels(data)
        rgb = torch.stack([r, g, b], -1).to(torch.uint8)
        hsv = cvops.rgb2hsv_u8(rgb)
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        mask = ((h > 10) & (h <= 20) & (s > 48) & (v > 80)).to(
            torch.float32)
        # integer-valued sums: exact in any order
        ii = torch.nn.functional.pad(mask.cumsum(1).cumsum(2), (1, 0, 1, 0))
        B, H, W = mask.shape
        dev = data.device
        best_d = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
        best = [torch.zeros(B, dtype=torch.int64, device=dev)
                for _ in range(3)]
        for k, (fh, fw) in enumerate(self._wins):
            ys = torch.arange(0, H - fh + 1, _STRIDE, device=dev)
            xs = torch.arange(0, W - fw + 1, _STRIDE, device=dev)
            yy, xx = torch.meshgrid(ys, xs, indexing="ij")
            dens = (ii[:, yy + fh, xx + fw] - ii[:, yy, xx + fw]
                    - ii[:, yy + fh, xx] + ii[:, yy, xx]) \
                * torch.tensor(_recip(fh * fw), device=dev)
            i = torch.argmax(dens.reshape(B, -1), 1)
            d = dens.reshape(B, -1).gather(1, i[:, None])[:, 0]
            take = d > torch.clamp(best_d, min=_MIN_DENSITY)
            best_d = torch.where(take, d, best_d)
            for j, val in enumerate((yy.reshape(-1)[i], xx.reshape(-1)[i],
                                     torch.full_like(i, k))):
                best[j] = torch.where(take, val, best[j])
        return best_d >= _MIN_DENSITY, best[0], best[1], best[2]

    def _composite(self, data, found, fy, fx, k):
        """Each frame with a face blends the overlay of its scale at its
        box (host loop over the window's frames, one box each)."""
        if self._overlays is None or not found.any():
            return data
        out = data.clone()
        H, W = data.shape[1], data.shape[2]
        recip = torch.tensor(_recip(255), device=data.device)
        for f in np.flatnonzero(found):
            fh, fw = self._wins[k[f]]
            over = self._overlays[k[f]]
            sh, sw = over.shape[0], over.shape[1]
            sy = int(fy[f]) + int(round(self.props["y"] * fh))
            sx = int(fx[f]) + int(round(self.props["x"] * fw))
            # dynamic_slice's start, clamped into the padded frame
            y0 = min(max(sy + sh, 0), H + sh) - sh
            x0 = min(max(sx + sw, 0), W + sw) - sw
            ya, yb = max(y0, 0), min(y0 + sh, H)
            xa, xb = max(x0, 0), min(x0 + sw, W)
            if ya >= yb or xa >= xb:
                continue
            ov = over[ya - y0:yb - y0, xa - x0:xb - x0]
            a = ov[..., 3].to(torch.float32) * recip
            region = out[f, ya:yb, xa:xb]
            for i, c in enumerate(self._rgb):
                blend = fma32(ov[..., i].to(torch.float32), a,
                              region[..., c].to(torch.float32) * (1 - a))
                region[..., c] = torch.clamp(blend + 0.5, 0, 255).to(
                    torch.uint8)
        return out

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        found, fy, fx, k = (self._detect_haar(data) if self._face is not None
                            else self._detect_skin(data))
        sizes = torch.tensor(self._wins, dtype=torch.int32,
                             device=data.device)[k]
        host = [t.cpu().numpy() for t in (found, fy, fx, k)]
        out = self._composite(data, *host)
        msgs = {"face": {"x": fx.to(torch.int32), "y": fy.to(torch.int32),
                         "width": sizes[:, 1], "height": sizes[:, 0],
                         "_emit": found}}
        return state, batch.with_data(out), msgs
