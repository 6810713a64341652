"""qroverlay / debugqroverlay (ext/qroverlay/gstqroverlay.c,
gstdebugqroverlay.c over gstbaseqroverlay.c), the torch form of
gstbad_tpu/elements/video/qroverlay.py.

The content encodes with the port's copy of the from-spec QR encoder
(io/qr.py) and rasterizes with draw_overlay (golden/qroverlay.py, the
reference's little-endian BGRA raster with its one-module shift and
float pixel-size truncations); the composite is H4's shr8_rgb_alpha
(video-blend.c's truncating (D*(256-a) + S*a) >> 8 on the RGB bytes and
(Da*(256-a) + 255*a) >> 8 on an alpha byte), one launch a window.

qroverlay: `data` is static (the reference's get_qrcode_content never
clears reuse_prev, so the first frame's overlay stays).  debugqroverlay:
per-frame JSON content (gstdebugqroverlay.c:243-284) with the
extra-data schedule, rasterized on the host for `max-frames` frames into
a device bank that the frame counter indexes; frames past the bank show
no overlay.  Packed RGB, 4-byte and 3-byte formats.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.golden import qroverlay as golden
from gstbad_tpu_torch.io import qr
from gstbad_tpu_torch.ops import overlay as ovops

_LEVEL_NAMES = ("L", "M", "Q", "H")   # QRecLevel order (libqrencode)


def rgb_chan(fmt: str, order=(0, 1, 2)):
    """chan of overlay_blend for a packed RGB frame format: the frame's
    R, G and B bytes take source planes order[0], order[1], order[2];
    every other byte is left as it is."""
    ro, go, bo, _ = VideoFormat.rgb_offsets(fmt)
    chan = [None] * (3 if fmt in VideoFormat.PACKED_RGB3 else 4)
    for off, j in zip((ro, go, bo), order):
        chan[off] = j
    return tuple(chan)


class _QrOverlayBase(VideoFilter):
    """Raster, placement and blend shared by both elements; subclasses
    supply the content.  The bank is [K, H, W, 4] u8: alpha, R, G, B."""

    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("x", float, 50.0, 0.0, 100.0, static=True,
                 doc="X position in percent of the width "
                     "(gstbaseqroverlay.c:281-285)"),
        Property("y", float, 50.0, 0.0, 100.0, static=True,
                 doc="Y position in percent of the height"),
        Property("pixel-size", float, 3.0, 1.0, 100.0, static=True,
                 doc="pixel size of each QR module "
                     "(DEFAULT_PROP_PIXEL_SIZE 3)"),
        Property("qrcode-error-correction", int, 1, 0, 3, static=True,
                 doc="QRecLevel: 0=L 1=M 2=Q 3=H "
                     "(DEFAULT_PROP_QUALITY 1 = M)"),
    )

    def _level(self) -> str:
        return _LEVEL_NAMES[self.props["qrcode-error-correction"]]

    def _rasterize(self, content: str):
        """content -> (rgb [s,s,3] u8, alpha [s,s] u8, x, y) or None."""
        if not content:
            return None
        modules = qr.encode(content, self._level())
        canvas = golden.draw_overlay(modules, self.props["pixel-size"])
        sq = canvas.shape[0]
        spec = self.out_spec
        x, y = golden.overlay_position(spec.width, spec.height, sq,
                                       self.props["x"], self.props["y"])
        # canvas is BGRA bytes (golden/qroverlay.py)
        return canvas[..., [2, 1, 0]], canvas[..., 3], x, y

    def _to_frame(self, ras) -> np.ndarray:
        """A rasterized overlay clipped into a full-frame [H, W, 4]
        (alpha, R, G, B) bank entry."""
        spec = self.out_spec
        H, W = spec.height, spec.width
        out = np.zeros((H, W, 4), np.uint8)
        if ras is None:
            return out
        rgb, alpha, x, y = ras
        sq = alpha.shape[0]
        sy, sx = max(0, -y), max(0, -x)
        dy, dx = max(0, y), max(0, x)
        h = min(sq - sy, H - dy)
        w = min(sq - sx, W - dx)
        if h > 0 and w > 0:
            out[dy:dy + h, dx:dx + w, 1:] = rgb[sy:sy + h, sx:sx + w]
            out[dy:dy + h, dx:dx + w, 0] = alpha[sy:sy + h, sx:sx + w]
        return out

    def _upload(self, entries):
        self._bank = torch.from_numpy(np.stack(entries)).to(self.device)
        fmt = self.out_spec.format
        self._chan = rgb_chan(fmt)
        xo = VideoFormat.rgb_offsets(fmt)[3]
        self._alpha_chan = (xo if xo is not None
                            and VideoFormat.has_alpha(fmt) else None)

    def _composite(self, frames, layers):
        bank = self._bank
        return ovops.overlay_blend(
            frames, bank[..., 0], [(bank[..., c], 0) for c in (1, 2, 3)],
            layers, self._chan, "shr8_rgb_alpha", self._alpha_chan)


@register
class QrOverlay(_QrOverlayBase):
    NAME = "qroverlay"
    PROPERTIES = _QrOverlayBase.PROPERTIES + (
        Property("data", str, "", static=True,
                 doc="content string (gstqroverlay.c:141-146; static "
                     "here = the reference's stuck reuse_prev quirk)"),
    )

    def prepare(self):
        ras = self._rasterize(self.props["data"])
        self._active = ras is not None
        if self._active:
            self._upload([self._to_frame(ras)])

    def process(self, params, state, batch: FrameBatch):
        if not self._active:
            return state, batch
        layers = torch.zeros((batch.batch, 1), dtype=torch.int32,
                             device=batch.pts.device)
        return state, batch.with_data(self._composite(batch.data, layers))


@register
class DebugQrOverlay(_QrOverlayBase):
    NAME = "debugqroverlay"
    PROPERTIES = _QrOverlayBase.PROPERTIES + (
        Property("extra-data-interval-buffers", int, 60, 0, None,
                 static=True),
        Property("extra-data-span-buffers", int, 1, 0, None, static=True),
        Property("extra-data-name", str, "", static=True),
        Property("extra-data-array", str, "", static=True,
                 doc="comma-separated values cycled at each interval"),
        Property("max-frames", int, 240, 1, None, static=True,
                 doc="host pre-raster bank depth (frames beyond it get "
                     "no overlay)"),
    )

    _instances = 0

    def __init__(self, **props):
        super().__init__(**props)
        self._name = f"debugqroverlay{DebugQrOverlay._instances}"
        DebugQrOverlay._instances += 1

    def _content(self, frame_number: int, pts_ns: int,
                 sched: dict) -> str:
        fr = self.out_spec.framerate
        obj = {
            "TIMESTAMP": int(pts_ns),
            "BUFFERCOUNT": frame_number,
            "FRAMERATE": f"{fr.numerator}/{fr.denominator}",
            "NAME": self._name,
        }
        arr = sched["array"]
        name = self.props["extra-data-name"]
        interval = self.props["extra-data-interval-buffers"]
        span = self.props["extra-data-span-buffers"]
        if arr and name and (
                frame_number == 1
                or (interval and frame_number % interval == 1)
                or (0 < sched["span_frame"] < span)):
            obj[name] = arr[sched["counter"]]
            sched["span_frame"] += 1
            if sched["span_frame"] == span:
                sched["counter"] += 1
                sched["span_frame"] = 0
                if sched["counter"] >= len(arr):
                    sched["counter"] = 0
        return json.dumps(obj, separators=(",", ":"))

    def prepare(self):
        require(self.props["extra-data-interval-buffers"] > 0
                or not (self.props["extra-data-array"]
                        and self.props["extra-data-name"]),
                "debugqroverlay: extra-data-interval-buffers of 0 "
                "divides by zero in the reference "
                "(gstdebugqroverlay.c:264); rejected here")
        dur = self.out_spec.frame_duration_ns
        arr = (self.props["extra-data-array"].split(",")
               if self.props["extra-data-array"] else [])
        sched = {"array": arr, "counter": 0, "span_frame": 0}
        self._upload([
            self._to_frame(self._rasterize(self._content(i + 1, i * dur,
                                                         sched)))
            for i in range(self.props["max-frames"])])

    def init_state(self, batch: int):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def process(self, params, state, batch: FrameBatch):
        b = batch.batch
        n = self._bank.shape[0]
        idx = state["count"] + torch.arange(b, dtype=torch.int32,
                                            device=batch.pts.device)
        layers = torch.where(idx < n, idx, -1)[:, None].to(torch.int32)
        return ({"count": state["count"] + b},
                batch.with_data(self._composite(batch.data, layers)))
