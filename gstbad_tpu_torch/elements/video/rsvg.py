"""rsvgoverlay / rsvgdec (ext/rsvg/gstrsvgoverlay.c, gstrsvgdec.c) over
librsvg (io/rsvg.py, a copy of the JAX package's ctypes binding), the
torch form of gstbad_tpu/elements/video/rsvg.py.

rsvgoverlay (gstrsvgoverlay.c:361-431): the SVG (from `data`,
`location` or push_data()) rasterizes once on the host at the placement
the properties give, permuted into the frame's byte order, and goes to
the device once; each window is H4's cairo_over, pixman's exact OVER on
every byte (out = O + UN8_MUL(F, 255 - O_a), saturating): one launch a
window.

rsvgdec (gstrsvgdec.c:156-246): a host source, one BGRA frame per SVG
document (split at `</svg>` like the reference's parse()); the first
document's natural size fixes the output, later ones render scaled to
it."""

from __future__ import annotations

import fractions

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.io import rsvg
from gstbad_tpu_torch.ops import overlay as ovops


@register
class RsvgOverlay(VideoFilter):
    NAME = "rsvgoverlay"
    FORMATS = (VideoFormat.BGRA, VideoFormat.RGBA, VideoFormat.ARGB,
               VideoFormat.ABGR)
    PROPERTIES = (
        Property("data", str, "", static=True, doc="SVG markup"),
        Property("location", str, "", static=True, doc="SVG file"),
        Property("fit-to-frame", bool, False, static=True),
        Property("x", int, 0, static=True),
        Property("y", int, 0, static=True),
        Property("x-relative", float, 0.0, static=True),
        Property("y-relative", float, 0.0, static=True),
        Property("width", int, 0, static=True),
        Property("height", int, 0, static=True),
        Property("width-relative", float, 0.0, static=True),
        Property("height-relative", float, 0.0, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._pushed = b""

    def push_data(self, data: bytes) -> None:
        """The reference's data sink pad: SVG markup as a byte stream
        (consumed at prepare)."""
        self._pushed += bytes(data)

    def _svg(self):
        if self.props["data"]:
            return rsvg.Svg(self.props["data"].encode())
        if self.props["location"]:
            return rsvg.Svg.from_file(self.props["location"])
        if self._pushed:
            return rsvg.Svg(self._pushed)
        return None

    def prepare(self):
        spec = self.out_spec
        fw, fh = spec.width, spec.height
        svg = self._svg()
        if svg is None:
            self._overlay = None
            return
        x, y = self.props["x"], self.props["y"]
        xr, yr = self.props["x-relative"], self.props["y-relative"]
        w, h = self.props["width"], self.props["height"]
        wr = self.props["width-relative"]
        hr = self.props["height-relative"]
        if self.props["fit-to-frame"]:
            x = y = 0
            xr = yr = 0.0
            w = h = 0
            wr = hr = 1.0
        # gstrsvgoverlay.c:391-410 applied-offset/dimension walk
        ax = float(x) if x else xr * fw
        ay = float(y) if y else yr * fh
        aw = w if w else int(wr * fw)
        ah = h if h else int(hr * fh)
        sx = sy = 1.0
        if (aw or ah) and svg.width and svg.height:
            aw = aw if aw else svg.width
            ah = ah if ah else svg.height
            sx = aw / svg.width
            sy = ah / svg.height
        bgra = svg.render(fw, fh, tx=ax, ty=ay, sx=sx, sy=sy)
        # cairo's B, G, R, A memory order permuted into the frame's
        ro, go, bo, ao = VideoFormat.rgb_offsets(spec.format)
        perm = np.empty_like(bgra)
        perm[..., ro] = bgra[..., 2]
        perm[..., go] = bgra[..., 1]
        perm[..., bo] = bgra[..., 0]
        perm[..., ao] = bgra[..., 3]
        self._overlay = torch.from_numpy(perm[None]).to(self.device)
        colour = [c for c in range(4) if c != ao]
        self._planes = [(self._overlay[..., c], 0) for c in colour]
        chan = [3] * 4
        for j, c in enumerate(colour):
            chan[c] = j
        self._chan = tuple(chan)
        self._alpha_idx = ao

    def process(self, params, state, batch: FrameBatch):
        if self._overlay is None:
            return state, batch
        layers = torch.zeros((batch.batch, 1), dtype=torch.int32,
                             device=batch.pts.device)
        out = ovops.overlay_blend(
            batch.data, self._overlay[..., self._alpha_idx], self._planes,
            layers, self._chan, "cairo_over")
        return state, batch.with_data(out)


@register
class RsvgDec(Element):
    NAME = "rsvgdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []
        self._carry = b""
        self._pos = 0
        self._last = None

    def push_packet(self, data: bytes) -> None:
        """One complete SVG document = one output frame."""
        self._docs.append(bytes(data))

    def push_data(self, data: bytes) -> None:
        """Byte-stream feed: split at '</svg>' like the reference's
        parse() (gstrsvgdec.c:105-154)."""
        self._carry += bytes(data)
        while True:
            idx = self._carry.find(b"</svg>")
            if idx < 0:
                break
            end = idx + len(b"</svg>")
            self._docs.append(self._carry[:end])
            self._carry = self._carry[end:]

    def process(self, params, state, batch: FrameBatch):
        return state, batch          # frames come from pull_window

    def negotiate(self, in_spec):
        require(self._docs, "rsvgdec: push SVG documents before "
                            "negotiating")
        self._svgs = [rsvg.Svg(d) for d in self._docs]
        first = self._svgs[0]
        require(first.width > 0 and first.height > 0,
                "rsvgdec: SVG has no intrinsic dimensions")
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=VideoFormat.BGRA,
                         width=first.width, height=first.height,
                         framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._svgs):
            return None
        W, H = self.out_spec.width, self.out_spec.height
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._svgs):
                svg = self._svgs[self._pos]
                # gstrsvgdec.c:229-242 scale-to-output-state walk
                sx = W / svg.width if svg.width != W else 1.0
                sy = H / svg.height if svg.height != H else 1.0
                self._last = svg.render(W, H, sx=sx, sy=sy)
                frames.append(self._last)
                pts.append(self._pos * dur)
                valid.append(True)
                self._pos += 1
            else:
                frames.append(self._last)
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
        return upload_frames(self.device, frames, pts, [0] * window, valid)

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
