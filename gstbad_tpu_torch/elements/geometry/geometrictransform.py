"""geometrictransform — the 16 warp elements (gst/geometrictransform/).

Each element's map function is built in float64 on the host
(golden/geometric.py transcriptions of the C gdouble math), fixed to one
int32 gather map at set_info (ops/remap.fix_map: the reference's
precalc_map, gstgeometrictransform.c:80-128), and applied as one gather of
packed pixels per window (ops/remap.warp_words, K7 on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.golden import geometric as maps
from gstbad_tpu_torch.ops import pointops, remap

_OFF_EDGE = Property("off-edge-pixels", str, "ignore", static=True,
                     doc="ignore | clamp | wrap "
                         "(gstgeometrictransform.c:58-76)")

# accepted so that launch strings stay compatible: the JAX package's two
# remap backends give the same bits, and here every engine is the one
# gather (K7 on the card)
_ENGINE = Property("engine", str, "auto", static=True,
                   doc="auto | pallas | gather — accepted for launch-string "
                       "compatibility; every engine runs the same gather")

_CIRCLE_PROPS = (
    Property("x-center", float, 0.5, 0.0, 1.0, static=True),
    Property("y-center", float, 0.5, 0.0, 1.0, static=True),
    Property("radius", float, 0.35, 0.0, 1.0, static=True),
)


class GeometricTransform(VideoFilter):
    """Abstract base: subclass provides `build_map(w, h) -> [H, W, 2]`.

    The inverse map is fixed on the host once (the reference's precalc_map,
    gstgeometrictransform.c:80-128) into one int32 map (-1 = off edge);
    per window the packed words go through warp_words."""

    FORMATS = VideoFormat.PACKED_RGB4 + (VideoFormat.AYUV,)

    def build_map(self, w: int, h: int) -> np.ndarray:
        raise NotImplementedError

    def prepare(self):
        spec = self.out_spec
        mp = self.build_map(spec.width, spec.height)
        flat, valid = remap.fix_map(mp, spec.width, spec.height,
                                    self.props["off-edge-pixels"])
        self._map = torch.as_tensor(remap.word_map(flat, valid),
                                    device=self.device)
        if spec.format == VideoFormat.AYUV:
            # AYUV black background 0xff108080 big-endian
            # (gstgeometrictransform.c:244-249)
            self._bg = remap.background_word(b"\xff\x10\x80\x80")
        else:
            self._bg = 0

    def process(self, params, state, batch: FrameBatch):
        out = remap.warp_words(pointops.word_source(batch), self._map,
                               self._bg, batch=batch.batch)
        return state, batch.with_data(pointops.unpack32(out)).replace(
            word=out)


@register
class Fisheye(GeometricTransform):
    NAME = "fisheye"
    PROPERTIES = (_OFF_EDGE, _ENGINE,)

    def build_map(self, w, h):
        return maps.fisheye_map(w, h)


@register
class Twirl(GeometricTransform):
    NAME = "twirl"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("angle", float, float(np.pi), static=True),)

    def build_map(self, w, h):
        return maps.twirl_map(w, h, self.props["angle"],
                              self.props["x-center"], self.props["y-center"],
                              self.props["radius"])


@register
class Perspective(GeometricTransform):
    NAME = "perspective"
    PROPERTIES = (_OFF_EDGE, _ENGINE, Property("matrix", str, "identity", static=True))

    def build_map(self, w, h):
        m = self.props["matrix"]
        if m == "identity":
            mat = None
        else:
            mat = [float(v) for v in m.replace(",", " ").split()]
            if len(mat) != 9:
                raise ValueError("perspective matrix needs 9 elements")
        return maps.perspective_map(w, h, mat)


@register
class Rotate(GeometricTransform):
    NAME = "rotate"
    PROPERTIES = (_OFF_EDGE, _ENGINE, Property("angle", float, 0.0, static=True))

    def build_map(self, w, h):
        return maps.rotate_map(w, h, self.props["angle"])


@register
class Bulge(GeometricTransform):
    NAME = "bulge"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("zoom", float, 3.0, 1.0, 100.0, static=True),)

    def build_map(self, w, h):
        return maps.bulge_map(w, h, self.props["zoom"], self.props["x-center"],
                              self.props["y-center"], self.props["radius"])


@register
class Pinch(GeometricTransform):
    NAME = "pinch"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("intensity", float, 0.5, -1.0, 1.0, static=True),)

    def build_map(self, w, h):
        return maps.pinch_map(w, h, self.props["intensity"],
                              self.props["x-center"], self.props["y-center"],
                              self.props["radius"])


@register
class Sphere(GeometricTransform):
    NAME = "sphere"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("refraction", float, 1.5, static=True),)

    def build_map(self, w, h):
        return maps.sphere_map(w, h, self.props["refraction"],
                               self.props["x-center"], self.props["y-center"],
                               self.props["radius"])


@register
class Kaleidoscope(GeometricTransform):
    NAME = "kaleidoscope"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("angle", float, 0.0, static=True),
        Property("angle2", float, 0.0, static=True),
        Property("sides", int, 3, 2, None, static=True),
    )

    def build_map(self, w, h):
        return maps.kaleidoscope_map(
            w, h, self.props["angle"], self.props["angle2"],
            self.props["sides"], self.props["x-center"],
            self.props["y-center"], self.props["radius"])


@register
class Circle(GeometricTransform):
    NAME = "circle"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("angle", float, 0.0, static=True),
        Property("height", float, 20.0, static=True),
        Property("spread-angle", float, float(np.pi), static=True),
    )

    def build_map(self, w, h):
        return maps.circle_map(w, h, self.props["angle"],
                               self.props["height"],
                               self.props["spread-angle"],
                               self.props["x-center"], self.props["y-center"],
                               self.props["radius"])


@register
class WaterRipple(GeometricTransform):
    NAME = "waterripple"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("amplitude", float, 10.0, static=True),
        Property("phase", float, 0.0, static=True),
        Property("wavelength", float, 16.0, static=True),
    )

    def build_map(self, w, h):
        return maps.waterripple_map(
            w, h, self.props["amplitude"], self.props["phase"],
            self.props["wavelength"], self.props["x-center"],
            self.props["y-center"], self.props["radius"])


@register
class Stretch(GeometricTransform):
    NAME = "stretch"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS + (
        Property("intensity", float, 0.5, 0.0, 1.0, static=True),)

    def build_map(self, w, h):
        return maps.stretch_map(w, h, self.props["intensity"],
                                self.props["x-center"], self.props["y-center"],
                                self.props["radius"])


@register
class Tunnel(GeometricTransform):
    NAME = "tunnel"
    PROPERTIES = (_OFF_EDGE, _ENGINE,) + _CIRCLE_PROPS

    def build_map(self, w, h):
        return maps.tunnel_map(w, h, self.props["x-center"],
                               self.props["y-center"], self.props["radius"])


@register
class Square(GeometricTransform):
    NAME = "square"
    PROPERTIES = (_OFF_EDGE, _ENGINE,
                  Property("width", float, 0.5, 0.0, 1.0, static=True),
                  Property("height", float, 0.5, 0.0, 1.0, static=True),
                  Property("zoom", float, 2.0, 1.0, 100.0, static=True))

    def build_map(self, w, h):
        return maps.square_map(w, h, self.props["width"],
                               self.props["height"], self.props["zoom"])


@register
class Mirror(GeometricTransform):
    NAME = "mirror"
    PROPERTIES = (_OFF_EDGE, _ENGINE, Property("mode", str, "left", static=True))

    def build_map(self, w, h):
        return maps.mirror_map(w, h, self.props["mode"])


@register
class Diffuse(GeometricTransform):
    NAME = "diffuse"
    PROPERTIES = (_OFF_EDGE, _ENGINE,
                  Property("scale", float, 4.0, 1.0, 100.0, static=True),
                  Property("seed", int, 0, static=True))

    def build_map(self, w, h):
        rng = np.random.default_rng(self.props["seed"])
        return maps.diffuse_map(w, h, self.props["scale"], rng)


@register
class Marble(GeometricTransform):
    NAME = "marble"
    PROPERTIES = (_OFF_EDGE, _ENGINE,
                  Property("x-scale", float, 4.0, static=True),
                  Property("y-scale", float, 4.0, static=True),
                  Property("amount", float, 1.0, 0.0, 1.0, static=True),
                  Property("turbulence", float, 1.0, 0.0, 1.0, static=True),
                  Property("seed", int, 0, static=True))

    def build_map(self, w, h):
        rng = np.random.default_rng(self.props["seed"])
        return maps.marble_map(w, h, self.props["x-scale"],
                               self.props["y-scale"],
                               self.props["turbulence"], rng)
