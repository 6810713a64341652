"""lcms — ICC color correction (reference: ext/colormanagement/gstlcms.c).

The reference builds an lcms2 transform between two ICC profiles (defaults:
sRGB for both ends, gstlcms.c:429,616) and runs it per pixel — with an
optional precalculated 2^24-entry LUT (gst_lcms_init_lookup_table:505-530).

As in the JAX package (gstbad_tpu/elements/video/lcms.py), matrix/TRC
profiles decompose into per-channel decode curves -> 3x3 PCS matrix ->
per-channel encode curves: the decode curves fold into three 256-entry
float32 tables (one gather each), the matrix is three float32
multiply-adds a channel, and the encode curves evaluate in closed form for
gamma/parametric TRCs (table TRCs through a dense host-built inverse and
`interp`).  The powers are taken in float64 and rounded to float32, so the
card and the CPU give the same bits (ops/cv.py).

The lookup property is accepted for launch-line compatibility and ignored:
every mode here is "precalculated" by construction.  embedded-profile is
accepted and ignored (no container metadata path carries ICC blobs).
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.io import icc
from gstbad_tpu_torch.ops.numerics import f32, true_div

_INTENTS = ("perceptual", "relative", "saturation", "absolute")


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """jnp.interp(x, xp, fp) for 1-D increasing xp, in the same operations:
    constant beyond the ends, fp[i-1] where two knots coincide."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _pow(y: torch.Tensor, e: float) -> torch.Tensor:
    """y ** float32(e) (the JAX package's exponent), in float64, rounded."""
    e = float(np.float32(e))
    return f32(lambda t: torch.pow(t, e), y)


def _inverse_table(curve: icc.Curve, device):
    """A table TRC's dense inverse (the curve at 4096 levels, and the
    levels) as float32 tensors on `device`; None for the other kinds."""
    if curve.kind in ("gamma", "para"):
        return None
    xs = np.linspace(0, 1, 4096)
    ys = curve.evaluate(xs)
    return (torch.as_tensor(ys, dtype=torch.float32, device=device),
            torch.as_tensor(xs, dtype=torch.float32, device=device))


def _encode(curve: icc.Curve, y: torch.Tensor, inverse) -> torch.Tensor:
    """Inverse TRC (linear -> encoded) on the device (float32); `inverse`
    is _inverse_table(curve)."""
    y = torch.clamp(y, 0.0, 1.0)
    if curve.kind == "gamma":
        return _pow(y, 1.0 / curve.gamma)
    if curve.kind == "para":
        g = curve.params[0]
        if curve.para_type == 0:
            return _pow(y, 1.0 / g)
        if curve.para_type == 1:
            _, a, b = curve.params
            return true_div(_pow(y, 1 / g) - b, a)
        if curve.para_type == 2:
            _, a, b, c = curve.params
            return true_div(_pow(torch.clamp(y - c, min=0), 1 / g) - b, a)
        if curve.para_type == 3:
            _, a, b, c, d = curve.params
            knee = c * d
            lin = true_div(y, max(c, 1e-12))
            pw = true_div(_pow(y, 1.0 / g) - b, a)
            return torch.where(y >= knee, pw, lin)
        if curve.para_type == 4:
            _, a, b, c, d, e, f = curve.params
            knee = c * d + f
            lin = true_div(y - f, max(c, 1e-12))
            pw = true_div(_pow(torch.clamp(y - e, min=0), 1 / g) - b, a)
            return torch.where(y >= knee, pw, lin)
    # table TRC: dense host inverse, piecewise linear on the device
    return interp(y, *inverse)


@register
class Lcms(VideoFilter):
    """lcms (gstlcms.c): input-profile -> dest-profile ICC correction;
    both default to sRGB (:429,616).  preserve-black keeps pure-black
    pixels black (:199-203)."""

    NAME = "lcms"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("intent", str, "perceptual", static=True,
                 doc="perceptual | relative | saturation | absolute"),
        Property("input-profile", str, "", static=True),
        Property("dest-profile", str, "", static=True),
        Property("lookup", str, "cached", static=True,
                 doc="accepted for compatibility; always precalculated"),
        Property("preserve-black", bool, False, static=True),
        Property("embedded-profile", bool, True, static=True),
    )

    def _load(self, path: str) -> icc.IccProfile:
        if not path:
            return icc.srgb_profile()
        with open(path, "rb") as f:
            return icc.parse_icc(f.read())

    def prepare(self):
        if self.props["intent"] not in _INTENTS:
            raise ValueError(f"lcms: unknown intent {self.props['intent']!r}")
        src = self._load(self.props["input-profile"])
        dst = self._load(self.props["dest-profile"])
        # decode tables; the source matrix folds into the mix below
        levels = np.arange(256) / 255.0
        dec = np.stack([src.trc[c].evaluate(levels).astype(np.float32)
                        for c in range(3)])
        self._dec = torch.from_numpy(dec).to(self.device)
        m = np.linalg.inv(dst.matrix) @ src.matrix
        if self.props["intent"] == "absolute":
            # absolute colorimetric: scale by the white-point ratio in XYZ
            # (lcms' D50-relative pipeline)
            scale = np.diag(src.white / dst.white)
            m = np.linalg.inv(dst.matrix) @ scale @ src.matrix
        self._m = [[float(v) for v in row] for row in m.astype(np.float32)]
        self._dst_trc = dst.trc
        self._inverse = [_inverse_table(c, self.device) for c in dst.trc]

    def process(self, params, state, batch: FrameBatch):
        offs = VideoFormat.rgb_offsets(self.out_spec.format)
        img = batch.data
        idx = [img[..., offs[c]].to(torch.int32) for c in range(3)]
        lin = [self._dec[c][idx[c]] for c in range(3)]
        m = self._m
        out = img.clone()
        for o in range(3):
            mixed = lin[0] * m[o][0] + lin[1] * m[o][1] + lin[2] * m[o][2]
            enc = _encode(self._dst_trc[o], mixed, self._inverse[o])
            out[..., offs[o]] = torch.clamp(torch.round(enc * 255.0), 0, 255
                                            ).to(torch.uint8)
        if self.props["preserve-black"]:
            black = (idx[0] == 0) & (idx[1] == 0) & (idx[2] == 0)
            out = torch.where(black.unsqueeze(-1), img, out)
        return state, batch.with_data(out)
