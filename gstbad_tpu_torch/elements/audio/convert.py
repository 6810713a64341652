"""audioconvert — sample-format and channel-count conversion (the
gst-plugins-base element BASELINE config 3's `freeverb ! audioconvert !
removesilence` needs; removesilence takes S16 mono only).

float -> int scales by 2^(bits-1), rounds half to even (torch.round, as
the JAX package's jnp.round; its docstring says half away from zero, its
code rounds half to even) and clamps; int -> float divides by 2^(bits-1).
Channel conversion: downmix averages equally weighted inputs, upmix from
mono duplicates, other counts copy the overlap and zero-fill; an explicit
`mix-matrix` (rows = out, cols = in, audiomixmatrix syntax) overrides.
The arithmetic is float64, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.elements.audio.mixmatrix import parse_matrix

_BITS = {AudioFormat.S16: 16, AudioFormat.S32: 32}
_INT_DTYPES = {16: torch.int16, 32: torch.int32}


def _to_f64(data, fmt):
    if fmt in _BITS:
        return data.to(torch.float64) / float(2 ** (_BITS[fmt] - 1))
    return data.to(torch.float64)


def _from_f64(x, fmt):
    if fmt in _BITS:
        bits = _BITS[fmt]
        scale = float(2 ** (bits - 1))
        v = torch.round(x * scale).clamp(-scale, scale - 1)
        return v.to(_INT_DTYPES[bits])
    if fmt == AudioFormat.F32:
        return x.to(torch.float32)
    return x


@register
class AudioConvert(Element):
    """Per-sample conversion: [B, S, Cin] -> [B, S, Cout]."""

    NAME = "audioconvert"
    PROPERTIES = (
        Property("format", str, "", static=True),    # "" = keep input
        Property("channels", int, 0, 0, 256, static=True),  # 0 = keep
        Property("mix-matrix", str, "", static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio input")
        fmt = self.props["format"] or in_spec.format
        require(fmt in AudioFormat.ALL,
                f"{self.NAME}: unknown format {fmt!r}")
        ch = self.props["channels"]
        if not ch and self.props["mix-matrix"]:
            ch = parse_matrix(self.props["mix-matrix"]).shape[0]
        ch = ch or in_spec.channels
        return in_spec.with_(format=fmt, channels=ch)

    def prepare(self):
        cin, cout = self.in_spec.channels, self.out_spec.channels
        mm = self.props["mix-matrix"]
        if mm:
            mat = parse_matrix(mm)
            require(mat.shape == (cout, cin),
                    f"{self.NAME}: mix-matrix shape {mat.shape} != "
                    f"({cout}, {cin})")
        elif cin == cout:
            mat = np.eye(cout, dtype=np.float64)
        elif cin == 1:
            mat = np.ones((cout, 1), np.float64)    # mono upmix: duplicate
        elif cout == 1:
            mat = np.full((1, cin), 1.0 / cin)      # downmix: equal average
        else:
            mat = np.zeros((cout, cin), np.float64)  # copy the overlap,
            k = min(cin, cout)                       # zero-fill the rest
            mat[:k, :k] = np.eye(k)
        self._matrix = torch.as_tensor(mat, device=self.device)
        self._identity_mix = (cin == cout
                              and bool(np.all(mat == np.eye(cout))))

    def process(self, params, state, batch: FrameBatch):
        x = _to_f64(batch.data, self.in_spec.format)
        if not self._identity_mix:
            x = torch.einsum("bsc,oc->bso", x, self._matrix)
        return state, batch.with_data(_from_f64(x, self.out_spec.format))
