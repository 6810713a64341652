"""gstbad_tpu_torch elements against gstbad_tpu's, element by element.

Each of the headline graph's ten filters runs its own (unfused) `process`
on the same numpy-seeded window in both packages, with per-run and per-frame
([B], the controllable-curve path) params.  Tolerance: bit exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec

torch.set_num_threads(1)   # parallel test workers share the cores

B, H, W = 4, 18, 40


def _window(rng):
    img = rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8)
    img[0, 0, 0] = 0            # the all-0 and all-255 edge pixels
    img[0, 0, 1] = 255
    return img


def _both(name, fmt, img, props, params_np=None):
    """Run element `name` once in each package on `img`; returns the two
    outputs as numpy (data, state)."""
    outs = []
    for pkg, spec_cls, fb_cls, to_dev in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make(name, **props)
        el.set_info(spec_cls(kind="video", format=fmt, width=W, height=H))
        params = el.dynamic_params()
        for k, v in (params_np or {}).items():
            params[k] = to_dev(np.asarray(v))
        st, out = el.process(params, el.init_state(B),
                             fb_cls.make(to_dev(img.copy())))[:2]
        outs.append((np.asarray(out.data), np.asarray(st)))
    return outs


ELEMENT_CASES = [
    ("coloreffects", "BGRx", {"preset": "sepia"}, None),
    ("coloreffects", "RGBx", {"preset": "heat"}, None),
    ("coloreffects", "xRGB", {"preset": "xray"}, None),
    ("coloreffects", "BGRA", {"preset": "xpro"}, None),
    ("coloreffects", "BGRx", {"preset": "yellowblue"}, None),
    ("coloreffects", "AYUV", {"preset": "sepia"}, None),
    ("coloreffects", "AYUV", {"preset": "xpro"}, None),
    ("coloreffects", "BGRx", {"preset": "none"}, None),
    ("solarize", "BGRx", {}, None),
    ("solarize", "RGBx", {"threshold": 10, "start": 200, "end": 40}, None),
    ("solarize", "BGRx", {}, {"threshold": [0, 50, 127, 256],
                              "start": [0, 50, 50, 0],
                              "end": [256, 50, 185, 256]}),
    ("chromium", "BGRx", {}, None),
    ("chromium", "BGRx", {"edge-a": 31, "edge-b": 255}, None),
    ("chromium", "BGRx", {}, {"edge-a": [0, 1, 200, 256],
                              "edge-b": [0, 255, 1, 7]}),
    ("dodge", "BGRx", {}, None),
    ("burn", "BGRx", {}, None),
    ("burn", "RGBx", {"adjustment": 0}, None),
    ("burn", "BGRx", {}, {"adjustment": [0, 1, 175, 256]}),
    ("exclusion", "BGRx", {}, None),
    ("exclusion", "BGRx", {"factor": 1}, None),
    ("exclusion", "BGRx", {}, {"factor": [1, 80, 150, 175]}),
    ("dilate", "BGRx", {}, None),
    ("dilate", "RGBx", {"erode": True}, None),
    ("dilate", "BGRx", {}, {"erode": [False, True, True, False]}),
    ("chromahold", "BGRx", {}, None),
    ("chromahold", "RGBA", {"target-r": 90, "target-g": 90,
                            "target-b": 90}, None),
    ("chromahold", "BGRx", {"target-g": 200, "tolerance": 0}, None),
    ("chromahold", "BGRx", {}, {"target-r": [255, 0, 30, 90],
                                "target-g": [0, 255, 60, 90],
                                "target-b": [0, 0, 90, 90],
                                "tolerance": [30, 180, 0, 10]}),
    ("videoconvert", "BGRx", {"format": "AYUV"}, None),
    ("videoconvert", "RGBA", {"format": "AYUV"}, None),
    ("videoconvert", "AYUV", {"format": "BGRx"}, None),
    ("videoconvert", "AYUV", {"format": "ARGB"}, None),
    ("videoconvert", "BGRx", {"format": "RGBx"}, None),
    ("videoconvert", "xRGB", {"format": "ABGR"}, None),
    ("videoconvert", "RGBA", {"format": "BGRA"}, None),
    ("videoconvert", "BGRx", {"format": "BGRx"}, None),
    ("zebrastripe", "AYUV", {}, None),
    ("zebrastripe", "AYUV", {"threshold": 0}, None),
    ("zebrastripe", "AYUV", {}, {"threshold": [0, 30, 90, 100]}),
]


@pytest.mark.parametrize("name,fmt,props,per_frame", ELEMENT_CASES)
def test_element_process(rng, name, fmt, props, per_frame):
    params_np = None
    if per_frame:
        el = gt.make(name)
        types = {p.name: p.type for p in el.PROPERTIES}
        params_np = {k: np.asarray(v, {int: np.int32, bool: bool,
                                       float: np.float32}[types[k]])
                     for k, v in per_frame.items()}
    (jd, js), (td, ts) = _both(name, fmt, _window(rng), props, params_np)
    assert td.dtype == jd.dtype and td.shape == jd.shape
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
