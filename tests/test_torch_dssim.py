"""ops.dssim and iqa's multiscale DSSIM in gstbad_tpu_torch against
gstbad_tpu on the CPU: dssim_rgb and its finest map, and iqa's N pads and
output-map through the fan-in launch string.

Tolerances: dssim_rgb, its finest map and iqa's dssim fields within 1e-5
absolute: float32 math in the JAX package's op order, but torch has no
cube root (torch.pow(t, 1/3) is within 1 ulp of jnp.cbrt) and its float32
reductions sum in another order.  iqa's ssim field within 1e-12 (float64
sums in another order).  output-map bytes (the finest map rounded to
0-255) within 1, since a map value within 1e-5 of a rounding edge may
round the other way; every other byte, pts, flags and valid exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.ops import blur_pallas
from gstbad_tpu.ops import dssim as jdssim
from gstbad_tpu_torch.ops import dssim as tdssim
from test_torch_quality import B, _degrade, assert_iqa_runs_close

torch.set_num_threads(1)   # parallel test workers share the cores


@pytest.mark.parametrize("h,w,offs", [(48, 96, (0, 1, 2)),
                                      (45, 67, (2, 1, 0)),
                                      (12, 10, (3, 1, 2))])
def test_dssim_rgb_within_1e_5(h, w, offs):
    """Three, three and one pyramid scales (the last frame narrower than
    the window), at three channel orders."""
    rng = np.random.default_rng(h)
    a = rng.integers(0, 256, (B, h, w, 4), dtype=np.uint8)
    b = _degrade(a, rng, 25)
    b[1] = a[1]
    js, jm = jdssim.dssim_rgb(jnp.asarray(a), jnp.asarray(b), offs)
    ts, tm = tdssim.dssim_rgb(torch.from_numpy(a), torch.from_numpy(b),
                              offs)
    assert ts.dtype == torch.float32 and tm.shape == (B, h, w)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-5)
    assert float(ts[1]) < 1e-5 < float(ts[0])


@pytest.fixture
def pallas_blur(monkeypatch):
    """The JAX gaussianblur element's Pallas path, in interpret mode (the
    float order the port keeps)."""
    monkeypatch.setattr(blur_pallas, "INTERPRET", True)


def test_iqa_n_pads_through_the_fan_in_launch(pallas_blur):
    """iqa.c:336-400 through the launch string: the first pad is the
    reference; an identical and a blurred branch each get a dssim-pad-N,
    the flat fields are pad 1's, exceeded is any pad's."""
    desc = ("videotestsrc pattern=ball width=128 height=16 format=AYUV "
            "name=ref ! m.  ref. ! identity ! m.  "
            "ref. ! gaussianblur sigma=3 ! m.  "
            "iqa name=m ssim-error-threshold=0.002 ! fakesink")
    msgs = assert_iqa_runs_close(desc, n_frames=2)
    f = msgs[-1][3]
    assert f["dssim-pad-1"] < 1e-6 < f["dssim-pad-2"]
    assert f["dssim"] == f["dssim-pad-1"] and f["exceeded"]


def test_iqa_blur_path_with_output_map(pallas_blur):
    """The chip's iqa_dssim graph at a small size, with output-map on:
    the reference pad's frames blurred, scored and mapped."""
    desc = ("videotestsrc pattern=ball width=128 height=16 format=AYUV "
            "name=ref ! m.  ref. ! gaussianblur sigma=1.2 ! m.  "
            "iqa name=m output-map=true ! fakesink")
    msgs = assert_iqa_runs_close(desc, n_frames=4, window=2)
    assert all(0 < m[3]["dssim"] < 0.1 for m in msgs)
