"""Parity harness: one launch string through gstbad_tpu and gstbad_tpu_torch
(on the CPU), compared frame for frame — data, pts, flags, valid and bus
messages — plus the headline graph's parity cases.  The other pipeline
files (tests/test_torch_pipeline_*.py) import the harness from here.

Tolerance: bit exact, with one stated exception.  videotestsrc's ball is a
float64 distance test, r2 < radius^2, and torch's and XLA's libm cos/sin
may differ in the last ulp.  A pixel whose r2 lies within 1e-6 * radius^2
of the rim could flip, and dilate then moves it by one pixel: those pixels
and their 3x3 neighbours are exempt.  At the sizes used here no pixel is
that close to the rim, so the comparison is in fact bit exact.
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

HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")
GRAPHS = {
    "headline": HEAD + " ! zebrastripe ! fakesink",
    "prefix": HEAD + " ! fakesink",     # no fused tail: the K2 path
    "config1_sepia": "coloreffects preset=sepia ! fakesink",
    "config2_gaudi": ("solarize ! chromium ! dodge ! burn ! exclusion "
                      "! fakesink"),
}
SIZES = [(256, 32), (200, 18)]          # tiled and non-tiled
TINY = (5, 3)    # every pixel is an edge pixel of the dilate stencil
WINDOW, N_FRAMES = 4, 8


def source(pattern, width, height):
    return (f"videotestsrc pattern={pattern} width={width} height={height} "
            "format=BGRx ! ")


def _messages(bus):
    return [(m.element, m.name, m.pts, m.fields) for m in bus.messages]


def run_both(desc, fuse=True, window=WINDOW, n_frames=N_FRAMES,
             controls=None, img=None):
    """Run `desc` in both packages (the port on the CPU).  With `img`
    ([B, H, W, 4] uint8 BGRx) the graph has no source and takes the frames
    as inputs.  controls(pipeline) may bind controllable curves."""
    out = {}
    for key, pkg, spec_cls, fb_cls, to_dev, kw in (
            ("jax", gt, JMediaSpec, JFrameBatch, jnp.asarray, {}),
            ("torch", gtt, MediaSpec, FrameBatch, torch.from_numpy,
             {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        if controls:
            controls(p)
        if img is None:
            p.negotiate()
            p.compile(window, fuse_luts=fuse)
            res = p.run(n_frames=n_frames, window=window)
        else:
            p.negotiate(spec_cls(kind="video", format="BGRx",
                                 width=img.shape[2], height=img.shape[1]))
            p.compile(window, fuse_luts=fuse)
            res = p.run(inputs=fb_cls.make(to_dev(img.copy())))
        out[key] = (res, _messages(p.bus))
    return out["jax"], out["torch"]


def ball_exempt(width, height, n_frames, start=0):
    """[N, H, W] mask of ball pixels near the rim (see the module doc)."""
    n = np.arange(start, start + n_frames, dtype=np.float64)
    cx = width / 2.0 + width / 3.0 * np.cos(n * 0.1)
    cy = height / 2.0 + height / 3.0 * np.sin(n * 0.13)
    yy = np.arange(height, dtype=np.float64)[None, :, None]
    xx = np.arange(width, dtype=np.float64)[None, None, :]
    r2 = (xx - cx[:, None, None]) ** 2 + (yy - cy[:, None, None]) ** 2
    rad2 = max(4.0, min(height, width) / 16.0) ** 2
    band = np.abs(r2 - rad2) < 1e-6 * rad2
    pad = np.pad(band, ((0, 0), (1, 1), (1, 1)))
    near = np.zeros_like(band)
    for dy in range(3):
        for dx in range(3):
            near |= pad[:, dy:dy + height, dx:dx + width]
    return near


def assert_same(jax_run, torch_run, exempt=None):
    (jres, jmsg), (tres, tmsg) = jax_run, torch_run
    assert len(jres) == len(tres)
    assert jmsg == tmsg
    for f in ("pts", "flags", "valid"):
        a = np.concatenate([np.asarray(getattr(b, f)) for b in jres])
        t = np.concatenate([getattr(b, f) for b in tres])
        assert a.dtype == t.dtype, f
        np.testing.assert_array_equal(t, a, err_msg=f)
    if jres and isinstance(jres[0].data, dict):    # planar: per plane
        assert all(sorted(b.data) == sorted(jres[0].data) for b in tres)
        planes = [(np.concatenate([np.asarray(b.data[k]) for b in jres]),
                   np.concatenate([b.data[k] for b in tres]))
                  for k in sorted(jres[0].data)]
    else:
        planes = [(np.concatenate([np.asarray(b.data) for b in jres]),
                   np.concatenate([b.data for b in tres]))]
    for a, t in planes:
        assert a.dtype == t.dtype == np.uint8 and a.shape == t.shape
        if exempt is not None:
            keep = ~exempt
            a, t = a[keep], t[keep]
        np.testing.assert_array_equal(t, a)


def check_graph(graph, pattern, size, fuse):
    w, h = size
    jr, tr = run_both(source(pattern, w, h) + GRAPHS[graph], fuse=fuse)
    exempt = ball_exempt(w, h, N_FRAMES) if pattern == "ball" else None
    assert_same(jr, tr, exempt)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_headline_graph(pattern, size, fuse):
    check_graph("headline", pattern, size, fuse)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_headline_graph_tiny_frames(pattern, fuse):
    check_graph("headline", pattern, TINY, fuse)


def test_ball_exempt_band_is_empty_here():
    """The stated exception never applies at this file's sizes."""
    for w, h in SIZES + [TINY]:
        assert not ball_exempt(w, h, N_FRAMES).any()


def test_run_to_host_batches():
    """run() hands back uint8 host frames; the fused tail's int32 word is
    restored to bytes (fakesink keeps the word on the device side)."""
    p = gtt.parse_launch(source("bars", 64, 8) + GRAPHS["headline"],
                         device="cpu")
    p.negotiate()
    step = p.compile(2)
    _, leaves, _ = step(p.params(), p.init_states(2), None)
    assert leaves[0].data is leaves[0].word
    assert leaves[0].data.dtype == torch.int32
    assert leaves[0].data.shape == (2, 8, 64)
    res = p.run(n_frames=4, window=2)
    assert [b.data.shape for b in res] == [(2, 8, 64, 4)] * 2
    assert all(b.data.dtype == np.uint8 and b.word is None for b in res)
    np.testing.assert_array_equal(
        np.concatenate([b.pts for b in res]),
        np.arange(4, dtype=np.int64) * 33333333)
