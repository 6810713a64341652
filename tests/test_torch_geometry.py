"""The config-4 family in gstbad_tpu_torch against gstbad_tpu on the CPU:
the 16 warps' fixed maps, the packed-pixel gather (the plain form of
kernel K7) against the Pallas warp kernel in interpret mode, every warp
element, bayer2rgb and rgb2bayer, and the config-4, warp and
config-2b graphs through both parse_launches.

Tolerance: bit exact everywhere (integer maps and gathers; the blur graph
runs the JAX element's Pallas path, see tests/test_torch_blur.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.golden import geometric as jmaps
from gstbad_tpu.models import benchmarks as jbench
from gstbad_tpu.ops import blur_pallas
from gstbad_tpu.ops import remap as jremap
from gstbad_tpu.ops import warp_pallas
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.golden import geometric as tmaps
from gstbad_tpu_torch.models import benchmarks as tbench
from gstbad_tpu_torch.ops import remap as tremap
from test_torch_parity import _messages, assert_same

torch.set_num_threads(1)   # parallel test workers share the cores

WARPS = sorted(jmaps.MAP_BUILDERS)
# non-default properties that move each map off its default
PROPS = {"rotate": {"angle": 0.4}, "perspective": {
    "matrix": "1.1 0.2 -3 0.05 0.9 2 0.001 0.0005 1"},
    "mirror": {"mode": "bottom"}, "diffuse": {"seed": 5},
    "marble": {"seed": 3}, "sphere": {"refraction": 2.5},
    "pinch": {"intensity": -0.6}, "tunnel": {"radius": 0.2},
    "kaleidoscope": {"sides": 5, "angle": 0.3}, "twirl": {"angle": 2.0},
    "circle": {"height": 12.0}, "waterripple": {"phase": 0.7},
    "bulge": {"zoom": 2.0}, "stretch": {"intensity": 0.8},
    "square": {"zoom": 3.0}}


def _map(name, w, h, pkg_maps):
    kw = {"rotate": {"angle": 0.4}}.get(name, {})
    if name in ("diffuse", "marble"):
        kw = {"rng": np.random.default_rng(9)}
    return pkg_maps.MAP_BUILDERS[name](w, h, **kw)


@pytest.mark.parametrize("off_edge", ["ignore", "clamp", "wrap"])
@pytest.mark.parametrize("name", WARPS)
def test_fix_map_equals_the_jax_package(name, off_edge):
    w, h = 64, 48
    tmp, jmp = _map(name, w, h, tmaps), _map(name, w, h, jmaps)
    np.testing.assert_array_equal(tmp, jmp)
    got = tremap.fix_map(tmp, w, h, off_edge)
    want = jremap.fix_map(jmp, w, h, off_edge)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", ["fisheye", "twirl", "rotate", "mirror"])
def test_warp_words_plain_matches_pallas_kernel(name):
    """As tests/test_warp_pallas.py:14-26 does for the golden remap."""
    h, w = 64, 256
    rng = np.random.default_rng(31)
    mp = _map(name, w, h, jmaps)
    plan = warp_pallas.plan(mp, w, h, "ignore")
    assert plan is not None
    img = rng.integers(0, 256, (2, h, w, 4), dtype=np.uint8)
    flat, valid = jremap.fix_map(mp, w, h, "ignore")
    want = np.asarray(warp_pallas.warp_batch(
        jnp.asarray(img), plan, jnp.asarray(valid), jnp.zeros(4, jnp.uint8),
        interpret=True))
    words = torch.from_numpy(np.ascontiguousarray(img).view("<i4")[..., 0])
    tm = torch.from_numpy(tremap.word_map(flat, valid))
    got = tremap.warp_words(words, tm, 0)
    np.testing.assert_array_equal(got.numpy().view(np.uint8).reshape(
        img.shape), want)
    # the u8 remap is the same gather
    got8 = tremap.remap(torch.from_numpy(img), torch.from_numpy(flat),
                        torch.from_numpy(valid),
                        torch.zeros(4, dtype=torch.uint8))
    np.testing.assert_array_equal(got8.numpy(), want)


def test_warp_words_broadcast_background_and_bad_input():
    """A [1, H, W] base with batch=B equals the materialized source; an
    off-edge pixel (and a map entry out of range) takes the background
    word; bad input raises before any launch."""
    rng = np.random.default_rng(32)
    h, w = 5, 7
    src = torch.from_numpy(rng.integers(-2**31, 2**31, (1, h, w),
                                        dtype=np.int64).astype(np.int32))
    mp = torch.from_numpy(rng.integers(-1, h * w + 3, h * w)
                          .astype(np.int32))
    bg = tremap.background_word(b"\xff\x10\x80\x80")
    assert bg == np.frombuffer(b"\xff\x10\x80\x80", "<i4")[0]
    got = tremap.warp_words(src, mp, bg, batch=3)
    want = tremap.warp_words(src.expand(3, h, w).contiguous(), mp, bg)
    assert got.shape == (3, h, w) and got.is_contiguous()
    assert torch.equal(got, want)
    flat = src.reshape(-1)
    for p, m in enumerate(mp.tolist()):
        v = flat[m].item() if 0 <= m < h * w else bg
        assert (got[:, p // w, p % w] == v).all()
    for bad in (lambda: tremap.warp_words(src.long(), mp, bg),
                lambda: tremap.warp_words(src, mp.long(), bg),
                lambda: tremap.warp_words(src, mp[1:], bg),
                lambda: tremap.warp_words(src, mp, 2**31),
                lambda: tremap.warp_words(src.expand(2, h, w), mp, bg,
                                          batch=3)):
        with pytest.raises(ValueError):
            bad()
    assert tremap.warp_words.launches == 0


def _element_both(name, fmt, props, img):
    outs = []
    for pkg, spec_cls, fb_cls, to_dev in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make(name, **props)
        el.set_info(spec_cls(kind="video", format=fmt, width=img.shape[2],
                             height=img.shape[1]))
        _, out = el.process(el.dynamic_params(), el.init_state(img.shape[0]),
                            fb_cls.make(to_dev(img.copy())))[:2]
        outs.append(np.asarray(out.data))
    return outs


@pytest.mark.parametrize("fmt", ["RGBA", "AYUV"])
@pytest.mark.parametrize("name", WARPS)
def test_warp_element_matches_the_jax_element(name, fmt):
    """Each warp at non-default properties, off-edge pixels cycling through
    the three modes; AYUV takes the FF 10 80 80 background."""
    rng = np.random.default_rng(33)
    img = rng.integers(0, 256, (2, 30, 44, 4), dtype=np.uint8)
    off_edge = ("ignore", "clamp", "wrap")[WARPS.index(name) % 3]
    props = dict(PROPS.get(name, {}), **{"off-edge-pixels": off_edge,
                                         "engine": "gather"})
    got, want = _element_both(name, fmt, props, img)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if fmt == "AYUV" and name == "rotate":   # corners fall off the edge
        assert (got == np.array([0xFF, 0x10, 0x80, 0x80], np.uint8)
                ).all(-1).any()


@pytest.mark.parametrize("fmt", ["bggr", "gbrg", "grbg", "rggb"])
@pytest.mark.parametrize("out_fmt", ["RGBA", "BGRA", "ARGB", "ABGR"])
def test_bayer2rgb_matches_the_jax_element(fmt, out_fmt):
    rng = np.random.default_rng(34)
    raw = rng.integers(0, 256, (2, 16, 24), dtype=np.uint8)
    outs = []
    for pkg, spec_cls, fb_cls, to_dev in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make("bayer2rgb", format=out_fmt)
        out_spec = el.set_info(spec_cls(kind="bayer", format=fmt, width=24,
                                        height=16))
        assert (out_spec.kind, out_spec.format) == ("video", out_fmt)
        _, out = el.process({}, (), fb_cls.make(to_dev(raw.copy())))[:2]
        outs.append(np.asarray(out.data))
    assert outs[0].dtype == outs[1].dtype == np.uint8
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("fmt", ["bggr", "gbrg", "grbg", "rggb"])
def test_rgb2bayer_matches_the_jax_element(fmt):
    rng = np.random.default_rng(35)
    img = rng.integers(0, 256, (2, 16, 24, 4), dtype=np.uint8)
    outs = []
    for pkg, spec_cls, fb_cls, to_dev in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make("rgb2bayer", format=fmt)
        out_spec = el.set_info(spec_cls(kind="video", format="ARGB",
                                        width=24, height=16))
        assert (out_spec.kind, out_spec.format) == ("bayer", fmt)
        _, out = el.process({}, (), fb_cls.make(to_dev(img.copy())))[:2]
        outs.append(np.asarray(out.data))
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("name", ["config4_warp", "warp_1080p",
                                  "config2_blur"])
def test_benchmark_graph_matches_the_jax_package(name, monkeypatch):
    """The slice's graphs at 256x64, window 4: data, pts, flags, valid and
    bus messages."""
    monkeypatch.setattr(blur_pallas, "INTERPRET", True)
    pj = jbench.build(name, width=256, height=64)
    pt = tbench.build(name, width=256, height=64, device="cpu")
    assert repr(pt) == repr(pj)
    runs = [(p.run(n_frames=8, window=4), _messages(p.bus))
            for p in (pj, pt)]
    assert_same(*runs)
