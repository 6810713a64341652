"""videoconvert in gstbad_tpu_torch against gstbad_tpu on the CPU: every
(source, target) pair of its 26 formats, its negotiation rules, the two
routes a 4-byte-only port got wrong once the format list widened (a
channel-count change in the RGB permutation, and the table-fusion word
map ending where the target is not a 4-byte word), and an I420 transcode
around gaussianblur.  Tolerance: bit exact (the blur against the JAX
package's Pallas kernel in interpret mode, whose float order the port
keeps; its XLA blur may differ by 1 LSB, ROADMAP queue 3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.core.spec import SpecError as JSpecError
from gstbad_tpu.elements.video import convert as jconvert
from gstbad_tpu.ops import blur_pallas
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec, SpecError, VideoFormat
from gstbad_tpu_torch.elements.video import convert as tconvert
from test_torch_parity import assert_same, run_both

torch.set_num_threads(1)   # parallel test workers share the cores

FORMATS = list(tconvert._ALL)
B, H, W = 2, 8, 16


def make_frames(fmt, b, h, w, rng):
    """A random window of format `fmt` as numpy (a dict for planar)."""
    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    def u16(*shape):
        return rng.integers(0, 65536, shape, dtype=np.uint16)

    hh, wh = (h + 1) // 2, (w + 1) // 2
    if fmt in VideoFormat.PACKED_4:
        return u8(b, h, w, 4)
    if fmt in VideoFormat.PACKED_RGB3:
        return u8(b, h, w, 3)
    if fmt in VideoFormat.PACKED_RGB16:
        return u16(b, h, w)
    if fmt == VideoFormat.ARGB64:
        return u16(b, h, w, 4)
    if fmt == VideoFormat.GRAY8:
        return u8(b, h, w)
    if fmt in (VideoFormat.I420, VideoFormat.YV12):
        return {"y": u8(b, h, w), "u": u8(b, hh, wh), "v": u8(b, hh, wh)}
    if fmt == VideoFormat.Y444:
        return {"y": u8(b, h, w), "u": u8(b, h, w), "v": u8(b, h, w)}
    if fmt == VideoFormat.Y42B:
        return {"y": u8(b, h, w), "u": u8(b, h, wh), "v": u8(b, h, wh)}
    if fmt == VideoFormat.Y41B:
        wq = (w + 3) // 4
        return {"y": u8(b, h, w), "u": u8(b, h, wq), "v": u8(b, h, wq)}
    if fmt in VideoFormat.SEMIPLANAR_YUV:
        return {"y": u8(b, h, w), "uv": u8(b, hh, 2 * wh)}
    assert fmt in VideoFormat.PACKED_YUV422, fmt
    return u8(b, h, 2 * w)


def _tree(data, fn):
    if isinstance(data, dict):
        return {k: fn(v) for k, v in data.items()}
    return fn(data)


def convert_both(src, dst, data, h=H, w=W):
    """videoconvert src -> dst on `data` in each package, unfused; returns
    the two outputs as numpy trees."""
    outs = []
    for pkg, spec_cls, fb_cls, to_dev in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make("videoconvert", format=dst)
        el.set_info(spec_cls(kind="video", format=src, width=w, height=h))
        _, out = el.process(el.dynamic_params(), el.init_state(B),
                            fb_cls.make(_tree(data, lambda a: to_dev(
                                a.copy()))))
        outs.append(_tree(out.data, np.asarray))
    return outs


def assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src", FORMATS)
def test_every_pair_from(src):
    """src to each of the 26 targets, bit exact against the JAX element."""
    assert sorted(tconvert._ALL) == sorted(jconvert._ALL)
    rng = np.random.default_rng(FORMATS.index(src))
    data = make_frames(src, B, H, W, rng)
    for dst in FORMATS:
        want, got = convert_both(src, dst, data)
        assert_trees_equal(got, want)


def _negotiates(pkg, spec_cls, src, dst, w, h):
    p = pkg.make("videoconvert", format=dst)
    try:
        p.set_info(spec_cls(kind="video", format=src, width=w, height=h))
    except (SpecError, JSpecError):
        return False
    return True


def test_negotiation_follows_the_jax_package():
    """Odd sizes refuse the 4:2:0, 4:2:2 and semi-planar targets, widths
    that are not a multiple of 4 refuse Y41B, in both packages; unknown
    formats refuse both ways."""
    refused = 0
    for w, h in ((16, 8), (15, 8), (16, 7), (14, 8), (13, 9)):
        for src in (VideoFormat.BGRx, VideoFormat.GRAY8, VideoFormat.RGB16):
            for dst in FORMATS:
                want = _negotiates(gt, JMediaSpec, src, dst, w, h)
                got = _negotiates(gtt, MediaSpec, src, dst, w, h)
                assert got == want, (src, dst, w, h)
                refused += not got
    assert refused == 3 * (8 + 4 + 1 + 8)
    for bad_src, bad_dst in (("P010", "AYUV"), ("AYUV", "NV16")):
        assert not _negotiates(gtt, MediaSpec, bad_src, bad_dst, 16, 8)
        assert not _negotiates(gt, JMediaSpec, bad_src, bad_dst, 16, 8)


@pytest.mark.parametrize("w,h", [(15, 9), (14, 7), (6, 4)])
def test_odd_sizes_convert_where_they_negotiate(w, h):
    """Sources of odd width or height (whose chroma planes round up) to
    every target that accepts them."""
    rng = np.random.default_rng(w * h)
    for src in (VideoFormat.I420, VideoFormat.Y41B, VideoFormat.NV21,
                VideoFormat.BGRA):
        data = make_frames(src, B, h, w, rng)
        for dst in FORMATS:
            if not _negotiates(gtt, MediaSpec, src, dst, w, h):
                continue
            want, got = convert_both(src, dst, data, h, w)
            assert_trees_equal(got, want)


@pytest.mark.parametrize("src,dst", [("RGB", "BGRx"), ("BGRx", "RGB"),
                                     ("BGR", "ARGB"), ("RGBA", "BGR")])
def test_rgb_permutation_changes_the_channel_count(src, dst):
    """The packed-RGB permutation writes n_channels(dst) bytes, with the
    fill or alpha byte only where dst has one (3 <-> 4 bytes)."""
    rng = np.random.default_rng(5)
    want, got = convert_both(src, dst, make_frames(src, B, H, W, rng))
    assert got.shape == (B, H, W, VideoFormat.n_channels(dst))
    assert_trees_equal(got, want)


@pytest.mark.parametrize("tail", ["videoconvert format=RGB",
                                  "videoconvert format=I420",
                                  "videoconvert format=RGB16",
                                  "videoconvert format=RGBA"])
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_fused_chain_ends_at_a_target_that_is_no_word(pattern, tail):
    """BGRx ! solarize ! videoconvert: the word map joins the table chain
    only for a 4-byte target; RGB, I420 and RGB16 end it, and their
    frames equal the JAX package's.  On static bars the chain is
    time-invariant and would absorb a word map; on the ball it flushes
    before the convert."""
    desc = (f"videotestsrc pattern={pattern} width=32 height=8 format=BGRx "
            f"! solarize ! {tail} ! fakesink")
    jr, tr = run_both(desc, window=2, n_frames=4)
    first = tr[0][0].data
    if tail.endswith("RGB16"):
        (jres, jmsg), (tres, tmsg) = jr, tr
        for a, b in zip(jres, tres):
            assert b.data.dtype == np.uint16
            np.testing.assert_array_equal(b.data, np.asarray(a.data))
        return
    if tail.endswith("RGB"):
        assert first.shape == (2, 8, 32, 3)
    assert_same(jr, tr)


def test_wide_formats_run_through_both_launches():
    """The 16-bit formats through videotestsrc and a chain of converts:
    RGB15 -> ARGB64 -> BGR16 -> NV12 -> YUY2 -> BGR -> GRAY8."""
    desc = ("videotestsrc pattern=ball width=24 height=8 format=RGB15 "
            "! videoconvert format=ARGB64 ! videoconvert format=BGR16 "
            "! videoconvert format=NV12 ! videoconvert format=YUY2 "
            "! videoconvert format=BGR ! videoconvert format=GRAY8 "
            "! fakesink")
    jr, tr = run_both(desc, window=2, n_frames=4)
    assert tr[0][0].data.shape == (2, 8, 24)
    assert_same(jr, tr)


@pytest.fixture
def pallas_blur(monkeypatch):
    """The JAX element's one-pass Pallas path, in interpret mode."""
    monkeypatch.setattr(blur_pallas, "INTERPRET", True)


@pytest.mark.parametrize("pattern", ["ball", "bars"])
def test_i420_transcode_around_gaussianblur(pallas_blur, pattern):
    """videotestsrc I420 ! videoconvert AYUV ! gaussianblur ! videoconvert
    I420, frame for frame with pts, flags and valid."""
    desc = (f"videotestsrc pattern={pattern} width=128 height=16 "
            "format=I420 ! videoconvert format=AYUV ! gaussianblur "
            "sigma=1.2 ! videoconvert format=I420 ! fakesink")
    jr, tr = run_both(desc, window=3, n_frames=6)
    assert sorted(tr[0][0].data) == ["u", "v", "y"]
    assert tr[0][0].data["u"].shape == (3, 8, 64)
    assert_same(jr, tr)
