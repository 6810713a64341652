"""Parity of the port's qroverlay, debugqroverlay, rsvgoverlay, rsvgdec
and faceoverlay with the JAX package on the CPU: frames, pts, valid and
bus messages equal.  The librsvg cases skip where the library is
missing, as the JAX tests do; faceoverlay's PNG overlays need PIL, which
both packages import only then."""

import os

import numpy as np
import pytest

from gstbad_tpu.io import rsvg as j_rsvg
from helpers.torch_overlay import (assert_same, data_of, run_both,
                                   run_launch_both, spec)
from test_faceoverlay import _frame_with_face
from test_rsvg import SVG

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "gstbad_tpu_torch", "data", "")
ALT2 = DATA + "haarcascade_frontalface_alt2.xml"
needs_rsvg = pytest.mark.skipif(not j_rsvg.available(),
                                reason="librsvg/cairo not present")


def _frames(n, w, h, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("fmt,props", [
    ("BGRx", {}),
    ("RGB", {"x": 0.0, "y": 0.0, "pixel-size": 2.5}),
    ("ARGB", {"x": 100.0, "y": 100.0, "qrcode-error-correction": 3}),
    ("xBGR", {"x": 20.0, "y": 80.0, "pixel-size": 1.0})])
def test_qroverlay(fmt, props):
    """The symbol at the centre, clipped at the edges, at fractional
    module sizes; 4-byte (an alpha byte takes its own rule) and 3-byte
    formats."""
    w, h = 97, 75
    c = 3 if fmt == "RGB" else 4
    frames = _frames(4, w, h, c, 1)
    res = run_both([("qroverlay", dict(props, data="gst port qr"))],
                   spec(fmt, w, h), [(frames[:2], None), (frames[2:], None)])
    assert_same(res)
    assert (data_of(res) != frames).any()


def test_qroverlay_without_data_passes_through():
    frames = _frames(2, 33, 21, 4, 2)
    res = run_both([("qroverlay", {})], spec("BGRA", 33, 21),
                   [(frames, None)])
    assert_same(res)
    np.testing.assert_array_equal(data_of(res), frames)


@pytest.mark.parametrize("fmt,props", [
    ("RGBx", {"max-frames": 6, "extra-data-name": "K",
              "extra-data-array": "a,b,c", "extra-data-interval-buffers": 2,
              "extra-data-span-buffers": 2}),
    ("BGR", {"max-frames": 5, "extra-data-name": "W",
             "extra-data-array": "240,480", "extra-data-interval-buffers": 3,
             "pixel-size": 1.5})])
def test_debugqroverlay(fmt, props):
    """Per-frame JSON symbols from a bank the frame counter indexes across
    windows; frames past max-frames pass through."""
    w, h = 120, 90
    c = 3 if fmt == "BGR" else 4
    frames = _frames(8, w, h, c, 3)
    res = run_both([("debugqroverlay", props)], spec(fmt, w, h),
                   [(frames[:4], None), (frames[4:], None)])
    assert_same(res)
    out = data_of(res)
    n = props["max-frames"]
    assert (out[:n] != frames[:n]).any(axis=(1, 2, 3)).all()
    np.testing.assert_array_equal(out[n:], frames[n:])


@needs_rsvg
@pytest.mark.parametrize("fmt,props", [
    ("BGRA", {}), ("RGBA", {"fit-to-frame": True}),
    ("ARGB", {"x": 10, "y": 6, "width": 40}),
    ("ABGR", {"x-relative": 0.25, "y-relative": 0.5,
              "height-relative": 0.5})])
def test_rsvgoverlay(fmt, props):
    frames = _frames(3, 49, 33, 4, 4)
    res = run_both([("rsvgoverlay", dict(props, data=SVG))],
                   spec(fmt, 49, 33), [(frames[:2], None), (frames[2:], None)])
    assert_same(res)
    assert (data_of(res) != frames).any()


@needs_rsvg
def test_rsvgoverlay_data_pad_and_none():
    frames = _frames(2, 48, 32, 4, 5)

    def setup(pkg, els):
        els[0].push_data(SVG.encode()[:30])
        els[0].push_data(SVG.encode()[30:])

    assert_same(run_both([("rsvgoverlay", {})], spec("BGRA", 48, 32),
                         [(frames, None)], setup))
    res = run_both([("rsvgoverlay", {})], spec("BGRA", 48, 32),
                   [(frames, None)])
    assert_same(res)
    np.testing.assert_array_equal(data_of(res), frames)


@needs_rsvg
def test_rsvgdec():
    """A byte stream split at </svg>, a later smaller document scaled to
    the first's size, and a short last window."""
    small = SVG.replace('width="24" height="16"', 'width="12" height="8"')

    def feed(pkg, p):
        dec = p.get_by_name("d")
        dec.push_data((SVG + small).encode()[:50])
        dec.push_data((SVG + small).encode()[50:])
        dec.push_packet(SVG.replace("#ff4020", "#2040ff").encode())

    res = run_launch_both("rsvgdec name=d ! fakesink", feed, window=2,
                          feed_first=True)
    assert_same(res)
    assert data_of(res).shape == (3, 16, 24, 4)


def _overlay_png(tmp_path):
    from PIL import Image
    o = np.zeros((16, 12, 4), np.uint8)
    o[..., 1] = 255
    o[..., 3] = np.arange(12, dtype=np.uint8)[None, :] * 20 + 15
    path = str(tmp_path / "over.png")
    Image.fromarray(o, "RGBA").save(path)
    return path


def _overlay_svg(tmp_path):
    path = str(tmp_path / "over.svg")
    with open(path, "w") as f:
        f.write('<svg xmlns="http://www.w3.org/2000/svg" width="8" '
                'height="10"><rect width="8" height="10" fill="lime" '
                'fill-opacity="0.7"/><circle cx="4" cy="5" r="3" '
                'fill="#ff2040"/></svg>')
    return path


@pytest.mark.parametrize("image,props,at", [
    ("png", {}, (16, 40)),
    ("svg", {"w": 1.5, "h": 0.7, "x": -0.3}, (30, 2)),
    ("png", {"x": 0.8, "y": 0.9}, (36, 70))])
def test_faceoverlay_skin(tmp_path, image, props, at):
    """The skin-density search, the box snapped to a scale, the overlay
    blended in float32 at its offset, clipped at the frame's edges."""
    if image == "svg" and not j_rsvg.available():
        pytest.skip("librsvg/cairo not present")
    if image == "png":
        pytest.importorskip("PIL")
    loc = (_overlay_png if image == "png" else _overlay_svg)(tmp_path)
    fy, fx = at
    frames = np.stack([_frame_with_face(fy=fy, fx=fx),
                       np.zeros((64, 96, 4), np.uint8),
                       _frame_with_face(fy=fy // 2, fx=fx // 3)])
    res = run_both([("faceoverlay", dict(props, location=loc,
                                         detector="skin"))],
                   spec("RGBx", 96, 64), [(frames, None)])
    assert_same(res, min_messages=2)
    out = data_of(res)
    assert (out[0] != frames[0]).any() and (out[1] == frames[1]).all()


def test_faceoverlay_haar(tmp_path):
    """The Haar path over the port's alt2 copy, passed to both packages
    (the default profile path is opencv4's): the face fixture at two
    places on a flat background, and a frame without a face.  A coarse
    pyramid (scale-factor 2) keeps the JAX element's compile short."""
    pytest.importorskip("PIL")
    face = np.load(DATA + "face_fixture.npz")["frame"]
    frames = np.full((3, 168, 176, 4), 90, np.uint8)
    frames[0, 4:165, 6:167, :3] = face[..., None]
    frames[2, 6:167, 10:171, :3] = face[..., None]
    res = run_both([("faceoverlay", {"location": _overlay_png(tmp_path),
                                     "profile": ALT2, "scale-factor": 2.0})],
                   spec("RGBA", 176, 168), [(frames, None)])
    assert_same(res, min_messages=2)
    out = data_of(res)
    changed = (out != frames).any(axis=(1, 2, 3))
    assert list(changed) == [True, False, True]
