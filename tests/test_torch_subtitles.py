"""Parity of the port's text renderers (assrender, ttmlrender, ttmlparse,
teletextdec) with the JAX package on the CPU: frames, pts, valid and bus
messages equal.  The pango faces render with this host's fonts in both
packages, so they are compared on one host; they skip where pango is
missing, as the JAX tests do."""

import numpy as np
import pytest

from gstbad_tpu.io import pangocairo as j_pangocairo
from gstbad_tpu.io import teletext as tt
from helpers.torch_overlay import (assert_same, data_of, run_both,
                                   run_launch_both, spec)
from test_assrender import SCRIPT
from test_teletext import _unit
from test_ttml import DOC

SEC = 10 ** 9
PANGO = j_pangocairo.available()


def _face(face):
    if face in ("pango", "auto") and not PANGO:
        pytest.skip("pango/pangocairo not present")


def _frames(n, w, h, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("fmt,face", [
    ("BGRx", "fixed"), ("RGB", "fixed"), ("ARGB", "fixed"),
    ("BGRx", "pango"), ("BGR", "pango"), ("RGBA", "auto")])
def test_assrender(fmt, face):
    """Two events in two styles, overlapping in time, over two windows;
    4-byte and 3-byte formats."""
    _face(face)
    w, h = 160, 120
    c = 3 if fmt in ("RGB", "BGR") else 4
    frames = _frames(6, w, h, c, 5)
    pts = [0, int(1.5e9), int(2.5e9), int(3.7e9), int(5e9), int(3.2e9)]

    def setup(pkg, els):
        els[0].push_script(SCRIPT)

    res = run_both([("assrender", {"face": face})], spec(fmt, w, h),
                   [(frames[:3], pts[:3]), (frames[3:], pts[3:])], setup)
    assert_same(res)
    changed = (data_of(res) != frames).any(axis=(1, 2, 3))
    assert list(changed) == [False, True, True, True, False, True]
    assert res["torch"][2][0]._face == res["jax"][2][0]._face


def test_assrender_disabled_and_chunks():
    w, h = 96, 64
    frames = _frames(3, w, h, 4, 6)
    pts = [int(1.2e9), int(2.2e9), int(2.7e9)]

    def setup(pkg, els):
        els[0].push_script(SCRIPT.split("[Events]")[0])
        els[0].push_chunk("1,0,Default,,0,0,0,,Chunk one", SEC, SEC)
        els[0].push_chunk("1,0,Default,,0,0,0,,Chunk one", SEC, SEC)
        els[0].push_chunk("2,0,Top,,0,0,0,,{\\i1}Chunk two", 2 * SEC, SEC)

    res = run_both([("assrender", {"face": "fixed"})], spec("RGBx", w, h),
                   [(frames, pts)], setup)
    assert_same(res)
    assert (data_of(res) != frames).any()
    off = run_both([("assrender", {"enable": False})], spec("RGBx", w, h),
                   [(frames, pts)], setup)
    assert_same(off)
    np.testing.assert_array_equal(data_of(off), frames)


def test_assrender_animates_within_event():
    """A \\t rotation sampled at animation-fps inside the event: a bank
    of snapshots, picked per frame."""
    script = SCRIPT.split("[Events]")[0] + (
        "[Events]\n"
        "Format: Layer, Start, End, Style, Name, MarginL, MarginR, "
        "MarginV, Effect, Text\n"
        "Dialogue: 0,0:00:00.00,0:00:04.00,Default,,0,0,0,,"
        "{\\pos(320,240)\\t(0,4000,\\frz90)}HELLO\n")

    def feed(pkg, p):
        p.get_by_name("ar").push_script(script)

    res = run_launch_both(
        "videotestsrc pattern=ball width=128 height=96 format=BGRx "
        "framerate=2/1 ! assrender name=ar animation-fps=2 face=fixed "
        "! fakesink", feed, n_frames=8, window=4, feed_first=True)
    assert_same(res)
    assert len(res["torch"][2].get_by_name("ar")._bank) > 4


@pytest.mark.parametrize("fmt,face", [
    ("RGBx", "bitmap"), ("BGR", "bitmap"), ("ABGR", "pango"),
    ("RGB", "pango")])
def test_ttmlrender(fmt, face):
    _face(face)
    w, h = 160, 120
    c = 3 if fmt in ("RGB", "BGR") else 4
    frames = _frames(6, w, h, c, 7)
    pts = [0, SEC, 2 * SEC, 5 * SEC, int(3.7e9), int(1.5e9)]

    def setup(pkg, els):
        els[0].push_ttml(DOC)

    res = run_both([("ttmlrender", {"face": face})],
                   spec(fmt, w, h, rate=2),
                   [(frames[:3], pts[:3]), (frames[3:], pts[3:])], setup)
    assert_same(res)
    changed = (data_of(res) != frames).any(axis=(1, 2, 3))
    assert list(changed) == [False, True, True, False, True, True]


def test_ttmlparse_posts_the_same_scenes():
    def setup(pkg, els):
        els[0].push_ttml(DOC)
        els[0].push_ttml(DOC.replace("00:00:01.000", "00:00:06.000")
                         .replace("00:00:03.500", "00:00:07.000"),
                         pts_ns=SEC, duration_ns=10 * SEC)

    frames = _frames(2, 64, 48, 4, 8)
    res = run_both([("ttmlparse", {})], spec("RGBx", 64, 48, rate=25),
                   [(frames[:1], None), (frames[1:], None)], setup)
    assert_same(res, min_messages=5)


def _teletext_packets():
    colors = [(15, 0, 0)] + [(0, 0, 0)] * 15
    l_x28 = tt.build_x28(1, 0, colors=colors)
    trips = [tt.hamming2418_encode(42 | (0x04 << 6) | (0 << 11)),
             tt.hamming2418_encode(0 | (0x03 << 6) | (16 << 11)),
             tt.hamming2418_encode(63 | (0x1F << 6))]
    trips += [tt.hamming2418_encode(63 | (0x1F << 6))] * (13 - len(trips))
    l_x26 = tt.build_line(
        1, 26, bytes([tt.hamming84_encode(0)]) + b"".join(trips))
    pages = []
    for sub, text in ((0, b"  NEWS AT TEN  "), (1, b"\x01COLOUR ROW"),
                      (2, b"")):
        pages.append(_unit(tt.build_header(1, 0, 0, subno=sub), line_no=7)
                     + _unit(l_x28, line_no=8) + _unit(l_x26, line_no=9)
                     + _unit(tt.build_row(1, 2, text), line_no=10)
                     + _unit(tt.build_row(1, 5, b"SECOND"), line_no=11))
    return pages + [_unit(tt.build_header(1, 0, 0, subno=3), line_no=7)]


@pytest.mark.parametrize("props", [
    {"page": 100}, {"page": 100, "subpage": 1, "level": 1.0},
    {"page": 100, "subtitles-template": "[%s]", "framerate": "30/1"}])
def test_teletextdec(props):
    """Pages through both host sources: the RGBA frames, their pts and
    valid, and the teletext-page messages with both text exports."""
    import gstbad_tpu as gt
    import gstbad_tpu_torch as gtt
    from gstbad_tpu.core.pipeline import Pipeline as JPipeline
    from gstbad_tpu_torch.core.pipeline import Pipeline

    res = {}
    for pkg, make, pipe, kw in (("jax", gt.make, JPipeline, {}),
                                ("torch", gtt.make, Pipeline,
                                 {"device": "cpu"})):
        el = make("teletextdec", **props)
        for pkt in _teletext_packets():
            el.push_packet(pkt)
        p = pipe([el], **kw)
        p.negotiate(None)
        res[pkg] = (p.run(n_frames=4, window=2), p.bus, [el])
    n = 1 if "subpage" in props else 3
    assert_same(res, min_messages=n)
    assert data_of(res).shape == (n, 250, 480, 4)
