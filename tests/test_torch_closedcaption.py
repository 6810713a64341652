"""Parity of the port's closed-caption elements (cccombiner, ccextractor,
line21encoder, line21decoder, ccconverter, ceaccoverlay) and ops/line21
with the JAX package on the CPU: frames, pts, valid and messages
equal."""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.io import cea608 as j_cea608
from gstbad_tpu.io import cea708 as j_cea708
from gstbad_tpu.io.ccconv import CCConverterEngine
from gstbad_tpu.ops import line21 as j_line21
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.pipeline import Pipeline
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import line21 as t_line21
from helpers.torch_overlay import (assert_same, data_of, run_both,
                                   run_launch_both, spec)
from test_ccconv import _cdp_frames
from test_closedcaption import (_cc_data_from_dtvcc, _dtvcc_packet, _pairs,
                                _s334, _svc_block)

SEC = 10 ** 9
TYPES = ("raw", "s334-1a", "cc-data", "cdp")


def _i420(rng, b, h, w):
    c = ((h + 1) // 2, (w + 1) // 2)
    return {"y": rng.integers(16, 235, (b, h, w), dtype=np.uint8),
            "u": rng.integers(16, 240, (b,) + c, dtype=np.uint8),
            "v": rng.integers(16, 240, (b,) + c, dtype=np.uint8)}


def test_line21_ops_equal_jax():
    rng = np.random.default_rng(0)
    pairs = _pairs(rng, 24)
    enc = t_line21.encode_lines(torch.from_numpy(pairs)).numpy()
    np.testing.assert_array_equal(
        enc, np.asarray(j_line21.encode_lines(jnp.asarray(pairs))))
    lines = np.concatenate([enc, rng.integers(0, 256, (6, 720),
                                              dtype=np.uint8),
                            np.full((2, 720), 40, np.uint8)])
    lines[3, 100:140] = 255                      # a damaged waveform
    tf, tp = t_line21.decode_lines(torch.from_numpy(lines))
    jf, jp = j_line21.decode_lines(jnp.asarray(lines))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tf.numpy()[:24].sum() >= 23 and not tf.numpy()[24:].any()


@pytest.mark.parametrize("height", [525, 486])
def test_line21_encode_decode(height):
    rng = np.random.default_rng(height)
    b = 5
    data = _i420(rng, b, height, 720)
    data["cc"] = _s334(_pairs(rng, b), _pairs(rng, b))
    data["cc"][1, 0] = 0x00                     # field 2 first, then 1
    data["cc"][1, 3] = 0x80
    data["cc"][2, 3] = 0x80                     # both field 1
    res = run_both([("line21encoder", {}), ("line21decoder", {})],
                   spec("I420", 720, height), [(data, None)])
    assert_same(res, min_messages=b if height == 525 else 0)


@pytest.mark.parametrize("mode", ["disabled", "add", "drop", "replace"])
def test_line21decoder_modes(mode):
    rng = np.random.default_rng(7)
    b = 4
    enc = _i420(rng, b, 525, 720)
    enc["cc"] = _s334(_pairs(rng, b), _pairs(rng, b))
    coded = data_of(run_both([("line21encoder", {})], spec("I420", 720, 525),
                             [(enc, None)]))
    plain = {k: v for k, v in coded.items() if k != "cc"}
    meta = dict(coded, cc=np.full((b, 6), 0x80, np.uint8))
    res = run_both([("line21decoder", {"mode": mode, "ntsc-only": True})],
                   spec("I420", 720, 525), [(plain, None), (meta, None)])
    assert_same(res)


def test_line21decoder_on_plain_video():
    rng = np.random.default_rng(4)
    res = run_both([("line21decoder", {})], spec("I420", 720, 525),
                   [(_i420(rng, 2, 525, 720), None)])
    assert_same(res)
    assert not res["torch"][1].messages


@pytest.mark.parametrize("remove", [False, True])
def test_combiner_and_extractor(remove):
    rng = np.random.default_rng(3)
    b, h, w = 5, 47, 63
    video = _i420(rng, b, h, w)
    cc = _s334(_pairs(rng, b), _pairs(rng, b))

    def feed(pkg, p):
        p.get_by_name("v").push_frames(video)
        p.get_by_name("c").push_frames(cc)

    res = run_launch_both(
        f"appsrc name=v format=I420 width={w} height={h} ! m.  "
        "appsrc name=c format=I420 width=6 height=1 ! m.  cccombiner name=m "
        f"! ccextractor remove-caption-meta={str(remove).lower()} "
        "! fakesink", feed, window=3)
    assert_same(res, min_messages=b)
    assert ("cc" in data_of(res)) != remove


def _cc_frames(kind, rng, b):
    """b frames of caption bytes of one type, as [b, W] u8."""
    s334 = _s334(_pairs(rng, b), _pairs(rng, b))
    s334[1, 0] = 0x00
    if kind == "s334-1a":
        return s334
    if kind == "raw":                      # two field-1 pairs a frame
        return np.concatenate([_pairs(rng, b), _pairs(rng, b)], 1)
    ccd = [j_cea608.s334_to_cc_data(bytes(r)) for r in s334]
    if kind == "cc-data":
        return np.stack([np.frombuffer(c, np.uint8) for c in ccd])
    return np.stack([np.frombuffer(j_cea608.cc_data_to_cdp(
        c, (30, 1), sequence=i), np.uint8) for i, c in enumerate(ccd)])


@pytest.mark.parametrize("it", TYPES)
def test_ccconverter_fixed_rate(it):
    """Every output type from input type `it` on a video cc plane over
    two windows, and CDP on a standalone caption stream (the sequence
    counter carried across the windows)."""
    rng = np.random.default_rng(TYPES.index(it))
    for ot in TYPES:
        cc = _cc_frames(it, rng, 6)
        video = _i420(rng, 6, 16, 24)
        props = {"input-type": it, "output-type": ot}
        if ot == "cdp":
            windows = [(cc[:3], None), (cc[3:], None)]
        else:
            windows = [(dict({k: v[:3] for k, v in video.items()},
                             cc=cc[:3]), None),
                       (dict({k: v[3:] for k, v in video.items()},
                             cc=cc[3:]), None)]
        assert_same(run_both([("ccconverter", props)], spec("I420", 24, 16),
                             windows))


def _xr_frames(it):
    if it == "cdp":
        return _cdp_frames(12)
    if it == "s334-1a":
        return [bytes([0x80, 0x20 + i, 0x40, 0x00, 0x21 + i, 0x41])
                for i in range(10)]
    if it == "raw":
        return [bytes([0x20 + i, 0x40 + i]) for i in range(10)]
    return [bytes([0xFC, 0x30 + i, 0x40, 0xC7, 0x10 + i, 0x55])
            for i in range(8)]


def _xr_props(it, ot, outfps):
    return {"input-type": it, "output-type": ot,
            "output-framerate": f"{outfps[0]}/{outfps[1]}"}


@pytest.mark.parametrize("it,ot,infps,outfps", [
    ("cdp", "cdp", (30, 1), (60, 1)), ("cdp", "raw", (30, 1), (24, 1)),
    ("s334-1a", "cdp", (30, 1), (60, 1)),
    ("cc-data", "cdp", (30000, 1001), (30, 1))])
def test_ccconverter_cross_rate(it, ot, infps, outfps):
    """The cross-framerate engine's output frames, their pts and which
    are emitted, over windows that carry its scratch state, against the
    JAX element."""
    cc = np.stack([np.frombuffer(f, np.uint8) for f in _xr_frames(it)])
    half = cc.shape[0] // 2
    sp = spec("I420", 64, 48, rate=Fraction(*infps))
    res = run_both([("ccconverter", _xr_props(it, ot, outfps))], sp,
                   [(cc[:half], None), (cc[half:], None)])
    assert_same(res)


def test_ccconverter_cross_rate_engine():
    """More rate pairs and types against the JAX package's byte-level
    spec of the engine (io/ccconv.py, which its element is tested
    against): every emitted frame starts with the spec's bytes."""
    for it, ot, infps, outfps in (
            ("cdp", "cdp", (30, 1), (24, 1)),
            ("cdp", "cc-data", (30, 1), (60, 1)),
            ("cdp", "s334-1a", (30, 1), (24, 1)),
            ("raw", "cdp", (25, 1), (50, 1)),
            ("cc-data", "cdp", (24, 1), (60, 1))):
        frames = _xr_frames(it)
        eng = CCConverterEngine(it, ot, infps, outfps)
        want = [w for f in frames for w in eng.push(f)]
        cc = np.stack([np.frombuffer(f, np.uint8) for f in frames])
        p = Pipeline([gtt.make("ccconverter", **_xr_props(it, ot, outfps))],
                     device="cpu")
        p.negotiate(MediaSpec(**spec("I420", 64, 48, rate=Fraction(*infps))))
        half = cc.shape[0] // 2
        got = np.concatenate([
            np.asarray(o.data) for w in (cc[:half], cc[half:])
            for o in p.run(inputs=FrameBatch.make(torch.from_numpy(w)))])
        assert got.shape[0] == len(want), (it, ot, outfps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[:len(w)], np.frombuffer(w,
                                                                    np.uint8))


def _captions():
    """cc_data feeds: two windows of text, a restyle, a hide."""
    C = j_cea708
    df0 = bytes([C.CMD_DF0, 0x20, 30, 40, (0 << 4) | 1, 15, 0])
    spc = bytes([C.CMD_SPC, 0x20, 0x00, 0x00])

    def cc(seq):
        return _cc_data_from_dtvcc(_dtvcc_packet(_svc_block(1, seq)))

    flush = cc(bytes([0x03]))
    return [(cc(df0 + b"FIRST LINE" + bytes([0x03])), SEC // 10),
            (flush, SEC // 10 + 1),
            (cc(spc + b" RED" + bytes([0x03])), SEC // 2),
            (flush, SEC // 2 + 1),
            (cc(bytes([C.CMD_HDW, 0x01])), SEC),
            (flush, SEC + 1)]


@pytest.mark.parametrize("face", ["fixed", "pango"])
def test_ceaccoverlay(face):
    if face == "pango" and not j_cea708.pango_available():
        pytest.skip("pango/pangocairo not present")
    feeds = _captions()

    def setup(pkg, els):
        for data, pts in feeds:
            els[0].push_cc(data, pts_ns=pts)

    rng = np.random.default_rng(8)
    w, h = 200, 150
    frames = rng.integers(0, 256, (6, h, w, 4), dtype=np.uint8)
    pts = [0, SEC // 5, SEC // 2 + SEC // 10, 3 * SEC // 4, SEC + 5, 2 * SEC]
    res = run_both([("ceaccoverlay", {"face": face})], spec("AYUV", w, h),
                   [(frames[:3], pts[:3]), (frames[3:], pts[3:])], setup)
    assert_same(res)
    out = data_of(res)
    changed = (out != frames).any(axis=(1, 2, 3))
    assert list(changed) == [False, True, True, True, False, False]
    assert res["torch"][2][0]._face == res["jax"][2][0]._face == face
