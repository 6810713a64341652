"""elements/misc.py's small elements, jaxfilter's counterpart and
testsrcbin in the port against the JAX package on the CPU: speed (F32 and
S16; the weighted sum is one FMA over the second product, as the JAX
package's compiled window rounds it), timecodestamper (drop-frame and not,
a start timecode, an offset, source=zero), videoparse and audioparse,
autoconvert, switchbin, accurip, uvch264mjpgdemux (the upstream fixtures
and a seeded multi-segment frame), jaxfilter and testsrcbin.

Tolerance: bit exact everywhere (frames, pts, flags, valid, messages,
CRCs, bytes).
"""

import os
import sys

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.spec import MediaSpec
from helpers.torch_runtime import assert_batches_equal, check_both

torch.set_num_threads(1)   # parallel test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UVC = os.path.join(ROOT, "tests", "data", "uvch264")


@pytest.mark.parametrize("fmt", ["F32", "S16"])
@pytest.mark.parametrize("speed", [1.5, 0.7, 2.3, 1.0, 0.1])
def test_speed_equals_the_jax_element(fmt, speed):
    rng = np.random.default_rng(int(speed * 10))
    if fmt == "F32":
        x = (rng.standard_normal((8, 480, 2)) * 0.5).astype(np.float32)
    else:
        x = rng.integers(-32768, 32768, (8, 480, 2)).astype(np.int16)

    def feed(p):
        p.get_by_name("s").push_frames(x)
    check_both(f"appsrc name=s kind=audio format={fmt} rate=44100 "
               f"channels=2 ! speed speed={speed} ! fakesink", 8, 4, feed)


@pytest.mark.parametrize("fr", ["30000/1001", "30/1", "60000/1001", "25/1"])
@pytest.mark.parametrize("props", [
    "", "drop-frame=true",
    "drop-frame=true set-internal-timecode=00:09:59;28 timecode-offset=5",
    "source=zero set-internal-timecode=01:00:00:00",
    "post-messages=false"])
def test_timecodestamper_equals_the_jax_element(fr, props):
    check_both(f"videotestsrc width=16 height=8 framerate={fr} "
               f"! timecodestamper {props} ! fakesink", 48, 16)


def test_timecodestamper_drop_frame_skips_two_numbers_a_minute():
    p = gtt.parse_launch("videotestsrc width=8 height=8 "
                         "framerate=30000/1001 ! timecodestamper "
                         "drop-frame=true set-internal-timecode=00:00:59;28 "
                         "! fakesink", device="cpu")
    p.run(n_frames=4, window=4)
    tc = [(m.fields["minutes"], m.fields["seconds"], m.fields["frames"])
          for m in p.bus.messages]
    assert tc == [(0, 59, 28), (0, 59, 29), (1, 0, 2), (1, 0, 3)]
    with pytest.raises(ValueError, match="ltc"):
        gtt.make("timecodestamper", source="ltc")


@pytest.mark.parametrize("fmt,w,h", [("GRAY8", 16, 12), ("I420", 16, 12),
                                     ("RGB", 10, 6), ("BGRx", 7, 5)])
def test_videoparse_equals_the_jax_element(fmt, w, h):
    size = {"GRAY8": w * h, "I420": w * h * 3 // 2}.get(
        fmt, w * h * (3 if fmt == "RGB" else 4))
    raw = np.random.default_rng(w).integers(
        0, 256, 5 * size + 7, dtype=np.uint8).tobytes()

    def feed(p):
        p.negotiate()
        p.elements[0].push_bytes(raw)
    desc = (f"videoparse format={fmt} width={w} height={h} "
            "framerate=25/1 ! identity ! fakesink")
    (jp, jres), (tp, tres) = [
        (p, p.run(window=2)) for p in (_fed(gt, desc, feed),
                                       _fed(gtt, desc, feed))]
    assert_batches_equal(jres, tres)
    assert sum(b.batch for b in tres) == 5


def _fed(pkg, desc, feed):
    p = pkg.parse_launch(desc, **({} if pkg is gt else {"device": "cpu"}))
    feed(p)
    return p


@pytest.mark.parametrize("fmt", ["S16", "F32", "S32"])
def test_audioparse_equals_the_jax_element(fmt):
    dt = {"S16": np.int16, "F32": np.float32, "S32": np.int32}[fmt]
    raw = np.random.default_rng(2).integers(
        -1000, 1000, 5 * 256 * 2 + 3).astype(dt).tobytes()

    def feed(p):
        p.negotiate()
        p.elements[0].push_bytes(raw)
    desc = (f"audioparse format={fmt} rate=44100 channels=2 "
            "samplesperbuffer=256 ! fakesink")
    jres = _fed(gt, desc, feed).run(window=3)
    tres = _fed(gtt, desc, feed).run(window=3)
    assert_batches_equal(jres, tres)
    assert sum(b.batch for b in tres) == 5


@pytest.mark.parametrize("desc", [
    "videotestsrc pattern=ball width=16 height=16 format=BGRx "
    "! autoconvert factories=gaussianblur,solarize ! fakesink",
    "videotestsrc pattern=ball width=16 height=16 format=AYUV "
    "! autoconvert factories=gaussianblur,solarize ! fakesink",
    "videotestsrc width=16 height=16 ! autoconvert ! fakesink",
    "videotestsrc pattern=ball width=16 height=16 format=GRAY8 ! switchbin "
    "paths=\"video/x-raw,format=GRAY8 : zebrastripe threshold=90 ; "
    "video/x-raw : solarize ! burn ; ANY : identity\" ! fakesink",
    "videotestsrc pattern=ball width=16 height=16 format=BGRx ! switchbin "
    "paths=\"video/x-raw,format=GRAY8 : zebrastripe threshold=90 ; "
    "video/x-raw : solarize ! burn ; ANY : identity\" ! fakesink",
    "audiotestsrc samplesperbuffer=64 ! switchbin paths=\"video/x-raw : "
    "solarize ; ANY : identity\" ! fakesink",
])
def test_autoconvert_and_switchbin_equal_the_jax_elements(desc):
    check_both(desc, 4, 2)


def test_autoconvert_and_switchbin_pick_as_the_jax_elements():
    for name, props, spec in (
            ("autoconvert", {"factories": "gaussianblur,solarize"},
             dict(kind="video", format="BGRx", width=16, height=16)),
            ("autoconvert", {"factories": "gaussianblur,solarize"},
             dict(kind="video", format="AYUV", width=16, height=16)),
            ("autovideoconvert", {},
             dict(kind="video", format="I420", width=16, height=16)),
            ("switchbin", {"paths": "audio/x-raw,channels=2 : identity ; "
                                    "ANY : identity ! identity"},
             dict(kind="audio", format="F32", rate=48000, channels=2))):
        j, t = gt.make(name, **props), gtt.make(name, **props)
        j.set_info(JMediaSpec(**spec))
        t.set_info(MediaSpec(**spec))
        names = [[e.NAME for e in (x.chosen if isinstance(x.chosen, list)
                                   else [x.chosen])] for x in (j, t)]
        assert names[0] == names[1]
        assert str(j.out_spec) == str(t.out_spec)
    t = gtt.make("switchbin", paths="video/x-raw,format=AYUV : identity")
    with pytest.raises(ValueError, match="no path caps matched"):
        t.set_info(MediaSpec(kind="audio", format="F32", rate=48000,
                             channels=2))


def test_accurip_crcs_equal_the_jax_element():
    x = np.random.default_rng(4).integers(-32768, 32768, (6, 588, 2)
                                          ).astype(np.int16)
    els = []
    for pkg in (gt, gtt):
        p = pkg.parse_launch("appsrc name=s kind=audio format=S16 "
                             "rate=44100 channels=2 ! accurip name=a "
                             "! fakesink",
                             **({} if pkg is gt else {"device": "cpu"}))
        p.get_by_name("s").push_frames(x)
        p.run(window=4)
        els.append(p.get_by_name("a"))
    assert (els[1].crc, els[1].crc_v2) == (els[0].crc, els[0].crc_v2)
    assert els[1].crc != 0


def _uvc(name):
    with open(os.path.join(UVC, name), "rb") as f:
        return f.read()


def test_uvch264mjpgdemux_equals_the_jax_element():
    sys.path.insert(0, ROOT)
    import chip_smoke
    frames = [(chip_smoke.uvc_mjpeg(seed, n, seg)[0], 10 ** 9 * seed)
              for seed, n, seg in ((1, 1, 200), (2, 3, 1000), (3, 2, 64))]
    frames += [(_uvc(n), -1) for n in ("valid_h264_jpg.mjpg",
                                       "valid_h264_yuy2.mjpg")]
    j, t = gt.make("uvch264mjpgdemux"), gtt.make("uvch264mjpgdemux")
    for data, pts in frames:
        assert t.chain(data, pts) == j.chain(data, pts)
    out = t.chain(_uvc("valid_h264_jpg.mjpg"), 10 ** 9)
    assert out["jpeg"] == _uvc("valid_h264_jpg.jpg")
    assert out["aux"][0]["data"] == _uvc("valid_h264_jpg.h264")
    data, payloads, bare = chip_smoke.uvc_mjpeg(5, 3, 300)
    out = t.chain(data, 0)
    assert out["jpeg"] == bare
    assert [(a["fourcc"], a["data"]) for a in out["aux"]] == payloads


@pytest.mark.parametrize("desc", [
    "videotestsrc pattern=ball width=16 height=8 format=BGRx",
    "videotestsrc pattern=ball width=16 height=8 format=I420"])
def test_jaxfilter_equals_the_jax_element(desc):
    outs = []
    for pkg, fn in ((gt, lambda x: 255 - x), (gtt, lambda x: 255 - x)):
        el = pkg.make("jaxfilter", fn=lambda d, f=fn: (
            {k: f(v) for k, v in d.items()} if isinstance(d, dict)
            else f(d)))
        p = pkg.parse_launch(desc + " ! fakesink",
                             **({} if pkg is gt else {"device": "cpu"}))
        p.insert_after("videotestsrc", el)
        outs.append(p.run(n_frames=4, window=2))
    assert_batches_equal(*outs)
    with pytest.raises(ValueError, match="fn="):
        gtt.make("jaxfilter")


def test_jaxfilter_spec_fn_and_testsrcbin():
    el = gtt.make("jaxfilter", fn=lambda x: x[..., :1].clone(),
                  spec_fn=lambda s: s.with_(format="GRAY8"))
    el.set_info(MediaSpec(kind="video", format="BGRx", width=4, height=2))
    assert el.out_spec.format == "GRAY8"
    check_both("testsrcbin stream-types=video,pattern=gradient,width=16,"
               "height=16 ! fakesink", 4, 2)
    check_both("testsrcbin stream-types=audio,freq=330,samplesperbuffer=64 "
               "! fakesink", 4, 2)
    for bad in ("audio+video", "subtitle", "video,shape=round"):
        with pytest.raises(ValueError):
            gtt.parse_launch(f"testsrcbin stream-types={bad} ! fakesink",
                             device="cpu")
