"""Bridges in the port against the JAX package on the CPU: appsrc
(including a short last window padded with invalid frames, packed and
planar), the inter video/audio and proxy pairs across two pipelines,
intersubsink/intersubsrc, and appsink/errorignore."""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.elements.bridges import AppSrc
from helpers.torch_runtime import assert_batches_equal, \
    assert_messages_equal

torch.set_num_threads(1)   # parallel test workers share the cores


def _both(fn):
    return [fn(gt, {}), fn(gtt, {"device": "cpu"})]


def test_appsrc_pads_a_short_window():
    frames = np.random.default_rng(3).integers(0, 256, (10, 4, 8, 4),
                                                dtype=np.uint8)
    src = AppSrc(format="BGRx", width=8, height=4)
    src.set_info(None)
    src.push_frames(frames, flags=np.arange(10, dtype=np.int32))
    src.pull_window(4), src.pull_window(4)
    last = src.pull_window(4)
    assert last.valid.tolist() == [True, True, False, False]
    assert last.flags.tolist() == [8, 9, 0, 0]
    assert last.pts.tolist() == [266666664, 299999997, 299999997, 299999997]
    np.testing.assert_array_equal(last.data.numpy(),
                                  frames[[8, 9, 9, 9]])
    assert src.pull_window(4) is None

    def run(pkg, kw):
        p = pkg.parse_launch("appsrc name=src format=BGRx width=8 height=4 "
                             "! solarize ! fakesink", **kw)
        p.negotiate()
        p.get_by_name("src").push_frames(frames)
        return p, p.run(window=4)
    (jp, jres), (tp, tres) = _both(run)
    assert_batches_equal(jres, tres)
    assert [b.batch for b in tres] == [4, 4, 2]


def test_appsrc_planar_in_one_upload():
    rng = np.random.default_rng(4)
    planes = {"y": rng.integers(0, 256, (5, 8, 16), dtype=np.uint8),
              "u": rng.integers(0, 256, (5, 4, 8), dtype=np.uint8),
              "v": rng.integers(0, 256, (5, 4, 8), dtype=np.uint8)}

    def run(pkg, kw):
        p = pkg.parse_launch("appsrc name=src format=I420 width=16 height=8 "
                             "! videoconvert format=AYUV ! gaussianblur "
                             "! videoconvert format=I420 ! appsink", **kw)
        p.negotiate()
        p.get_by_name("src").push_frames(planes)
        return p, p.run(window=2)
    (jp, jres), (tp, tres) = _both(run)
    assert_batches_equal(jres, tres)
    src = AppSrc(format="I420", width=16, height=8)
    src.set_info(None)
    src.push_frames(planes)
    b = src.pull_window(4)
    # every field is a view of one buffer: one host-to-device copy
    base = b.pts.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in
               (b.flags, b.valid, b.data["y"], b.data["u"], b.data["v"]))


@pytest.mark.parametrize("sink,src", [("intervideosink", "intervideosrc"),
                                      ("proxysink", "proxysrc")])
def test_video_pairs_across_two_pipelines(sink, src):
    def run(pkg, kw):
        ch = f"{sink}-{pkg.__name__}"
        a = pkg.parse_launch("videotestsrc pattern=ball width=16 height=8 "
                             f"format=BGRx ! burn ! {sink} channel={ch}",
                             **kw)
        b = pkg.parse_launch(f"{src} name=s channel={ch} format=BGRx "
                             "width=16 height=8 ! dodge ! fakesink", **kw)
        a.run(n_frames=6, window=3)
        return b, b.run(window=3)
    (jp, jres), (tp, tres) = _both(run)
    assert_batches_equal(jres, tres)
    assert sum(x.batch for x in tres) == 6


def test_audio_pair_across_two_pipelines():
    def run(pkg, kw):
        ch = f"audio-{pkg.__name__}"
        a = pkg.parse_launch("audiotestsrc wave=sine channels=2 format=S16 "
                             "samplesperbuffer=64 ! interaudiosink "
                             f"channel={ch}", **kw)
        b = pkg.parse_launch(f"interaudiosrc channel={ch} kind=audio "
                             "format=S16 channels=2 ! audiosegmentclip "
                             "start=2000000 ! fakesink", **kw)
        a.run(n_frames=4, window=2)
        return b, b.run(window=2)
    (jp, jres), (tp, tres) = _both(run)
    assert_batches_equal(jres, tres)
    # the 1.33 ms block spanning 2 ms loses its first 32 samples
    assert tres[0].data.shape == (1, 32, 2) and tres[0].pts[0] == 2000000


def test_intersub_latch():
    latched = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        ch = f"sub-{pkg.__name__}"
        sink = pkg.make("intersubsink", channel=ch)
        src = pkg.make("intersubsrc", channel=ch)
        assert src.create() == b"\x00"
        sink.render("one")
        sink.render("two")            # a latch: the last one wins
        assert src.create() == b"two" and src.create() == b"\x00"
        assert src.n_frames == 3
        p = pkg.parse_launch("videotestsrc width=4 height=2 format=GRAY8 "
                             f"! intersubsink channel={ch}", **kw)
        p.run(n_frames=2, window=2)
        latched.append(src.create())     # the last frame's bytes
    assert latched[0] == latched[1] and len(latched[1]) == 8


def test_appsink_and_errorignore_pass_through():
    desc = ("videotestsrc pattern=ball width=16 height=8 format=BGRx "
            "! errorignore ! solarize ! appsink")
    (jp, jres), (tp, tres) = _both(
        lambda pkg, kw: (lambda p: (p, p.run(n_frames=4, window=2)))(
            pkg.parse_launch(desc, **kw)))
    assert_batches_equal(jres, tres)
    assert_messages_equal(jp.bus, tp.bus)
    ref = gtt.parse_launch(desc.replace("! errorignore ", "").replace(
        "appsink", "fakesink"), device="cpu").run(n_frames=4, window=2)
    assert_batches_equal(ref, tres)
