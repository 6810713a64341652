"""spandsp's tonegeneratesrc, dtmfdetect and spanplc, and the meters
(videoframe-audiolevel, audiolatency) of the port against the JAX package
on the CPU, and the negotiation of all 17 audio-breadth names over a
sweep of input specs.

Tolerances.  tonegeneratesrc, dtmfdetect's messages, spanplc's samples
and messages, audiolatency's messages and videoframe-audiolevel's S16
levels are bit exact.  videoframe-audiolevel's levels of S32, F32 and
F64 input, whose float64 squares do not sum exactly, within 1e-14
(relative).  audiolatency's tick output is the float32 sine of a
float32 argument up to 2764 radians: the port takes it in float64 and
rounds it, XLA in float32 with its own reduction, so the ticks agree
within 2e-4 (measured 1.5e-6 within the first 0.4 s, 2e-4 at the
second's end).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.core.spec import SpecError as JSpecError
from gstbad_tpu_torch.core.spec import MediaSpec, SpecError
from helpers.torch_audio import (batches_within, messages_within,
                                 push_audio_both, run_pipelines)

torch.set_num_threads(1)

BREADTH = ("bs2b", "pitch", "webrtcdsp", "webrtcechoprobe", "bpmdetect",
           "audiobuffersplit", "videoframe-audiolevel", "audiolatency",
           "adpcmdec", "adpcmenc", "tonegeneratesrc", "dtmfdetect",
           "spanplc", "wavescope", "spacescope", "spectrascope",
           "synaescope")


def _run_both(desc, n_frames, window):
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        res = p.run(n_frames=n_frames, window=window)
        out.append((res, [(m.element, m.name, m.pts, m.fields)
                          for m in p.bus.messages]))
    return out


@pytest.mark.parametrize("props", [
    "freq=440", "freq=697 freq2=1209 volume=3 volume2=6 on-time=50 "
    "off-time=30 repeat=true",
    "freq=1000 on-time=20 off-time=10 on-time2=15 off-time2=5 repeat=true "
    "samplesperbuffer=160"])
def test_tonegeneratesrc(props):
    (ja, _), (ta, _) = _run_both(f"tonegeneratesrc {props} ! fakesink",
                                 12, 4)
    batches_within(ja, ta)
    assert np.abs(np.concatenate([t.data for t in ta]).astype(int)).max() \
        > 10000


def _dtmf(digits):
    tt = np.arange(800) / 8000.0
    rows = (697.0, 770.0, 852.0, 941.0)
    cols = (1209.0, 1336.0, 1477.0, 1633.0)
    pad = {1: (0, 0), 5: (1, 1), 9: (2, 2), 0: (3, 1), 15: (3, 3)}
    out = []
    for d in digits:
        r, c = pad[d]
        out += [8000 * (np.sin(2 * np.pi * rows[r] * tt)
                        + np.sin(2 * np.pi * cols[c] * tt)),
                np.zeros(400)]
    return np.concatenate(out).astype(np.int16)


def test_dtmfdetect_messages():
    x = _dtmf([1, 5, 9, 0, 15, 1])
    x = np.concatenate([x, np.zeros(-len(x) % 1000, np.int16)])
    blocks = x.reshape(-1, 1000, 1)
    (ja, jm), (ta, tm) = push_audio_both("dtmfdetect", "S16", 1, 8000,
                                         [blocks[:4], blocks[4:]])
    batches_within(ja, ta)
    messages_within(jm, tm)
    got = [int(v) for m in tm for v in m[3]["number"] if v >= 0]
    assert got == [1, 5, 9, 0, 15, 1]


@pytest.mark.parametrize("lost", [[2, 3], [1, 4, 5, 6]])
def test_spanplc_conceals(lost):
    rng = np.random.default_rng(len(lost))
    t = np.arange(8 * 160) / 8000.0
    x = (6000 * np.sin(2 * np.pi * 210 * t) + rng.standard_normal(t.shape)
         * 50).astype(np.int16).reshape(8, 160, 1)
    valid = np.ones(8, bool)
    valid[lost] = False
    pts = np.arange(8, dtype=np.int64) * 20_000_000
    j, t_ = run_pipelines(gt.parse_launch("spanplc"),
                          gtt.parse_launch("spanplc", device="cpu"), 2, 4,
                          spec=("S16", 1, 8000), inputs=(x, pts, valid))
    for a, b in zip(j["batches"], t_["batches"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(v, u)
    assert j["messages"] == t_["messages"] and j["messages"]
    for k in j["states"][0]:
        np.testing.assert_array_equal(t_["states"][0][k], j["states"][0][k])


@pytest.mark.parametrize("fmt,rtol", [("S16", 0.0), ("S32", 1e-14),
                                      ("F32", 1e-14), ("F64", 1e-14)])
def test_videoframe_audiolevel_one_input(fmt, rtol):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1600, 2)) * 0.3
    x = {"S16": lambda v: (v * 32767).astype(np.int16),
         "S32": lambda v: (v * 2 ** 31).astype(np.int32),
         "F32": lambda v: v.astype(np.float32), "F64": lambda v: v}[fmt](x)
    (ja, jm), (ta, tm) = push_audio_both("videoframe-audiolevel", fmt, 2,
                                         48000, [x, x[::-1].copy()])
    batches_within(ja, ta)
    messages_within(jm, tm, rtol=rtol)


def test_videoframe_audiolevel_av():
    """The two-input form: video frames pass through, one message per
    video frame with the RMS of the audio samples in its interval."""
    desc = ("videotestsrc pattern=ball width=32 height=24 format=RGB ! m.  "
            "audiotestsrc wave=sine format=S16 rate=48000 channels=2 "
            "samplesperbuffer=1600 ! m.  videoframe-audiolevel name=m ! "
            "fakesink")
    (ja, jm), (ta, tm) = _run_both(desc, 6, 3)
    batches_within(ja, ta)
    messages_within(jm, tm)
    assert len(tm) == 6


def test_audiolatency():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 4800, 1)) * 0.1).astype(np.float32)
    x[1, 1234] = 0.9
    x[3, 17] = -0.95
    x[4, 4000] = 0.8
    # blocks 0.6 s apart: hits in four seconds, two in one second
    pts = np.arange(6, dtype=np.int64) * 600_000_000
    (ja, jm), (ta, tm) = push_audio_both("audiolatency", "F32", 1, 48000,
                                         [x[:3], x[3:]],
                                         pts=[pts[:3], pts[3:]])
    batches_within(ja, ta, atol=2e-4)
    messages_within(jm, tm)
    assert len(tm) == 3


def _specs(pkg):
    cls = JMediaSpec if pkg is gt else MediaSpec
    out = []
    for fmt in ("S16", "S32", "F32", "F64"):
        for rate in (8000, 44100, 48000):
            for ch in (1, 2, 3):
                out.append(cls(kind="audio", format=fmt, rate=rate,
                               channels=ch))
    out.append(cls(kind="video", format="RGB", width=32, height=24))
    out.append(cls(kind="audio", format="S16", rate=1000, channels=2))
    return out


def _negotiate(pkg, name, spec, props):
    el = pkg.make(name, **props)
    try:
        out = el.set_info(spec)
    except Exception as e:   # noqa: BLE001 - the class is compared
        return type(e).__name__
    return (out.kind, out.format, out.rate, out.channels, out.width,
            out.height)


@pytest.mark.parametrize("name", BREADTH)
def test_negotiation_sweep(name):
    """Each of the 17 names over 38 input specs: the same output spec, or
    an error of the same class, in both packages."""
    props = {"adpcmenc": {"blocksize": 1024}}.get(name, {})
    got = {pkg: [_negotiate(pkg, name, s, props) for s in _specs(pkg)]
           for pkg in (gt, gtt)}
    names = {"SpecError": "SpecError"}
    assert [names.get(v, v) for v in got[gt]] == [
        names.get(v, v) for v in got[gtt]]
    assert name in gtt.element_names()


def test_port_registers_the_breadth_slice():
    assert set(BREADTH) <= set(gtt.element_names())
    assert len(gtt.element_names()) == 227
    assert JSpecError.__name__ == SpecError.__name__
