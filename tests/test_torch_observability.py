"""Observability in the port against the JAX package on the CPU:
fpsdisplaysink's messages, videocodectestsink's per-frame and stream
checksums, debugspy's messages, the Harness, and PipelineTracer's report
and per-element profile."""

import types

import numpy as np
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.harness import Harness as JHarness
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.harness import Harness
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.utils.trace import PipelineTracer, trace_to
from helpers.torch_runtime import assert_batches_equal, \
    assert_messages_equal, check_both

torch.set_num_threads(1)   # parallel test workers share the cores


def test_fpsdisplaysink_messages(monkeypatch):
    """The sinks read a monotonic clock that advances 0.25 s a call in
    both packages, so their rates and messages compare exactly."""
    from gstbad_tpu.elements import observability as jobs
    from gstbad_tpu_torch.elements import observability as tobs
    pipes = []
    for pkg, mod, kw in ((gt, jobs, {}), (gtt, tobs, {"device": "cpu"})):
        ticks = iter([0.25 * i for i in range(1, 100)])
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: next(ticks)))
        p = pkg.parse_launch("videotestsrc width=16 height=8 format=GRAY8 "
                             "! fpsdisplaysink fps-update-interval=400",
                             **kw)
        p.run(n_frames=20, window=4)
        pipes.append(p)
    assert_messages_equal(*(p.bus for p in pipes))
    tm = pipes[1].bus.messages
    # 12 frames in the first 0.5 s, 8 in the next
    assert len(tm) == 2 and [m["fps"] for m in tm] == [24.0, 16.0]
    sink = pipes[1].elements[-1]
    assert sink.frames_rendered == 20


def test_videocodectestsink_checksums_equal_jax():
    for fmt in ("I420", "BGRx"):
        (jp, _), (tp, _) = check_both(
            f"videotestsrc pattern=ball width=16 height=8 format={fmt} "
            "! videocodectestsink", 6, 4)
        js, ts = jp.elements[-1], tp.elements[-1]
        assert js.frame_checksums == ts.frame_checksums
        assert js.stream_checksum == ts.stream_checksum
        assert len(ts.frame_checksums) == 8


def test_debugspy_messages():
    for silent in ("false", "true"):
        (_, _), (tp, _) = check_both(
            "videotestsrc width=8 height=4 format=GRAY8 framerate=24/1 "
            f"! interlace pattern=2:3 ! debugspy silent={silent} "
            "! fakesink", 6, 3)
        assert len(tp.bus.messages) == (0 if silent == "true" else 12)


def test_harness_equals_jax():
    frames = np.random.default_rng(9).integers(0, 256, (6, 8, 16),
                                                dtype=np.uint8)
    spec = dict(kind="video", format="GRAY8", width=16, height=8)
    jh = JHarness("zebrastripe", threshold=60)
    th = Harness("zebrastripe", device="cpu", threshold=60)
    jh.set_src_spec(JMediaSpec(**spec))
    th.set_src_spec(MediaSpec(**spec))
    for lo, hi in ((0, 4), (4, 6)):
        assert_batches_equal(jh.push(frames[lo:hi]), th.push(frames[lo:hi]))
    np.testing.assert_array_equal(th.push_pull(frames[:2]),
                                  jh.push_pull(frames[:2]))
    assert_messages_equal(jh.bus, th.bus)


def test_tracer_report_and_trace_scope(tmp_path):
    p = gtt.parse_launch("videotestsrc width=16 height=8 format=GRAY8 "
                         "! videoanalyse ! fakesink", device="cpu")
    tracer = PipelineTracer(p)
    with trace_to(str(tmp_path / "trace")):
        p.run(n_frames=8, window=4)
    rep = tracer.report()
    assert rep["graph"] == "videotestsrc ! videoanalyse ! fakesink"
    assert rep["frames"] == 8 and rep["messages"] == 8
    assert rep["wall_s"] > 0 and rep["fps"] > 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_profile_elements():
    p = gtt.parse_launch("videotestsrc pattern=ball width=32 height=16 "
                         "format=BGRx ! solarize ! burn name=b ! dodge "
                         "! fakesink", device="cpu")
    rep = PipelineTracer(p).profile_elements(window=2, reps=2)
    assert list(rep) == ["videotestsrc", "solarize", "b", "dodge",
                         "fakesink", "_total_ms"]
    assert all(v >= 0 for v in rep.values()) and rep["_total_ms"] > 0
