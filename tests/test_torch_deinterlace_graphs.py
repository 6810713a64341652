"""The telecine slice end to end in the port against gstbad_tpu, on the CPU:
BASELINE config 5 (videotestsrc ball GRAY8 24/1 ! interlace 2:3 !
fieldanalysis ! ivtc) and the combdetect graph over several windows, EOS,
a resume from the JAX package's carried states, and config 5's SSIM gate.

Interlace emits 2 slots per source frame and leaves some of them invalid
(2:3 gives 5 fields per 2 frames), so fieldanalysis and ivtc see invalid
padding slots in every window.  Tolerance: bit exact (the SSIM gate is a
float64 mean; it too agrees exactly here).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.models import benchmarks
from test_torch_parity import _messages, assert_same

torch.set_num_threads(1)   # parallel test workers share the cores

TAILS = {
    "config5": "interlace pattern=2:3 ! fieldanalysis ! ivtc ! fakesink",
    "combdetect": "interlace pattern=2:3 ! combdetect ! fakesink",
}


def launch(graph, fmt="GRAY8", w=66, h=50):
    return (f"videotestsrc pattern=ball width={w} height={h} format={fmt} "
            f"framerate=24/1 ! {TAILS[graph]}")


def run_both(desc, window, n_frames):
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        res = p.run(n_frames=n_frames, window=window)
        out.append(((res, _messages(p.bus)), p))
    return out


@pytest.mark.parametrize("graph,fmt", [("config5", "GRAY8"),
                                       ("config5", "I420"),
                                       ("combdetect", "GRAY8")])
def test_graph_equals_jax(graph, fmt):
    """4 windows of 5 source frames; config 5 also drains at EOS."""
    (jrun, jp), (trun, tp) = run_both(launch(graph, fmt), 5, 20)
    assert_same(jrun, trun)
    assert sum(len(b.pts) for b in trun[0]) > 10
    if graph == "config5":
        assert len(trun[1]) > 20       # fieldanalysis messages compared
        jd, td = jp.send_eos(), tp.send_eos()
        assert sorted(jd) == sorted(td) == ["fieldanalysis"]
        (jb,), (tb,) = jd["fieldanalysis"], td["fieldanalysis"]
        for f in ("pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
        jdata = jb.data if fmt == "GRAY8" else jb.data["y"]
        tdata = tb.data if fmt == "GRAY8" else tb.data["y"]
        np.testing.assert_array_equal(tdata, np.asarray(jdata))
        assert tp.send_eos() == {}       # nothing held after the flush


@pytest.mark.parametrize("graph", ["config5", "combdetect"])
def test_resume_from_jax_states(graph):
    """The JAX package runs 2 windows; the port takes its carried states
    (np.asarray of each) and both run 3 more windows: equal."""
    window = 6
    desc = launch(graph, w=64, h=48)
    jp = gt.parse_launch(desc)
    jp.run(n_frames=2 * window, window=window)
    carried = [_numpy(s) for s in jp._states]
    tp = gtt.parse_launch(desc, device="cpu")
    tp.negotiate()
    tp.compile(window)
    tp.load_states(carried)
    jn = len(jp.bus.messages)
    jres = jp.run(n_frames=3 * window, window=window)
    tres = tp.run(n_frames=3 * window, window=window)
    assert_same((jres, _messages(jp.bus)[jn:]), (tres, _messages(tp.bus)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return np.asarray(tree)


def test_config5_fidelity_equals_bench():
    """models/benchmarks.config5_fidelity on the port computes what the
    JAX package's bench.py config5_fidelity computes."""
    import bench
    kw = dict(width=64, height=48, n_frames=20, window=5)
    want = bench.config5_fidelity(**kw)
    got = benchmarks.config5_fidelity(device="cpu", **kw)
    assert got == want
    assert got["frames_scored"] > 10
