"""BASELINE config 3 (audiotestsrc ! audiomixmatrix ! freeverb !
audioconvert ! removesilence) and vad_square in the port against
gstbad_tpu, on the CPU, through the launch strings of
models/benchmarks.py at 1024 samples per buffer.

config3_audio runs at window 2 (2048 samples: freeverb's whole-window
form) and window 1 (1024 samples, shorter than its longest delay: the
128-sample walk), with taps on freeverb and audioconvert.

Tolerance: freeverb's float32 output and float state within 2e-6 (the
JAX package's gate against the serial C); the S16 samples after
audioconvert within 1 LSB (a float32 difference of 2e-6 can cross a
rounding boundary); valid, pts, bus messages and every integer state
exact.  vad_square is bit exact.  The JAX removesilence takes the XLA
form of its serial power kernel (helpers/torch_audio.py).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
from gstbad_tpu.models import benchmarks as jbench
from gstbad_tpu_torch.models import benchmarks as tbench
from gstbad_tpu_torch.ops import audio
from helpers.torch_audio import assert_states_close, run_pipelines, \
    use_xla_vad_serial

torch.set_num_threads(1)   # parallel test workers share the cores

S = 1024
VAD_SQUARE = ("audiotestsrc wave=square channels=1 format=S16 "
              f"samplesperbuffer={S} ! removesilence silent=false "
              "threshold=0 ! fakesink")


def _same_graph(pj, pt):
    assert repr(pt) == repr(pj)
    assert [e.props for e in pt.elements] == [e.props for e in pj.elements]


def config3_pair():
    """config3_audio of both packages at S samples per buffer."""
    pj = jbench.config3_audio()
    pj.elements[0].set_property("samplesperbuffer", S)
    pt = tbench.config3_audio(S, device="cpu")
    _same_graph(pj, pt)
    return pj, pt


def test_launch_strings_are_the_jax_package_graphs():
    _same_graph(jbench.config3_audio(), tbench.config3_audio(device="cpu"))
    _same_graph(gt.parse_launch(VAD_SQUARE),
                tbench.vad_square(S, device="cpu"))


@pytest.mark.parametrize("window", [2, 1])
def test_config3_audio(window, monkeypatch):
    use_xla_vad_serial(monkeypatch)
    j, t = run_pipelines(*config3_pair(), n_windows=3, window=window,
                         taps=("freeverb", "audioconvert"))
    for tap, atol in (("freeverb", 2e-6), ("audioconvert", 1)):
        for a, b in zip(j["taps"][tap], t["taps"][tap]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=tap)
    assert j["messages"] == t["messages"]
    for (jd, jp, jv), (td, tp, tv) in zip(j["batches"], t["batches"]):
        assert td.shape == (window, S, 1) and td.dtype == np.int16
        assert np.abs(td.astype(int) - jd.astype(int)).max() <= 1
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
    # the carried states; freeverb's float state within 2e-6
    assert_states_close(j["states"], t["states"], 2e-6)
    assert audio.vad_powers_bracket.launches == 0


def test_vad_square(monkeypatch):
    use_xla_vad_serial(monkeypatch)
    j, t = run_pipelines(gt.parse_launch(VAD_SQUARE),
                         tbench.vad_square(S, device="cpu"), n_windows=3,
                         window=2)
    assert j["messages"] == t["messages"]
    assert [m[3]["silence_detected"] for m in t["messages"]] == [True]
    for (jd, jp, jv), (td, tp, tv) in zip(j["batches"], t["batches"]):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
        assert tv.all()
    assert_states_close(j["states"], t["states"])
    assert audio.vad_powers_serial.launches == 0
