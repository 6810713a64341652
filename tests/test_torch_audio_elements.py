"""BASELINE config 3's elements in the port against gstbad_tpu, each alone
on the CPU in a one-element graph (audiotestsrc as the source, the others
fed the same blocks, made with numpy from fixed seeds, with pts and an
invalid window slot): data, pts, valid, bus messages and the carried
states, window by window.

Tolerance: bit exact, with two stated exceptions.  audiochannelmix rounds
float64 gains with rint, and the JAX package's compiled form may fuse a
multiply and an add where the port does not, so a sample at an exact half
may land 1 LSB away; its own test allows that (tests/test_audio.py).
freeverb's float32 output and state agree within 2e-6 (its S16 output,
truncated from those floats, within 1 LSB), the JAX package's own gate
against the serial C.  The JAX removesilence takes the XLA form of its
serial power kernel (helpers/torch_audio.py).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu_torch as gtt
from helpers.torch_audio import assert_states_close, run_both, \
    use_xla_vad_serial

torch.set_num_threads(1)   # parallel test workers share the cores

MATRIX_4_2 = "<<1.0,0.0,0.5,0.0>,<0.0,1.0,-0.25,0.5>>"
BLOCK_NS = 10_000_000


def inputs(data, invalid=(1,)):
    """(data, pts, valid) for blocks [n, S, C] of 10 ms each."""
    n = data.shape[0]
    valid = np.ones(n, bool)
    valid[list(invalid)] = False
    return data, np.arange(n, dtype=np.int64) * BLOCK_NS, valid


def assert_runs_equal(j, t, atol=0.0):
    assert j["messages"] == t["messages"]
    assert len(j["batches"]) == len(t["batches"])
    for (jd, jp, jv), (td, tp, tv) in zip(j["batches"], t["batches"]):
        for a, b in ((jp, tp), (jv, tv)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)
        assert jd.dtype == td.dtype and jd.shape == td.shape
        if atol:
            np.testing.assert_allclose(td, jd, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(td, jd)
    assert_states_close(j["states"], t["states"], atol)


@pytest.mark.parametrize("fmt", ["S16", "S32", "F32", "F64"])
@pytest.mark.parametrize("wave", ["sine", "square", "silence"])
def test_audiotestsrc(wave, fmt):
    j, t = run_both(f"audiotestsrc wave={wave} format={fmt} channels=3 "
                    "samplesperbuffer=100 freq=1000 volume=0.9 ! fakesink",
                    n_windows=3, window=2)
    assert_runs_equal(j, t)
    assert t["batches"][0][0].shape == (2, 100, 3)


def test_audiotestsrc_white_noise_is_not_ported():
    p = gtt.parse_launch("audiotestsrc wave=white-noise ! fakesink",
                         device="cpu")
    with pytest.raises(ValueError, match="ROADMAP"):
        p.negotiate()


def _blocks(fmt, n, s, c, seed):
    rng = np.random.default_rng(seed)
    if fmt == "S16":
        return rng.integers(-32768, 32768, (n, s, c)).astype(np.int16)
    if fmt == "S32":
        return rng.integers(-2**31, 2**31, (n, s, c)).astype(np.int32)
    x = (rng.random((n, s, c)) - 0.5) * 2.2
    return x.astype(np.float32 if fmt == "F32" else np.float64)


@pytest.mark.parametrize("fmt", ["S16", "S32", "F32", "F64"])
def test_audiomixmatrix_manual(fmt):
    j, t = run_both(f"audiomixmatrix matrix={MATRIX_4_2} ! fakesink",
                    n_windows=2, window=2, spec=(fmt, 4, 48000),
                    inputs=inputs(_blocks(fmt, 4, 64, 4, seed=1)))
    assert_runs_equal(j, t)


def test_audiomixmatrix_first_channels():
    j, t = run_both("audiomixmatrix mode=first-channels out-channels=2 "
                    "! fakesink", n_windows=2, window=2,
                    spec=("S16", 4, 48000),
                    inputs=inputs(_blocks("S16", 4, 64, 4, seed=2)))
    assert_runs_equal(j, t)


def test_audiochannelmix_within_one_lsb():
    j, t = run_both("audiochannelmix left-to-left=0.7 left-to-right=0.3 "
                    "right-to-left=-0.2 right-to-right=1.0 ! fakesink",
                    n_windows=2, window=2, spec=("S16", 2, 48000),
                    inputs=inputs(_blocks("S16", 4, 100, 2, seed=3)))
    got = np.concatenate([b[0] for b in t["batches"]]).astype(int)
    want = np.concatenate([b[0] for b in j["batches"]]).astype(int)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    for (_, jp, jv), (_, tp, tv) in zip(j["batches"], t["batches"]):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("fmt,channels,damping", [("F32", 2, 0.2),
                                                  ("S16", 1, 0.8)])
def test_freeverb(fmt, channels, damping):
    data = _blocks(fmt, 6, 1024, channels, seed=4)
    if fmt == "F32":
        data = data * np.float32(0.4)
    else:
        data = (data // 2).astype(np.int16)
    j, t = run_both(f"freeverb damping={damping} ! fakesink", n_windows=3,
                    window=2, spec=(fmt, channels, 48000),
                    inputs=inputs(data))
    # S16: outputs truncated from floats within 2e-6 of full scale
    assert_runs_equal(j, t, atol=1 if fmt == "S16" else 2e-6)


def test_audioconvert_f32_to_s16_mono_rounds_half_to_even():
    data = _blocks("F32", 4, 64, 2, seed=5)
    halves = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 32767.5, -32768.5])
    data[0, :8, :] = (halves / 32768.0).astype(np.float32)[:, None]
    j, t = run_both("audioconvert format=S16 channels=1 ! fakesink",
                    n_windows=2, window=2, spec=("F32", 2, 48000),
                    inputs=inputs(data))
    assert_runs_equal(j, t)
    np.testing.assert_array_equal(t["batches"][0][0][0, :8, 0],
                                  [0, 0, 2, -2, 2, -2, 32767, -32768])


def test_audioconvert_s16_to_f32_and_back():
    j, t = run_both("audioconvert format=F32 ! audioconvert format=S16 "
                    "! fakesink", n_windows=2, window=2,
                    spec=("S16", 2, 48000),
                    inputs=inputs(_blocks("S16", 4, 64, 2, seed=6)))
    assert_runs_equal(j, t)


def test_audioconvert_mix_matrix():
    j, t = run_both(f"audioconvert mix-matrix={MATRIX_4_2} ! fakesink",
                    n_windows=2, window=2, spec=("F32", 4, 48000),
                    inputs=inputs(_blocks("F32", 4, 64, 4, seed=7)))
    assert_runs_equal(j, t)


def _speech(n_blocks=12, s=480, seed=8):
    """Loud sine and noise blocks around runs of silence and near-silence,
    [n_blocks, s, 1] S16."""
    rng = np.random.default_rng(seed)
    pattern = [1, 1, 1, 0, 0, 0, 2, 1, 1, 0, 0, 1][:n_blocks]
    t = np.arange(s)
    out = np.zeros((n_blocks, s), np.float64)
    for i, kind in enumerate(pattern):
        if kind == 1:
            out[i] = 20000 * np.sin(2 * np.pi * 300 * (t + i * s) / 48000)
        elif kind == 2:
            out[i] = rng.integers(-40, 40, s)
    return out.astype(np.int16)[..., None]


@pytest.mark.parametrize("props", [
    "remove=true",
    "remove=true squash=true silent=false",
    "silent=false",
    "remove=true silent=false minimum-silence-buffers=2",
    "remove=true squash=true minimum-silence-time=25000000",
    "remove=true silent=false hysteresis=1500",
])
def test_removesilence(props, monkeypatch):
    use_xla_vad_serial(monkeypatch)
    j, t = run_both(f"removesilence {props} ! fakesink", n_windows=3,
                    window=4, spec=("S16", 1, 48000),
                    inputs=inputs(_speech(), invalid=(5,)))
    assert_runs_equal(j, t)
    if "silent=false" in props:
        assert t["messages"]
