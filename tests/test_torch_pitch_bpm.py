"""pitch and bpmdetect of the port against the JAX package on the CPU.

Tolerances.  resample_linear is exact.  The phase vocoder's synthesis
phase is a float32 sum that grows without wrapping
(gstbad_tpu/ops/audio.py:1345), so a difference of an ulp in one frame's
phase stays in every later frame.  The port takes the analysis phase as
a float32 atan2 and contracts the wrap and the phase update into FMAs, as
the JAX package's compiled window does, and on the CPU its FFTs go
through scipy.fft (gstbad_tpu_torch/ops/fft.py), which rounds as XLA's
CPU FFT does.  Measured over four 8192-sample windows: a 440 Hz sine at
pitch 1.25 1.8e-7, at pitch 0.8 tempo 1.1 2.4e-7; noise (0.3 RMS) at
pitch 1.25 1.8e-7, at rate 1.5 output-rate 0.5 1.8e-7.  The tests hold
every input to 1e-5, with lengths, pts, flags and valid equal.
bpmdetect's `bpm` messages are equal."""

import numpy as np
import pytest
import torch

import jax

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio as taudio
from helpers.torch_audio import audio_spec, push_audio_both

torch.set_num_threads(1)


@pytest.mark.parametrize("n,n_out", [(100, 80), (5120, 4096), (7, 19)])
def test_resample_linear_exact(n, n_out):
    x = np.random.default_rng(n).standard_normal((n, 2)).astype(np.float32)
    a = jax.jit(lambda x: jaudio.resample_linear(x, n_out))(x)
    b = taudio.resample_linear(torch.from_numpy(x), n_out)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _pitch_inputs(kind):
    if kind == "sine":
        t = np.arange(8 * 4096) / 44100
        s = (0.8 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        return np.stack([s, s], -1).reshape(4, 2, 4096, 2)
    return (np.random.default_rng(0).standard_normal((4, 2, 4096, 2))
            * 0.3).astype(np.float32)


PITCH_CASES = [  # (input, properties, limit over its four windows)
    ("sine", {"pitch": 1.25}, 1e-5),
    ("sine", {"pitch": 0.8, "tempo": 1.1}, 1e-5),
    ("noise", {"pitch": 1.25}, 1e-5),
    ("noise", {"rate": 1.5, "output-rate": 0.5}, 1e-5)]


@pytest.mark.parametrize("kind,props,limit", PITCH_CASES)
def test_pitch_element(kind, props, limit):
    (ja, _), (ta, _) = push_audio_both("pitch", "F32", 2, 44100,
                                       list(_pitch_inputs(kind)), props)
    assert len(ja) == len(ta) == 4
    for i, (a, t) in enumerate(zip(ja, ta)):
        for f in ("pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(t, f), getattr(a, f))
        x, y = np.asarray(a.data), np.asarray(t.data)
        assert x.shape == y.shape and x.dtype == y.dtype == np.float32
        err = np.abs(x - y).max()
        assert err <= limit, (i, err)
        if kind == "sine" and i == 0:
            assert err <= 1e-5, err


@pytest.mark.parametrize("kind,props,limit", PITCH_CASES)
def test_pitch_same_fft_closes_the_gap(kind, props, limit, monkeypatch):
    """The witness that the FFT route closes the gap: with the port's
    CPU FFTs (ops/fft.py) replaced by the JAX package's own, every input
    is within 3e-7 over four windows (measured 2.4e-7), as it is with
    scipy.fft, far under its limit."""
    from gstbad_tpu_torch.ops import fft as tfft
    rfft = jax.jit(lambda a: jax.numpy.fft.rfft(a, axis=1))
    irfft = jax.jit(lambda a, n: jax.numpy.fft.irfft(a, n=n, axis=1),
                    static_argnums=1)

    def jax_rfft(x, dim):
        assert dim == 1
        return torch.from_numpy(np.array(rfft(x.numpy())))

    def jax_irfft(x, n, dim):
        assert dim == 1
        return torch.from_numpy(np.array(irfft(x.numpy(), n)))

    monkeypatch.setattr(tfft, "rfft", jax_rfft)
    monkeypatch.setattr(tfft, "irfft", jax_irfft)
    (ja, _), (ta, _) = push_audio_both("pitch", "F32", 2, 44100,
                                       list(_pitch_inputs(kind)), props)
    assert len(ja) == len(ta) == 4
    errs = [np.abs(np.asarray(a.data) - t.data).max() for a, t in zip(ja, ta)]
    assert max(errs) <= 3e-7 < limit, errs


def test_pitch_live_tempo_change():
    """set_static_property mid-stream: both packages rebuild and carry the
    vocoder's state (migrate_state crops the overlap-add tail)."""
    from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
    from gstbad_tpu_torch.core.frame import FrameBatch
    x = _pitch_inputs("sine")
    outs = []
    for pkg, kw, make in (
            (gt, {}, lambda a: JFrameBatch.make(jax.numpy.asarray(a))),
            (gtt, {"device": "cpu"},
             lambda a: FrameBatch.make(torch.from_numpy(a.copy())))):
        p = pkg.parse_launch("pitch name=p pitch=1.25 ! fakesink", **kw)
        res = []
        for i in range(2):
            if i == 1:
                p.set_static_property("p", "tempo", 1.5)
            p.negotiate(audio_spec(pkg, "F32", 2, 44100))
            res += p.run(inputs=make(x[i]))
        outs.append(res)
    ja, ta = outs
    assert [np.asarray(a.data).shape for a in ja] == [t.data.shape
                                                      for t in ta]
    for a, t in zip(ja, ta):
        assert np.abs(np.asarray(a.data) - t.data).max() <= 1e-4


def _beats(rate, seconds, bpm, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    env = np.maximum(np.sin(2 * np.pi * t * bpm / 60.0), 0.0) ** 16
    x = env * np.sin(2 * np.pi * 300 * t) * 0.6 + rng.standard_normal(
        t.shape) * 0.01
    return x


@pytest.mark.parametrize("fmt,bpm,ch", [("F32", 120.0, 1), ("S16", 96.0, 2)])
def test_bpmdetect_messages(fmt, bpm, ch):
    rate, s = 8000, 2000
    x = _beats(rate, 10, bpm, int(bpm))
    x = np.repeat(x[:, None], ch, axis=1).reshape(-1, s, ch)
    if fmt == "S16":
        x = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    else:
        x = x.astype(np.float32)
    wins = [x[i:i + 10] for i in range(0, 40, 10)]
    (ja, jm), (ta, tm) = push_audio_both("bpmdetect", fmt, ch, rate, wins)
    assert len(jm) == len(tm) and jm, (jm, tm)
    for a, t in zip(jm, tm):
        assert a[:3] == t[:3] and a[3] == t[3], (a, t)
    assert abs(tm[-1][3]["bpm"] - bpm) < 3.0
    for a, t in zip(ja, ta):
        np.testing.assert_array_equal(t.data, np.asarray(a.data))


@pytest.mark.parametrize("hs", [205, 256, 320])
def test_phase_vocoder_op(hs):
    """One window of the vocoder on a sine, from a fresh state and then
    from the carried one: the stretched lengths equal, the output within
    2e-5 (the first window, before the phases drift; measured 1.5e-5)
    and the carried tails, whose overlap-add sums are not yet scaled by
    the hann^2 norm, within 5e-5.  (The phases of bins that hold only rounding noise
    are arbitrary in both packages and are not compared.)"""
    t = np.arange(4096) / 44100
    x = np.stack([0.8 * np.sin(2 * np.pi * 440 * t),
                  0.5 * np.sin(2 * np.pi * 660 * t)], -1).astype(np.float32)
    sj = jaudio.pv_init_state(1024, 256, hs, 2)
    aj, nj = jax.jit(lambda x, s: jaudio.phase_vocoder(
        x, s, 1024, 256, hs))(x, sj)
    at, nt = taudio.phase_vocoder(torch.from_numpy(x),
                                  taudio.pv_init_state(1024, 256, hs, 2),
                                  1024, 256, hs)
    assert at.shape == np.asarray(aj).shape == (16 * hs, 2)
    assert np.abs(at.numpy() - np.asarray(aj)).max() <= 2e-5
    for k in ("in_tail", "ola"):
        assert np.abs(nt[k].numpy() - np.asarray(nj[k])).max() <= 5e-5, k
    assert bool(nt["primed"]) and bool(nj["primed"])
