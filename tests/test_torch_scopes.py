"""The fixed-point FFT and the four scopes of the port against the JAX
package on the CPU, bit exact: kiss_fftr_s16 and gst_fft_s16's window,
the scopes' float64 resonant filter (scope_filter's plain walk, which
takes the JAX package's contracted `carry + value * k` as one rounding),
and wavescope and spacescope in their four styles, the shaders,
spectrascope and synaescope, with the canvas and the filter carried
across windows.  The anti-aliased lines add each pixel's taps in the
JAX package's order and saturate once (its accumulate-then-saturate
form, not the C's per-dot read-modify-write)."""

import numpy as np
import pytest
import torch

import jax

from gstbad_tpu.elements.audio import visualizers as jvis
from gstbad_tpu.ops import ffts16 as jffts16
from gstbad_tpu_torch.golden import ffts16 as tgold
from gstbad_tpu_torch.ops import audio as taudio
from gstbad_tpu_torch.ops import ffts16 as tffts16
from helpers.torch_audio import batches_within, push_audio_both

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [32, 40, 96, 160, 1440, 2560])
def test_fft_s16_exact(n):
    x = np.random.default_rng(n).integers(-32768, 32768, (3, n)).astype(
        np.int32)
    a = jax.jit(lambda x: jffts16.fft_s16(jffts16.window_hamming(x)))(x)
    b = tffts16.fft_s16(tffts16.window_hamming(torch.from_numpy(x)))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))


def test_golden_tables():
    from gstbad_tpu.golden import ffts16 as jgold
    for n in (64, 96, 1440, 2560):
        assert tgold.fft_scale(n) == jgold.fft_scale(n)
        assert tgold.kf_factor(n) == jgold.kf_factor(n)
    for u, v in zip(jgold.synaescope_tables(), tgold.synaescope_tables()):
        np.testing.assert_array_equal(v, u)
    assert tgold.SYNAE_SL == jgold.SYNAE_SL


@pytest.mark.parametrize("ch", [1, 2])
def test_scope_filter_exact(ch):
    rng = np.random.default_rng(ch)
    flt = rng.standard_normal(6 * ch)
    x = rng.integers(-32768, 32768, (500, ch)).astype(np.int32)
    el = jvis.WaveScope()
    el._audio_spec = type("S", (), {"channels": ch})()
    fj, ys = jax.jit(el._filter_scan)(flt, x)
    ft, taps = taudio.scope_filter(torch.from_numpy(flt),
                                   torch.from_numpy(x))
    for k in range(3):
        np.testing.assert_array_equal(taps[:, k].numpy(), np.asarray(ys[k]))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


def _audio(rng, fmt, n, s, ch=2):
    x = rng.standard_normal((n, s, ch)) * 0.5
    if fmt == "S16":
        return np.clip(x * 32767, -32768, 32767).astype(np.int16)
    return x.astype(np.float32)


def _sine(n, s):
    t = np.arange(n * s)
    x = np.sin(2 * np.pi * t / 37.0)[:, None] * np.array([0.6, 0.4])
    return (x * 32767).astype(np.int16).reshape(n, s, 2)


@pytest.mark.parametrize("name", ["wavescope", "spacescope"])
@pytest.mark.parametrize("style", ["dots", "lines", "color-dots",
                                   "color-lines"])
@pytest.mark.parametrize("fmt", ["S16", "F32"])
def test_wave_and_space_scopes(name, style, fmt):
    rng = np.random.default_rng(len(style))
    wins = ([_sine(2, 100), _audio(rng, fmt, 2, 100)] if fmt == "S16"
            else [_audio(rng, fmt, 2, 100), _audio(rng, fmt, 2, 100)])
    (ja, _), (ta, _) = push_audio_both(name, fmt, 2, 44100, wins, {
        "style": style, "width": 64, "height": 48})
    batches_within(ja, ta)
    assert ta[0].data.shape == (2, 48, 64, 4)


@pytest.mark.parametrize("shader", ["none", "fade", "fade-and-move-up",
                                    "fade-and-move-down",
                                    "fade-and-move-left",
                                    "fade-and-move-right"])
def test_shaders(shader):
    rng = np.random.default_rng(1)
    (ja, _), (ta, _) = push_audio_both(
        "wavescope", "S16", 1, 44100, [_audio(rng, "S16", 3, 90, 1)],
        {"style": "lines", "width": 40, "height": 30, "shader": shader,
         "shade-amount": 0x00402010})
    batches_within(ja, ta)


@pytest.mark.parametrize("fmt,ch,shader", [("S16", 2, "fade"),
                                           ("F32", 1, "fade-and-move-down"),
                                           ("S16", 3, "none")])
def test_spectrascope(fmt, ch, shader):
    rng = np.random.default_rng(ch)
    (ja, _), (ta, _) = push_audio_both(
        "spectrascope", fmt, ch, 44100,
        [_audio(rng, fmt, 3, 200, ch), _audio(rng, fmt, 3, 50, ch)],
        {"width": 48, "height": 32, "shader": shader})
    batches_within(ja, ta)


@pytest.mark.parametrize("fmt", ["S16", "F32"])
def test_synaescope(fmt):
    rng = np.random.default_rng(9)
    (ja, _), (ta, _) = push_audio_both(
        "synaescope", fmt, 2, 44100,
        [_audio(rng, fmt, 3, 200), _audio(rng, fmt, 3, 30)],
        {"width": 96, "height": 80})
    batches_within(ja, ta)
