"""webrtcdsp and webrtcechoprobe of the port against the JAX package on
the CPU: the STFT and overlap-add, the noise suppressor, the gain walk,
the echo canceller, and the element through both packages' pipelines.

Tolerances.  The FFTs are torch.fft's here and XLA's in the JAX package,
and the Hann window's cosine is taken in float64 (rounded) where XLA
takes it in float32: the STFT frames agree within 4e-7 of the largest
sample (a few ulp of the window); the suppressor and the canceller within 1e-4 of their
output's peak; the gain walk is exact.  The element's S16 output within
4 LSB with a mean difference under 0.5 LSB, and voice-activity messages
equal, with the echo probe (the voice-call graph) and without it when
the high-pass filter is off.  Without the probe and with the high-pass
filter on, the JAX package's float32 associative-scan high-pass is
itself about 7 LSB from the exact serial filter, and the suppressor's
and gain's amplification of that rounding exceeds 4 LSB (ROADMAP queue
3); that case is held within 1 LSB at the high-pass filter's output
(tests/test_torch_audio_iir.py).  The states' magnitudes hold within
1e-3 relative or 1e-4 of their largest value: a bin far below the
spectrum's peak carries the FFT's absolute rounding."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio as taudio
from helpers.torch_audio import speech_like

torch.set_num_threads(1)
BLOCK = 480


def _signals(seed, n):
    rng = np.random.default_rng(seed)
    far = speech_like(rng, n)
    h = np.zeros(1920)
    h[400:] = 0.3 * np.exp(-np.arange(1520) / 300.0) * rng.standard_normal(
        1520)
    near = (np.convolve(far, h)[:n] + 0.1 * speech_like(rng, n)[::-1]
            + rng.standard_normal(n) * 10)
    return (np.clip(near, -32768, 32767).astype(np.int16),
            np.clip(far, -32768, 32767).astype(np.int16))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stft_and_ola(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1920, 2)) * 3000).astype(dtype)
    tail = (rng.standard_normal((240, 2)) * 3000).astype(np.float32)
    fj, tj = jax.jit(lambda x, t: jaudio.stft_frames(x, t, 480))(x, tail)
    ft, tt = taudio.stft_frames(torch.from_numpy(x), torch.from_numpy(tail),
                                480)
    fj = np.asarray(fj)
    assert ft.dtype == getattr(torch, fj.dtype.name) and ft.shape == fj.shape
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                               atol=4e-7 * np.abs(x).max())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    acc = rng.standard_normal((240, 2)).astype(np.float32)
    oj, aj = jax.jit(jaudio.ola)(fj.astype(np.float32), acc)
    ot, at = taudio.ola(torch.from_numpy(fj.astype(np.float32)),
                        torch.from_numpy(acc))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


@pytest.mark.parametrize("level", [6.0, 25.0])
def test_noise_suppress(level):
    near, _ = _signals(2, 480 * 12)
    x = near.astype(np.float32)[:, None]
    frames = np.asarray(jax.jit(lambda x, t: jaudio.stft_frames(
        x, t, 480)[0])(x, np.zeros((240, 1), np.float32)))
    g = np.float32(10.0 ** (-level / 20.0))
    oj, sj = jax.jit(lambda f, s: jaudio.noise_suppress(f, s, g))(
        frames, jaudio.ns_init(241, 1))
    ot, st = taudio.noise_suppress(torch.from_numpy(frames.copy()),
                                   taudio.ns_init(241, 1), float(g))
    oj = np.asarray(oj)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-4 * np.abs(oj).max())
    for k in sj:
        a, b = np.asarray(sj[k]), st[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_allclose(
            b, a, rtol=1e-3, atol=1e-4 * max(np.abs(a).max(), 1.0),
            err_msg=k)


def test_agc_walk_exact():
    rng = np.random.default_rng(4)
    lv = (rng.standard_normal(40) * 20 - 40).astype(np.float32)
    lv[5] = -80.0
    for g0 in (0.0, 4.5):
        gj, sj = jax.jit(lambda l, g: jaudio.agc_adaptive(
            l, g, jnp.float32(3.0), jnp.float32(9.0)))(lv, np.float32(g0))
        gt_, st = taudio.agc_adaptive(
            torch.from_numpy(lv), torch.tensor(g0, dtype=torch.float32),
            torch.tensor(3.0), torch.tensor(9.0))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert float(gt_) == float(gj)


@pytest.mark.parametrize("parts,od", [(16, 2.0), (8, 0.0)])
def test_aec_cancel(parts, od):
    near, far = _signals(3, 480 * 10)
    x, f = near.astype(np.float32)[:, None], far.astype(np.float32)[:, None]
    oj, sj = jax.jit(lambda x, f, s: jaudio.aec_cancel(x, f, s, od))(
        x, f, jaudio.aec_init(480, 1, parts))
    ot, st = taudio.aec_cancel(torch.from_numpy(x), torch.from_numpy(f),
                               taudio.aec_init(480, 1, parts), od)
    oj = np.asarray(oj)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=0,
                               atol=1e-4 * np.abs(oj).max())
    assert sorted(st) == sorted(sj)


def _run_graph(desc, near, far, window):
    outs = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.negotiate()
        p.get_by_name("near").push_frames(near.reshape(-1, BLOCK, 1))
        if far is not None:
            p.get_by_name("far").push_frames(far.reshape(-1, BLOCK, 1))
        res = p.run(window=window)
        outs.append((np.concatenate([np.asarray(r.data) for r in res]),
                     [(m.name, m.pts, m.fields) for m in p.bus.messages]))
    return outs


_NEAR = "appsrc name=near kind=audio format=S16 rate=48000 channels=1"
_FAR = ("appsrc name=far kind=audio format=S16 rate=48000 channels=1 "
        "! webrtcechoprobe ! dsp.")


@pytest.mark.parametrize("props,probe", [
    ("voice-detection=true", True),
    ("echo-suppression-level=high extended-filter=false "
     "gain-control-mode=fixed-digital", True),
    ("high-pass-filter=false voice-detection=true "
     "voice-detection-likelihood=moderate noise-suppression-level=high",
     False),
    ("high-pass-filter=false noise-suppression=false limiter=false",
     False)])
def test_element_against_jax(props, probe):
    near, far = _signals(5, BLOCK * 24)
    if probe:
        desc = f"{_NEAR} ! dsp.  {_FAR}  webrtcdsp name=dsp {props} ! fakesink"
    else:
        desc = f"{_NEAR} ! webrtcdsp name=dsp {props} ! fakesink"
    (a, am), (b, bm) = _run_graph(desc, near, far if probe else None, 8)
    assert a.dtype == b.dtype == np.int16 and a.shape == b.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 4 and d.mean() < 0.5, (d.max(), d.mean())
    assert am == bm


@pytest.mark.parametrize("spec,err", [
    ({"rate": 44100}, "rate 44100"),
    ({"props": "noise-suppression-level=extreme"}, "noise-suppression"),
    ({"props": "echo-suppression-level=max"}, "echo-suppression")])
def test_negotiation_refusals(spec, err):
    from gstbad_tpu.core.spec import SpecError as JSpecError
    from gstbad_tpu_torch.core.spec import SpecError
    rate = spec.get("rate", 48000)
    desc = (f"appsrc name=near kind=audio format=S16 rate={rate} channels=1 "
            f"! webrtcdsp {spec.get('props', '')} ! fakesink")
    for pkg, kw, exc in ((gt, {}, JSpecError),
                         (gtt, {"device": "cpu"}, SpecError)):
        with pytest.raises(exc, match=err):
            pkg.parse_launch(desc, **kw).negotiate()
