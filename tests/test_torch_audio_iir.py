"""The IIR helpers and bs2b of the port against the JAX package on the
CPU: first_order_iir, bs2b_cross_feed, biquad, and the bs2b element in
its four formats with state across windows.

Tolerances.  first_order_iir in float32 is bit exact: the port repeats
the associative scan's order and contracts the compose's b2 + a2*b1 as
the JAX package's compiled scan does.  In float64 the JAX package's
compiled scan contracts in places that depend on XLA's fusion (the
final b + a*y0 at some lengths): within 1e-12 (relative) there, and so
bs2b's F64 output within 1e-12, its F32 within 1 ulp and its S16/S32
within 1 LSB (measured: equal on these inputs but for F64 at 4e-16).
The biquad is an associative scan over a near-unit-pole 2x2 recursion in
float32: JAX's own result is about 7 LSB from the exact serial filter,
and the port follows its order within 1.0 (int16 scale) on 7680 samples.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio as taudio
from helpers.torch_audio import (batches_within, push_audio_both,
                                 speech_like)

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 1023])
def test_first_order_iir_f32_exact(n):
    rng = np.random.default_rng(n)
    d = rng.standard_normal((n, 2)).astype(np.float32)
    y0 = rng.standard_normal(2).astype(np.float32)
    a = jax.jit(lambda d, y0: jaudio.first_order_iir(d, 0.93, y0))(d, y0)
    b = taudio.first_order_iir(torch.from_numpy(d), 0.93,
                               torch.from_numpy(y0))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("n", [2, 99, 4096])
def test_first_order_iir_f64_close(n):
    rng = np.random.default_rng(n)
    d = rng.standard_normal((n, 3))
    y0 = rng.standard_normal(3)
    a = np.asarray(jax.jit(lambda d, y0: jaudio.first_order_iir(
        d, 0.999, y0))(d, y0))
    b = taudio.first_order_iir(torch.from_numpy(d), 0.999,
                               torch.from_numpy(y0)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)


def test_bs2b_cross_feed_and_coefficients():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1000, 2))
    cj = jaudio.bs2b_coefficients(650, 95, 44100)
    ct = taudio.bs2b_coefficients(650, 95, 44100)
    for k in cj:
        assert float(cj[k]) == float(ct[k]), k
    st = {k: rng.standard_normal(2) for k in ("lo", "hi", "asis")}
    sj, a = jax.jit(jaudio.bs2b_cross_feed)(
        {k: jnp.asarray(v) for k, v in st.items()}, x, cj)
    stt, b = taudio.bs2b_cross_feed(
        {k: torch.from_numpy(v) for k, v in st.items()},
        torch.from_numpy(x), ct)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                               atol=1e-12)
    for k in sj:
        np.testing.assert_allclose(stt[k].numpy(), np.asarray(sj[k]),
                                   rtol=1e-12, atol=1e-12)


def test_biquad_within_one_lsb():
    rng = np.random.default_rng(3)
    x = np.clip(speech_like(rng, 7680), -32768, 32767).astype(
        np.int16).astype(np.float32)[:, None]
    bq_b, bq_a = jaudio.butter_highpass(90.0, 48000)
    assert taudio.butter_highpass(90.0, 48000) == (
        tuple(float(v) for v in bq_b), tuple(float(v) for v in bq_a))
    st = rng.standard_normal((2, 1)).astype(np.float32)
    a, sa = jax.jit(lambda x, s: jaudio.biquad(x, bq_b, bq_a, s))(x, st)
    b, sb = taudio.biquad(torch.from_numpy(x), *taudio.butter_highpass(
        90.0, 48000), torch.from_numpy(st))
    assert b.dtype == torch.float64 and np.asarray(a).dtype == np.float64
    assert np.abs(b.numpy() - np.asarray(a)).max() <= 1.0
    assert np.abs(sb.numpy() - np.asarray(sa)).max() <= 1.0


_BS2B_TOL = {"F32": 1.2e-7, "F64": 1e-12, "S16": 1.0, "S32": 1.0}


def _pcm(rng, fmt, n, s):
    x = rng.standard_normal((n, s, 2)) * 0.4
    if fmt == "S16":
        return np.clip(x * 32767, -32768, 32767).astype(np.int16)
    if fmt == "S32":
        return np.clip(x * 2 ** 31, -2 ** 31, 2 ** 31 - 1).astype(np.int32)
    return x.astype(np.float32 if fmt == "F32" else np.float64)


@pytest.mark.parametrize("fmt,props", [
    ("F32", {"preset": "cmoy"}), ("F64", {}), ("S16", {"preset": "jmeier"}),
    ("S32", {"fcut": 1500, "feed": 20})])
def test_bs2b_element(fmt, props):
    rng = np.random.default_rng(11)
    wins = [_pcm(rng, fmt, 3, 200), _pcm(rng, fmt, 3, 200)]
    (ja, _), (ta, _) = push_audio_both("bs2b", fmt, 2, 44100, wins, props)
    batches_within(ja, ta, atol=_BS2B_TOL[fmt])


def test_bs2b_mono_passes_through():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 1)).astype(np.float32)
    (ja, _), (ta, _) = push_audio_both("bs2b", "F32", 1, 44100, [x])
    batches_within(ja, ta)
    np.testing.assert_array_equal(ta[0].data, x)
