"""The audio ops of BASELINE config 3 in the port against gstbad_tpu, on
the CPU: the four audiomixmatrix paths, and freeverb's whole-window and
short-window forms against gstbad_tpu.ops.audio and against the serial C
transcription gstbad_tpu.golden.audio.Freeverb.

Tolerance: the mixes are bit exact (integer paths, and float paths that
accumulate in channel order with one multiply and one add per term).
freeverb's float32 output and float state agree within 2e-6 absolute,
the JAX package's own gate against the serial C (tests/test_audio.py); on
S16 samples, whose full scale is 32768 and not 1, the same gate scaled to
full scale, 2e-6 * 32768.  The port solves each comb block with one matrix
product where the JAX package scans or convolves, so sums are taken in
another order.  The JAX side runs under jax.jit, as the JAX package's
pipeline does.  Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.golden import audio as golden
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio
from helpers.torch_audio import assert_states_close, numpy_tree

torch.set_num_threads(1)   # parallel test workers share the cores

MATRIX_4_2 = np.array([[1.0, 0.0, 0.5, 0.0], [0.0, 1.0, -0.25, 0.5]])
ATOL = 2e-6


def test_mix_f32():
    x = ((np.random.default_rng(1).random((2, 64, 4)) - 0.5) * 3
         ).astype(np.float32)
    want = jax.jit(jaudio.mix_f32)(jnp.asarray(x), jnp.asarray(MATRIX_4_2))
    got = audio.mix_f32(torch.from_numpy(x), torch.from_numpy(MATRIX_4_2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got[0].numpy(), golden.mixmatrix_f32(x[0], MATRIX_4_2))


def test_mix_f64():
    x = np.random.default_rng(2).random((2, 32, 4)) - 0.5
    want = jax.jit(jaudio.mix_f64)(jnp.asarray(x), jnp.asarray(MATRIX_4_2))
    got = audio.mix_f64(torch.from_numpy(x), torch.from_numpy(MATRIX_4_2))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mix_s16():
    x = np.random.default_rng(3).integers(-32768, 32768, (2, 128, 4)
                                          ).astype(np.int16)
    shift = 32 - 16 - 1 - 2
    conv = (MATRIX_4_2 * (1 << shift)).astype(np.int32)
    want = jax.jit(jaudio.mix_s16, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(conv), shift)
    got = audio.mix_s16(torch.from_numpy(x), torch.from_numpy(conv), shift)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(),
                                  golden.mixmatrix_s16(x[0], MATRIX_4_2))


def test_mix_s32():
    x = np.random.default_rng(4).integers(-2**31, 2**31, (2, 64, 4)
                                          ).astype(np.int32)
    shift = 64 - 32 - 1 - 2
    conv = (MATRIX_4_2 * (1 << shift)).astype(np.int64)
    want = jax.jit(jaudio.mix_s32, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(conv), shift)
    got = audio.mix_s32(torch.from_numpy(x), torch.from_numpy(conv), shift)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(),
                                  golden.mixmatrix_s32(x[0], MATRIX_4_2))


def _params(damping):
    """The element's coefficients in both packages (they must agree)."""
    jp = gt.make("freeverb", damping=damping).dynamic_params()
    tp = gtt.make("freeverb", damping=damping).dynamic_params()
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        assert np.float32(jp[k]) == tp[k].numpy(), k
    return jp, tp


# (window length, windows): 2048 >= the longest delay takes the whole-window
# form, 1000 the short-window walk
@pytest.mark.parametrize("n,windows", [(2048, 2), (1000, 3)])
@pytest.mark.parametrize("damping", [0.2, 0.8])
@pytest.mark.parametrize("layout", ["stereo_f32", "mono_s16"])
def test_freeverb_against_jax_and_serial_c(n, windows, damping, layout):
    rate = 48000
    rng = np.random.default_rng(5)
    mono = layout == "mono_s16"
    if mono:
        x = rng.integers(-20000, 20000, windows * n).astype(np.float32)
    else:
        x = ((rng.random((windows * n, 2)) - 0.5) * 0.8).astype(np.float32)
    atol = ATOL * (32768 if mono else 1)
    jp, tp = _params(damping)
    jstep = jax.jit(lambda st, xw: jaudio.freeverb_process(st, xw, jp, rate,
                                                           mono))
    jst = jaudio.freeverb_init_state(rate)
    tst = audio.freeverb_init_state(rate)
    got, want = [], []
    for w in range(windows):
        xw = x[w * n:(w + 1) * n]
        jst, jy = jstep(jst, jnp.asarray(xw))
        tst, ty = audio.freeverb_process(tst, torch.from_numpy(xw), tp, rate,
                                         mono)
        assert ty.dtype == torch.float32 and ty.shape == (n, 2)
        want.append(np.asarray(jy))
        got.append(ty.numpy())
        assert_states_close(numpy_tree(jst), numpy_tree(tst), atol)
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    fv = golden.Freeverb(rate, damping=damping)
    c = fv.process_mono_float(x) if mono else fv.process_stereo_float(x)
    np.testing.assert_allclose(got, c, rtol=0, atol=atol)


def test_freeverb_below_32khz_is_not_ported():
    """Below 32 kHz freeverb_process no longer raises: it takes the
    per-sample walk, freeverb_scan, as the JAX package takes its scan
    (tests/test_torch_freeverb_scan.py holds that walk against it)."""
    _, tp = _params(0.2)
    st = audio.freeverb_init_state(22050)
    x = torch.linspace(-0.5, 0.5, 128).reshape(64, 2)
    got_st, got = audio.freeverb_process(st, x, tp, 22050, False)
    want_st, want = audio.freeverb_scan(st, x, tp, 22050, False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert_states_close(numpy_tree(got_st), numpy_tree(want_st))
    assert int(got_st["t"]) == 64
