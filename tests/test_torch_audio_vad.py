"""The removesilence VAD in the port against gstbad_tpu, on the CPU: the
plain forms of kernel 8's two modes (ops.audio.vad_powers_serial and
vad_powers_bracket on CPU tensors) against the JAX Pallas kernel
_vad_powers_pallas in interpret mode and the XLA bracket
_vad_powers_bracket, then the removesilence element's VAD against
vad_window (blocks of at least 256 samples) and against vad_block folded
over the blocks (shorter blocks): frame types and every state key.

The inputs are the four kinds the JAX package's tests name: noise or
sines, whose brackets close; DC at 30000 and a square wave, whose
brackets stay open (a constant squared sample leaves the recurrence
neighbouring fixed points), so the serial recurrence runs; and silence.
The element reports its frame types through `remove=true`: a block is
dropped exactly when it is silence.  The JAX vad_window tests take the
XLA form of the serial kernel (helpers/torch_audio.py); the first test
here holds the port against the Pallas kernel itself.

Tolerance: bit exact.  Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.core.frame import FrameBatch, tensors_from_numpy
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import audio
from helpers.torch_audio import numpy_tree, use_xla_vad_serial

torch.set_num_threads(1)   # parallel test workers share the cores

KINDS = ["closed", "dc", "square", "silence"]
P0 = 123456789


def vad_data(kind, nb, n, seed=0):
    """[nb, n] int16 blocks of one kind.  "closed": sines whose loudness
    changes from block to block (loud, quiet and silent blocks, so the
    hysteresis runs) with noise blocks between."""
    rng = np.random.default_rng(seed)
    t = np.arange(nb * n).reshape(nb, n)
    if kind == "dc":
        return np.full((nb, n), 30000, np.int16)
    if kind == "silence":
        return np.zeros((nb, n), np.int16)
    if kind == "square":
        return (26213 * np.sign(np.sin(2 * np.pi * 440 * t / 48000))
                ).astype(np.int16)
    amp = rng.choice([20000.0, 20000.0, 60.0, 0.0], nb)[:, None]
    out = amp * np.sin(2 * np.pi * 300 * t / 48000)
    noisy = rng.random(nb) < 0.3
    out[noisy] = rng.integers(-32768, 32768, (int(noisy.sum()), n))
    return out.astype(np.int16)


def squares(data):
    return ((data.astype(np.int64) ** 2) >> 14) & 0xFFFF


@pytest.mark.parametrize("kind", KINDS)
def test_serial_plain_equals_the_pallas_kernel(kind):
    data = vad_data(kind, 2, 1024, seed=1)
    hl = jaudio._vad_powers_pallas(
        jnp.asarray([P0 >> 16, P0 & 0xFFFF], jnp.int32),
        jnp.asarray(squares(data), jnp.int32), interpret=True)
    hl = np.asarray(hl).astype(np.int64)
    want = (hl[:, 0] << 16) | hl[:, 1]
    got = audio.vad_powers_serial(torch.from_numpy(data),
                                  torch.tensor(P0, dtype=torch.int64))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert audio.vad_powers_serial.launches == 0


@pytest.mark.parametrize("kind,shape", [(k, (2, 1024)) for k in KINDS]
                         + [("closed", (3, 300)), ("dc", (5, 4801))])
def test_bracket_plain_equals_the_xla_bracket(kind, shape):
    data = vad_data(kind, *shape, seed=2)
    lo, hi = jax.jit(jaudio._vad_powers_bracket)(jnp.asarray(squares(data)))
    got_lo, got_hi = audio.vad_powers_bracket(torch.from_numpy(data))
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(hi))
    if shape == (2, 1024):   # the kinds do what they are named for
        assert (np.asarray(lo) == np.asarray(hi)).all() == (
            kind in ("closed", "silence"))
    assert audio.vad_powers_bracket.launches == 0


def _carried_vad_state(count, seed):
    """A JAX VAD state from mid-stream: a filled ring, a power, voice."""
    rng = np.random.default_rng(seed)
    st = jaudio.vad_init_state()
    st["ring"] = jnp.asarray(rng.integers(-3000, 3000, 256, dtype=np.int16))
    st["count"] = jnp.int64(count)
    st["power"] = jnp.int64(P0)
    st["state"] = jnp.int32(1)
    st["samples"] = jnp.int64(0)
    return st


def _port_vad(jstate, data, hysteresis):
    """The port's removesilence over one window with the VAD state
    `jstate`: (frame types from the kept blocks, the new VAD state)."""
    el = gtt.make("removesilence", remove=True, hysteresis=hysteresis)
    el.set_info(MediaSpec(kind="audio", format="S16", rate=48000,
                          channels=1))
    state = el.init_state(data.shape[0])
    state["vad"] = tensors_from_numpy(numpy_tree(jstate), "cpu")
    new, out, _ = el.process(el.dynamic_params(), state,
                             FrameBatch.make(torch.from_numpy(data[..., None])))
    return out.valid.numpy().astype(np.int32), numpy_tree(new["vad"])


def _assert_vad_equal(jnew, jtypes, got_types, got_state):
    np.testing.assert_array_equal(got_types, np.asarray(jtypes))
    jnew = numpy_tree(jnew)
    assert sorted(got_state) == sorted(jnew)
    for k in jnew:
        assert got_state[k].dtype == jnew[k].dtype, k
        np.testing.assert_array_equal(got_state[k], jnew[k], err_msg=k)


# a hysteresis of 2500 samples holds voice for two more 1024-sample blocks
@pytest.mark.parametrize("kind,hysteresis",
                         [(k, 480) for k in KINDS] + [("closed", 2500)])
def test_element_vad_equals_vad_window(kind, hysteresis, monkeypatch):
    use_xla_vad_serial(monkeypatch)
    data = vad_data(kind, 6, 1024, seed=3)
    params = gt.make("removesilence",
                     hysteresis=hysteresis).dynamic_params()
    jst = _carried_vad_state(5000, seed=4)
    jnew, jtypes = jax.jit(jaudio.vad_window)(
        jst, jnp.asarray(data), params["threshold"], params["hysteresis"])
    _assert_vad_equal(jnew, jtypes, *_port_vad(jst, data, hysteresis))


@pytest.mark.parametrize("count", [0, 70, 5000])
def test_element_vad_equals_folded_vad_block(count):
    """Blocks shorter than the ZCR ring: vad_block folded over the blocks,
    from a fresh, a partly filled and a full ring; the hysteresis holds
    voice for two more blocks."""
    data = vad_data("closed", 7, 100, seed=5)
    params = gt.make("removesilence", hysteresis=250).dynamic_params()
    jst = (jaudio.vad_init_state() if count == 0
           else _carried_vad_state(count, seed=6))
    block = jax.jit(jaudio.vad_block)
    types = []
    jnew = jst
    for row in data:
        jnew, ft = block(jnew, jnp.asarray(row), params["threshold"],
                         params["hysteresis"])
        types.append(int(ft))
    _assert_vad_equal(jnew, types, *_port_vad(jst, data, 250))
