"""freeverb below 32 kHz in gstbad_tpu_torch against gstbad_tpu on the CPU:
the per-sample walk (ops.audio.freeverb_scan, the plain form of the CUDA
kernel) against the JAX package's lax.scan _freeverb_process_scan over
blocks that carry the state, and the element through both parse_launches.

Tolerance: float32 output and float state within 2e-6 absolute, the JAX
package's own gate against the serial C (tests/test_audio.py): the port
takes every product and sum in the C's order, the JAX scan leaves the
order of its 8-tap sum and any contraction to XLA.  S16 samples within
1 LSB (a float within 2e-6 of a rounding edge may round the other way);
pts, flags and valid exact.  Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio
from helpers.torch_audio import (assert_states_close, numpy_tree,
                                 run_both, run_pipelines)

torch.set_num_threads(1)   # parallel test workers share the cores

ATOL = 2e-6
# block lengths: one longer than the shortest comb at 16 kHz (404), one
# sample, and one longer than every delay line at 16 kHz (592 is the
# longest comb there)
BLOCKS = (450, 1, 700)


def _params(damping):
    jp = gt.make("freeverb", damping=damping).dynamic_params()
    tp = gtt.make("freeverb", damping=damping).dynamic_params()
    return jp, tp


@pytest.mark.parametrize("rate", [16000, 22050])
@pytest.mark.parametrize("mono", [False, True])
def test_scan_against_the_jax_scan(rate, mono):
    rng = np.random.default_rng(rate + mono)
    n = sum(BLOCKS)
    x = (rng.integers(-20000, 20000, n) if mono
         else (rng.random((n, 2)) - 0.5) * 1.6).astype(np.float32)
    jp, tp = _params(0.6 if mono else 0.2)
    jstep = jax.jit(lambda st, xw: jaudio._freeverb_process_scan(
        st, xw, jp, rate, mono))
    jst = jaudio.freeverb_init_state(rate)
    tst = audio.freeverb_init_state(rate)
    atol = ATOL * (32768 if mono else 1)   # mono: S16-scaled samples
    lo = 0
    for m in BLOCKS:
        xw = x[lo:lo + m]
        lo += m
        jst, jy = jstep(jst, jnp.asarray(xw))
        tst, ty = audio.freeverb_scan(tst, torch.from_numpy(xw), tp, rate,
                                      mono)
        assert ty.dtype == torch.float32 and ty.shape == (m, 2)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=atol)
        assert_states_close(numpy_tree(jst), numpy_tree(tst), atol)
    assert int(tst["t"]) == n
    # freeverb_process dispatches below 32 kHz to the walk
    st2, y2 = audio.freeverb_process(audio.freeverb_init_state(rate),
                                     torch.from_numpy(x[:BLOCKS[0]]), tp,
                                     rate, mono)
    _, y1 = audio.freeverb_scan(audio.freeverb_init_state(rate),
                                torch.from_numpy(x[:BLOCKS[0]]), tp, rate,
                                mono)
    np.testing.assert_array_equal(y2.numpy(), y1.numpy())


def test_freeverb_22k_graph():
    """freeverb_22k's launch string (models/benchmarks.py) at 300 samples
    a block: freeverb's float output (a tap) within 2e-6, the S16 samples
    within 1 LSB, the carried states within 2e-6."""
    desc = ("audiotestsrc wave=sine channels=2 format=F32 rate=22050 "
            "samplesperbuffer=300 ! freeverb ! audioconvert format=S16 "
            "! fakesink")
    j, t = run_both(desc, n_windows=3, window=2, taps=("freeverb",))
    for a, b in zip(j["taps"]["freeverb"], t["taps"]["freeverb"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    for (jd, jp, jv), (td, tp, tv) in zip(j["batches"], t["batches"]):
        assert td.dtype == jd.dtype == np.int16 and td.shape == (2, 300, 2)
        assert np.abs(td.astype(int) - jd.astype(int)).max() <= 1
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
    assert_states_close(j["states"], t["states"], ATOL)


def test_s16_mono_16k_through_both_launches():
    """S16 mono in at 16 kHz (freeverb's S16 path: clamp and truncate),
    within 1 LSB; a state carried from the JAX run into the port
    (Pipeline.load_states) for the last windows."""
    desc = ("audiotestsrc wave=square channels=1 format=S16 rate=16000 "
            "samplesperbuffer=250 freq=300 ! freeverb room-size=0.9 "
            "! fakesink")
    j, t = run_both(desc, n_windows=3, window=2)
    for (jd, _, _), (td, _, _) in zip(j["batches"], t["batches"]):
        assert td.dtype == np.int16 and td.shape == (2, 250, 2)
        assert np.abs(td.astype(int) - jd.astype(int)).max() <= 1
    # resume: the JAX run's states after its 3 windows, 2 more in both
    pj, pt = gt.parse_launch(desc), gtt.parse_launch(desc, device="cpu")
    pj.negotiate()
    step = pj.compile(2)
    states, params = pj.init_states(2), pj.params()
    for _ in range(3):
        states, _, _ = step(params, states, None)
    carried = jax.tree_util.tree_map(np.asarray, states)
    pt.negotiate()
    pt.compile(2)
    pt.load_states(carried)
    tstates = pt._states
    tstep, tparams = pt._step, pt.params()
    for _ in range(2):
        states, jl, _ = step(params, states, None)
        tstates, tl, _ = tstep(tparams, tstates, None)
        a, b = np.asarray(jl[0].data), tl[0].data.numpy()
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert_states_close(numpy_tree(jax.tree_util.tree_map(np.asarray,
                                                          states)),
                        numpy_tree(tstates), ATOL * 32768)
