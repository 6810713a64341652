"""The port's Haar engine (gstbad_tpu_torch/ops/haar.py, ops/resize.py,
io/haarcascade.py) against the JAX package's on the CPU.

Tolerances.  The cascade parses, the summed-area table (jnp.cumsum's
blocked order, ops/scan.cumsum), the float64 rotated table and both
evaluators (eval_cascade_arrays for the face models, eval_cascade for the
hand models, the JAX functions under jax.jit) are bit exact: the passes
and the scores at every window, on integer planes and on the non-integer
planes a pyramid makes.  resize_linear is within 4 ulp of
jax.image.resize: XLA's CPU dot splits each output's taps across its
thread pool and adds the partial sums (ops/resize.py), so at a block edge
it rounds once more than the port's ascending FMA sum (measured: at most
4 ulp; bit exact at scale 1 and on the 48x64 plane)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstbad_tpu.io.haarcascade import parse_cascade as jparse
from gstbad_tpu.ops import haar as jhaar
from gstbad_tpu_torch.io.haarcascade import parse_cascade
from gstbad_tpu_torch.ops import haar
from gstbad_tpu_torch.ops.resize import resize_linear

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "gstbad_tpu_torch", "data", "")
ALT2 = DATA + "haarcascade_frontalface_alt2.xml"


def _planes():
    rng = np.random.default_rng(11)
    fix = np.load(DATA + "face_fixture.npz")["frame"].astype(np.float32)
    return {"integer": fix,
            "fractional": (fix * np.float32(0.9) + np.float32(7.3)),
            "noise": (rng.random((70, 90)) * 255).astype(np.float32)}


@pytest.mark.parametrize("name", ["fist", "palm",
                                  "haarcascade_frontalface_alt2"])
def test_cascade_parses_alike(name):
    a, b = jparse(DATA + name + ".xml"), parse_cascade(DATA + name + ".xml")
    assert a.window == b.window and a.n_features == b.n_features
    assert [(s.threshold, [[vars(n) for n in t.nodes] for t in s.trees])
            for s in a.stages] == [
        (s.threshold, [[vars(n) for n in t.nodes] for t in s.trees])
        for s in b.stages]


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_integral_exact(kind):
    x = _planes()[kind]
    a = np.asarray(jax.jit(lambda g: (jhaar.integral(g),
                                      jhaar.integral(g * g)))(x)[1])
    b = haar.integral(torch.from_numpy(x * x)[None])[0].numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind", ["fractional", "noise"])
def test_tilted_integral_exact(kind):
    x = _planes()[kind]
    a = np.asarray(jax.jit(jhaar.tilted_integral)(x))
    b = haar.tilted_integral(torch.from_numpy(x)[None])[0].numpy()
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(b, a)


def _both(x, jfn, packed):
    jp, js = jax.jit(jfn)(jnp.asarray(x))
    tp, ts = haar.eval_cascade(torch.from_numpy(x)[None], packed)
    return (np.asarray(jp), np.asarray(js)), (tp[0].numpy(), ts[0].numpy())


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_arrays_evaluator_exact(kind):
    """alt2 (20 stages, 2094 features) over every stride-2 window."""
    x = _planes()[kind]
    arrs = jhaar.compile_arrays(jparse(ALT2))
    (jp, js), (tp, ts) = _both(x, lambda g: jhaar.eval_cascade_arrays(
        g, arrs), haar.pack(parse_cascade(ALT2), "arrays"))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("name", ["fist", "palm"])
def test_unrolled_evaluator_exact(name):
    """The hand models, with their tilted features, on a pyramid-like
    (non-integer) plane."""
    x = _planes()["noise"]
    c = jparse(DATA + name + ".xml")
    (jp, js), (tp, ts) = _both(x, lambda g: jhaar.eval_cascade(g, c),
                               haar.pack(parse_cascade(DATA + name + ".xml"),
                                         "unrolled"))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("h,w", [(161, 161), (72, 128), (48, 64),
                                 (720, 1280)])
def test_resize_within_4_ulp(h, w):
    """Every scale of the 1.25 pyramid the detectors take (at most
    haar.MAX_SCALES: 16 of the 720x1280 plane's)."""
    x = np.random.default_rng(h).integers(0, 256, (h, w)).astype(np.float32)
    f, n = 1.0, 0
    while int(h / f) >= 20 and int(w / f) >= 20 and n < haar.MAX_SCALES:
        n += 1
        sh, sw = int(h / f), int(w / f)
        a = np.asarray(jax.jit(lambda g: jax.image.resize(
            g, (sh, sw), "linear"))(x))
        b = resize_linear(torch.from_numpy(x), sh, sw).numpy()
        ulp = np.spacing(np.abs(a).astype(np.float32))
        assert np.abs(b - a).max() <= 4 * ulp.max(), (sh, sw)
        assert (np.abs(b - a) <= 4 * ulp).all(), (sh, sw)
        f *= 1.25


_RESIZE_CHILD = """
import os, sys
import numpy as np
if sys.argv[1] == "one":
    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
import jax
jax.config.update("jax_enable_x64", True)   # as gstbad_tpu runs it
x = np.random.default_rng(720).integers(0, 256, (720, 1280)).astype(
    np.float32)
np.save(sys.argv[2], np.asarray(jax.jit(lambda g: jax.image.resize(
    g, (576, 1024), "linear"))(x)))
"""


def test_resize_reference_moves_with_the_core_count(tmp_path):
    """Why ops/resize.py cannot match jax.image.resize bit for bit on every
    host: XLA's CPU dot splits its k sums across its thread pool, so the
    reference gives other bits on one core than on all of them.  Each
    run is a process of its own, as the JAX package runs (without these
    tests' 8 virtual devices, under which the pool ignores the affinity);
    the port is within 4 ulp of both."""
    import subprocess
    import sys
    if len(os.sched_getaffinity(0)) < 2:
        pytest.skip("needs a host with more than one core")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = {mode: subprocess.Popen(
        [sys.executable, "-c", _RESIZE_CHILD, mode,
         str(tmp_path / f"{mode}.npy")], env=env) for mode in ("one", "all")}
    assert all(p.wait(timeout=300) == 0 for p in procs.values())
    one, every = (np.load(tmp_path / f"{m}.npy") for m in ("one", "all"))
    assert one.shape == every.shape == (576, 1024)
    assert (one != every).any()
    x = np.random.default_rng(720).integers(0, 256, (720, 1280)).astype(
        np.float32)
    port = resize_linear(torch.from_numpy(x), 576, 1024).numpy()
    for ref in (one, every):
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(port - ref) <= 4 * ulp).all()
