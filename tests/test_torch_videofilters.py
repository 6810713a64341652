"""videodiff, scenechange and smooth in gstbad_tpu_torch against
gstbad_tpu on the CPU, on every format each accepts: the window step run
over several windows with invalid (rate-padding) slots, comparing every
slot's data, the carried states and the bus messages; and a run resumed
from the JAX package's states.  Tolerance: bit exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat
from helpers.torch_audio import assert_states_close, numpy_tree
from test_torch_convert import make_frames

torch.set_num_threads(1)   # parallel test workers share the cores

H, W = 16, 24
WINDOW, N_WINDOWS = 5, 5
DIFF_FORMATS = ["I420", "Y444", "Y42B", "Y41B", "GRAY8"]
SCENE_FORMATS = ["I420", "Y42B", "Y41B", "Y444", "GRAY8"]


def scene_frames(fmt, n, rng):
    """n frames of `fmt` made of three scenes (cuts at n/3 and 2n/3), each
    a still image under a little noise, plus one frame of pure noise."""
    frames = make_frames(fmt, n, H, W, rng)

    def shape(x):
        cut = np.arange(n) * 3 // n
        base = [rng.integers(0, 256, x.shape[1:]) for _ in range(3)]
        noise = rng.integers(-3, 4, x.shape)
        out = np.stack([base[c] for c in cut]) + noise
        out[n // 2] = rng.integers(0, 256, x.shape[1:])
        return np.clip(out, 0, 255).astype(np.uint8)

    if isinstance(frames, dict):
        return {k: shape(v) for k, v in frames.items()}
    return shape(frames)


def valid_mask(n, rng):
    valid = rng.random(n) > 0.25
    valid[:WINDOW] = [True, False, True, True, False]
    valid[2 * WINDOW:3 * WINDOW] = False     # a window with no arrival
    return valid


def _slice(tree, sl):
    if isinstance(tree, dict):
        return {k: np.ascontiguousarray(v[sl]) for k, v in tree.items()}
    return np.ascontiguousarray(tree[sl])


def run_steps(desc, fmt, frames, valid, carry_after=None):
    """Step `desc` (no source) over the frames, WINDOW slots a window, in
    both packages.  With carry_after=k the port starts from the JAX run's
    states after k windows (Pipeline.load_states).  Returns per package
    (outputs of every slot per window, messages, final states)."""
    out = {}
    carried = None
    for key, pkg, spec_cls, fb_cls, conv, kw in (
            ("jax", gt, JMediaSpec, JFrameBatch, jnp.asarray, {}),
            ("torch", gtt, MediaSpec, FrameBatch, torch.from_numpy,
             {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.negotiate(spec_cls(kind="video", format=fmt, width=W, height=H))
        step = p.compile(WINDOW)
        params, states = p.params(), p.init_states(WINDOW)
        first = 0
        if key == "torch" and carried is not None:
            p.load_states(carried)
            states, first = p._states, carry_after
        outs = []
        for w in range(first, len(valid) // WINDOW):
            sl = slice(w * WINDOW, (w + 1) * WINDOW)
            data = _slice(frames, sl)
            data = ({k: conv(v) for k, v in data.items()}
                    if isinstance(data, dict) else conv(data))
            pts = conv(np.arange(sl.start, sl.stop, dtype=np.int64) * 1000)
            batch = fb_cls.make(data, pts=pts, valid=conv(valid[sl]))
            states, leaves, msgs = step(params, states, batch)
            p._drain_messages(leaves[0], msgs)
            outs.append(numpy_tree(leaves[0].data))
            if key == "jax" and carry_after is not None \
                    and w + 1 == carry_after:
                carried = numpy_tree(states)
        out[key] = (outs, [(m.element, m.name, m.pts, m.fields)
                           for m in p.bus.messages], numpy_tree(states))
    return out["jax"], out["torch"]


def assert_runs_equal(jax_run, torch_run, first_window=0):
    (jouts, jmsgs, jstates), (touts, tmsgs, tstates) = jax_run, torch_run
    assert len(touts) == len(jouts) - first_window
    for a, b in zip(jouts[first_window:], touts):
        assert_states_close(a, b)     # exact, dtypes and shapes too
    assert_states_close(jstates, tstates)
    return jmsgs, tmsgs


@pytest.mark.parametrize("fmt", DIFF_FORMATS)
def test_videodiff(fmt):
    rng = np.random.default_rng(DIFF_FORMATS.index(fmt))
    n = WINDOW * N_WINDOWS
    frames = scene_frames(fmt, n, rng)
    jr, tr = run_steps("videodiff ! fakesink", fmt, frames, valid_mask(n, rng))
    jmsgs, tmsgs = assert_runs_equal(jr, tr)
    assert jmsgs == tmsgs == []


@pytest.mark.parametrize("fmt", SCENE_FORMATS)
def test_scenechange(fmt):
    """The SAD scores, the ring of five, the decision tree and the
    scenechange messages (cuts after a still scene post one each)."""
    rng = np.random.default_rng(10 + SCENE_FORMATS.index(fmt))
    n = WINDOW * N_WINDOWS
    frames = scene_frames(fmt, n, rng)
    valid = np.ones(n, bool)
    valid[[1, 4, 13]] = False
    jr, tr = run_steps("scenechange ! fakesink", fmt, frames, valid)
    jmsgs, tmsgs = assert_runs_equal(jr, tr)
    assert tmsgs == jmsgs
    assert len(tmsgs) >= 1
    assert all(m[1] == "scenechange" for m in tmsgs)


@pytest.mark.parametrize("fmt,props", [
    ("GRAY8", ""), ("I420", ""), ("I420", "luma-only=false"),
    ("GRAY8", "filter-size=1 tolerance=30"), ("I420", "active=false")])
def test_smooth(fmt, props):
    """The tolerance-gated window mean, its rows [r - fs, r + fs + 3) and
    its untouched last row; luma-only=false smooths u and v too."""
    rng = np.random.default_rng(20)
    n = WINDOW * 2
    frames = scene_frames(fmt, n, rng)
    jr, tr = run_steps(f"smooth {props} ! fakesink", fmt, frames,
                       np.ones(n, bool))
    assert_runs_equal(jr, tr)
    outs = tr[0]
    y = outs[0] if fmt == "GRAY8" else outs[0]["y"]
    src = frames if fmt == "GRAY8" else frames["y"]
    np.testing.assert_array_equal(y[:, H - 1], src[:WINDOW, H - 1])
    changed = (y != src[:WINDOW]).any()
    assert changed == ("active=false" not in props)


@pytest.mark.parametrize("desc,fmt", [("videodiff ! fakesink", "Y42B"),
                                      ("scenechange ! fakesink", "I420")])
def test_states_resume_from_the_jax_package(desc, fmt):
    """Two windows in JAX, its states carried into the port
    (Pipeline.load_states: videodiff's previous frame, scenechange's
    previous frame and ring of scores), then the rest in both."""
    rng = np.random.default_rng(30)
    n = WINDOW * N_WINDOWS
    frames = scene_frames(fmt, n, rng)
    jr, tr = run_steps(desc, fmt, frames, valid_mask(n, rng), carry_after=2)
    jmsgs, tmsgs = assert_runs_equal(jr, tr, first_window=2)
    from_window_2 = [m for m in jmsgs if m[2] >= 2 * WINDOW * 1000]
    assert tmsgs == from_window_2
