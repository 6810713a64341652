"""Pipeline behaviour beyond the static graphs, gstbad_tpu vs
gstbad_tpu_torch on the CPU: controllable per-frame params, state carried
from a JAX run into the port, and debug taps.  Bit exact (see
tests/test_torch_parity.py for the harness)."""

import numpy as np
import pytest
import torch

import jax

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.frame import FrameBatch, tensors_from_numpy
from gstbad_tpu_torch.core.spec import MediaSpec
from test_torch_parity import (GRAPHS, assert_same, ball_exempt, run_both,
                               source)

torch.set_num_threads(1)   # parallel test workers share the cores


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (4, 24, 128, 4), dtype=np.uint8)


def _controls(p):
    """Per-frame curves on solarize, exclusion and zebrastripe
    (tests/test_tablefuse.py's controllable case): [B, 256] tables all
    through the fused chain."""
    for el in p.elements:
        if el.NAME == "solarize":
            el.set_control("threshold", lambda pts: 60 + (pts // 33333333) % 80)
        if el.NAME == "exclusion":
            el.set_control("factor", lambda pts: 100 + (pts // 33333333) % 60)
        if el.NAME == "zebrastripe":
            el.set_control("threshold", lambda pts: 40 + (pts // 33333333) % 50)


@pytest.mark.parametrize("fuse", [True, False])
def test_per_frame_controllable_params(img, fuse):
    jr, tr = run_both(GRAPHS["headline"], fuse=fuse, controls=_controls,
                      img=img)
    assert_same(jr, tr)


@pytest.mark.parametrize("fuse", [True, False])
def test_controllable_params_on_source(fuse):
    """Controls on a source-driven graph: the runner derives pts from its
    frame counter, so the curves advance across windows."""
    jr, tr = run_both(source("bars", 64, 16) + GRAPHS["headline"],
                      fuse=fuse, controls=_controls)
    assert_same(jr, tr)


def test_states_carried_from_jax_run():
    """One window in JAX, its params and states carried into the port
    (tensors_from_numpy / Pipeline.load_states), then the next window in
    both: same frames, same states (the ball's int64 frame counter and the
    zebrastripe phase)."""
    desc = source("ball", 200, 18) + GRAPHS["headline"]
    pj = gt.parse_launch(desc)
    pj.negotiate()
    step_j = pj.compile(4)
    params_j = pj.params()
    states_j, _, _ = step_j(params_j, pj.init_states(4), None)
    carried = jax.tree_util.tree_map(np.asarray, states_j)
    carried_params = jax.tree_util.tree_map(np.asarray, params_j)
    states_j, leaves_j, _ = step_j(params_j, states_j, None)

    pt = gtt.parse_launch(desc, device="cpu")
    pt.negotiate()
    step_t = pt.compile(4)
    params_t = tensors_from_numpy(carried_params, "cpu")
    own = pt.params()
    for a, b in zip(params_t, own):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].item() == b[k].item()
    pt.load_states(carried)
    assert pt._states[0].dtype == torch.int64 and int(pt._states[0]) == 4
    states_t, leaves_t, _ = step_t(params_t, pt._states, None)

    want = np.asarray(leaves_j[0].data)
    got = leaves_t[0].data.numpy().view(np.uint8).reshape(want.shape)
    exempt = ball_exempt(200, 18, 4, start=4)
    np.testing.assert_array_equal(got[~exempt], want[~exempt])
    np.testing.assert_array_equal(leaves_t[0].pts.numpy(),
                                  np.asarray(leaves_j[0].pts))
    for a, b in zip(jax.tree_util.tree_leaves(states_j),
                    jax.tree_util.tree_leaves(states_t)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_taps_see_interior_nodes(img):
    """A tap on an interior node breaks the chain there and shows that
    node's own output, in both packages."""
    import jax.numpy as jnp
    from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
    from gstbad_tpu.core.spec import MediaSpec as JMediaSpec

    desc = ("coloreffects preset=sepia name=ce ! solarize "
            "! exclusion name=ex ! dilate ! fakesink")
    taps = []
    for pkg, spec_cls, fb_cls, to_dev, kw in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray, {}),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy,
             {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.negotiate(spec_cls(kind="video", format="BGRx", width=img.shape[2],
                             height=img.shape[1]))
        step = p.compile(img.shape[0], taps=["ex", "ce"])
        _, leaves, _ = step(p.params(), p.init_states(img.shape[0]),
                            fb_cls.make(to_dev(img.copy())))
        taps.append({k: np.asarray(v.data) for k, v in
                     p.taps_of(leaves).items()})
    assert sorted(taps[0]) == sorted(taps[1]) == ["ce", "ex"]
    for k in taps[0]:
        np.testing.assert_array_equal(taps[1][k], taps[0][k])
