"""The port's stereo ops (gstbad_tpu_torch/ops/stereo.py) and the
disparity element against the JAX package on the CPU: the XSobel
prefilter, StereoBM, SGM (its 8 path aggregations are the plain walk of
the H3 kernel here) and the min-max normalisation are bit exact, and so
are the element's frames in both methods.  The pair is a seeded texture
and the same texture shifted by a known disparity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import stereo as jst
from gstbad_tpu_torch.ops import stereo as tst
from helpers.torch_cv import assert_frames

torch.set_num_threads(1)


def _pair(h, w, shift, seed=0):
    tex = np.random.default_rng(seed).integers(0, 256, (h, w + 24)
                                               ).astype(np.uint8)
    return tex[:, 12:12 + w].copy(), tex[:, 12 + shift:12 + shift + w].copy()


def test_prefilter_exact():
    left, _ = _pair(30, 50, 0)
    np.testing.assert_array_equal(
        tst.prefilter_xsobel(torch.from_numpy(left)).numpy(),
        np.asarray(jst.prefilter_xsobel(jnp.asarray(left))))


@pytest.mark.parametrize("h,w,shift", [(40, 96, 4), (33, 71, 9)])
def test_stereo_bm_exact(h, w, shift):
    left, right = _pair(h, w, shift, seed=h)
    a = np.asarray(jst.stereo_bm(jnp.asarray(left), jnp.asarray(right)))
    b = tst.stereo_bm(torch.from_numpy(left)[None],
                      torch.from_numpy(right)[None])[0].numpy()
    np.testing.assert_array_equal(b, a)


def test_stereo_sgm_exact():
    left, right = _pair(40, 96, 5, seed=7)
    a = np.asarray(jst.stereo_sgm(jnp.asarray(left), jnp.asarray(right)))
    b = tst.stereo_sgm(torch.from_numpy(left)[None],
                       torch.from_numpy(right)[None])
    np.testing.assert_array_equal(b[0].numpy(), a)
    na = np.asarray(jst.normalize_minmax_u8(jnp.asarray(a)))
    np.testing.assert_array_equal(tst.normalize_minmax_u8(b)[0].numpy(), na)


def test_sgm_passes_sum_to_the_total():
    """Each pass's walk starts from the line's first cost and stays in
    [C, C + P2]: the 8 passes' total is an integer volume."""
    left, right = _pair(20, 80, 3, seed=2)
    cost = tst.sgm_cost(torch.from_numpy(left)[None],
                        torch.from_numpy(right)[None])
    for axis, rev, shear in tst.SGM_PASSES:
        agg = tst.sgm_aggregate(cost, torch.zeros_like(cost), axis, rev,
                                shear, 200, 255)
        assert bool((agg >= cost).all() and (agg <= cost + 255).all())
        assert bool((agg == torch.round(agg)).all())


@pytest.mark.parametrize("method", ["sbm", "sgbm"])
def test_disparity_element(method):
    left, right = _pair(36, 88, 6, seed=5)
    frames = [np.repeat(x[None, ..., None], 3, -1).repeat(2, 0)
              for x in (left, right)]
    desc = ("appsrc name=l format=RGB width=88 height=36 ! d.  "
            "appsrc name=r format=RGB width=88 height=36 ! d.  "
            f"disparity name=d method={method} ! fakesink")
    res = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.get_by_name("l").push_frames(frames[0])
        p.get_by_name("r").push_frames(frames[1])
        res.append(p.run(window=2))
    assert_frames(*res)
