"""segmentation of the port against the JAX package on the CPU: mog2,
mog and codebook (past its 30 learning frames), in test-mode (the mask
in every channel), mask-to-alpha and the reference's passthrough, over
two windows so the models carry.  Bit exact: the masks, and the MOG2
state after the run.  The input is a seeded background with noise and a
moving block."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.ops import segmentation as jseg
from gstbad_tpu_torch.ops import segmentation as tseg
from helpers.torch_cv import assert_frames, push_both

torch.set_num_threads(1)


def _frames(t, h=24, w=32):
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    fr = np.repeat(base[None], t, 0).astype(int)
    for i in range(t):
        y, x = 3 + i % (h - 10), 2 + (2 * i) % (w - 12)
        fr[i, y:y + 7, x:x + 8, :3] = [250, 30, 30]
    fr += rng.integers(-3, 4, fr.shape)
    return np.clip(fr, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("method,props", [
    ("mog2", {"test-mode": True, "learning-rate": 0.2}),
    ("mog2", {"mask-to-alpha": True}),
    ("mog", {"test-mode": True, "learning-rate": 0.1}),
    ("mog2", {})])
def test_segmentation_element(method, props):
    fr = _frames(8)
    (jr, _), (tr, _) = push_both("segmentation", "RGBA", [fr[:4], fr[4:]],
                                 {"method": method, **props})
    assert_frames(jr, tr)


def test_codebook_after_learning():
    fr = _frames(36, 16, 20)
    fr[32:, 2:8, 2:8, :3] = [20, 240, 20]       # a colour never learned
    (jr, _), (tr, _) = push_both("segmentation", "RGBA",
                                 [fr[:18], fr[18:]],
                                 {"method": "codebook", "test-mode": True,
                                  "learning-rate": 0.25})
    assert_frames(jr, tr)
    assert (tr[-1].data != 0).any()


def test_mog2_state_exact():
    fr = _frames(6)
    ycc = np.asarray(jseg.rgb2ycrcb_u8(jnp.asarray(fr[..., :3])))
    sj = jseg.mog2_new_state(24, 32)
    st = tseg.mog2_new_state(24, 32)
    for t in range(6):
        sj, mj = jseg.mog2_frame(sj, jnp.asarray(ycc[t]), 0.3)
        st, mt = tseg.mog2_frame(st, torch.from_numpy(ycc[t].copy()), 0.3)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    for k in sj:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]), k)
