"""cvtracker (MOSSE) and grabcut of the port against the JAX package on
the CPU.  The port's CPU FFTs (ops/fft.py: scipy.fft with the last axis
first) equal XLA's fft2/ifft2 bit for bit, so MOSSE's boxes and PSR
decisions match: the tracker's frames and `object` messages are equal.
GrabCut's sums run in float64 and its 3x3 determinants and inverses by
cofactors (the JAX package: float32 in XLA's order, LAPACK's LU), which
holds the masks, the frames and the fg-pixels messages equal on these
inputs."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import grabcut as jgc
from gstbad_tpu_torch.ops import fft
from gstbad_tpu_torch.ops import grabcut as tgc
from helpers.torch_cv import assert_frames, assert_messages, host

torch.set_num_threads(1)


@pytest.mark.parametrize("h,w", [(50, 50), (20, 24), (37, 29)])
def test_fft2_and_ifft2_exact(h, w):
    x = np.random.default_rng(h).standard_normal((h, w)).astype(np.float32)
    a = np.asarray(jax.jit(jnp.fft.fft2)(x))
    b = fft.fft2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(fft.ifft2(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax.jit(jnp.fft.ifft2)(a)))


def _run(desc, n, window):
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        out.append((p.run(n_frames=n, window=window), p.bus))
    return out


def test_cvtracker_follows_the_ball():
    (jr, jb), (tr, tb) = _run(
        "videotestsrc pattern=ball width=96 height=72 format=RGB ! cvtracker "
        "object-initial-x=36 object-initial-y=24 object-initial-width=24 "
        "object-initial-height=24 ! fakesink", 10, 5)
    assert_frames(jr, tr)
    assert_messages(jb, tb)
    assert len(tb.messages) >= 5


GRABCUT = ("videotestsrc pattern=ball width=48 height=36 format=RGBA "
           "! grabcut test-mode=true bbox-x=10 bbox-y=8 bbox-width=20 "
           "bbox-height=14 ! fakesink")


def _op_inputs():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 60, (30, 40, 3)).astype(np.uint8)
    img[8:22, 12:30] = rng.integers(180, 255, (14, 18, 3))
    mask = np.asarray(jgc.init_mask_from_rect(30, 40, (9, 6, 24, 18)))
    return img, mask


@pytest.fixture(scope="module", autouse=True)
def jax_grabcut():
    """The JAX package's side of the two grabcut tests, each in a thread
    from the module's first test on: XLA compiles the element's window
    and the op (each most of half a minute) while the tests before run.
    -> {"element": () -> (outputs, bus), "op": () -> mask}."""
    out = {}

    def element():
        p = gt.parse_launch(GRABCUT)
        out["element"] = (p.run(n_frames=2, window=2), p.bus)

    def op():
        img, mask = _op_inputs()
        out["op"] = np.asarray(jgc.grabcut(jnp.asarray(img),
                                           jnp.asarray(mask)))

    threads = {k: threading.Thread(target=f)
               for k, f in (("element", element), ("op", op))}
    for th in threads.values():
        th.start()

    def result(key):
        threads[key].join()
        return out[key]

    yield {k: (lambda k=k: result(k)) for k in threads}
    for th in threads.values():
        th.join()


def test_grabcut_element(jax_grabcut):
    jr, jb = jax_grabcut["element"]()
    p = gtt.parse_launch(GRABCUT, device="cpu")
    tr, tb = p.run(n_frames=2, window=2), p.bus
    assert len(jr) == len(tr) > 0
    assert_frames(jr, tr)
    assert len(jb.messages) == len(tb.messages) > 0
    assert_messages(jb, tb)


def test_grabcut_op_masks(jax_grabcut):
    img, mask = _op_inputs()
    a = jax_grabcut["op"]()
    b = tgc.grabcut(torch.from_numpy(img), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(b, a)
