"""gaussianblur in gstbad_tpu_torch against gstbad_tpu on the CPU: the
carried tables, the words blur (the plain form of kernel K3) against the
Pallas kernel in interpret mode and against the XLA blur, and the element
through both parse_launches.

Tolerance: bit exact against the Pallas kernel, which keeps the C's
float32 operation order (taps k = 0 .. 2c as product then sum, the border
sum division, +0.5, clamp, truncation), as the port does.  Against the JAX
package's XLA blur (ops/blur.py:gaussian_blur) the JAX package's own
tolerance holds: at most 1 LSB, on under 1% of the bytes
(tests/test_gaudieffects.py:77-80), because XLA may order that float
arithmetic differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.ops import blur as jblur
from gstbad_tpu.ops import blur_pallas
from gstbad_tpu_torch.ops import blur as tblur
from test_torch_parity import assert_same, run_both

torch.set_num_threads(1)   # parallel test workers share the cores


def _words(img):
    return np.ascontiguousarray(img).view("<i4")[..., 0]


def _img(rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[0, 0, 0] = 0            # the all-0 and all-255 edge pixels
    img[0, 0, 1] = 255
    return img


@pytest.mark.parametrize("sigma", [1.2, 0.5, 3.0, 8.0, -2.0])
def test_blur_tables_equal_the_jax_package(sigma):
    """make_blur_tables (kernel, row and column border sums) carried over
    bit for bit, float32 steps included."""
    got = tblur.make_blur_tables(sigma, 37, 53)
    want = jblur.make_blur_tables(sigma, 37, 53)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sigma", [1.2, 0.5, 3.0, -2.0])
def test_words_plain_matches_pallas_kernel(sigma):
    rng = np.random.default_rng(21)
    b, h, w = 2, 32, 128
    words = _words(_img(rng, (b, h, w, 4)))
    tables = tblur.make_blur_tables(sigma, h, w)
    want = np.asarray(blur_pallas.gaussian_blur_words(
        jnp.asarray(words), *tables, interpret=True))
    got = tblur.gaussian_blur_words(torch.from_numpy(words), *tables)
    np.testing.assert_array_equal(got.numpy(), want)
    # a [1, H, W] broadcast base with batch=3: every frame is frame 0's blur
    base = np.asarray(blur_pallas.gaussian_blur_words(
        jnp.asarray(words[:1]), *tables, batch=3, interpret=True))
    got = tblur.gaussian_blur_words(torch.from_numpy(words[:1]), *tables,
                                    batch=3)
    assert got.shape == (3, h, w) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), base)
    np.testing.assert_array_equal(got.numpy(), np.repeat(want[:1], 3, 0))


@pytest.mark.parametrize("sigma", [1.2, 0.5, 4.0, -2.0, 8.0])
def test_words_plain_matches_xla_blur(sigma):
    """A ragged 24x31 frame and a 41-tap window (sigma 8): within 1 LSB on
    under 1% of the bytes (see the module doc)."""
    rng = np.random.default_rng(22)
    img = _img(rng, (2, 24, 31, 4))
    tables = tblur.make_blur_tables(sigma, 24, 31)
    want = np.asarray(jblur.gaussian_blur(
        jnp.asarray(img), *(jnp.asarray(t) for t in tables)))
    got = tblur.gaussian_blur_words(torch.from_numpy(_words(img)), *tables)
    got = got.numpy().view(np.uint8).reshape(img.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("sigma,h,w,kind", [
    (1.0, 2, 3, "black"), (-3.7, 9, 10, "black"), (0.3, 1, 1, "black"),
    (1.0, 2, 3, "mixed"), (-3.7, 9, 10, "mixed")])
def test_words_blur_on_frames_narrower_than_the_window(sigma, h, w, kind):
    """Frames narrower than the window have border sums of 0 (and below):
    a black pixel there is 0/0 = NaN, which must cast to the word 0 as in
    the XLA blur, and a lit one is ±inf, which the clamp takes to 255 or
    0.  Word for word at the positions whose row or column sum is 0, and
    within the module's tolerance elsewhere; on black frames every word
    is 0."""
    rng = np.random.default_rng(24)
    img = np.zeros((2, h, w, 4), np.uint8)
    if kind == "mixed":     # half the pixels lit, half black
        img = rng.integers(0, 256, img.shape, dtype=np.uint8)
        img[rng.random((2, h, w)) < 0.5] = 0
    tables = tblur.make_blur_tables(sigma, h, w)
    zero = (tables[1][:, None] == 0) | (tables[2][None, :] == 0)
    assert zero.any()
    want = np.asarray(jblur.gaussian_blur(
        jnp.asarray(img), *(jnp.asarray(t) for t in tables)))
    got = tblur.gaussian_blur_words(torch.from_numpy(_words(img)), *tables)
    np.testing.assert_array_equal(got.numpy()[:, zero], _words(want)[:, zero])
    if kind == "black":
        assert not got.numpy().any()
    got = got.numpy().view(np.uint8).reshape(img.shape)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 0.01


def test_byte_blur_equals_words_blur():
    """gaussian_blur on [B, H, W, 4] bytes is the words blur, byte for
    byte."""
    rng = np.random.default_rng(23)
    img = _img(rng, (2, 19, 45, 4))
    tables = tblur.make_blur_tables(-1.5, 19, 45)
    got = tblur.gaussian_blur(torch.from_numpy(img), *tables)
    words = tblur.gaussian_blur_words(torch.from_numpy(_words(img)), *tables)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), words.numpy().view(np.uint8).reshape(img.shape))


def test_words_blur_refuses_bad_input():
    tables = tblur.make_blur_tables(1.2, 8, 16)
    with pytest.raises(ValueError, match="int32"):
        tblur.gaussian_blur_words(torch.zeros((2, 8, 16), dtype=torch.int64),
                                  *tables)
    with pytest.raises(ValueError, match="source frames"):
        tblur.gaussian_blur_words(torch.zeros((2, 8, 16), dtype=torch.int32),
                                  *tables, batch=3)
    with pytest.raises(ValueError, match="tables"):
        tblur.gaussian_blur_words(torch.zeros((2, 8, 17), dtype=torch.int32),
                                  *tables)
    assert tblur.gaussian_blur_words.launches == 0


@pytest.fixture
def pallas_blur(monkeypatch):
    """The JAX element's one-pass Pallas path, in interpret mode (the JAX
    package's own switch, tests/test_gaudieffects.py)."""
    monkeypatch.setattr(blur_pallas, "INTERPRET", True)


@pytest.mark.parametrize("sigma,pattern", [(1.2, "bars"), (1.2, "ball"),
                                           (-2.0, "bars"), (0.0, "ball")])
def test_gaussianblur_through_both_launches(pallas_blur, sigma, pattern):
    """videotestsrc AYUV ! gaussianblur through both parse_launches (the
    static bars take the broadcast base, the ball a materialized window);
    sigma 0 passes the frames through."""
    desc = (f"videotestsrc pattern={pattern} width=128 height=24 "
            f"format=AYUV ! gaussianblur sigma={sigma} ! fakesink")
    jr, tr = run_both(desc, window=3, n_frames=6)
    assert_same(jr, tr)
    if sigma == 0.0:
        src = run_both(desc.replace(f"gaussianblur sigma={sigma} ! ", ""),
                       window=3, n_frames=6)[1]
        for a, b in zip(tr[0], src[0]):
            np.testing.assert_array_equal(a.data, b.data)
