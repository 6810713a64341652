"""gstbad_tpu_torch.ops.cv and the remap additions of ops.remap against
gstbad_tpu's on the CPU, on the same seeded numpy inputs at small sizes.

Tolerances: every u8 op bit exact (the integer paths by construction;
bilateral and retinex, float32 paths, are exact here too); matchTemplate's
scores within 1e-5 of the largest score of the map (float32 convolutions
sum in another order); the host maps of cameraundistort and dewarp bit
exact (the same numpy code)."""

import numpy as np
import pytest
import torch

from gstbad_tpu.ops import cv as jcv
from gstbad_tpu.ops import remap as jremap
from gstbad_tpu_torch.ops import cv as tcv
from gstbad_tpu_torch.ops import remap as tremap
from helpers.torch_cv import assert_exact, jax_and_torch

H, W = 23, 31     # odd sizes: the borders of both passes are exercised


@pytest.fixture
def rgb():
    return np.random.default_rng(10).integers(0, 256, (2, H, W, 3),
                                              dtype=np.uint8)


@pytest.fixture
def gray(rgb):
    # smooth regions and edges, so Canny's hysteresis has chains to grow
    yy, xx = np.mgrid[:H, :W]
    base = ((xx * 9 + yy * 4) % 256).astype(np.int32)
    disk = ((yy - 11) ** 2 + (xx - 15) ** 2 < 49) * 120
    return np.clip(base + disk + rgb[..., 0] // 16, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("n,p,mode", [(5, 2, "reflect"), (3, 7, "reflect"),
                                      (1, 4, "reflect"), (2, 5, "reflect"),
                                      (4, 6, "edge")])
def test_border_index_is_numpys_pad(n, p, mode):
    got = tcv._border_index(n, p, mode, "cpu").numpy()
    np.testing.assert_array_equal(got, np.pad(np.arange(n), p, mode=mode))


@pytest.mark.parametrize("op,args", [
    ("rgb2gray_u8", ()), ("rgb2hsv_u8", ()), ("pyr_down_u8", ()),
    ("box_blur_u8", (5, 3)), ("box_blur_u8", (1, 7)),
    ("gaussian_blur_u8", (5, 7, 0.0)), ("gaussian_blur_u8", (9, 0, 2.3)),
    ("median_blur_u8", (1,)), ("median_blur_u8", (3,)),
    ("median_blur_u8", (5,)), ("median_blur_u8", (7,)),
    ("dilate_u8", (1,)), ("dilate_u8", (3,)), ("erode_u8", (1,)),
    ("erode_u8", (3,)), ("bilateral_u8", (30.0, 0.0)),
    ("bilateral_u8", (10.0, 3.0)),
    ("retinex_basic", (14.0, 128, 128)), ("retinex_basic", (3.0, 64, 100)),
    ("retinex_multiscale", (3, 128, 128)),
    ("retinex_multiscale", (1, 200, 90)),
])
def test_rgb_ops_exact(rgb, op, args):
    a, b = jax_and_torch(lambda x: getattr(jcv, op)(x, *args),
                         lambda x: getattr(tcv, op)(x, *args), rgb)
    assert_exact(a, b, op)


@pytest.mark.parametrize("op,args", [
    ("median_blur_u8", (4,)), ("median_blur_u8", (9,)),
    ("box_blur_u8", (4, 2)), ("box_blur_u8", (15, 15)),
    ("gaussian_blur_u8", (4, 6, 0.0)), ("gaussian_blur_u8", (11, 11, 0.0)),
    ("bilateral_u8", (5.0, 4.0))])
def test_even_and_oversized_kernels_exact(op, args):
    # even widths, and borders wider than the 9x13 frame (reflected again)
    img = np.random.default_rng(1).integers(0, 256, (2, 9, 13, 3),
                                            dtype=np.uint8)
    a, b = jax_and_torch(lambda x: getattr(jcv, op)(x, *args),
                         lambda x: getattr(tcv, op)(x, *args), img)
    assert_exact(a, b, op)


def test_retinex_black_regions_cast_like_the_jax_package(rgb):
    # log(0) - log(0) is NaN: both packages' cast gives 0 there
    img = rgb.copy()
    img[:, 4:20, 3:25] = 0
    for fn in ("retinex_basic", "retinex_multiscale"):
        args = (2.0, 128, 128) if fn == "retinex_basic" else (2, 128, 128)
        a, b = jax_and_torch(lambda x: getattr(jcv, fn)(x, *args),
                             lambda x: getattr(tcv, fn)(x, *args), img)
        assert_exact(a, b, fn)


@pytest.mark.parametrize("dx,dy,k", [(1, 0, 1), (0, 1, 3), (1, 1, 3),
                                     (2, 0, 5), (1, 2, 7), (0, 2, 7)])
def test_sobel_exact(gray, dx, dy, k):
    a, b = jax_and_torch(lambda x: jcv.sobel_u8(x, dx, dy, k),
                         lambda x: tcv.sobel_u8(x, dx, dy, k), gray)
    assert_exact(a, b)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_laplacian_exact(gray, k):
    a, b = jax_and_torch(lambda x: jcv.laplacian_i16(x, k),
                         lambda x: tcv.laplacian_i16(x, k), gray)
    assert_exact(a, b)


@pytest.mark.parametrize("t1,t2,ap", [(50, 150, 3), (150, 50, 3),
                                      (100, 400, 5), (800, 2500, 7),
                                      (10, 30, 3)])
def test_canny_exact(gray, t1, t2, ap):
    a, b = jax_and_torch(lambda x: jcv.canny_u8(x, t1, t2, ap),
                         lambda x: tcv.canny_u8(x, t1, t2, ap), gray)
    assert_exact(a, b)
    assert 0 < (b > 0).mean() < 0.5


@pytest.mark.parametrize("length", [40, 70, 160])
def test_canny_hysteresis_cap(length):
    # a weak edge along one row (|gy| 100, between the thresholds), strong
    # only where the step meets the bright start: both packages grow it
    # one pixel a step and stop after HYSTERESIS_CAP steps, so a chain
    # longer than the cap ends at the same column in both
    img = np.zeros((1, 8, length), np.uint8)
    img[0, 4:, :] = 25
    img[0, 4:, :2] = 255
    a, b = jax_and_torch(lambda x: jcv.canny_u8(x, 50, 150, 3),
                         lambda x: tcv.canny_u8(x, 50, 150, 3), img)
    assert_exact(a, b, length)
    reach = int(np.nonzero(b[0].any(axis=0))[0].max()) + 1
    assert reach == min(length, tcv.HYSTERESIS_CAP + 3), reach


def test_equalize_hist_exact(gray):
    frames = np.stack([gray[0], gray[1] // 4 + 100,
                       np.full((H, W), 77, np.uint8),   # constant frame
                       np.where(gray[0] > 128, 255, 0).astype(np.uint8)])
    a, b = jax_and_torch(jcv.equalize_hist_u8, tcv.equalize_hist_u8, frames)
    assert_exact(a, b)
    np.testing.assert_array_equal(b[2], frames[2])


def test_hsv_over_every_colour_class():
    # all 4096 colours on a 16-level grid plus every grey and pure hue
    lv = np.arange(0, 256, 17, dtype=np.uint8)
    grid = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(
        1, 64, 64, 3)
    a, b = jax_and_torch(jcv.rgb2hsv_u8, tcv.rgb2hsv_u8, grid)
    assert_exact(a, b)


def test_thresholds_exact(gray):
    a, b = jax_and_torch(
        lambda x: jcv.adaptive_threshold_gaussian_inv(x, 7, 5),
        lambda x: tcv.adaptive_threshold_gaussian_inv(x, 7, 5), gray)
    assert_exact(a, b)
    for inv in (False, True):
        a, b = jax_and_torch(
            lambda x: jcv.threshold_binary(x, 100, inverse=inv),
            lambda x: tcv.threshold_binary(x, 100, inverse=inv), gray)
        assert_exact(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 9, 25, 49, 81])
def test_median_network_selects_the_median(n):
    # the pruned network against numpy's sort on random and tied columns
    rng = np.random.default_rng(n)
    cols = np.concatenate([rng.integers(0, 256, (500, n)),
                           rng.integers(0, 3, (500, n))]).astype(np.uint8)
    wires = [torch.from_numpy(cols[:, i].copy()) for i in range(n)]
    for lo, hi, keep_min, keep_max in tcv.median_network(n):
        a, b = wires[lo], wires[hi]
        if keep_min:
            wires[lo] = torch.minimum(a, b)
        if keep_max:
            wires[hi] = torch.maximum(a, b)
    np.testing.assert_array_equal(wires[n // 2].numpy(),
                                  np.sort(cols, axis=1)[:, n // 2])


@pytest.mark.parametrize("method", ["ccorr", "sqdiff", "ccorr_normed",
                                    "sqdiff_normed", "ccoeff",
                                    "ccoeff_normed"])
def test_match_template_within_rtol(rgb, method):
    templ = rgb[0, 5:12, 8:18].copy()
    a, b = jax_and_torch(lambda x, t: jcv.match_template(x, t, method),
                         lambda x, t: tcv.match_template(x, t, method),
                         rgb, templ)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    for fa, fb in zip(a, b):
        np.testing.assert_allclose(fb, fa, rtol=0,
                                   atol=1e-5 * np.abs(fa).max())


@pytest.mark.parametrize("span", ["inside", "straddling"])
def test_remap_bilinear_exact(rgb, span):
    # the port's two steps (host taps, device gathers) against the JAX
    # package's remap_bilinear, with maps inside the frame or running off it
    rng = np.random.default_rng(4)
    lo, scale = (0.0, 1.0) if span == "inside" else (-0.15, 1.3)
    h, w = rgb.shape[1], rgb.shape[2]
    mx = ((rng.random((19, 27)) * scale + lo) * (w - 1)).astype(np.float32)
    my = ((rng.random((19, 27)) * scale + lo) * (h - 1)).astype(np.float32)

    def port(x):
        flat, wts = tremap.bilinear_taps(mx, my, h, w)
        return tremap.remap_taps(x, torch.from_numpy(flat),
                                 torch.from_numpy(wts), mx.shape)

    a, b = jax_and_torch(lambda x: jremap.remap_bilinear(x, mx, my), port,
                         rgb)
    assert_exact(a, b)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_undistort_maps_bit_equal(alpha):
    K = np.array([[140.0, 0, 96], [0, 140, 54], [0, 0, 1]])
    dist = [-0.30, 0.10, 0.001, 0.0005, -0.02]
    size = (192, 108)
    nk_j = jremap.get_optimal_new_camera_matrix(K, dist, size, alpha)
    nk_t = tremap.get_optimal_new_camera_matrix(K, dist, size, alpha)
    np.testing.assert_array_equal(nk_t, nk_j)
    for a, b in zip(jremap.init_undistort_map(K, dist, nk_j, size),
                    tremap.init_undistort_map(K, dist, nk_t, size)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jremap._get_rectangles(K, dist, size),
                    tremap._get_rectangles(K, dist, size)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_dewarp_map_bit_equal():
    args = (192, 108, 200, 48, 0.5, 0.5, 0.05, 0.28, 1.0, 1.2)
    for a, b in zip(jremap.dewarp_map(*args), tremap.dewarp_map(*args)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
