"""The telecine path's ops in the port against gstbad_tpu, on the CPU:
the plain forms of kernels 4, 5 and 6 (fieldanalysis default metrics,
comb pair scores, comb mask) against the JAX Pallas kernels in interpret
mode and against the JAX XLA forms, and the other fieldanalysis metrics,
the ivtc reconstruction and the SSIM oracle.

Tolerance: bit exact, except SSIM, which agrees to 1e-12 absolute in
float64 (the mean over windows may sum in another order).  The JAX side
runs under jax.jit, as the JAX package's pipeline does: XLA then turns
the metrics' division by a float32 constant into a product with its
reciprocal, which the port does too (an eager JAX division can differ in
the last bit).  Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gstbad_tpu.ops import comb as jcomb
from gstbad_tpu.ops import fieldanalysis as jfa
from gstbad_tpu.ops import ivtc as jivtc
from gstbad_tpu.ops import ssim as jssim
from gstbad_tpu_torch.ops import comb, fieldanalysis as fa, ivtc, ssim

torch.set_num_threads(1)   # parallel test workers share the cores

# ragged widths (not multiples of 4, 32 or 128) and row counts that are
# not multiples of 16
METRIC_SHAPES = [(4, 48, 64), (3, 50, 66), (5, 8, 4), (2, 42, 130)]
PAIR_CFGS = [(12, 48, 64, 11), (6, 50, 130, 40), (5, 22, 37, 33)]


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _mixed_frames(rng, shape):
    """Half smooth frames (few outliers, low comb scores), half noise, so
    every branch of the chain and the comb thresholds is taken."""
    b, h, w = shape
    yy, xx = np.mgrid[:h, :w]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.int64)
    out = _u8(rng, shape)
    for i in range(0, b, 2):
        noise = rng.integers(-3, 4, (h, w))
        out[i] = np.clip(smooth + noise, 0, 255).astype(np.uint8)
    return out


def _metrics_port_and_jax(shape, nf):
    """metrics_default on a pool of random frames (one close to its
    predecessor) through the port and the JAX package's Pallas kernel
    (interpret mode) and vmapped XLA metrics, all under jax.jit."""
    b, h, w = shape
    rng = np.random.default_rng(1)
    pool = _u8(rng, (b + 1, h, w))
    pool[2] = pool[1] // 2 + 60     # a frame close to its predecessor
    cur = np.arange(1, b + 1, dtype=np.int32)
    prev = np.maximum(cur - 1 - (np.arange(b) % 2), 0).astype(np.int32)
    got = fa.metrics_default(torch.from_numpy(pool), torch.from_numpy(cur),
                             torch.from_numpy(prev), torch.tensor(nf))
    jy, jp = jnp.asarray(pool[cur]), jnp.asarray(pool[prev])
    pallas = jax.jit(lambda y, p: jfa.metrics_default(
        y, p, jnp.int32(nf), interpret=True))(jy, jp)

    def ref(yi, pi):
        z, o, n = jnp.int32(0), jnp.int32(1), jnp.int32(nf)
        return (jfa.opposite_parity_5_tap(yi, z, yi, n),
                jfa.same_parity_ssd(yi, z, pi, z, n),
                jfa.same_parity_ssd(yi, o, pi, o, n),
                jfa.opposite_parity_5_tap(yi, z, pi, n),
                jfa.opposite_parity_5_tap(yi, o, pi, n))

    xla = jax.jit(jax.vmap(ref))(jy, jp)
    return got, pallas, xla


# the main path's noise floor 16 on each of METRIC_SHAPES (ids shape0..),
# then the gates' edges at a width that is not a multiple of 4 or 16
# (ids nf..): every pixel kept (0, -1), nf = 1, the ssd's nf^2 at and past
# the largest square (255, 256), and nf^2 or 6 nf past int32, where both
# packages take the wrapped product (46341 and -46341: nf^2 < 0, every
# square kept; 2^31 - 1: nf^2 = 1; 357913942: 6 nf < 0, every tap kept)
METRIC_CASES = ([pytest.param(shape, 16, id=f"shape{i}")
                 for i, shape in enumerate(METRIC_SHAPES)]
                + [pytest.param((3, 10, 38), nf, id=f"nf{nf}")
                   for nf in (0, 1, 255, 256, -1, 46341, -46341,
                              2**31 - 1, 357913942)])


@pytest.mark.parametrize("shape,nf", METRIC_CASES)
def test_metrics_default_plain_equals_pallas_and_xla(shape, nf):
    got, pallas, xla = _metrics_port_and_jax(shape, nf)
    for name, g, p, x in zip(["f", "t", "b", "t_b", "b_t"], got, pallas,
                             xla):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), name)


@pytest.mark.parametrize("metric", ["sad", "3-tap", "windowed-comb"])
def test_other_metrics_equal_jax(metric):
    rng = np.random.default_rng(2)
    y = _mixed_frames(rng, (4, 48, 66))
    p = _mixed_frames(rng, (4, 48, 66))
    ty, tp = torch.from_numpy(y), torch.from_numpy(p)
    nf = 16
    for p0, p1 in ((0, 0), (1, 1), (0, 1)):
        if metric == "sad":
            got = fa.same_parity_sad(ty, p0, tp, p1, nf)
            fn = lambda a, b: jfa.same_parity_sad(  # noqa: E731
                a, jnp.int32(p0), b, jnp.int32(p1), jnp.int32(nf))
        elif metric == "3-tap":
            got = fa.same_parity_3_tap(ty, p0, tp, p1, nf)
            fn = lambda a, b: jfa.same_parity_3_tap(  # noqa: E731
                a, jnp.int32(p0), b, jnp.int32(p1), jnp.int32(nf))
        else:
            args = (9, 16, 16, 80, 2, p1 == 1)
            got = fa.windowed_comb(ty, p0, tp, *args)
            fn = lambda a, b: jfa.windowed_comb(  # noqa: E731
                a, jnp.int32(p0), b, *args)
        want = jax.jit(jax.vmap(fn))(jnp.asarray(y), jnp.asarray(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", PAIR_CFGS)
def test_comb_score_pairs_plain_equals_pallas_and_xla(cfg):
    pcount, h, w, n = cfg
    rng = np.random.default_rng(3)
    pool = _mixed_frames(rng, (pcount, h, w))
    ti = rng.integers(0, pcount, n).astype(np.int32)
    bi = rng.integers(0, pcount, n).astype(np.int32)
    got = comb.comb_score_pairs(torch.from_numpy(pool), torch.from_numpy(ti),
                                torch.from_numpy(bi))
    assert got.dtype == torch.int32
    args = (jnp.asarray(pool), jnp.asarray(ti), jnp.asarray(bi))
    xla = jcomb.comb_score_pairs(*args, engine="xla")
    pallas = jcomb.comb_score_pairs(*args, engine="pallas", chunk=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    assert got.numpy().min() < 100 < got.numpy().max()  # both branches
    top, bot = pool[ti], pool[bi]
    np.testing.assert_array_equal(
        comb.comb_score(torch.from_numpy(top), torch.from_numpy(bot)),
        np.asarray(jcomb.comb_score(jnp.asarray(top), jnp.asarray(bot))))


@pytest.mark.parametrize("shape", [(3, 37, 150), (2, 50, 130), (1, 6, 9)])
def test_comb_mask_plain_equals_pallas_and_xla(shape):
    rng = np.random.default_rng(4)
    luma = _mixed_frames(rng, shape)
    mask, score = comb.comb_mask(torch.from_numpy(luma))
    for engine in ("xla", "pallas"):
        jm, js = jcomb.comb_mask(jnp.asarray(luma), engine=engine)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(score.numpy(), np.asarray(js))


def test_scan_rows_equals_pallas_chain_and_c_recurrence():
    """The plain chain against the Pallas chain kernel (interpret mode) on
    ragged masks, and against the C recurrence written out."""
    rng = np.random.default_rng(11)
    for shape in ((37, 150), (2, 61, 300)):
        m = rng.random(shape) < 0.35
        got = comb._scan_rows(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jcomb._scan_rows_pallas(jnp.asarray(m),
                                                    interpret=True)))
    m = rng.random((50, 200)) < 0.5
    t = np.zeros(200, np.int64)
    want = np.zeros_like(m)
    for r in range(m.shape[0]):
        for i in range(m.shape[1]):
            if m[r, i]:
                t[i] = min(t[i] + (t[i - 1] if i else 0) + 1, 1000)
            else:
                t[i] = 0
            want[r, i] = t[i] > 100
    np.testing.assert_array_equal(comb._scan_rows(torch.from_numpy(m)),
                                  want)


def _weave(n, h, w):
    """Frames whose rows alternate 0 and 255, so that every cell of the
    band is an outlier; the odd frames inverted, so that a pair of frames
    of one parity weaves to the same and of two parities to a flat
    frame."""
    f = np.zeros((n, h, w), np.uint8)
    f[:, 1::2] = 255
    f[1::2] = 255 - f[1::2]
    return f


def _c_comb(il):
    """gstcombdetect.c's row loop written out on one woven frame: the mask
    of cells over 100, its count, and whether a carried cell reached the
    1000 clamp."""
    h, w = il.shape
    v = il.astype(np.int64)
    t = np.zeros(w, np.int64)
    mask = np.zeros((h, w), bool)
    clamped = False
    for j in range(2, h - 2):
        for i in range(w):
            a, b, c = v[j - 1, i], v[j, i], v[j + 1, i]
            if b < min(a, c) - 5 or b > max(a, c) + 5:
                t[i] = min(t[i] + (t[i - 1] if i else 0) + 1, 1000)
                clamped |= t[i] == 1000
            else:
                t[i] = 0
            mask[j, i] = t[i] > 100
    return mask, int(mask.sum()), clamped


@pytest.mark.parametrize("h,w", [(h, w) for h in (4, 5, 6)
                                 for w in (1, 33, 257)] + [(12, 257)])
def test_comb_weave_equals_pallas_xla_and_c(h, w):
    """The all-outlier weave, where runs span the whole width and, at
    W = 257 from the second row on, the sums pass the 1000 clamp (H = 12
    carries clamped rows on), with repeated pairs.  The JAX Pallas
    comb_mask has no band to scan at H = 4 and raises there, so that
    height holds to the XLA path and the C loop only."""
    luma = _weave(2, h, w)
    mask, score = comb.comb_mask(torch.from_numpy(luma))
    want = [_c_comb(f) for f in luma]
    np.testing.assert_array_equal(mask.numpy(),
                                  np.stack([m for m, _, _ in want]))
    np.testing.assert_array_equal(score.numpy(), [s for _, s, _ in want])
    assert want[0][2] == (h >= 6 and w == 257)
    for engine in ("xla", "pallas") if h > 4 else ("xla",):
        jm, js = jcomb.comb_mask(jnp.asarray(luma), engine=engine)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(score.numpy(), np.asarray(js))
    ti = np.array([0, 0, 1, 1, 0, 1], np.int32)
    bi = np.array([0, 1, 1, 1, 0, 0], np.int32)
    got = comb.comb_score_pairs(torch.from_numpy(luma), torch.from_numpy(ti),
                                torch.from_numpy(bi))
    even = (np.arange(h) % 2 == 0)[:, None]
    np.testing.assert_array_equal(got.numpy(), [
        _c_comb(np.where(even, luma[t], luma[b]))[1] for t, b in zip(ti, bi)])
    for engine in ("xla", "pallas"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jcomb.comb_score_pairs(jnp.asarray(luma), jnp.asarray(ti),
                                   jnp.asarray(bi), engine=engine,
                                   chunk=32)))


def test_reconstruction_equals_jax():
    rng = np.random.default_rng(5)
    frames = _mixed_frames(rng, (4, 20, 37))
    chroma = _u8(rng, (4, 11, 19))     # odd height: the clamped mirror row
    parity = np.array([0, 1, 1, 0], np.int32)
    np.testing.assert_array_equal(
        ivtc.interp_rows(torch.from_numpy(frames[:, 3]),
                         torch.from_numpy(frames[:, 4])).numpy(),
        np.asarray(jivtc.interp_rows(jnp.asarray(frames[:, 3]),
                                     jnp.asarray(frames[:, 4]))))
    np.testing.assert_array_equal(
        ivtc.reconstruct_single_luma(torch.from_numpy(frames),
                                     torch.from_numpy(parity)).numpy(),
        np.asarray(jivtc.reconstruct_single_luma(jnp.asarray(frames),
                                                 jnp.asarray(parity))))
    np.testing.assert_array_equal(
        ivtc.reconstruct_single_chroma(torch.from_numpy(chroma),
                                       torch.from_numpy(parity)).numpy(),
        np.asarray(jivtc.reconstruct_single_chroma(jnp.asarray(chroma),
                                                   jnp.asarray(parity))))
    np.testing.assert_array_equal(
        ivtc.weave(torch.from_numpy(frames[0]),
                   torch.from_numpy(frames[1])).numpy(),
        np.asarray(jivtc.weave(jnp.asarray(frames[0]),
                               jnp.asarray(frames[1]))))


@pytest.mark.parametrize("shape", [(3, 48, 64), (2, 37, 45), (1, 8, 30)])
def test_ssim_equals_jax(shape):
    rng = np.random.default_rng(6)
    a = _u8(rng, shape)
    b = np.clip(a.astype(np.int64) + rng.integers(-20, 21, shape), 0,
                255).astype(np.uint8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for port, ref in ((ssim.ssim_plane, jssim.ssim_plane),
                      (ssim.dssim_plane, jssim.dssim_plane)):
        got = port(ta, tb)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref(a, b)), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(ssim.ssim_map(ta, tb).numpy(),
                                  np.asarray(jssim.ssim_map(a, b)))


def test_kernel_wrappers_check_inputs_and_count_no_cpu_launch():
    """Bad dtypes, shapes and heights raise; CPU tensors take the plain
    forms, so no launch is counted."""
    z8 = torch.zeros((3, 8, 8), dtype=torch.uint8)
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.metrics_default(z8.to(torch.int32), i32, i32, 16)
    with pytest.raises(ValueError):
        fa.metrics_default(z8[:, :7], i32, i32, 16)       # odd height
    with pytest.raises(ValueError):
        fa.metrics_default(z8, i32.long(), i32, 16)
    with pytest.raises(ValueError):
        comb.comb_score_pairs(z8, i32, i32[:1])
    with pytest.raises(ValueError):
        comb.comb_mask(z8.to(torch.int32))
    fa.metrics_default(z8, i32, i32, 16)
    comb.comb_score_pairs(z8, i32, i32)
    comb.comb_mask(z8)
    assert (fa.metrics_default.launches, comb.comb_score_pairs.launches,
            comb.comb_mask.launches) == (0, 0, 0)
