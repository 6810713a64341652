"""videotestsrc pattern=noise and audiotestsrc wave=white-noise in
gstbad_tpu_torch.  The JAX package draws them from JAX's PRNG, which torch
cannot reproduce, so the two are held together in distribution (ROADMAP
queue 3): same layout, byte histograms that pass a chi-squared test at
p > 1e-3 in both packages, audio mean and variance within stated bounds of
the JAX package's.  The port's own draws are a counter hash of (seed,
frame) or (seed, sample): the same seed gives the same frames and samples
at any window, and consecutive audio windows differ."""

import numpy as np
import torch
from scipy import stats

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.elements.sources import testsrc

torch.set_num_threads(1)   # parallel test workers share the cores

FORMATS = ["AYUV", "I420", "GRAY8", "YUY2", "NV21", "RGB", "BGRx", "RGB16"]
W, H = 40, 12


def _video(pkg, fmt, seed, n_frames, window, w=W, h=H):
    kw = {"device": "cpu"} if pkg is gtt else {}
    p = pkg.parse_launch(f"videotestsrc pattern=noise width={w} height={h} "
                         f"format={fmt} seed={seed} ! fakesink", **kw)
    res = p.run(n_frames=n_frames, window=window)

    def cat(key=None):
        return np.concatenate([np.asarray(b.data if key is None
                                          else b.data[key]) for b in res])
    if isinstance(res[0].data, dict):
        return {k: cat(k) for k in res[0].data}
    return cat()


def _audio(pkg, seed, n_windows, window, s=480, fmt="F32", channels=2):
    kw = {"device": "cpu"} if pkg is gtt else {}
    p = pkg.parse_launch(f"audiotestsrc wave=white-noise seed={seed} "
                         f"samplesperbuffer={s} format={fmt} "
                         f"channels={channels} ! fakesink", **kw)
    res = p.run(n_frames=n_windows * window, window=window)
    return np.concatenate([np.asarray(b.data) for b in res])


def _chi2_p(values, n_bins, lo, hi):
    hist = np.histogram(values, bins=n_bins, range=(lo, hi))[0]
    return stats.chisquare(hist).pvalue


def test_hash_equals_unbounded_integer_arithmetic():
    """The int64 hash equals the same formula on Python's unbounded ints
    at the extremes of its inputs: no product reaches 2^63."""
    xs = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0x9E3779B9, 123456789]
    got = testsrc._mix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [testsrc._mix32(x) for x in xs]
    assert max(got) < 2**32 and min(got) >= 0
    assert len(set(got)) == len(xs)
    counters = torch.tensor([0, 1, -1, 2**40 + 3, -(2**62)])
    keys = testsrc._counter_key(-7, testsrc._VIDEO_STREAM, counters)
    want = [testsrc._counter_key(-7, testsrc._VIDEO_STREAM, c)
            for c in counters.tolist()]
    assert keys.tolist() == want


def test_video_noise_is_window_independent_and_seeded():
    """Frame n is a function of (seed, n): windows of 2 and 5 give the same
    frames; another seed gives other frames; frames differ."""
    for fmt in FORMATS:
        a = _video(gtt, fmt, 3, 10, 2)
        b = _video(gtt, fmt, 3, 10, 5)
        c = _video(gtt, fmt, 4, 10, 5)
        ya, yb, yc = ((x["y"] if isinstance(x, dict) else x)
                      for x in (a, b, c))
        np.testing.assert_array_equal(ya, yb)
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        if fmt == "AYUV":       # alpha is 255 throughout
            ya, yc = ya[..., 1:], yc[..., 1:]
        assert (ya != yc).mean() > 0.9
        assert (ya[1:] != ya[:-1]).mean() > 0.9


def test_video_noise_layout_matches_the_jax_package():
    """Same shapes and (but for the 16-bit formats) dtypes as the JAX
    package: planar chroma 128, AYUV's alpha 255, every other byte
    drawn."""
    for fmt in FORMATS:
        t = _video(gtt, fmt, 0, 4, 2)
        j = _video(gt, fmt, 0, 4, 2)
        if isinstance(j, dict):
            assert sorted(t) == sorted(j)
            for k in j:
                assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
                if k != "y":
                    assert (t[k] == 128).all() and (j[k] == 128).all()
            continue
        assert t.shape == j.shape
        # the JAX package draws 0-255 into uint8 frames for the 16-bit
        # formats; the port keeps the format's uint16 (ROADMAP queue 3)
        assert t.dtype == (np.uint16 if fmt == "RGB16" else j.dtype)
        if fmt == "AYUV":
            assert (t[..., 0] == 255).all() and (j[..., 0] == 255).all()


def test_byte_histograms_pass_chi_squared():
    """Each byte value equally likely, in the port and in the JAX package
    alike (p > 1e-3 over 256 bins), on the drawn bytes of GRAY8, AYUV,
    I420 and RGB16 frames."""
    for fmt in ("GRAY8", "AYUV", "I420", "RGB16"):
        for pkg in (gtt, gt):
            d = _video(pkg, fmt, 1, 4, 2, w=320, h=96)
            if isinstance(d, dict):
                d = d["y"]
            elif fmt == "AYUV":
                d = d[..., 1:]
            d = np.ascontiguousarray(d).view(np.uint8)
            assert _chi2_p(d.ravel(), 256, 0, 256) > 1e-3, (fmt, pkg)


def test_audio_noise_is_window_independent_and_seeded():
    """Sample i is a function of (seed, i): windows of 2 and 5 blocks give
    the same samples, consecutive windows differ, another seed differs,
    and every channel carries the same wave."""
    a = _audio(gtt, 9, 5, 2)
    b = _audio(gtt, 9, 2, 5)
    c = _audio(gtt, 10, 2, 5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (10, 480, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a[..., 0], a[..., 1])
    assert (a[0] != a[1]).mean() > 0.99
    assert (a != c).mean() > 0.99
    s16 = _audio(gtt, 9, 1, 2, fmt="S16", channels=1)
    np.testing.assert_array_equal(
        s16[..., 0], np.clip(a[:2, :, 0].astype(np.float64) * 32767.0,
                             -32768, 32767).astype(np.int16))


def test_audio_noise_moments_match_the_jax_package():
    """Uniform on [-volume, volume] in both packages: over 48000 samples
    each, the means within 0.02 * volume of each other (about 5 standard
    errors) and the variances within 5% (about 12); both histograms pass a
    chi-squared test over 64 bins at p > 1e-3."""
    vol = 0.8
    t = _audio(gtt, 2, 1, 1, s=48000, channels=1).astype(np.float64)
    j = _audio(gt, 2, 1, 1, s=48000, channels=1).astype(np.float64)
    assert abs(t.mean() - j.mean()) < 0.02 * vol
    assert abs(t.var() / j.var() - 1) < 0.05
    assert abs(t.var() - vol * vol / 3) < 0.05 * vol * vol / 3
    for x in (t, j):
        assert x.min() >= -vol and x.max() <= vol
        assert _chi2_p(x.ravel(), 64, -vol, vol) > 1e-3
    # the JAX package repeats one draw in every window; the port does not
    j2 = _audio(gt, 2, 2, 1, s=480, channels=1)
    t2 = _audio(gtt, 2, 2, 1, s=480, channels=1)
    np.testing.assert_array_equal(j2[0], j2[1])
    assert (t2[0] != t2[1]).all()
