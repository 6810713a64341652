"""gstbad_tpu_torch on a CUDA card: each hand-written kernel against its
plain version, and the headline, config-5, combdetect, config-2b (blur),
config-3 (audio), vad_square, config-4, warp, I420 transcode, iqa DSSIM
and 22.05 kHz freeverb graphs, videoconvert's formats and the noise
sources on the card against the CPU port; the runtime surface: the
transcode CLI, a config-5 checkpoint, live headline edits and the validate
scenarios on the card; and the opencv family, digitalzoom, lcms and the
codecalpha pair, element by element and in the five cv graphs, on the card
against the CPU port; and audio breadth's four walks (the ADPCM decoders
and encoder, the scopes' filter) against their plain walks, and six of its
graphs on the card against the CPU port; and the OpenCV detectors'
kernels (H1 haar_cascade, H2 tilted_integral, H3 sgm_aggregate) against
their plain versions, with the face, hand and stereo elements on the card
against the CPU port; and H5 (netsim_bucket, netsim's token-bucket walk)
against its plain walk, with netsim, speed, timecodestamper,
autovideoconvert and checksumsink graphs on the card against the CPU port;
and the sessions (Play with a colour balance and with a visualisation, a
Camera recording) on the card against the CPU port; and the raw-video RTP
headline graph (rtpsrc ! the headline's chain ! rtpsink over localhost
UDP) on the card against the CPU port, with K1 against its plain version
on that path's own window; and the file formats' device paths (vmncdec !
the headline's chain, K1 once a window; onnxobjectdetector on phase 4m's
detector, no kernel, scores and boxes within 1e-4; chromaprint's chroma
image within 1e-5 on rows of unit norm) on the card against the CPU port;
and the decoders in front of the headline's chain (libde265dec, av1dec and
openjpegdec: one upload a window onto the card, K1 once a window, every
frame equal to the CPU port's; each skips where its library is missing).

These tests need an NVIDIA card and nvcc, and skip without them.  They
import neither jax nor gstbad_tpu, so they run on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit exact (integer kernels; H1's passes everywhere and its
scores where a window passed, since it stops at a window's first failed
stage), but config3_audio's S16 samples,
within 1 LSB (freeverb's float32 sums, stated at its test); freeverb_scan
within 2e-6 of its plain version (the JAX package's freeverb gate; both
take the C's operation order, so they are in fact expected to agree bit
for bit); iqa's dssim within 1e-5 (float32 reductions in another order);
retinex, bilateral, lcms and digitalzoom within 1 LSB on under 1% of the
bytes, templatematch's result within 1e-5 of the score map's largest;
the audio walks bit exact, the bs2b ! pitch graph within 1e-3 (torch.fft
on the card and the CPU, through the vocoder's unwrapped phase).
"""

import os

import numpy as np
import pytest
import torch

import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
from gstbad_tpu_torch.golden import geometric
from gstbad_tpu_torch.models import benchmarks
from gstbad_tpu_torch.ops import (audio, blur, chainfuse, comb, fieldanalysis,
                                  lut, overlay, remap)

pytestmark = pytest.mark.cuda

HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _i32(rng, shape, dev, lo=-2**31, hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64)
                            .astype(np.int32)).to(dev)


@pytest.mark.parametrize("shape,batch", [((3, 18, 200), None),
                                         ((1, 18, 200), 5),
                                         ((2, 1, 1), None),
                                         ((1, 33, 129), 3)])
@pytest.mark.parametrize("erode", [False, True])
def test_dilate_zebra_kernel_matches_plain(dev, shape, batch, erode):
    rng = np.random.default_rng(11)
    src = _i32(rng, shape, dev)
    word_t = _i32(rng, 256, dev)
    rank_t = TableChain.rank_table(_i32(rng, 256, dev, 0, 60000))
    b = batch or shape[0]
    thr = _i32(rng, b, dev, 0, 257)
    phase = _i32(rng, b, dev)
    for index in (LinearIndex((19, 183, 54, 0), 8, 16),
                  LinearIndex((0, 1, 1, 0), 0, 1)):
        before = chainfuse.dilate_zebra_fused.launches
        got = chainfuse.dilate_zebra_fused(src, rank_t, word_t, index,
                                           erode, thr, phase, batch=batch)
        assert chainfuse.dilate_zebra_fused.launches == before + 1
        scal = torch.stack([torch.full((b,), int(erode), dtype=torch.int32,
                                       device=dev), thr, phase])
        want = chainfuse.dilate_zebra_plain(src, rank_t, word_t, index, scal)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# the index whose weights exceed 255 takes the kernel's wide path
WIDE_INDEX = LinearIndex((300, 1000, 7, 0), 0, 11)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 127, 129, 333])
def test_dilate_zebra_kernel_unaligned_widths(dev, w):
    """Rows that are not 16-byte aligned (the kernel's scalar path), on a
    materialized window and a broadcast base, frames mixing erode values
    and thresholds, with the luma and the wide index."""
    rng = np.random.default_rng(19)
    word_t = _i32(rng, 256, dev)
    rank_t = TableChain.rank_table(_i32(rng, 256, dev, 0, 60000))
    for shape, batch in (((3, 37, w), None), ((1, 37, w), 5)):
        b = batch or shape[0]
        src = _i32(rng, shape, dev)
        erode = torch.tensor([0, 1, 1, 0, 1][:b], dtype=torch.int32,
                             device=dev)
        thr = torch.tensor([120, 0, 255, 256, -3][:b], dtype=torch.int32,
                           device=dev)
        phase = _i32(rng, b, dev)
        for index in (LinearIndex((19, 183, 54, 0), 8, 16), WIDE_INDEX):
            got = chainfuse.dilate_zebra_fused(src, rank_t, word_t, index,
                                               erode, thr, phase, batch=batch)
            want = chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, index, torch.stack([erode, thr, phase]))
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("index", [LinearIndex((19, 183, 54, 0), 8, 16),
                                   WIDE_INDEX,
                                   LinearIndex((1000, 3000, 500, 2), 3, 19)])
@pytest.mark.parametrize("shape,batch", [((1, 1080, 1920), 64),
                                         ((64, 1080, 1920), None)])
def test_dilate_zebra_kernel_mixed_frames(dev, index, shape, batch):
    """A broadcast base (and a window) whose frames mix erode values and
    thresholds: the kernel dilates a broadcast tile once and redoes it only
    where a frame's erode differs from the one before; ranks with ties."""
    rng = np.random.default_rng(20)
    word_t = _i32(rng, 256, dev)
    rank_t = TableChain.rank_table(_i32(rng, 256, dev, 0, 8))
    b = batch or shape[0]
    src = _i32(rng, shape, dev)
    erode = torch.from_numpy(np.arange(b) // 3 % 2).to(torch.int32).to(dev)
    thr = torch.from_numpy(np.arange(b) * 37 % 300 - 20).to(
        torch.int32).to(dev)
    phase = _i32(rng, b, dev)
    got = chainfuse.dilate_zebra_fused(src, rank_t, word_t, index, erode,
                                       thr, phase, batch=batch)
    want = chainfuse.dilate_zebra_plain(src, rank_t, word_t, index,
                                        torch.stack([erode, thr, phase]))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4, 18, 200), (1,), (5, 3), (2, 8, 256)])
def test_word_lut_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(12)
    idx = _i32(rng, shape, dev, 0, 256)
    table = _i32(rng, 256, dev)
    got = lut.apply_word_table(idx, table)
    torch.cuda.synchronize()
    assert torch.equal(got, lut.apply_word_table_plain(idx, table))
    # a misaligned contiguous view takes the scalar path
    flat = idx.reshape(-1)
    if flat.numel() > 1:
        got = lut.apply_word_table(flat[1:], table)
        assert torch.equal(got, lut.apply_word_table_plain(flat[1:], table))


# two stencils in one chain: the first moves the idx plane, so the fused
# tail stays off and K2 runs 3 times a window (two rank planes, one word)
TWO_STENCILS = ("coloreffects preset=sepia ! solarize ! dilate "
                "! dilate erode=true ! videoconvert format=AYUV "
                "! zebrastripe ! fakesink")


@pytest.mark.parametrize("pattern,graph,launched", [
    ("bars", HEAD + " ! zebrastripe ! fakesink", (2, 0)),
    ("ball", HEAD + " ! zebrastripe ! fakesink", (2, 0)),
    ("bars", HEAD + " ! fakesink", (0, 4)),
    ("bars", TWO_STENCILS, (0, 6))])
def test_graph_on_card_equals_cpu_port(dev, pattern, graph, launched):
    desc = (f"videotestsrc pattern={pattern} width=200 height=18 "
            f"format=BGRx ! {graph}")
    before = (chainfuse.dilate_zebra_fused.launches,
              lut.apply_word_table.launches)
    card = gtt.parse_launch(desc, device="cuda").run(n_frames=8, window=4)
    assert (chainfuse.dilate_zebra_fused.launches - before[0],
            lut.apply_word_table.launches - before[1]) == launched
    cpu = gtt.parse_launch(desc, device="cpu").run(n_frames=8, window=4)
    for a, b in zip(card, cpu):
        for f in ("data", "pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_kernel_wrappers_raise_on_bad_input(dev):
    t = torch.zeros(256, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        lut.apply_word_table(torch.zeros((4, 4), dtype=torch.int32,
                                         device=dev).t(), t)
    with pytest.raises(ValueError):
        lut.apply_word_table(torch.zeros(4, dtype=torch.int32), t)


def _u8(rng, shape, dev):
    """Noise frames with every other frame a smooth gradient plus a little
    noise, so comb scores fall on both sides of the thresholds."""
    out = rng.integers(0, 256, shape, dtype=np.uint8)
    h, w = shape[-2:]
    yy, xx = np.mgrid[:h, :w]
    for i in range(0, shape[0], 2):
        out[i] = np.clip((xx * 3 + yy * 2) % 256
                         + rng.integers(-3, 4, (h, w)), 0, 255)
    return torch.from_numpy(out).to(dev)


@pytest.mark.parametrize("shape", [(9, 48, 64), (5, 50, 66), (3, 8, 4),
                                   (4, 720, 1280)])
def test_fieldanalysis_metrics_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(13)
    pool = _u8(rng, shape, dev)
    b = shape[0] - 1
    cur = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    prev = torch.from_numpy(np.maximum(np.arange(b) - (np.arange(b) % 2),
                                       0).astype(np.int32)).to(dev)
    nf = torch.tensor(16, dtype=torch.int32, device=dev)
    before = fieldanalysis.metrics_default.launches
    got = fieldanalysis.metrics_default(pool, cur, prev, nf)
    assert fieldanalysis.metrics_default.launches == before + 1
    want = fieldanalysis.metrics_default_plain(pool, cur, prev, nf)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _metrics_or_zeros(pool, cur, prev, nf):
    """metrics_default_plain on the frames inside the pool; a frame with
    an index outside it reads 0 (the kernel reads nothing for it)."""
    p = pool.shape[0]
    inside = (cur >= 0) & (cur < p) & (prev >= 0) & (prev < p)
    want = [torch.zeros(cur.shape, dtype=torch.float32, device=cur.device)
            for _ in range(5)]
    if inside.any():
        got = fieldanalysis.metrics_default_plain(pool, cur[inside],
                                                  prev[inside], nf)
        for a, b in zip(want, got):
            a[inside] = b
    return want


# the gates' edges: every pixel kept (-1, 0), the main path's 16, nf^2 at
# and past the largest square (255, 256) and past int32 (46341: every
# square kept)
K4_NOISE_FLOORS = (-1, 0, 16, 255, 256, 46341)


@pytest.mark.parametrize("w", [1, 3, 5, 12, 15, 17, 127, 129, 1280, 1281])
@pytest.mark.parametrize("h", [4, 6, 8, 126, 128, 130, 190, 192, 194])
def test_fieldanalysis_metrics_kernel_hard_cases(dev, h, w):
    """Exact at widths of both load paths (8-byte rows at 1280, bytes at the
    rest, 12 a multiple of 4 but not of 8), at the smallest heights (the first and last field lines
    in one band), either side of the band height (128) and of the height
    where a frame splits into two bands (192); at each noise floor of
    K4_NOISE_FLOORS; with indices below and past the pool (zeros)."""
    rng = np.random.default_rng(19)
    pool = _u8(rng, (5, h, w), dev)
    pool[2] = (pool[1].int() + torch.from_numpy(rng.integers(
        -20, 21, (h, w))).to(dev)).clamp(0, 255).to(torch.uint8)
    cur = torch.tensor([1, 2, 3, 4, 0, 5, 2], dtype=torch.int32, device=dev)
    prev = torch.tensor([0, 1, 2, 3, -1, 4, 2**31 - 1], dtype=torch.int32,
                        device=dev)
    for nf in K4_NOISE_FLOORS:
        nft = torch.tensor(nf, dtype=torch.int32, device=dev)
        got = fieldanalysis.metrics_default(pool, cur, prev, nft)
        want = _metrics_or_zeros(pool, cur, prev, nft)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x), nf


def test_fieldanalysis_metrics_kernel_more_frames_than_sms(dev):
    """300 frames (more clusters than the card has SMs), pools whose base
    is not 8-byte aligned (byte loads at a W that is a multiple of 8), and
    the main path's shape."""
    rng = np.random.default_rng(20)
    pool = _u8(rng, (301, 36, 40), dev)
    cur = torch.arange(1, 301, dtype=torch.int32, device=dev)
    nf = torch.tensor(16, dtype=torch.int32, device=dev)
    cases = [(pool, cur, cur - 1)]
    flat = _u8(rng, (1, 1, 4 * 40 * 64 + 8), dev).reshape(-1)
    for off in (1, 2, 4):
        cases.append((flat[off:off + 4 * 40 * 64].view(4, 40, 64),
                      cur[:3], cur[:3] - 1))
    big = _u8(rng, (3, 720, 1280), dev)
    cases.append((big, torch.tensor([1, 2], dtype=torch.int32, device=dev),
                  torch.tensor([0, 1], dtype=torch.int32, device=dev)))
    for pool, c, p in cases:
        got = fieldanalysis.metrics_default(pool, c, p, nf)
        want = fieldanalysis.metrics_default_plain(pool, c, p, nf)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert torch.equal(g, x)


def _weave(shape, dev):
    """Frames whose rows alternate 0 and 255, so that every cell of the
    band is an outlier (runs as wide as the frame, carries at the 1000
    clamp); the odd frames inverted, so that a pair of one parity weaves
    to the same and of two parities to a flat frame."""
    out = np.zeros(shape, np.uint8)
    out[:, 1::2] = 255
    out[1::2] = 255 - out[1::2]
    return torch.from_numpy(out).to(dev)


# (pool shape, pairs, frames): random frames, and the all-outlier weave at
# narrow, ragged and wide widths and at the heights with no band, one row
# and two rows, its pairs repeated and some out of the pool
COMB_CASES = ([((12, 48, 64), 11, "random"), ((6, 50, 130), 40, "random"),
               ((5, 22, 37), 33, "random"), ((3, 4, 9), 2, "random"),
               ((9, 720, 1280), 17, "random")]
              + [((3, 64, w), 9, "weave")
                 for w in (1, 31, 33, 1281, 3840, 8192)]
              + [((3, h, w), 9, "weave") for h in (4, 5, 6)
                 for w in (33, 1281)])
WEAVE_TOP = [0, 0, 2, -1, 3, 0, 1, 1, 2**31 - 1]
WEAVE_BOT = [1, 0, 2, 1, 0, 100, 1, 1, 0]


@pytest.mark.parametrize("shape,n,frames", COMB_CASES)
def test_comb_kernels_match_plain(dev, shape, n, frames):
    """Exact; a pair with an index outside the pool scores 0."""
    rng = np.random.default_rng(14)
    if frames == "random":
        pool = _u8(rng, shape, dev)
        ti = torch.from_numpy(rng.integers(0, shape[0], n).astype(np.int32)
                              ).to(dev)
        bi = torch.from_numpy(rng.integers(0, shape[0], n).astype(np.int32)
                              ).to(dev)
    else:
        pool = _weave(shape, dev)
        ti = torch.tensor(WEAVE_TOP, dtype=torch.int32, device=dev)
        bi = torch.tensor(WEAVE_BOT, dtype=torch.int32, device=dev)
    before = (comb.comb_score_pairs.launches, comb.comb_mask.launches)
    got = comb.comb_score_pairs(pool, ti, bi)
    mask, score = comb.comb_mask(pool)
    assert (comb.comb_score_pairs.launches,
            comb.comb_mask.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    inside = (ti >= 0) & (ti < shape[0]) & (bi >= 0) & (bi < shape[0])
    want = torch.zeros_like(got)
    want[inside] = comb.comb_score_pairs_plain(pool, ti[inside], bi[inside])
    assert torch.equal(got, want)
    want_mask, want_score = comb.comb_mask_plain(pool)
    assert torch.equal(mask, want_mask) and torch.equal(score, want_score)


TELECINE = {
    "config5": ("interlace pattern=2:3 ! fieldanalysis ! ivtc ! fakesink",
                (1, 1, 0)),
    "combdetect": ("interlace pattern=2:3 ! combdetect ! fakesink",
                   (0, 0, 1)),
}


@pytest.mark.parametrize("graph", sorted(TELECINE))
@pytest.mark.parametrize("fmt", ["GRAY8", "I420"])
def test_telecine_graph_on_card_equals_cpu_port(dev, graph, fmt):
    tail, per_window = TELECINE[graph]
    desc = (f"videotestsrc pattern=ball width=66 height=50 format={fmt} "
            f"framerate=24/1 ! {tail}")
    counters = (fieldanalysis.metrics_default, comb.comb_score_pairs,
                comb.comb_mask)
    before = [c.launches for c in counters]
    card = gtt.parse_launch(desc, device="cuda")
    got = card.run(n_frames=20, window=5)
    assert [c.launches - b for c, b in zip(counters, before)] == [
        4 * k for k in per_window]
    cpu = gtt.parse_launch(desc, device="cpu")
    want = cpu.run(n_frames=20, window=5)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if isinstance(a.data, dict):
            for k in a.data:
                np.testing.assert_array_equal(a.data[k], b.data[k])
        else:
            np.testing.assert_array_equal(a.data, b.data)
    assert [(m.element, m.name, m.pts, m.fields) for m in card.bus.messages] \
        == [(m.element, m.name, m.pts, m.fields) for m in cpu.bus.messages]
    if graph == "config5":
        drained = card.send_eos()["fieldanalysis"][0]
        ref = cpu.send_eos()["fieldanalysis"][0]
        np.testing.assert_array_equal(drained.pts, ref.pts)
        np.testing.assert_array_equal(drained.flags, ref.flags)


@pytest.mark.parametrize("shape,batch", [((64, 1080, 1920), None),
                                         ((1, 1080, 1920), 64),
                                         ((3, 37, 333), None),
                                         ((1, 37, 333), 5),
                                         ((2, 1, 1), None)])
@pytest.mark.parametrize("sigma", [1.2, -2.0, 3.2, 8.0, 20.0])
def test_blur_kernel_matches_plain(dev, shape, batch, sigma):
    """Bit exact: the kernel keeps the plain version's float32 order."""
    rng = np.random.default_rng(15)
    src = _i32(rng, shape, dev)
    tables = [torch.from_numpy(x).to(dev)
              for x in blur.make_blur_tables(sigma, *shape[1:])]
    before = blur.gaussian_blur_words.launches
    got = blur.gaussian_blur_words(src, *tables, batch=batch)
    assert blur.gaussian_blur_words.launches == before + 1
    want = blur.gaussian_blur_words_plain(src, *tables, batch=batch)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h", [15, 16, 17, 31, 32, 33, 63, 64, 65])
@pytest.mark.parametrize("sigma", [1.2, 8.0, 20.0])
def test_blur_kernel_at_tile_edges(dev, sigma, h):
    """Frames one below, at and one above the kernel's tiles: 64 columns,
    and 64 rows at centres 4 and 50 (sigma 1.2 and 20, the largest window),
    32 at centre 20 (sigma 8); materialized and broadcast."""
    rng = np.random.default_rng(21)
    for w in (63, 64, 65):
        tables = [torch.from_numpy(x).to(dev)
                  for x in blur.make_blur_tables(sigma, h, w)]
        for shape, batch in (((2, h, w), None), ((1, h, w), 3)):
            src = _i32(rng, shape, dev)
            got = blur.gaussian_blur_words(src, *tables, batch=batch)
            want = blur.gaussian_blur_words_plain(src, *tables, batch=batch)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (w, shape)


def _warp_map(name, h, w, dev, off_edge="ignore"):
    flat, valid = remap.fix_map(geometric.MAP_BUILDERS[name](w, h), w, h,
                                off_edge)
    return torch.from_numpy(remap.word_map(flat, valid)).to(dev)


@pytest.mark.parametrize("shape,batch", [((64, 1080, 1920), None),
                                         ((16, 2160, 3840), None),
                                         ((1, 1080, 1920), 64),
                                         ((3, 37, 333), None),
                                         ((1, 37, 333), 5)])
@pytest.mark.parametrize("name,off_edge", [("fisheye", "ignore"),
                                           ("twirl", "ignore"),
                                           ("rotate", "wrap")])
def test_warp_kernel_matches_plain(dev, shape, batch, name, off_edge):
    rng = np.random.default_rng(16)
    src = _i32(rng, shape, dev)
    mp = _warp_map(name, *shape[1:], dev, off_edge)
    for bg in (0, remap.background_word(b"\xff\x10\x80\x80")):
        before = remap.warp_words.launches
        got = remap.warp_words(src, mp, bg, batch=batch)
        assert remap.warp_words.launches == before + 1
        want = remap.warp_words_plain(src, mp, bg, batch=batch)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_warp_kernel_out_of_range_map_takes_background(dev):
    rng = np.random.default_rng(17)
    src = _i32(rng, (4, 9, 13), dev)
    mp = _i32(rng, 9 * 13, dev, -5, 9 * 13 + 5)
    got = remap.warp_words(src, mp, 77)
    torch.cuda.synchronize()
    assert torch.equal(got, remap.warp_words_plain(src, mp, 77))


# (graph, launches of (gaussian_blur_words, warp_words) per window)
SLICE_GRAPHS = {"config2_blur": (1, 0), "config4_warp": (0, 2),
                "warp_1080p": (0, 1)}


@pytest.mark.parametrize("size", [(256, 64), (200, 18)])
@pytest.mark.parametrize("name", sorted(SLICE_GRAPHS))
def test_slice_graph_on_card_equals_cpu_port(dev, name, size):
    per_window = SLICE_GRAPHS[name]
    before = (blur.gaussian_blur_words.launches, remap.warp_words.launches)
    card = benchmarks.build(name, width=size[0], height=size[1],
                            device="cuda").run(n_frames=8, window=4)
    assert (blur.gaussian_blur_words.launches - before[0],
            remap.warp_words.launches - before[1]) == tuple(
                2 * k for k in per_window)
    cpu = benchmarks.build(name, width=size[0], height=size[1],
                           device="cpu").run(n_frames=8, window=4)
    assert len(card) == len(cpu) == 2
    for a, b in zip(card, cpu):
        for f in ("data", "pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("pattern", ["ball", "checkers"])
def test_blur_and_warps_on_a_moving_source(dev, pattern):
    """A materialized window (ball) and AYUV warps with their background."""
    desc = (f"videotestsrc pattern={pattern} width=160 height=40 "
            "format=AYUV ! gaussianblur sigma=-1.5 ! rotate angle=0.5 "
            "! tunnel ! fakesink")
    card = gtt.parse_launch(desc, device="cuda").run(n_frames=6, window=3)
    cpu = gtt.parse_launch(desc, device="cpu").run(n_frames=6, window=3)
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.data, b.data)


def test_blur_and_warp_wrappers_raise_on_bad_input(dev):
    tables = [torch.from_numpy(x).to(dev)
              for x in blur.make_blur_tables(1.2, 8, 16)]
    with pytest.raises(ValueError):
        blur.gaussian_blur_words(torch.zeros((2, 8, 16), dtype=torch.int64,
                                             device=dev), *tables)
    with pytest.raises(ValueError):
        blur.gaussian_blur_words(torch.zeros((2, 16, 8), dtype=torch.int32,
                                             device=dev).transpose(1, 2),
                                 *tables)
    src = torch.zeros((2, 8, 16), dtype=torch.int32, device=dev)
    mp = torch.zeros(8 * 16, dtype=torch.int32)
    with pytest.raises(ValueError):        # a CPU map for a card source
        remap.warp_words(src, mp, 0)
    with pytest.raises(ValueError):        # a card map for a CPU source
        remap.warp_words(src.cpu(), mp.to(dev), 0)
    with pytest.raises(ValueError):
        remap.warp_words(src.float(), mp.to(dev), 0)



def _vad_rows(kind, shape, dev):
    """S16 VAD blocks: noise (brackets close), DC 30000 and a square wave
    (brackets stay open) and silence."""
    rng = np.random.default_rng(18)
    t = np.arange(shape[0] * shape[1]).reshape(shape)
    data = {"noise": lambda: rng.integers(-32768, 32768, shape),
            "dc": lambda: np.full(shape, 30000),
            "square": lambda: 26213 * np.sign(np.sin(2 * np.pi * 440 * t
                                                     / 48000)),
            "silence": lambda: np.zeros(shape)}[kind]()
    return torch.from_numpy(data.astype(np.int16)).to(dev)


@pytest.mark.parametrize("shape", [(64, 4800), (3, 300), (5, 4801)])
@pytest.mark.parametrize("kind", ["noise", "dc", "square", "silence"])
def test_vad_kernels_match_plain(dev, kind, shape):
    """Both modes of K8 against their plain versions, exactly; the serial
    plain version runs on a CPU copy (one Python step per sample)."""
    data = _vad_rows(kind, shape, dev)
    p0 = torch.tensor(123456789, dtype=torch.int64, device=dev)
    before = (audio.vad_powers_serial.launches,
              audio.vad_powers_bracket.launches)
    got = audio.vad_powers_serial(data, p0)
    lo, hi = audio.vad_powers_bracket(data)
    assert (audio.vad_powers_serial.launches,
            audio.vad_powers_bracket.launches) == (before[0] + 1,
                                                   before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), audio.vad_powers_serial_plain(
        data.cpu(), p0.cpu()))
    want_lo, want_hi = audio.vad_powers_bracket_plain(data)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


@pytest.mark.parametrize("n", [1, 31, 33, 300, 4801, 9600])
@pytest.mark.parametrize("nb", [1, 64, 300])
def test_vad_bracket_kernel_hard_cases(dev, nb, n):
    """The bracket kernel exactly: rows shorter than a batch of 32 squares,
    one either side of it, across chunks of 2048, odd lengths (the 2-byte
    staging) and 9600 (16-byte staging over five chunks); rows whose
    brackets close (noise, silence) and stay open (DC, square)."""
    for kind in ("noise", "dc", "square", "silence"):
        data = _vad_rows(kind, (nb, n), dev)
        before = audio.vad_powers_bracket.launches
        lo, hi = audio.vad_powers_bracket(data)
        assert audio.vad_powers_bracket.launches == before + 1
        want_lo, want_hi = audio.vad_powers_bracket_plain(data)
        torch.cuda.synchronize()
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi), kind


def test_vad_bracket_kernel_unaligned_rows(dev):
    """A block whose base is not 16-byte aligned takes the 2-byte
    staging at n % 8 == 0; an empty row ends on the two starts."""
    rng = np.random.default_rng(21)
    flat = torch.from_numpy(rng.integers(-32768, 32768, 64 * 4800 + 8)
                            .astype(np.int16)).to(dev)
    for off in (1, 8):
        data = flat[off:off + 64 * 4800].view(64, 4800)
        lo, hi = audio.vad_powers_bracket(data)
        want_lo, want_hi = audio.vad_powers_bracket_plain(data)
        torch.cuda.synchronize()
        assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    lo, hi = audio.vad_powers_bracket(
        torch.zeros((3, 0), dtype=torch.int16, device=dev))
    torch.cuda.synchronize()
    assert lo.tolist() == [0] * 3 and hi.tolist() == [2**32 - 1] * 3


def test_vad_wrappers_raise_on_bad_input(dev):
    data = torch.zeros((2, 300), dtype=torch.int16, device=dev)
    p0 = torch.zeros((), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):        # a CPU power for card samples
        audio.vad_powers_serial(data, p0.cpu())
    with pytest.raises(ValueError):        # a card power for CPU samples
        audio.vad_powers_serial(data.cpu(), p0)
    with pytest.raises(ValueError):
        audio.vad_powers_bracket(data.to(torch.int32))
    with pytest.raises(ValueError):
        audio.vad_powers_bracket(data.t())


# (graph, launches of (vad_powers_bracket, vad_powers_serial) per window)
AUDIO_GRAPHS = {"config3_audio": (1, 0), "vad_square": (1, 1)}


@pytest.mark.parametrize("name", sorted(AUDIO_GRAPHS))
def test_audio_graph_on_card_equals_cpu_port(dev, name):
    """vad_square bit exact; config3_audio's S16 samples within 1 LSB (the
    card's float32 matrix products sum freeverb's blocks in another order,
    within 2e-6), pts, valid and messages exact."""
    per_window = AUDIO_GRAPHS[name]
    before = (audio.vad_powers_bracket.launches,
              audio.vad_powers_serial.launches)
    card = benchmarks.build(name, samplesperbuffer=1200, device="cuda")
    got = card.run(n_frames=12, window=4)
    assert (audio.vad_powers_bracket.launches - before[0],
            audio.vad_powers_serial.launches - before[1]) == tuple(
                3 * k for k in per_window)
    cpu = benchmarks.build(name, samplesperbuffer=1200, device="cpu")
    want = cpu.run(n_frames=12, window=4)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.pts, b.pts)
        np.testing.assert_array_equal(a.valid, b.valid)
        diff = np.abs(a.data.astype(int) - b.data.astype(int))
        assert diff.max() <= (1 if name == "config3_audio" else 0)
    assert [(m.element, m.name, m.pts, m.fields) for m in card.bus.messages] \
        == [(m.element, m.name, m.pts, m.fields) for m in cpu.bus.messages]


def _fv_params(dev, damping=0.2, room=0.5):
    p = gtt.make("freeverb", damping=damping, **{"room-size": room})
    return {k: v.to(dev) for k, v in p.dynamic_params().items()}


def _fv_state_close(a, b, atol):
    for k in a:
        got, want = a[k].cpu(), b[k].cpu()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert float((got.double() - want.double()).abs().max()) <= atol, k


def _fv_edges(rate):
    """Blocks either side of the kernel's chunk K, of the shortest comb
    and of the shortest allpass at `rate`."""
    k = audio.freeverb_chunk(rate)
    sizes = audio.freeverb_sizes(rate)
    comb = int(min(sizes["combL"].min(), sizes["combR"].min()))
    ap = int(min(sizes["apL"].min(), sizes["apR"].min()))
    return (k - 1, k, k + 1, comb - 1, comb + 1, ap - 1, ap + 1)


@pytest.mark.parametrize("rate", [8000, 11025, 16000, 22050, 24000, 31999])
@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("blocks", [(1, 7), (150, 3000), (5000,), "edges"])
def test_freeverb_scan_kernel_matches_plain(dev, rate, mono, blocks):
    """Blocks of one sample, shorter than the shortest ring and longer than
    every ring, and either side of the kernel's chunk, the shortest comb
    and the shortest allpass, the state carried from call to call; the
    plain version on a CPU copy.  Within 2e-6, and the outputs and state
    values that differ at all counted: both take the C's operation order,
    so none is expected to."""
    if blocks == "edges":
        blocks = _fv_edges(rate)
    rng = np.random.default_rng(rate + len(blocks))
    params = _fv_params(dev, damping=0.7 if mono else 0.2)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    st = audio.freeverb_init_state(rate, dev)
    ref = audio.freeverb_init_state(rate, "cpu")
    differ = 0
    for n in blocks:
        shape = (n,) if mono else (n, 2)
        x = torch.from_numpy(((rng.random(shape) - 0.5) * 1.8)
                             .astype(np.float32))
        before = audio.freeverb_scan.launches
        st, y = audio.freeverb_scan(st, x.to(dev), params, rate, mono)
        torch.cuda.synchronize()
        assert audio.freeverb_scan.launches == before + 1
        ref, want = audio.freeverb_scan(ref, x, cpu_params, rate, mono)
        assert y.shape == (n, 2) and y.dtype == torch.float32
        assert float((y.cpu() - want).abs().max()) <= 2e-6
        _fv_state_close(st, ref, 2e-6)
        assert int(st["t"]) == int(ref["t"])
        differ += int((y.cpu() != want).sum()) + sum(
            int((st[k].cpu() != ref[k]).sum()) for k in ref)
    assert differ == 0, f"{differ} outputs and state values differ"


def test_freeverb_scan_raises_on_bad_input(dev):
    params = _fv_params(dev)
    st = audio.freeverb_init_state(22050, dev)
    x = torch.zeros((64, 2), device=dev)
    with pytest.raises(ValueError):
        audio.freeverb_scan(st, x.double(), params, 22050, False)
    with pytest.raises(ValueError):
        audio.freeverb_scan(st, x, params, 22050, True)     # not [N]
    with pytest.raises(ValueError):
        audio.freeverb_scan(st, x, params, 100, False)      # rings < 1
    bad = dict(st, t=st["t"].long())
    with pytest.raises(ValueError):
        audio.freeverb_scan(bad, x, params, 22050, False)


# (graph, size, launches of (gaussian_blur_words, freeverb_scan) a window)
SLICE8_GRAPHS = {"transcode_i420_blur": (1, 0), "iqa_dssim_1080p": (1, 0),
                 "freeverb_22k": (0, 1)}


@pytest.mark.parametrize("name", sorted(SLICE8_GRAPHS))
def test_new_path_graph_on_card_equals_cpu_port(dev, name):
    """The transcode exact; iqa's fields within 1e-5 (dssim) and 1e-12
    (ssim); freeverb_22k's S16 within 1 LSB."""
    per_window = SLICE8_GRAPHS[name]
    kw = ({"samplesperbuffer": 500} if name == "freeverb_22k"
          else {"width": 256, "height": 64})
    before = (blur.gaussian_blur_words.launches,
              audio.freeverb_scan.launches)
    card = benchmarks.build(name, device="cuda", **kw)
    got = card.run(n_frames=8, window=4)
    assert (blur.gaussian_blur_words.launches - before[0],
            audio.freeverb_scan.launches - before[1]) == tuple(
                2 * k for k in per_window)
    cpu = benchmarks.build(name, device="cpu", **kw)
    want = cpu.run(n_frames=8, window=4)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.pts, b.pts)
        np.testing.assert_array_equal(a.valid, b.valid)
        if isinstance(b.data, dict):
            for k in b.data:
                np.testing.assert_array_equal(a.data[k], b.data[k])
            continue
        diff = np.abs(a.data.astype(int) - b.data.astype(int))
        assert diff.max() <= (1 if name == "freeverb_22k" else 0)
    cm, tm = card.bus.messages, cpu.bus.messages
    assert len(cm) == len(tm)
    for a, b in zip(cm, tm):
        assert (a.element, a.name, a.pts) == (b.element, b.name, b.pts)
        assert abs(a["dssim"] - b["dssim"]) <= 1e-5
        assert abs(a["ssim"] - b["ssim"]) <= 1e-12


def test_videoconvert_formats_on_card_equal_cpu(dev):
    """Every source format to every target, on the card and on the CPU."""
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.elements.video.convert import _ALL
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.core.spec import VideoFormat as VF
    rng = np.random.default_rng(3)
    for src in _ALL:
        shape = {VF.ARGB64: (2, 8, 32, 4), VF.GRAY8: (2, 8, 32),
                 VF.YUY2: (2, 8, 64), VF.UYVY: (2, 8, 64),
                 VF.RGB: (2, 8, 32, 3), VF.BGR: (2, 8, 32, 3)}.get(
                     src, (2, 8, 32) if src in VF.PACKED_RGB16
                     else (2, 8, 32, 4))
        wide = src == VF.ARGB64 or src in VF.PACKED_RGB16
        planes = {VF.I420: (4, 16), VF.YV12: (4, 16), VF.Y444: (8, 32),
                  VF.Y42B: (8, 16), VF.Y41B: (8, 8)}
        if src in planes:
            data = {k: rng.integers(0, 256, (2,) + hw, dtype=np.uint8)
                    for k, hw in (("y", (8, 32)), ("u", planes[src]),
                                  ("v", planes[src]))}
        elif src in VF.SEMIPLANAR_YUV:
            data = {"y": rng.integers(0, 256, (2, 8, 32), dtype=np.uint8),
                    "uv": rng.integers(0, 256, (2, 4, 32), dtype=np.uint8)}
        else:
            data = rng.integers(0, 65536 if wide else 256, shape).astype(
                np.uint16 if wide else np.uint8)
        for dst in _ALL:
            outs = []
            for d in ("cuda", "cpu"):
                el = gtt.make("videoconvert", format=dst)
                el.device = torch.device(d)
                el.set_info(MediaSpec(kind="video", format=src, width=32,
                                      height=8))
                tree = ({k: torch.from_numpy(v).to(d) for k, v in
                         data.items()} if isinstance(data, dict)
                        else torch.from_numpy(data).to(d))
                out = el.process({}, None, FrameBatch.make(tree))[1].data
                outs.append({k: v.cpu() for k, v in out.items()}
                            if isinstance(out, dict) else out.cpu())
            a, b = outs
            if isinstance(b, dict):
                for k in b:
                    assert torch.equal(a[k], b[k]), (src, dst, k)
            else:
                assert torch.equal(a, b), (src, dst)


def test_noise_sources_on_card_equal_cpu(dev):
    for fmt in ("AYUV", "I420", "GRAY8", "RGB16"):
        desc = (f"videotestsrc pattern=noise width=64 height=16 "
                f"format={fmt} seed=5 ! fakesink")
        a = gtt.parse_launch(desc, device="cuda").run(n_frames=6, window=3)
        b = gtt.parse_launch(desc, device="cpu").run(n_frames=6, window=2)
        ga = np.concatenate([x.data["y"] if isinstance(x.data, dict)
                             else x.data for x in a])
        gb = np.concatenate([x.data["y"] if isinstance(x.data, dict)
                             else x.data for x in b])
        np.testing.assert_array_equal(ga, gb)
    desc = ("audiotestsrc wave=white-noise seed=5 samplesperbuffer=333 "
            "format=F32 ! fakesink")
    a = gtt.parse_launch(desc, device="cuda").run(n_frames=6, window=3)
    b = gtt.parse_launch(desc, device="cpu").run(n_frames=6, window=2)
    np.testing.assert_array_equal(np.concatenate([x.data for x in a]),
                                  np.concatenate([x.data for x in b]))


# -- the runtime surface on the card (chip_smoke.py phase 4d, small) ------

BLUR_CHAIN = ("videoconvert format=AYUV ! gaussianblur sigma=1.2 "
              "! videoconvert format=I420")


def test_transcode_cli_on_card_equals_cpu(dev, tmp_path):
    from gstbad_tpu_torch.cli import transcode_main
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.io import y4m
    rng = np.random.default_rng(2)
    y4m.write_y4m(tmp_path / "in.y4m", MediaSpec(
        kind="video", format="I420", width=66, height=50),
        {"y": rng.integers(0, 256, (10, 50, 66), dtype=np.uint8),
         "u": rng.integers(0, 256, (10, 25, 33), dtype=np.uint8),
         "v": rng.integers(0, 256, (10, 25, 33), dtype=np.uint8)})
    before = blur.gaussian_blur_words.launches
    for d in ("cuda", "cpu"):
        transcode_main([str(tmp_path / "in.y4m"), str(tmp_path / f"{d}.y4m"),
                        "--filters", BLUR_CHAIN, "--window", "4",
                        "--device", d])
        if d == "cuda":
            assert blur.gaussian_blur_words.launches - before == 3
    assert (tmp_path / "cuda.y4m").read_bytes() == \
        (tmp_path / "cpu.y4m").read_bytes()


def test_checkpoint_config5_on_card(dev, tmp_path):
    def build():
        return benchmarks.config5_ivtc(64, 48, device="cuda")
    whole = build()
    ref = whole.run(n_frames=32, window=8)
    a, b = build(), build()
    got = a.run(n_frames=16, window=8)
    a.save_checkpoint(tmp_path / "ck.pkl")
    b.load_checkpoint(tmp_path / "ck.pkl")
    assert b._states[2]["prev"]["y"].is_cuda
    got += b.run(n_frames=16, window=8)
    assert len(got) == len(ref)
    for x, y in zip(got, ref):
        for f in ("data", "pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert a.bus.messages + b.bus.messages == whole.bus.messages


def test_headline_edits_on_card_equal_cpu(dev):
    desc = ("videotestsrc pattern=ball width=200 height=18 format=BGRx ! "
            + HEAD + " ! zebrastripe ! fakesink")
    outs = {}
    for d in ("cuda", "cpu"):
        p = gtt.parse_launch(desc, device=d)
        k = (chainfuse.dilate_zebra_fused.launches,
             lut.apply_word_table.launches)
        res = [p.run(n_frames=4, window=4)]
        p.remove("zebrastripe")
        res.append(p.run(n_frames=4, window=4))
        p.insert_after("videoconvert", gtt.make("zebrastripe"))
        res.append(p.run(n_frames=4, window=4))
        if d == "cuda":
            assert (chainfuse.dilate_zebra_fused.launches - k[0],
                    lut.apply_word_table.launches - k[1]) == (2, 2)
        outs[d] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        for x, y in zip(a, b):
            for f in ("data", "pts", "flags", "valid"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def test_validate_scenarios_on_card(dev):
    import glob
    import os
    from gstbad_tpu_torch.utils.validate import run_validatetest
    paths = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                          "validate", "*.validatetest")))
    assert len(paths) == 6
    for path in paths:
        report = run_validatetest(path, device="cuda")
        assert report.ok, (path, report.details)


# the cv slice: (element, format, properties, LSB allowed)
CV_W, CV_H = 96, 64
CV_CASES = [
    ("cvsmooth", "RGB", {"type": "blur", "kernel-width": 5}, 0),
    ("cvsmooth", "GRAY8", {"type": "gaussian", "kernel-width": 5}, 0),
    ("cvsmooth", "BGRx", {"type": "median", "kernel-width": 5}, 0),
    ("cvsmooth", "RGB", {"type": "median", "kernel-width": 3,
                         "position-x": 10, "width": 40}, 0),
    ("cvsmooth", "RGB", {"type": "bilateral", "color": 30.0}, 1),
    ("cvsobel", "RGB", {"aperture-size": 5}, 0),
    ("cvsobel", "RGB", {"aperture-size": 7, "mask": False}, 0),
    ("cvlaplace", "RGB", {"aperture-size": 3, "scale": 0.5}, 0),
    ("cvlaplace", "RGB", {"aperture-size": 7, "mask": False}, 0),
    ("cvdilate", "RGB", {"iterations": 3}, 0),
    ("cverode", "GRAY8", {"iterations": 1}, 0),
    ("cvequalizehist", "GRAY8", {}, 0),
    ("edgedetect", "RGB", {"aperture-size": 3}, 0),
    ("edgedetect", "RGB", {"aperture-size": 7}, 0),
    ("retinex", "RGB", {}, 1),
    ("retinex", "RGB", {"method": "multiscale"}, 1),
    ("cameraundistort", "BGRx", {"camera-matrix": "70 0 48 0 70 32 0 0 1",
                                 "distortion-coeffs": "-0.3 0.1",
                                 "alpha": 0.5, "crop": True}, 0),
    ("dewarp", "RGBA", {"inner-radius": 0.05, "outer-radius": 0.28}, 0),
    ("dewarp", "RGBA", {"inner-radius": 0.05, "outer-radius": 0.28,
                        "interpolation-method": "nearest",
                        "display-mode": "quad-view"}, 0),
    ("skindetect", "RGB", {}, 0),
    ("skindetect", "RGB", {"method": "rgb"}, 0),
    ("digitalzoom", "BGRx", {"zoom": 1.7}, 1),
    ("digitalzoom", "I420", {"zoom": 4.0}, 1),
    ("lcms", "BGRx", {"intent": "absolute"}, 1),
    ("lcms", "RGB", {"preserve-black": True}, 1),
]


def _cv_frames(fmt, seed):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.integers(0, 256, (3,) + shape, dtype=np.uint8)

    if fmt == "I420":
        return {"y": r(CV_H, CV_W), "u": r(CV_H // 2, CV_W // 2),
                "v": r(CV_H // 2, CV_W // 2)}
    if fmt == "GRAY8":
        return r(CV_H, CV_W)
    return r(CV_H, CV_W, 3 if fmt == "RGB" else 4)


def _assert_close(got, want, lsb):
    got = got if isinstance(got, dict) else {"": got}
    want = want if isinstance(want, dict) else {"": want}
    assert sorted(got) == sorted(want)
    for k in got:
        d = np.abs(got[k].astype(np.int64) - want[k].astype(np.int64))
        assert d.max(initial=0) <= lsb, k
        assert (d > 0).mean() < 0.01 or not lsb, k


def _cv_run(dev_name, name, fmt, props, setup=None):
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.core.spec import MediaSpec
    h = Harness(name, device=dev_name, **props)
    if setup:
        setup(h.element)
    h.set_src_spec(MediaSpec(kind="video", format=fmt, width=CV_W,
                             height=CV_H))
    out = []
    for seed in (0, 1):
        out += h.push(_cv_frames(fmt, seed))
    return out, [(m.element, m.name, m.pts, m.fields)
                 for m in h.bus.messages]


@pytest.mark.parametrize("name,fmt,props,lsb", CV_CASES)
def test_cv_element_on_card_equals_cpu_port(dev, name, fmt, props, lsb):
    got, gm = _cv_run("cuda", name, fmt, props)
    want, wm = _cv_run("cpu", name, fmt, props)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _assert_close(a.data, b.data, lsb)
    assert gm == wm


@pytest.mark.parametrize("method", ["sqdiff-normed", "ccorr", "ccoeff",
                                    "ccoeff-normed"])
def test_templatematch_on_card_equals_cpu_port(dev, method):
    templ = _cv_frames("RGB", 0)[1, 10:26, 20:44].copy()

    def setup(el):
        el.set_template(templ)

    got, gm = _cv_run("cuda", "templatematch", "RGB", {"method": method},
                      setup)
    want, wm = _cv_run("cpu", "templatematch", "RGB", {"method": method},
                       setup)
    assert len(gm) == len(wm) == 6
    for g, w in zip(gm, wm):
        assert (g[3]["x"], g[3]["y"]) == (w[3]["x"], w[3]["y"])
        assert abs(g[3]["result"] - w[3]["result"]) <= 1e-5 * max(
            1.0, abs(w[3]["result"]))
    assert gm[1][3]["x"] == 20 and gm[1][3]["y"] == 10
    for a, b in zip(got, want):
        _assert_close(a.data, b.data, 1)


CV_GRAPHS = ["cv_edges_1080p", "cv_median_1080p", "undistort_1080p",
             "dewarp_1080p", "lcms_motion_720p"]


@pytest.mark.parametrize("name", CV_GRAPHS)
def test_cv_graph_on_card_equals_cpu_port(dev, name, tmp_path):
    kw = {}
    if name == "lcms_motion_720p":
        path = tmp_path / "wide.icc"
        path.write_bytes(benchmarks.wide_gamma22_icc())
        kw["dest_profile"] = str(path)
    runs = {}
    for d in ("cuda", "cpu"):
        p = getattr(benchmarks, name)(width=256, height=144, device=d, **kw)
        runs[d] = (p.run(n_frames=16, window=8),
                   [(m.element, m.name, m.pts, str(m.fields))
                    for m in p.bus.messages])
    for a, b in zip(*(r[0] for r in runs.values())):
        _assert_close(a.data, b.data, 1 if name.startswith("lcms") else 0)
    assert runs["cuda"][1] == runs["cpu"][1]


def test_alphacombine_codecalphademux_on_card_equal_cpu(dev):
    desc = ("videotestsrc pattern=ball width=96 height=64 format=I420 ! m.  "
            "videotestsrc pattern=gradient width=96 height=64 format=GRAY8 "
            "! m.  alphacombine name=m ! codecalphademux ! fakesink")
    runs = {}
    for d in ("cuda", "cpu"):
        p = gtt.parse_launch(desc, device=d)
        runs[d] = (p.run(n_frames=8, window=4),
                   [(m.element, m.name, m.pts, m.fields)
                    for m in p.bus.messages])
    for a, b in zip(*(r[0] for r in runs.values())):
        _assert_close(a.data, b.data, 0)
    assert runs["cuda"][1] == runs["cpu"][1]


# -- audio breadth: the per-sample walks and the slice's graphs ---------------


@pytest.mark.parametrize("ch,bsz", [(1, 16), (1, 1024), (2, 2048), (2, 40)])
def test_adpcm_decode_kernels_match_plain(dev, ch, bsz):
    rng = np.random.default_rng(bsz + ch)
    blocks = torch.from_numpy(rng.integers(0, 256, (37, bsz),
                                           dtype=np.uint8))
    for fn, plain in ((audio.adpcm_ima_decode, audio.adpcm_ima_decode_plain),
                      (audio.adpcm_ms_decode, audio.adpcm_ms_decode_plain)):
        before = fn.launches
        got = fn(blocks.to(dev), ch)
        assert fn.launches == before + 1
        assert torch.equal(got.cpu(), plain(blocks, ch))
        # the plain walk on the card takes the same ops
        assert torch.equal(plain(blocks.to(dev), ch).cpu(), got.cpu())


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 25, 2), (64, 2041, 2),
                                   (5, 1017, 1)])
def test_adpcm_encode_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.integers(-32768, 32768, shape).astype(np.int16))
    si0 = torch.from_numpy(rng.integers(0, 89, shape[2]).astype(np.int32))
    before = audio.adpcm_ima_encode.launches
    got = audio.adpcm_ima_encode(x.to(dev), si0.to(dev))
    assert audio.adpcm_ima_encode.launches == before + 1
    for g, w in zip(got, audio.adpcm_ima_encode_plain(x, si0)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n,ch", [(1, 1), (1764, 2), (3000, 1), (500, 2)])
def test_scope_filter_kernel_matches_plain(dev, n, ch):
    rng = np.random.default_rng(n)
    st = torch.from_numpy(rng.standard_normal(6 * ch) * 100)
    x = torch.from_numpy(rng.integers(-32768, 32768, (n, ch)).astype(
        np.int32))
    before = audio.scope_filter.launches
    s1, t1 = audio.scope_filter(st.to(dev), x.to(dev))
    assert audio.scope_filter.launches == before + 1
    s2, t2 = audio.scope_filter_plain(st, x)
    assert torch.equal(s1.cpu(), s2) and torch.equal(t1.cpu(), t2)


@pytest.mark.parametrize("ch", [1, 2, 32])
@pytest.mark.parametrize("where", ["one", "chunk-1", "chunk+1", "long"])
def test_scope_filter_kernel_chunk_edges(dev, ch, where):
    """One sample, a chunk of the kernel's shared-memory ring less one and
    more one, and play_vis_48k's 307200 samples, for 1, 2 and 32
    channels: bit for bit."""
    k = audio.scope_chunk(ch)
    n = {"one": 1, "chunk-1": k - 1, "chunk+1": k + 1, "long": 307200}[where]
    rng = np.random.default_rng(n + ch)
    st = torch.from_numpy(rng.standard_normal(6 * ch) * 100)
    x = torch.from_numpy(rng.integers(-32768, 32768, (n, ch)).astype(
        np.int32))
    s1, t1 = audio.scope_filter(st.to(dev), x.to(dev))
    s2, t2 = audio.scope_filter_plain(st, x)
    assert torch.equal(s1.cpu(), s2) and torch.equal(t1.cpu(), t2)


AUDIO_BREADTH_GRAPHS = {
    "bs2b_pitch": ("audiotestsrc wave=sine format=F32 rate=44100 channels=2 "
                   "samplesperbuffer=4096 ! bs2b preset=cmoy ! pitch "
                   "pitch=1.25 ! fakesink", 8, 4),
    "adpcm_enc": ("audiotestsrc wave=sine format=S16 rate=44100 channels=2 "
                  "samplesperbuffer=2041 ! adpcmenc blocksize=2048 ! "
                  "fakesink", 8, 4),
    "wavescope": ("audiotestsrc wave=sine format=S16 rate=44100 channels=2 "
                  "samplesperbuffer=1764 ! wavescope style=color-lines "
                  "width=320 height=240 ! fakesink", 4, 4),
    "spacescope": ("audiotestsrc wave=sine format=S16 rate=44100 channels=2 "
                   "samplesperbuffer=1764 ! spacescope style=color-lines "
                   "width=320 height=240 ! fakesink", 4, 4),
    "spectrascope": ("audiotestsrc wave=sine format=S16 rate=44100 "
                     "channels=2 samplesperbuffer=1764 ! spectrascope "
                     "width=320 height=240 ! fakesink", 4, 4),
    "synaescope": ("audiotestsrc wave=sine format=S16 rate=44100 channels=2 "
                   "samplesperbuffer=1764 ! synaescope width=320 "
                   "height=240 ! fakesink", 4, 4),
}


@pytest.mark.parametrize("name", sorted(AUDIO_BREADTH_GRAPHS))
def test_audio_breadth_graph_on_card_equals_cpu_port(dev, name):
    """The graph on the card against the CPU port: exact, but pitch's
    output within 1e-3 (torch.fft on the card, pocketfft or MKL on the
    CPU; the vocoder's unwrapped phase carries their rounding)."""
    desc, n, window = AUDIO_BREADTH_GRAPHS[name]
    got = gtt.parse_launch(desc, device="cuda").run(n_frames=n,
                                                    window=window)
    cpu = gtt.parse_launch(desc, device="cpu").run(n_frames=n,
                                                   window=window)
    assert len(got) == len(cpu)
    for a, c in zip(got, cpu):
        assert a.data.shape == c.data.shape and a.data.dtype == c.data.dtype
        for f in ("pts", "flags", "valid"):
            assert np.array_equal(getattr(a, f), getattr(c, f))
        if name == "bs2b_pitch":
            assert np.abs(a.data - c.data).max() <= 1e-3
        else:
            assert np.array_equal(a.data, c.data)


# -- the OpenCV detectors' kernels (H1-H3) -----------------------------------

HAAR_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "gstbad_tpu_torch", "data", "")


def _haar_planes(dev, h, w):
    from gstbad_tpu_torch.ops.resize import resize_linear
    face = np.load(HAAR_DATA + "face_fixture.npz")["frame"].astype(np.float32)
    rng = np.random.default_rng(h * w)
    x = np.stack([face, face * np.float32(0.9) + np.float32(7.3),
                  (rng.random((161, 161)) * 255).astype(np.float32)])
    return resize_linear(torch.from_numpy(x).to(dev), h, w)


@pytest.mark.parametrize("name,form", [("haarcascade_frontalface_alt2",
                                        "arrays"), ("fist", "unrolled"),
                                       ("palm", "unrolled")])
@pytest.mark.parametrize("h,w", [(161, 161), (103, 90), (41, 65)])
def test_haar_kernels_match_plain(dev, name, form, h, w):
    from gstbad_tpu_torch.io.haarcascade import parse_cascade
    from gstbad_tpu_torch.ops import haar
    packed = haar.pack(parse_cascade(HAAR_DATA + name + ".xml"), form)
    x = _haar_planes(dev, h, w)
    ny, nx = haar.grid(h, w, packed)
    ii, sq = haar.integral(x), haar.integral(x * x)
    tii = None
    if packed.any_tilted:
        tii = haar.tilted_integral(x)
        assert torch.equal(tii.cpu(), haar.tilted_integral_plain(x.cpu()))
    kp, ks = haar.haar_cascade(ii, sq, tii, packed, ny, nx)
    pp, ps = haar.eval_cascade_plain(ii, sq, tii, packed, ny, nx)
    torch.cuda.synchronize()
    assert torch.equal(kp, pp)
    assert torch.equal(ks[pp], ps[pp])


@pytest.mark.parametrize("b,h,w,kind", [
    (2, 1, 40, "resize"), (2, 2, 40, "resize"), (2, 3, 40, "resize"),
    (16, 480, 640, "resize"), (2, 480, 640, "zero"), (2, 480, 640, "255"),
    (1, 20, 1024 - 129 - 21, "resize"), (1, 20, 1024 - 129 - 20, "resize"),
    (1, 20, 1024 - 129 - 19, "resize"),     # W + H + 129 = 1023, 1024, 1025
    (3, 100, 256 * 5 - 229 - 1, "resize"),  # 256 threads x 5 columns - 1
    (3, 100, 256 * 5 - 229, "resize"), (3, 100, 256 * 5 - 229 + 1, "resize"),
    (1, 1080, 1920, "resize"), (140, 40, 60, "resize"), (1, 57, 91, "255")])
def test_tilted_integral_kernel_equals_plain(dev, b, h, w, kind):
    """H2 bit for bit against tilted_integral_plain: planes 1 to 480 rows
    high, tables either side of 1024 columns and of a plan's threads x
    columns, a 1080p plane, 1 and 140 planes (more than the card's SMs);
    resize_linear's non-integer planes and planes of 0 and of 255."""
    from gstbad_tpu_torch.ops import haar
    from gstbad_tpu_torch.ops.resize import resize_linear
    if kind == "resize":
        rng = np.random.default_rng(b * h * w)
        src = (rng.random((b, h + 7, w + 5)) * 255).astype(np.float32)
        x = resize_linear(torch.from_numpy(src).to(dev), h, w)
    else:
        x = torch.full((b, h, w), 0.0 if kind == "zero" else 255.0,
                       device=dev)
    before = haar.tilted_integral.launches
    got = haar.tilted_integral(x)
    torch.cuda.synchronize()
    assert haar.tilted_integral.launches == before + 1
    want = haar.tilted_integral_plain(x.cpu())
    assert got.shape == want.shape and got.dtype == torch.float64
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("b,h,w", [(1, 5, 7), (3, 37, 53), (2, 480, 640)])
def test_tilted_integral_unaligned_input(dev, off, b, h, w):
    """Planes that start 0-3 floats past a 16-byte boundary, or whose
    floats do not end on one, give the plain version's table; the entry
    point itself refuses a pointer off a 16-byte boundary (its bulk
    copies read whole 16-byte units)."""
    from gstbad_tpu_torch.ops import _cuda, haar
    n = b * h * w
    rng = np.random.default_rng(off + n)
    base = torch.from_numpy((rng.random(n + 4) * 255).astype(np.float32))
    x = base.to(dev)[off:off + n].view(b, h, w)
    assert torch.equal(haar.tilted_integral(x).cpu(),
                       haar.tilted_integral_plain(x.cpu()))
    if off:
        p = haar.tilted_plan(h, w)
        out = torch.empty((b, h + 1, w + h + 2 * haar.TILT_PAD + 1),
                          dtype=torch.float64, device=dev)
        with pytest.raises(RuntimeError):
            _cuda.launch("gst_haar_tilted_integral", x, out, b, h, w,
                         p.cols, p.threads, x.numel())


def test_tilted_integral_raises_on_a_plane_too_wide(dev):
    """A 2 x W plane whose shared rings do not fit on the card has no
    launch: the kernel's launcher refuses it before the card runs
    anything, one column after the widest that runs (and equals the plain
    version), though the block's threads x columns would take it; a table
    wider than those raises in the wrapper."""
    from gstbad_tpu_torch.ops import haar

    def runs(w):
        try:
            haar.tilted_integral(torch.zeros((1, 2, w), device=dev))
            return True
        except RuntimeError:
            return False

    lo, hi = 1000, 7500
    assert runs(lo) and not runs(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if runs(mid) else (lo, mid)
    haar.tilted_plan(2, hi)
    x = torch.from_numpy((np.random.default_rng(3).random((1, 2, lo))
                          * 255).astype(np.float32)).to(dev)
    assert torch.equal(haar.tilted_integral(x).cpu(),
                       haar.tilted_integral_plain(x.cpu()))
    before = haar.tilted_integral.launches
    with pytest.raises(RuntimeError):
        haar.tilted_integral(torch.zeros((1, 2, hi), device=dev))
    assert haar.tilted_integral.launches == before
    with pytest.raises(ValueError):
        haar.tilted_integral(torch.zeros((1, 2, 7600), device=dev))


def _h1_check(packed, x):
    """H1 against eval_cascade_plain on planes x: passed equal at every
    window, score equal where passed; -> windows passing."""
    from gstbad_tpu_torch.ops import haar
    ny, nx = haar.grid(x.shape[-2], x.shape[-1], packed)
    ii, sq = haar.integral(x), haar.integral(x * x)
    tii = haar.tilted_integral(x) if packed.any_tilted else None
    before = haar.haar_cascade.launches
    kp, ks = haar.haar_cascade(ii, sq, tii, packed, ny, nx)
    assert haar.haar_cascade.launches == before + 1
    pp, ps = haar.eval_cascade_plain(ii, sq, tii, packed, ny, nx)
    torch.cuda.synchronize()
    assert torch.equal(kp, pp)
    assert torch.equal(ks[pp], ps[pp])
    return int(pp.sum())


def _haar_packed(name, form):
    from gstbad_tpu_torch.io.haarcascade import parse_cascade
    from gstbad_tpu_torch.ops import haar
    return haar.pack(parse_cascade(HAAR_DATA + name + ".xml"), form)


@pytest.mark.parametrize("name,form", [("haarcascade_frontalface_alt2",
                                        "arrays"), ("fist", "unrolled")])
@pytest.mark.parametrize("h,w", [(57, 91), (26, 300), (203, 47)])
def test_haar_cascade_ragged_tiles(dev, name, form, h, w):
    """Window grids that are no multiple of the kernel's tile."""
    from gstbad_tpu_torch.ops import haar
    packed = _haar_packed(name, form)
    tx, ty = haar.plan(packed).tile
    ny, nx = haar.grid(h, w, packed)
    assert ny % ty and nx % tx
    _h1_check(packed, _haar_planes(dev, h, w))


@pytest.mark.parametrize("name,form", [("haarcascade_frontalface_alt2",
                                        "arrays"), ("fist", "unrolled"),
                                       ("palm", "unrolled")])
@pytest.mark.parametrize("everywhere", [True, False])
def test_haar_cascade_all_or_none_pass(dev, name, form, everywhere):
    """A flat plane with a copy of the cascade whose stage thresholds are
    -1e30 (every window runs every stage and passes: the warps take the
    late stages of whole tiles) or 1e30 (none passes the first)."""
    import copy
    from gstbad_tpu_torch.ops import haar
    packed = copy.copy(_haar_packed(name, form))
    packed.stage_thr = np.full_like(packed.stage_thr,
                                    -1e30 if everywhere else 1e30)
    x = torch.full((2, 60, 100), 93.0, device=dev)
    ny, nx = haar.grid(60, 100, packed)
    assert _h1_check(packed, x) == (2 * ny * nx if everywhere else 0)


def _pixel_cascade(trees_per_stage):
    """A cascade on a 4x4 window whose stage s passes where the window's
    pixel (s % 2, 0) is positive: each tree two nodes on that pixel (a
    weight of -1 against a threshold of 0), a leaf of 1 on the left."""
    from gstbad_tpu_torch.ops import haar
    rects, wts, leaf, child = [], [], [], []
    tree_nodes, stage_trees, stage_thr = [0], [0], []
    for s, nt in enumerate(trees_per_stage):
        for _ in range(nt):
            base = len(rects)
            for d in range(2):
                r = np.zeros((3, 4), np.int32)
                r[0] = (s % 2, 0, 1, 1)
                w = np.zeros(3, np.float32)
                w[0] = -1.0
                rects.append(r)
                wts.append(w)
                leaf.append((1.0, 0.0) if d else (0.0, 0.0))
                child.append((base + 1, -1) if d == 0 else (-1, -1))
            tree_nodes.append(len(rects))
        stage_trees.append(len(tree_nodes) - 1)
        stage_thr.append(nt - 0.5)
    n = len(rects)
    return haar.Packed((4, 4), np.asarray(rects), np.asarray(wts),
                       np.zeros(n, np.int32), np.zeros(n, np.float32),
                       np.asarray(leaf, np.float32),
                       np.asarray(child, np.int32),
                       np.asarray(tree_nodes, np.int32),
                       np.asarray(stage_trees, np.int32),
                       np.asarray(stage_thr, np.float32), True)


@pytest.mark.parametrize("pattern", ["edges", "one", "below", "at",
                                     "above"])
def test_haar_cascade_survivors_on_tile_edges(dev, pattern):
    """Windows that pass every stage on the edges of the kernel's tiles,
    or the first 1, warp_max - 1, warp_max and warp_max + 1 of a tile
    (the survivors at which warps take over), beside windows that pass
    stage 0 and fail stage 1; stages of 1 to 70 trees, so a warp's lanes
    take one to three rounds of 32."""
    from gstbad_tpu_torch.ops import haar
    packed = _pixel_cascade([3, 40, 33, 64, 1, 70, 32])
    pl = haar.plan(packed)
    tx, ty = pl.tile
    ny, nx = 2 * ty + 7, 3 * tx - 5
    h, w = (ny - 1) * haar.STRIDE + 4, (nx - 1) * haar.STRIDE + 4
    x = np.zeros((3, h, w), np.float32)
    wy, wx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    ly, lx = wy % ty, wx % tx
    if pattern == "edges":
        keep = (lx == 0) | (lx == tx - 1) | (ly == 0) | (ly == ty - 1)
    else:
        k = {"one": 1, "below": pl.warp_max - 1, "at": pl.warp_max,
             "above": pl.warp_max + 1}[pattern]
        keep = ly * tx + lx >= tx * ty - k      # the tile's last k
    half = ~keep & ((wy + wx) % 3 == 0)     # pass stage 0, fail stage 1
    for f in range(3):
        x[f, wy[keep] * 2, wx[keep] * 2] = 1.0 + f
        x[f, wy[keep] * 2 + 1, wx[keep] * 2] = 2.0
        x[f, wy[half] * 2, wx[half] * 2] = 3.0
    assert _h1_check(packed, torch.from_numpy(x).to(dev)) == 3 * keep.sum()


def test_haar_cascade_more_frames_than_sms(dev):
    """More frames than the card has SMs: alt2 on random planes, and the
    pixel cascade passing a pattern of windows that moves with the
    frame."""
    from gstbad_tpu_torch.ops import haar
    n = torch.cuda.get_device_properties(0).multi_processor_count + 9
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.random((n, 36, 70)) * 255).astype(
        np.float32)).to(dev)
    _h1_check(_haar_packed("haarcascade_frontalface_alt2", "arrays"), x)
    packed = _pixel_cascade([3, 40, 33])
    ny, nx = 21, 40
    x = np.zeros((n, (ny - 1) * haar.STRIDE + 4, (nx - 1) * haar.STRIDE + 4),
                 np.float32)
    wy, wx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    want = 0
    for f in range(n):
        keep = (wy + wx + f) % 7 == 0
        x[f, wy[keep] * 2, wx[keep] * 2] = 1.0
        x[f, wy[keep] * 2 + 1, wx[keep] * 2] = 1.0
        want += int(keep.sum())
    assert _h1_check(packed, torch.from_numpy(x).to(dev)) == want


@pytest.mark.parametrize("h,w,d", [(48, 160, 64), (33, 70, 64), (20, 50, 40)])
def test_sgm_kernel_matches_plain(dev, h, w, d):
    from gstbad_tpu_torch.ops import stereo
    rng = np.random.default_rng(h)
    tex = rng.integers(0, 256, (2, h, w + 80)).astype(np.uint8)
    left = torch.from_numpy(tex[:, :, 40:40 + w].copy()).to(dev)
    right = torch.from_numpy(tex[:, :, 45:45 + w].copy()).to(dev)
    cost = stereo.sgm_cost(left, right, d)
    for axis, rev, shear in stereo.SGM_PASSES:
        total = torch.full_like(cost, 3.0)
        want = stereo.sgm_aggregate_plain(cost, total.clone(), axis, rev,
                                          shear, 200, 255)
        got = stereo.sgm_aggregate(cost, total, axis, rev, shear, 200, 255)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (axis, rev, shear)


@pytest.mark.parametrize("desc", [
    "facedetect profile={alt2} min-neighbors=1",
    "faceblur profile={alt2} min-neighbors=1",
    "handdetect",
    "segmentation method=mog2 test-mode=true"])
def test_detector_on_card_equals_cpu_port(dev, desc):
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.core.spec import MediaSpec
    face = np.load(HAAR_DATA + "face_fixture.npz")["frame"]
    rng = np.random.default_rng(3)
    fmt = "RGBA" if desc.startswith("segmentation") else "RGB"
    frames = rng.integers(40, 200, (4, 176, 184, len(fmt))).astype(np.uint8)
    frames[1:3, 5:166, 9:170, :3] = face[..., None]
    name, *props = desc.format(
        alt2=HAAR_DATA + "haarcascade_frontalface_alt2.xml").split()
    kw = dict(p.split("=") for p in props)
    out = []
    for device in ("cuda", "cpu"):
        hn = Harness(name, device=device, **kw)
        hn.set_src_spec(MediaSpec(kind="video", format=fmt, width=184,
                                  height=176))
        res = hn.push(frames[:2]) + hn.push(frames[2:])
        out.append((res,
                    [(m.name, m.pts, str(m.fields)) for m in hn.bus.messages]))
    (a, am), (b, bm) = out
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.data, y.data)
        np.testing.assert_array_equal(x.valid, y.valid)
    assert am == bm


@pytest.mark.parametrize("mode", sorted(overlay.MODES))
@pytest.mark.parametrize("c,size,n_layers", [(4, (5, 7), 1), (3, (13, 17), 3),
                                             (1, (9, 31), 2),
                                             (4, (1080, 1921), 3)])
def test_overlay_blend_kernel_matches_plain(dev, mode, c, size, n_layers):
    """H4 against its plain version on the card: strided and shifted
    planes, overlapping layers with gaps, odd sizes."""
    h, w = size
    rng = np.random.default_rng(h * w + c)
    frames = torch.from_numpy(rng.integers(0, 256, (3, h, w, c),
                                           dtype=np.uint8)).to(dev)
    bank = torch.from_numpy(rng.integers(0, 256, (4, 2 * h + 1, 2 * w + 1, 4),
                                         dtype=np.uint8)).to(dev)
    layers = torch.from_numpy(rng.integers(-1, 4, (3, n_layers)).astype(
        np.int32)).to(dev)
    alpha = bank[:, ::2, ::2, 0][:, :h, :w]
    planes = [(bank[:, :h, :w, 1], 0), (bank[..., 2], 1),
              (bank[:, 1::2, 1::2, 3], 0)]
    chan = {1: (1,), 3: (2, 0, 3 if mode == "cairo_over" else 1),
            4: (3 if mode == "cairo_over" else None, 1, 0, 2)}[c]
    ac = 0 if mode == "shr8_rgb_alpha" and c == 4 else None
    got = overlay.overlay_blend(frames, alpha, planes, layers, chan, mode, ac)
    want = overlay.overlay_blend_plain(frames, alpha, planes, layers, chan,
                                       mode, ac)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


OVERLAY_SVG = ('<svg xmlns="http://www.w3.org/2000/svg" width="20" '
               'height="10"><circle cx="8" cy="5" r="4" fill="#ff4020" '
               'fill-opacity="0.6"/></svg>')


@pytest.mark.parametrize("name,fmt,kw", [
    ("qroverlay", "BGR", {"data": "card", "pixel-size": 2}),
    ("debugqroverlay", "RGBA", {"max-frames": 3}),
    ("rsvgoverlay", "BGRA", {"fit-to-frame": True, "data": OVERLAY_SVG})])
def test_overlay_element_on_card_equals_cpu_port(dev, name, fmt, kw):
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.elements.video.qroverlay import DebugQrOverlay
    from gstbad_tpu_torch.io import rsvg
    if name == "rsvgoverlay" and not rsvg.available():
        pytest.skip("librsvg/cairo not present")
    frames = np.random.default_rng(5).integers(
        0, 256, (4, 37, 61, len(fmt)), dtype=np.uint8)
    out = []
    for device in ("cuda", "cpu"):
        launched = overlay.overlay_blend.launches
        DebugQrOverlay._instances = 0        # the JSON names its instance
        hn = Harness(name, device=device, **kw)
        hn.set_src_spec(MediaSpec(kind="video", format=fmt, width=61,
                                  height=37))
        out.append(hn.push(frames[:2]) + hn.push(frames[2:]))
        if device == "cuda":
            assert overlay.overlay_blend.launches == launched + 2
    for x, y in zip(*out):
        np.testing.assert_array_equal(x.data, y.data)


@pytest.mark.parametrize("kbps,mbs,dropn,bits", [
    (1500000, 200000, 3, 66355200), (-1, 50, 0, 1536), (0, 40, 9, 1536),
    (45, -1, 2, 1536), (30, 5, 1, 1536)])
def test_netsim_bucket_kernel_matches_plain(dev, kbps, mbs, dropn, bits):
    from gstbad_tpu_torch.ops import netsim as netsim_ops
    rng = np.random.default_rng(kbps + 7)
    carry = torch.tensor([mbs * 1000 if mbs > 0 else 0, -1, dropn])
    k = torch.tensor(kbps, dtype=torch.int32)
    m = torch.tensor(mbs, dtype=torch.int32)
    t = 0
    for n in (64, 1, 17):    # the carry threaded through three windows
        pts = t + np.cumsum(rng.integers(-20, 80, n) * 10**6)
        t = int(pts[-1])
        pts = torch.from_numpy(pts.astype(np.int64))
        valid = torch.from_numpy(rng.random(n) < 0.8)
        launched = netsim_ops.netsim_bucket.launches
        got = netsim_ops.netsim_bucket(pts.to(dev), valid.to(dev), bits,
                                       k.to(dev), m.to(dev), carry.to(dev))
        assert netsim_ops.netsim_bucket.launches == launched + 1
        want = netsim_ops.netsim_bucket_plain(pts, valid, bits, k, m, carry)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        carry = want[1]


@pytest.mark.parametrize("desc,n,window", [
    ("videotestsrc pattern=ball width=64 height=48 format=BGRx ! netsim "
     "max-kbps=1500 max-bucket-size=200 drop-packets=3 ! fakesink", 32, 16),
    ("videotestsrc pattern=ball width=64 height=48 format=I420 ! netsim "
     "duplicate-probability=1 delay-probability=1 min-delay=40 max-delay=40 "
     "delay-distribution=gamma allow-reordering=false ! fakesink", 16, 8),
    ("audiotestsrc samplesperbuffer=480 format=F32 ! speed speed=1.5 "
     "! fakesink", 16, 8),
    ("audiotestsrc samplesperbuffer=480 format=S16 ! speed speed=0.7 "
     "! fakesink", 16, 8),
    ("videotestsrc width=64 height=48 framerate=30000/1001 "
     "! timecodestamper drop-frame=true set-internal-timecode=00:09:59;20 "
     "! fakesink", 32, 16),
    ("videotestsrc pattern=ball width=64 height=48 format=I420 "
     "! autovideoconvert ! videoconvert format=BGRx ! checksumsink",
     16, 8)])
def test_deferred_graph_on_card_equals_cpu_port(dev, desc, n, window):
    from gstbad_tpu_torch.ops import netsim as netsim_ops
    out = {}
    for device in ("cuda", "cpu"):
        launched = netsim_ops.netsim_bucket.launches
        p = gtt.parse_launch(desc, device=device)
        res = p.run(n_frames=n, window=window)
        out[device] = (res, [(m.element, m.name, m.pts, m.fields)
                             for m in p.bus.messages])
        if device == "cuda" and "netsim" in desc:
            assert netsim_ops.netsim_bucket.launches == \
                launched + n // window
    assert out["cuda"][1] == out["cpu"][1]
    assert len(out["cuda"][0]) == len(out["cpu"][0])
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        np.testing.assert_array_equal(a.pts, b.pts)
        np.testing.assert_array_equal(a.valid, b.valid)
        da = a.data if isinstance(a.data, dict) else {"": a.data}
        db = b.data if isinstance(b.data, dict) else {"": b.data}
        for k in db:
            np.testing.assert_array_equal(da[k], db[k])


def _session_run(case, device, tmp_path):
    """One session scenario on `device`: what it dispatched or wrote and
    its messages (states by value, file names without directories)."""
    import time
    from gstbad_tpu_torch.session import Play, camera

    def fields(f):
        return {k: (os.path.basename(v) if k in ("filename", "location")
                    else getattr(v, "value", v)) for k, v in f.items()
                if k not in ("media_info", "buffer")}

    frames = []

    def keep(b, i):
        d = b.data
        frames.append((int(b.pts[i]),
                       {k: np.array(v[i]) for k, v in d.items()}
                       if isinstance(d, dict) else np.array(d[i])))

    if case.startswith("camera"):
        out = tmp_path / device
        out.mkdir()
        cam = camera.Camera(source="videotestsrc pattern=ball width=64 "
                            "height=48 format=AYUV", mode=camera.MODE_VIDEO,
                            zoom=2.0, window=4, post_previews=True,
                            location=str(out / "vid_%d.raw"), device=device)
        cam.set_ev_compensation(1.0)
        if case == "camera":
            cam.set_color_tone_mode("sepia")
        else:
            # tone normal: the chroma goes through the float64 gains
            cam.set_iso_speed(400)
            assert cam.set_white_balance_mode("cloudy")
        cam.start_capture()
        cam.step()
        with open(cam.stop_capture(), "rb") as f:
            data = f.read()
        return data, [(m.name, fields(m.fields)) for m in cam.bus.messages]
    if case == "headline":
        p = Play(f"videotestsrc pattern=ball width=64 height=48 format=BGRx "
                 f"! {HEAD} ! zebrastripe ! fakesink", window=4,
                 realtime=False, n_frames=12, on_frame=keep, device=device)
        p.set_color_balance("hue", 0.6)
        p.set_color_balance("saturation", 0.7)
        p.set_config(seek_accurate=True)
        p.seek(4 * (10**9 // 30))
    else:
        p = Play("audiotestsrc wave=sine freq=440 samplesperbuffer=480 "
                 "! fakeaudiosink", window=4, realtime=False, n_frames=8,
                 on_frame=keep, device=device)
        p.set_volume(0.5)
        assert p.set_visualization("wavescope")
        p.set_visualization_enabled(True)
        # the style on the element Play made (dots takes no filter)
        assert p._prepare()
        p._vis_node.element.set_property("style", "color-lines")
    p.play()
    deadline = time.time() + 120
    while p.state.value != "stopped" and time.time() < deadline:
        time.sleep(0.01)
    p.stop()
    return frames, [(m.name, fields(m.fields)) for m in p.message_bus.messages]


@pytest.mark.parametrize("case", ["headline", "vis", "camera",
                                  "camera_cloudy"])
def test_sessions_on_card_equal_cpu_port(dev, case, tmp_path):
    """Play of the headline with a colour balance (K1 once a window), of
    a sine with a color-lines wavescope (scope_filter once a window) and
    a Camera recording in sepia and in tone normal under the cloudy
    gains: the card's frames, messages and bytes equal the CPU port's."""
    kernel = {"headline": chainfuse.dilate_zebra_fused,
              "vis": audio.scope_filter}.get(case)
    before = kernel.launches if kernel is not None else 0
    got, msgs = _session_run(case, "cuda", tmp_path)
    if kernel is not None:
        assert kernel.launches - before == 2
    want, cpu_msgs = _session_run(case, "cpu", tmp_path)
    assert msgs == cpu_msgs
    if case.startswith("camera"):
        assert got == want and len(got) == 8 * 48 * 64 * 4
        return
    assert [f[0] for f in got] == [f[0] for f in want]
    for (_, a), (_, b) in zip(got, want):
        a = a if isinstance(a, dict) else {"": a}
        b = b if isinstance(b, dict) else {"": b}
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def _rtp_headline(device, frames, window):
    """rtpsrc ! videoconvert format=BGRx ! the headline's chain !
    zebrastripe ! videoconvert format=BGRA ! rtpsink over localhost UDP:
    the frames' RFC 4175 datagrams sent before the run (they fit in the
    socket's buffer), an RTCP BYE after them; the depaid output and the
    pipeline's leaf batches."""
    import socket
    from gstbad_tpu_torch.io import rtpnet

    def port_pair():
        while True:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            s.close()
            if port % 2 == 0 and port < 65534:
                return port

    n, h, w = frames.shape[:3]
    p_in, p_out = port_pair(), port_pair()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", p_out))
    rx.setblocking(False)
    p = gtt.parse_launch(
        f"rtpsrc uri=rtp://127.0.0.1:{p_in}?latency=50 "
        'caps="application/x-rtp,media=video,encoding-name=RAW,'
        f'sampling=BGRA,width={w},height={h},framerate=60/1" '
        f"! videoconvert format=BGRx ! {HEAD} ! zebrastripe "
        f"! videoconvert format=BGRA ! rtpsink uri=rtp://127.0.0.1:{p_out}",
        device=device)
    p.negotiate()
    src = p.nodes[0].element
    src.open()
    pay = rtpnet.RawVideoPayloader("BGRA", w, h)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in range(n):
        for pk in pay.pay_frame(frames[i], 1500 * i):
            tx.sendto(pk.serialize(), ("127.0.0.1", p_in))
    tx.sendto(rtpnet.rtcp_bye(pay.ssrc), ("127.0.0.1", p_in + 1))
    tx.close()
    outs = p.run(window=window)
    p.close()
    depay = rtpnet.RawVideoDepayloader("BGRA", w, h)
    back = []
    while True:
        try:
            back += depay.depay(rtpnet.RtpPacket.parse(rx.recv(65536)))
        except BlockingIOError:
            break
    rx.close()
    return p, outs, back


@pytest.mark.parametrize("size", [(256, 16), (200, 18)])
def test_rtp_headline_on_card_equals_cpu_port(dev, size):
    """2 windows of 4 seeded BGRA frames in over RTP and out over RTP:
    K1 once a window on the card (the frames are not time-invariant), and
    every frame back equal to the CPU port's, pts within one 90 kHz
    tick."""
    w, h = size
    frames = np.random.default_rng(5).integers(0, 256, (8, h, w, 4),
                                               dtype=np.uint8)
    before = chainfuse.dilate_zebra_fused.launches
    _, outs, back = _rtp_headline("cuda", frames, 4)
    assert chainfuse.dilate_zebra_fused.launches - before == 2
    _, cpu_outs, cpu_back = _rtp_headline("cpu", frames, 4)
    assert len(back) == len(cpu_back) == 8
    for (ts, f), (cts, cf), i in zip(back, cpu_back, range(8)):
        assert ts == cts and abs(ts - 1500 * i) <= 1
        np.testing.assert_array_equal(f, cf)
    for a, b in zip(outs, cpu_outs):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.pts, b.pts)


def test_k1_on_the_rtp_window_matches_plain(dev):
    """K1 on the window rtpsrc uploaded (a materialized [B, H, W] source,
    not a broadcast base), against its plain version."""
    frames = np.random.default_rng(6).integers(0, 256, (4, 24, 256, 4),
                                               dtype=np.uint8)
    calls = []
    orig = chainfuse.dilate_zebra_fused

    def spy(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    spy.launches = 0      # the wrapper counts on the module's attribute
    chainfuse.dilate_zebra_fused = spy
    try:
        _rtp_headline("cuda", frames, 4)
    finally:
        chainfuse.dilate_zebra_fused = orig
    (args, kw), = calls
    src, rank_t, word_t, index, erode, thr, phase = args
    assert tuple(src.shape) == (4, 24, 256) and src.is_cuda
    scal = torch.stack([chainfuse._per_frame_i32(v, 4, src.device)
                        for v in (erode, thr, phase)])
    torch.testing.assert_close(
        orig(*args, **kw),
        chainfuse.dilate_zebra_plain(src, rank_t, word_t, index, scal),
        rtol=0, atol=0)


def _vmnc_headline(device, packets, window):
    import chip_smoke
    p = gtt.parse_launch("vmncdec framerate=60/1 ! " + chip_smoke.HEAD
                         + " ! zebrastripe ! fakesink", device=device)
    src = p.nodes[0].element
    for x in packets:
        src.push_packet(x)
    return p.run(window=window)


@pytest.mark.parametrize("size", [(256, 32), (200, 18)])
def test_vmnc_headline_on_card_equals_cpu_port(dev, size):
    """A seeded VMnc recording (chip_smoke.screen_updates: RAW, then COPY,
    HEXTILE and cursor updates) through vmncdec ! the headline's chain, 2
    windows of 4: K1 once a window on the card, every frame and pts equal
    to the CPU port's."""
    import chip_smoke
    packets = chip_smoke.screen_updates(8, *size)
    before = chainfuse.dilate_zebra_fused.launches
    outs = _vmnc_headline("cuda", packets, 4)
    assert chainfuse.dilate_zebra_fused.launches - before == 2
    cpu = _vmnc_headline("cpu", packets, 4)
    assert len(outs) == len(cpu) == 2
    for a, b in zip(outs, cpu):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.pts, b.pts)


def test_onnx_detector_on_card_matches_cpu_port(dev, tmp_path):
    """chip_smoke.onnx_model in onnxobjectdetector behind a 128x96 ball, 2
    windows of 4: no hand-written kernel launched, the keep masks equal
    and scores, boxes and classes within 1e-4 of the CPU port's."""
    import chip_smoke
    model = tmp_path / "model.onnx"
    model.write_bytes(chip_smoke.onnx_model())
    desc = chip_smoke.ONNX_DETECT.format(w=128, h=96, model=model)
    counts = [f.launches for f in (chainfuse.dilate_zebra_fused,
                                   lut.apply_word_table)]
    got = {}
    for d in ("cuda", "cpu"):
        p = gtt.parse_launch(desc, device=d)
        p.run(n_frames=8, window=4)
        got[d] = [m.fields for m in p.bus.messages]
    assert counts == [f.launches for f in (chainfuse.dilate_zebra_fused,
                                           lut.apply_word_table)]
    assert len(got["cuda"]) == len(got["cpu"]) == 8
    for a, b in zip(got["cuda"], got["cpu"]):
        np.testing.assert_array_equal(a["scores"] > 0, b["scores"] > 0)
        for k in ("scores", "boxes", "classes"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)


def test_chroma_image_on_card_matches_cpu(dev):
    """chromaprint's chroma image of 20 s of phase 4m's chords at 11025
    Hz on the card (cuFFT) and on the CPU (pocketfft): within 1e-5 on
    rows of unit norm, and the same fingerprint string."""
    import chip_smoke
    from gstbad_tpu_torch.elements.audio import fingerprint
    mono = (chip_smoke.chord_audio(20, 11025).astype(np.float32)
            / 32768).mean(1).astype(np.float32)
    a = fingerprint._chroma_image(mono, "cuda")
    b = fingerprint._chroma_image(mono, "cpu")
    assert np.abs(a - b).max() <= 1e-5
    assert fingerprint._fingerprint_string(fingerprint._quantize(a)) == \
        fingerprint._fingerprint_string(fingerprint._quantize(b))


def _decoder_packets(name, w, h, n):
    """A seeded stream for one of the decoders, made by the port's own
    encoder on the CPU (skips where the decoder's library is missing):
    lossless x265, realtime AV1, lossless JPEG 2000 codestreams."""
    from gstbad_tpu_torch.elements.video import jpeg2000
    from gstbad_tpu_torch.io import av1, h265
    lib = {"libde265dec": h265.available, "av1dec": av1.available,
           "openjpegdec": jpeg2000.available}[name]
    if not lib():
        pytest.skip(f"{name}: its library is not present")
    rng = np.random.default_rng(17)
    if name == "openjpegdec":
        enc = "openjpegenc"
        p = gtt.parse_launch(f"appsrc name=src format=RGB width={w} "
                             f"height={h} ! {enc} name=enc ! fakesink",
                             device="cpu")
        p.get_by_name("src").push_frames(
            rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    else:
        enc = ("x265enc lossless=true speed-preset=ultrafast "
               "tune=zerolatency" if name == "libde265dec" else
               "av1enc usage-profile=realtime cpu-used=8")
        p = gtt.parse_launch(f"appsrc name=src format=I420 width={w} "
                             f"height={h} ! {enc} name=enc ! fakesink",
                             device="cpu")
        p.get_by_name("src").push_frames(
            {"y": rng.integers(0, 256, (n, h, w), dtype=np.uint8),
             "u": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
             "v": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)})
    p.run(window=n)
    p.close()
    packets = [d for _pts, d in p.get_by_name("enc").packets]
    return [b"".join(packets)] if name == "libde265dec" else packets


def _decoder_headline(name, device, packets, window):
    import chip_smoke
    p = gtt.parse_launch(f"{name} framerate=60/1 ! videoconvert format=BGRx "
                         f"! {chip_smoke.HEAD} ! zebrastripe ! fakesink",
                         device=device)
    for x in packets:
        p.nodes[0].element.push_packet(x)
    return p.run(window=window)


@pytest.mark.parametrize("name", ["libde265dec", "av1dec", "openjpegdec"])
def test_decoder_uploads_once_to_the_card(dev, name, monkeypatch):
    """Each decoder hands the runner a window in one host-to-device copy
    (core/frame.upload_frames) onto the card."""
    from gstbad_tpu_torch.core import frame
    packets = _decoder_packets(name, 64, 48, 5)
    seen = []
    orig = frame.upload_frames

    def spy(device, frames, **kw):
        out = orig(device, frames, **kw)
        seen.append((torch.device(device).type, len(frames),
                     out.pts.device.type))
        return out
    module = {"libde265dec": "h265codec", "av1dec": "av1codec",
              "openjpegdec": "jpeg2000"}[name]
    monkeypatch.setattr(f"gstbad_tpu_torch.elements.video.{module}."
                        "upload_frames", spy)
    outs = _decoder_headline(name, "cuda", packets, 4)
    assert seen == [("cuda", 4, "cuda"), ("cuda", 4, "cuda")]
    assert [len(b.pts) for b in outs] == [4, 1]


@pytest.mark.parametrize("name", ["libde265dec", "av1dec", "openjpegdec"])
@pytest.mark.parametrize("size", [(256, 32), (200, 48)])
def test_decoder_headline_on_card_equals_cpu_port(dev, name, size):
    """A decoded stream through `<decoder> ! videoconvert format=BGRx !
    the headline's chain ! zebrastripe`, 2 windows of 4: K1 once a window
    on the card, every frame and pts equal to the CPU port's."""
    packets = _decoder_packets(name, *size, 8)
    before = chainfuse.dilate_zebra_fused.launches
    outs = _decoder_headline(name, "cuda", packets, 4)
    assert chainfuse.dilate_zebra_fused.launches - before == 2
    cpu = _decoder_headline(name, "cpu", packets, 4)
    assert len(outs) == len(cpu) == 2
    for a, b in zip(outs, cpu):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.pts, b.pts)
