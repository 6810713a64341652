"""gstbad_tpu_torch on a CUDA card: each hand-written kernel against its
plain version, and the headline, config-5, combdetect, config-2b (blur),
config-3 (audio), vad_square, config-4 and warp graphs on the card against
the CPU port.

These tests need an NVIDIA card and nvcc, and skip without them.  They
import neither jax nor gstbad_tpu, so they run on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit exact (integer kernels), but config3_audio's S16 samples,
within 1 LSB (freeverb's float32 sums, stated at its test).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
from gstbad_tpu_torch.golden import geometric
from gstbad_tpu_torch.models import benchmarks
from gstbad_tpu_torch.ops import (audio, blur, chainfuse, comb, fieldanalysis,
                                  lut, remap)

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


@pytest.mark.parametrize("shape,n", [((12, 48, 64), 11), ((6, 50, 130), 40),
                                     ((5, 22, 37), 33), ((3, 4, 9), 2),
                                     ((9, 720, 1280), 17)])
def test_comb_kernels_match_plain(dev, shape, n):
    rng = np.random.default_rng(14)
    pool = _u8(rng, shape, dev)
    ti = torch.from_numpy(rng.integers(0, shape[0], n).astype(np.int32)
                          ).to(dev)
    bi = torch.from_numpy(rng.integers(0, shape[0], n).astype(np.int32)
                          ).to(dev)
    before = (comb.comb_score_pairs.launches, comb.comb_mask.launches)
    got = comb.comb_score_pairs(pool, ti, bi)
    mask, score = comb.comb_mask(pool)
    assert (comb.comb_score_pairs.launches,
            comb.comb_mask.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, comb.comb_score_pairs_plain(pool, ti, bi))
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
@pytest.mark.parametrize("sigma", [1.2, -2.0, 8.0, 20.0])
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
