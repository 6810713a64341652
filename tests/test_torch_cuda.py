"""gstbad_tpu_torch on a CUDA card: each hand-written kernel against its
plain version, and the headline graph on the card against the CPU port.

These tests need an NVIDIA card and nvcc, and skip without them.  They
import neither jax nor gstbad_tpu, so they run on a machine that has only
the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: bit exact (integer kernels).
"""

import numpy as np
import pytest
import torch

import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
from gstbad_tpu_torch.ops import chainfuse, lut

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
