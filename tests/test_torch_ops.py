"""gstbad_tpu_torch ops against gstbad_tpu on the CPU.

Inputs come from numpy seeds and go through the JAX function and its port.
Where the JAX function is a Pallas kernel it runs in interpret mode, as the
JAX package's own tests run it (tests/test_tablefuse.py).  Tolerance: bit
exact (every path here is integer arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.core.tablefuse import TableChain as JTableChain
from gstbad_tpu.ops import chainfuse as jchainfuse
from gstbad_tpu.ops import lut as jlut
from gstbad_tpu.ops import pointops as jpointops
from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
from gstbad_tpu_torch.golden.gaudieffects import chromium_cos_table
from gstbad_tpu_torch.ops import _cuda, chainfuse, lut, pointops

torch.set_num_threads(1)   # parallel test workers share the cores


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(rng, shape, lo=-2**31, hi=2**31):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# -- table builders, per-run and per-frame [B] params ------------------------

def test_burn_table_all_adjustments():
    adj = np.arange(257, dtype=np.int32)               # [B] per-frame
    np.testing.assert_array_equal(
        lut.burn_table(_t(adj)).numpy(),
        np.asarray(jlut.burn_table(jnp.asarray(adj))))
    for a in (0, 175, 256):                            # per-run scalar
        np.testing.assert_array_equal(
            lut.burn_table(torch.tensor(a, dtype=torch.int32)).numpy(),
            np.asarray(jlut.burn_table(jnp.int32(a))))


def test_chromium_table_grid():
    ea, eb = np.meshgrid(np.arange(0, 257, 8), np.arange(0, 257, 16))
    ea, eb = ea.ravel().astype(np.int32), eb.ravel().astype(np.int32)
    cos = chromium_cos_table()
    np.testing.assert_array_equal(
        lut.chromium_table(_t(ea), _t(eb), _t(cos)).numpy(),
        np.asarray(jlut.chromium_table(jnp.asarray(ea), jnp.asarray(eb),
                                       jnp.asarray(cos))))
    np.testing.assert_array_equal(
        lut.chromium_table(torch.tensor(200), torch.tensor(1), _t(cos)).numpy(),
        np.asarray(jlut.chromium_table(jnp.int32(200), jnp.int32(1),
                                       jnp.asarray(cos))))


def test_dodge_table():
    np.testing.assert_array_equal(lut.dodge_table().numpy(),
                                  np.asarray(jlut.dodge_table()))


def test_solarize_table_wrap_semantics(rng):
    """Exact C int/uint32 wrap semantics, including the degenerate ranges
    (threshold == start, end == start, threshold past end)."""
    edge = np.array([[127, 50, 185], [0, 0, 256], [256, 0, 256],
                     [50, 50, 50], [10, 200, 40], [256, 256, 0],
                     [0, 256, 0], [200, 10, 10]], np.int32)
    rand = rng.integers(0, 257, (64, 3)).astype(np.int32)
    p = np.concatenate([edge, rand])
    got = lut.solarize_table(_t(p[:, 0]), _t(p[:, 1]), _t(p[:, 2])).numpy()
    want = np.asarray(jlut.solarize_table(*(jnp.asarray(p[:, i])
                                            for i in range(3))))
    np.testing.assert_array_equal(got, want)
    for thr, start, end in edge:                       # per-run scalars
        np.testing.assert_array_equal(
            lut.solarize_table(*(torch.tensor(int(v)) for v in
                                 (thr, start, end))).numpy(),
            np.asarray(jlut.solarize_table(jnp.int32(thr), jnp.int32(start),
                                           jnp.int32(end))))


def test_lookup_per_frame_tables(rng):
    """[B, 256] tables broadcast per frame over [B, H, W] indices (the
    controllable-curve path), against the JAX bit-plane lookup."""
    tables = rng.integers(0, 256, (3, 256)).astype(np.int32)
    idx = rng.integers(0, 256, (3, 5, 7)).astype(np.int32)
    got = lut.lookup(_t(idx), _t(tables)).numpy()
    want = np.asarray(jlut.apply_lut(jnp.asarray(idx),
                                     jlut.pack_table(jnp.asarray(tables))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(
        tables[:, None, :], idx.reshape(3, 1, 35), -1).reshape(3, 5, 7))


# -- kernel K2: apply_word_table ---------------------------------------------

def test_apply_word_table_vs_pallas_interpret(rng):
    table = _i32(rng, 256)
    idx = rng.integers(0, 256, (2, 16, 256)).astype(np.int32)
    want = np.asarray(jlut._word_lut_pallas(jnp.asarray(idx),
                                            jnp.asarray(table),
                                            interpret=True))
    np.testing.assert_array_equal(
        lut.apply_word_table(_t(idx), _t(table)).numpy(), want)


@pytest.mark.parametrize("shape", [(3, 18, 200), (1, 1, 1), (7,)])
def test_apply_word_table_any_shape(rng, shape):
    """No tiling gate: any shape, against the JAX package's CPU path."""
    table = _i32(rng, 256)
    idx = rng.integers(0, 256, shape).astype(np.int32)
    np.testing.assert_array_equal(
        lut.apply_word_table(_t(idx), _t(table)).numpy(),
        np.asarray(jlut.apply_word_table(jnp.asarray(idx),
                                         jnp.asarray(table))))


def test_apply_word_table_rejects_bad_inputs():
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        lut.apply_word_table(idx, torch.zeros(255, dtype=torch.int32))
    with pytest.raises(ValueError):
        lut.apply_word_table(idx.long(), torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError):
        lut.apply_word_table(idx, torch.zeros(256, dtype=torch.int64))


# -- kernel K1: dilate_zebra_fused ---------------------------------------------

# the sepia head's BT.709 luma on BGRx, and a second descriptor (the mean of
# bytes 1 and 2, the index of tests/test_tablefuse.py's broadcast test)
INDEXES = {
    "luma": (LinearIndex((19, 183, 54, 0), 8, 16),
             lambda w: (((jpointops.byte_of(w, 2) << 8) * 54)
                        + ((jpointops.byte_of(w, 1) << 8) * 183)
                        + ((jpointops.byte_of(w, 0) << 8) * 19)) >> 16),
    "mean12": (LinearIndex((0, 1, 1, 0), 0, 1),
               lambda w: (jpointops.byte_of(w, 1)
                          + jpointops.byte_of(w, 2)) >> 1),
}


def _chain_inputs(rng, sb, h, w):
    src = _i32(rng, (sb, h, w))
    word_t = _i32(rng, 256)
    key_t = rng.integers(0, 60000, 256).astype(np.int32)
    key_t[::7] = key_t[3]                   # ties map to equal ranks
    return src, word_t, key_t


@pytest.mark.parametrize("index_name", sorted(INDEXES))
@pytest.mark.parametrize("erode", [False, True])
@pytest.mark.parametrize("bcast", [False, True])
def test_dilate_zebra_fused_vs_pallas_interpret(rng, index_name, erode,
                                                bcast):
    b, h, w = 3, 16, 256
    index, jindex = INDEXES[index_name]
    src, word_t, key_t = _chain_inputs(rng, 1 if bcast else b, h, w)
    phase = np.arange(b, dtype=np.int32) + 5
    batch = b if bcast else None
    jrank = JTableChain.rank_table(jnp.asarray(key_t))
    want = np.asarray(jchainfuse.dilate_zebra_fused(
        jnp.asarray(src), jrank, jnp.asarray(word_t), jindex,
        jnp.bool_(erode), jnp.int32(120), jnp.asarray(phase),
        interpret=True, batch=batch))
    rank = TableChain.rank_table(_t(key_t))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    got = chainfuse.dilate_zebra_fused(
        _t(src), rank, _t(word_t), index, torch.tensor(erode),
        torch.tensor(120, dtype=torch.int32), _t(phase), batch=batch)
    np.testing.assert_array_equal(got.numpy(), want)


def _numpy_dilate_zebra(src, word_t, key_t, jindex, erode, thr, phase):
    """The step-by-step formulation of tests/test_tablefuse.py: luma index,
    rank-keyed dilate3 walk, word-table lookup, stripe select."""
    b, h, w = phase.shape[0], src.shape[1], src.shape[2]
    src = np.broadcast_to(src, (b, h, w))
    idx = np.asarray(jindex(jnp.asarray(src)))
    rank = np.asarray(JTableChain.rank_table(jnp.asarray(key_t)))[idx]

    def down(p):
        return np.concatenate([p[:, 1:, :], p[:, -1:, :]], axis=1)

    def right(p):
        return np.concatenate([p[:, :, 1:], p[:, :, -1:]], axis=2)

    def left(p):
        return np.concatenate([p[:, :, :1], p[:, :, :-1]], axis=2)

    oi, ok = idx.copy(), rank.copy()
    for s in (down, right, left):
        ni, nk = s(idx), s(rank)
        take = np.where(erode[:, None, None], nk < ok, nk > ok)
        oi = np.where(take, ni, oi)
        ok = np.where(take, nk, ok)
    word = word_t[oi]
    y = (word >> 8) & 255
    ii = np.arange(w)[None, None, :]
    jj = np.arange(h)[None, :, None]
    stripe = ((ii + jj + phase[:, None, None]) & 4) != 0
    zebra = (word & np.int32(np.uint32(0xFFFF00FF))) | (16 << 8)
    return np.where(stripe & (y >= thr[:, None, None]), zebra, word)


@pytest.mark.parametrize("index_name", sorted(INDEXES))
@pytest.mark.parametrize("bcast", [False, True])
def test_dilate_zebra_fused_ragged_shape(rng, index_name, bcast):
    """H=18, W=200 (no 8/128 tiling) with per-frame erode/thr/phase."""
    b, h, w = 4, 18, 200
    index, jindex = INDEXES[index_name]
    src, word_t, key_t = _chain_inputs(rng, 1 if bcast else b, h, w)
    erode = np.array([False, True, True, False])
    thr = np.array([0, 120, 200, 256], np.int32)
    phase = np.array([0, 3, 2**31 - 2, -7], np.int32)
    got = chainfuse.dilate_zebra_fused(
        _t(src), TableChain.rank_table(_t(key_t)), _t(word_t), index,
        _t(erode), _t(thr), _t(phase), batch=b if bcast else None)
    want = _numpy_dilate_zebra(src, word_t, key_t, jindex, erode, thr,
                               phase)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dilate_zebra_fused_rejects_bad_inputs(rng):
    src = torch.zeros((2, 4, 4), dtype=torch.int32)
    t = torch.zeros(256, dtype=torch.int32)
    index = INDEXES["luma"][0]
    with pytest.raises(ValueError):          # 2 source frames for batch 3
        chainfuse.dilate_zebra_fused(src, t, t, index, 0, 0, 0, batch=3)
    with pytest.raises(ValueError):
        chainfuse.dilate_zebra_fused(src.long(), t, t, index, 0, 0, 0)
    with pytest.raises(ValueError):
        chainfuse.dilate_zebra_fused(src, t[:128], t, index, 0, 0, 0)


# -- the linear index descriptor and the word views --------------------------

def test_linear_index_matches_coloreffects_luma(rng):
    words = _i32(rng, (5, 9, 11))
    index, jindex = INDEXES["luma"]
    np.testing.assert_array_equal(index(_t(words)).numpy(),
                                  np.asarray(jindex(jnp.asarray(words))))


@pytest.mark.parametrize("weights,pre,post", [
    ((255, 255, 255, 255), 8, 16),   # leaves int32
    ((54, 183, 19, 0), 8, 15),       # index reaches 511
    ((1, 1, 1, 1), 0, 1),            # index reaches 510
    ((-1, 1, 1, 0), 0, 0),           # negative weight
])
def test_linear_index_rejects_out_of_range(weights, pre, post):
    with pytest.raises(ValueError):
        LinearIndex(weights, pre, post)


def test_pack32_views_share_memory(rng):
    img = _t(rng.integers(0, 256, (2, 3, 5, 4)).astype(np.uint8))
    word = pointops.pack32(img)
    assert word.data_ptr() == img.data_ptr() and word.dtype == torch.int32
    np.testing.assert_array_equal(
        word.numpy(), np.asarray(jpointops.pack32(jnp.asarray(img.numpy()))))
    np.testing.assert_array_equal(pointops.unpack32(word).numpy(),
                                  img.numpy())
    # a broadcast frame (batch stride 0) views in place too
    base = img[:1].expand(4, 3, 5, 4)
    assert pointops.pack32(base).stride()[0] == 0


def test_rank_table_per_frame(rng):
    keys = rng.integers(0, 9, (3, 256)).astype(np.int32)   # many ties
    np.testing.assert_array_equal(
        TableChain.rank_table(_t(keys)).numpy(),
        np.asarray(JTableChain.rank_table(jnp.asarray(keys))))


def test_cuda_launch_refuses_cpu_tensors():
    """The launcher never takes a CPU tensor (nor builds anything for
    one): CPU callers take the plain versions."""
    with pytest.raises(ValueError):
        _cuda.launch("gst_word_lut", torch.zeros(4, dtype=torch.int32),
                      torch.zeros(256, dtype=torch.int32),
                      torch.zeros(4, dtype=torch.int32), 4)
    assert _cuda._lib is None
