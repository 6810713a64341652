"""H1's launch plan (gstbad_tpu_torch/ops/haar.py `plan`): the tile, the
regions of the summed-area and rotated tables a block copies into shared
memory, and the node records with their corners as region offsets.

A numpy copy of what the kernel does with the plan (each tile's regions,
a row's even columns first; each node's corners read at the window's
base plus the record's offsets) is held against direct reads of the
tables, and its walk of the cascade against eval_cascade_plain: passed
equal everywhere, score equal where passed.  Both bit exact."""

import copy
import os

import numpy as np
import pytest
import torch

from gstbad_tpu_torch.io.haarcascade import parse_cascade
from gstbad_tpu_torch.ops import haar

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "gstbad_tpu_torch", "data", "")
CASCADES = {"alt2": ("haarcascade_frontalface_alt2", "arrays"),
            "fist": ("fist", "unrolled"), "palm": ("palm", "unrolled")}


def _packed(name):
    f, form = CASCADES[name]
    return haar.pack(parse_cascade(DATA + f + ".xml"), form)


def _plane(b, h, w, seed):
    face = np.load(DATA + "face_fixture.npz")["frame"].astype(np.float32)
    rng = np.random.default_rng(seed)
    x = np.stack([face if i % 2 == 0 else
                  (rng.random((161, 161)) * 255).astype(np.float32)
                  for i in range(b)])
    from gstbad_tpu_torch.ops.resize import resize_linear
    return resize_linear(torch.from_numpy(x), h, w)


def _regions(table, reg, tile, ny, nx, pad=0):
    """[B, tiles_y, tiles_x, rows * pitch] as the kernel copies them: the
    rows from a tile's first window + dy0, the columns from its x + pad +
    dx0, zero off the table, even columns first in a row."""
    dy0, dx0, rows, pitch = reg
    tx, ty = tile
    b, hi, wt = table.shape
    tys, txs = -(-ny // ty), -(-nx // tx)
    out = np.zeros((b, tys, txs, rows, pitch), table.dtype)
    r = np.arange(rows)[:, None]
    c = np.arange(pitch)[None, :]
    order = (c & 1) * (pitch // 2) + (c >> 1)
    for by in range(tys):
        for bx in range(txs):
            gy = by * ty * haar.STRIDE + dy0 + r
            gx = bx * tx * haar.STRIDE + pad + dx0 + c
            ok = (gy >= 0) & (gy < hi) & (gx >= 0) & (gx < wt)
            vals = table[:, np.clip(gy, 0, hi - 1), np.clip(gx, 0, wt - 1)]
            dst = np.zeros((b, rows, pitch), table.dtype)
            dst[:, r, order] = np.where(ok, vals, 0)
            out[:, by, bx] = dst
    return out.reshape(b, tys, txs, rows * pitch)


class Walk:
    """The kernel's reads through the plan for every window of a frame
    set: read(k, j, tilted) -> [B, ny, nx] of node k's rect j's corners."""

    def __init__(self, packed, ii, tii, ny, nx):
        self.pl = pl = haar.plan(packed)
        tx, ty = pl.tile
        self.ny, self.nx = ny, nx
        wy, wx = np.arange(ny), np.arange(nx)
        self.tile_y, self.tile_x = wy // ty, wx // tx
        self.regs = {False: _regions(ii, pl.region, pl.tile, ny, nx)}
        base = {False: ((wy % ty)[:, None] * haar.STRIDE * pl.region[3]
                        + (wx % tx)[None, :])}
        if tii is not None:
            self.regs[True] = _regions(tii, pl.tregion, pl.tile, ny, nx,
                                       haar.TILT_PAD)
            base[True] = ((wy % ty)[:, None] * haar.STRIDE * pl.tregion[3]
                          + (wx % tx)[None, :])
        self.base = base
        offs = pl.records[:, :6].copy().view(np.uint16)
        self.offs = offs.reshape(-1, 3, 4).astype(np.int64)

    def corner(self, node, j, q, tilted):
        reg = self.regs[tilted]
        idx = self.base[tilted] + self.offs[node, j, q]
        return reg[:, self.tile_y[:, None], self.tile_x[None, :], idx]


def _direct_corners(packed, k, j, table, ny, nx, tilted, pad=0):
    """The same four corners read straight from the table."""
    live = np.flatnonzero(packed.weights[k] != 0)
    ry, rx, rh, rw = packed.rects[k, live[j]]
    if tilted:
        cs = [(ry, rx), (ry + rh, rx - rh), (ry + rw, rx + rw),
              (ry + rw + rh, rx + rw - rh)]
    else:
        cs = [(ry + rh, rx + rw), (ry, rx + rw), (ry + rh, rx), (ry, rx)]
    y = np.arange(ny)[:, None] * haar.STRIDE
    x = np.arange(nx)[None, :] * haar.STRIDE + pad
    return [table[:, y + dy, x + dx] for dy, dx in cs]


@pytest.mark.parametrize("name", sorted(CASCADES))
@pytest.mark.parametrize("h,w", [(47, 203), (161, 161), (24, 24)])
def test_plan_offsets_read_every_corner(name, h, w):
    packed = _packed(name)
    x = _plane(2, h, w, h * w)
    ny, nx = haar.grid(h, w, packed)
    ii = haar.integral(x).numpy()
    tii = haar.tilted_integral_plain(x).numpy() if packed.any_tilted \
        else None
    walk = Walk(packed, ii, tii, ny, nx)
    tilted = packed.tilted.astype(bool)
    nrect = walk.pl.records[:, 14] & 0xff
    assert (nrect == (packed.weights != 0).sum(1)).all()
    assert ((walk.pl.records[:, 14] >> 8) == tilted).all()
    for k in range(len(packed.thr)):
        for j in range(nrect[k]):
            want = _direct_corners(packed, k, j, tii if tilted[k] else ii,
                                   ny, nx, tilted[k],
                                   haar.TILT_PAD if tilted[k] else 0)
            for q in range(4):
                np.testing.assert_array_equal(
                    walk.corner(k, j, q, bool(tilted[k])), want[q])


def _fma32(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _fma64(w, s, c):
    hi = s.astype(np.float32).astype(np.float64)
    lo = s - hi
    p_hi, p_lo = w * hi, w * lo
    t = p_hi + c
    bv = t - p_hi
    err = (p_hi - (t - bv)) + (c - bv)
    return t + (err + p_lo)


def plan_walk(packed, ii, sq, tii, ny, nx):
    """The kernel's walk in numpy: every node read through its record,
    the corners through the plan's regions, a window's stage sum added in
    tree order, the windows that failed a stage left out of the next."""
    walk = Walk(packed, ii, tii, ny, nx)
    rec = walk.pl.records
    f32 = lambda v: np.asarray(v, np.int32).view(np.float32)  # noqa: E731
    ww, wh = packed.window
    inv_area = np.float32(1) / np.float32(ww * wh)
    inv64 = 1.0 / float(ww * wh)
    b = ii.shape[0]
    region = walk.pl.region

    def corners(table, reg, dys_dxs, tilted=False):
        return [walk.regs[tilted][:, walk.tile_y[:, None],
                                  walk.tile_x[None, :],
                                  walk.base[tilted]
                                  + haar.region_offset(reg, dy, dx)]
                for dy, dx in dys_dxs]

    win = [(wh, ww), (0, ww), (wh, 0), (0, 0)]
    a = corners(ii, region, win)
    tot = ((a[0] - a[1]) - a[2]) + a[3]
    y = np.arange(ny)[:, None] * haar.STRIDE
    x = np.arange(nx)[None, :] * haar.STRIDE
    q = [sq[:, y + dy, x + dx] for dy, dx in win]
    tsq = ((q[0] - q[1]) - q[2]) + q[3]
    mean = tot * inv_area
    mm = mean * mean
    var = _fma32(tsq, inv_area, -mm) if packed.fused_variance \
        else tsq * inv_area - mm
    var = np.maximum(var, np.float32(0))
    vnorm = np.where(var > 0, np.sqrt(var.astype(np.float64)).astype(
        np.float32), np.float32(1))

    alive = np.ones((b, ny, nx), bool)
    passed = np.zeros((b, ny, nx), bool)
    score = np.zeros((b, ny, nx), np.float32)
    n_st = len(packed.stage_thr)
    for s in range(n_st):
        if not alive.any():
            break
        st = np.zeros((b, ny, nx), np.float32)
        for t in range(packed.stage_trees[s], packed.stage_trees[s + 1]):
            node = np.full((b, ny, nx), packed.tree_nodes[t])
            val = np.zeros((b, ny, nx), np.float32)
            done = ~alive
            while not done.all():
                for k in np.unique(node[~done]):
                    at = ~done & (node == k)
                    r = rec[k]
                    limit = f32(r[9]) * vnorm
                    tilted = bool(r[14] >> 8)
                    acc = np.zeros((b, ny, nx),
                                   np.float64 if tilted else np.float32)
                    for j in range(r[14] & 0xff):
                        c = [walk.corner(k, j, i, tilted) for i in range(4)]
                        v = ((c[0] - c[1]) - c[2]) + c[3]
                        wk = f32(r[6 + j])
                        acc = _fma64(np.float64(wk), v, acc) if tilted \
                            else _fma32(wk, v, acc)
                    left = (acc * inv64 < limit.astype(np.float64)) \
                        if tilted else (acc * inv_area < limit)
                    nxt = np.where(left, r[12], r[13])
                    leaf = np.where(left, f32(r[10]), f32(r[11]))
                    end = at & (nxt < 0)
                    val = np.where(end, leaf, val)
                    node = np.where(at & ~end, nxt, node)
                    done = done | end
            st = np.where(alive, st + val, st)
        ok = st >= packed.stage_thr[s]
        score = np.where(alive, st, score)
        passed = np.where(alive & ok & (s == n_st - 1), True, passed)
        alive = alive & ok
    return passed, score


def _check(packed, x):
    b, h, w = x.shape
    ny, nx = haar.grid(h, w, packed)
    ii, sq = haar.integral(x), haar.integral(x * x)
    tii = haar.tilted_integral_plain(x) if packed.any_tilted else None
    pp, ps = haar.eval_cascade_plain(ii, sq, tii, packed, ny, nx)
    kp, ks = plan_walk(packed, ii.numpy(), sq.numpy(),
                       None if tii is None else tii.numpy(), ny, nx)
    np.testing.assert_array_equal(kp, pp.numpy())
    np.testing.assert_array_equal(ks[kp], ps.numpy()[kp])
    return int(kp.sum())


@pytest.mark.parametrize("name,h,w", [("alt2", 70, 90), ("fist", 61, 103),
                                      ("palm", 47, 64)])
def test_plan_walk_matches_plain(name, h, w):
    _check(_packed(name), _plane(2, h, w, 5))


@pytest.mark.parametrize("name", sorted(CASCADES))
@pytest.mark.parametrize("everywhere", [True, False])
def test_plan_walk_all_or_none_pass(name, everywhere):
    """A flat plane with the stage thresholds at -1e30 (every window runs
    every stage and passes) or at 1e30 (none passes the first)."""
    packed = copy.copy(_packed(name))
    packed.stage_thr = np.full_like(packed.stage_thr,
                                    -1e30 if everywhere else 1e30)
    x = torch.full((1, 40, 70), 93.0)
    n = _check(packed, x)
    ny, nx = haar.grid(40, 70, packed)
    assert n == (ny * nx if everywhere else 0)


def test_plan_rejects_a_child_before_its_parent():
    packed = copy.copy(_packed("alt2"))
    packed.child = packed.child.copy()
    packed.child[1, 0] = 0
    with pytest.raises(ValueError, match="child"):
        haar.plan(packed)


def test_plan_geometry():
    """The tile, regions and shared memory of the three cascades: the
    region covers the tile's windows and every corner, even pitch."""
    for name in CASCADES:
        packed = _packed(name)
        pl = haar.plan(packed)
        tx, ty = pl.tile
        assert tx * ty % 32 == 0 and tx * ty <= 65535
        ww, wh = packed.window
        dy0, dx0, rows, pitch = pl.region
        assert dy0 <= 0 and dx0 <= 0 and pitch % 2 == 0
        assert rows >= (ty - 1) * haar.STRIDE + wh + 1
        assert pitch >= (tx - 1) * haar.STRIDE + ww + 1
        assert (pl.tregion[2] > 0) == packed.any_tilted
        assert pl.n_smem == min(len(packed.thr), haar.SMEM_NODES)
        assert pl.warp_max == haar.WARP_MAX
        assert pl.smem_bytes() <= 227 * 1024
        assert haar.plan(packed) is pl
