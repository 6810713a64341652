"""Viola-Jones Haar cascades (the torch form of gstbad_tpu/ops/haar.py):
the engine behind facedetect, faceblur and handdetect.

A window is a stride-2 position of the cascade's base window on one
pyramid scale; its rect sums are four corners of the summed-area table
(integral, jnp.cumsum's blocked order) or, for 45-degree features, of
OpenCV's rotated table (tilted_integral, float64 as the JAX package's is).
The JAX package evaluates every tree at every window, either as one
unrolled op chain per node (eval_cascade, the hand models) or as a scan
over trees (eval_cascade_arrays, the face models), and XLA's CPU code
rounds both alike but in one place: a node's feature is acc + w * s over
its rects (taken here as one FMA; on alt2, fist and palm the JAX bits do
not tell it from two roundings) times float32(1/area), a tilted one the
same in float64; the window variance total_sq * (1/area) - mean^2 is one
FMA in the arrays form and two roundings in the unrolled one (pack's
`form`).  With these the port equals both forms bit for bit on the CPU.

Two hand-written CUDA kernels (csrc/haar_kernels.cu) replace what would be
launch-bound on the card as plain ops (about 10^5 small ops a frame):
- `haar_cascade` (H1) walks one pyramid scale of a window of frames in
  one launch, a block a tile of windows: the tile's regions of the tables
  and the first node records go into shared memory once (`plan`), each
  stage runs one thread a window over the windows still alive, compacted
  after every stage, and a warp a window once few are left.  A window
  stops at its first failed stage.  Its contract: `passed` equals the
  plain version everywhere and `score` equals it where `passed`; the
  elements read score only there.
- `tilted_integral` (H2) is the rotated table's row recurrence, one block
  a plane: each thread keeps its columns of the last two rows in
  registers, one barrier a row; input rows come in and finished rows go
  out by bulk copies a few rows at a time; bit exact.
CPU tensors take the plain versions, which give the JAX package's passes
and scores at every window (a stage but the last only where the stages
before it passed) and also count the (window, node) evaluations the
kernel's early exit leaves (the kernel's work, for its bound)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.io.haarcascade import HaarCascade
from gstbad_tpu_torch.ops import scan
from gstbad_tpu_torch.ops.numerics import fma32
from gstbad_tpu_torch.ops.resize import resize_linear

STRIDE = 2
TILT_PAD = 64       # left margin of the rotated table for (x - h) corners
MAX_RECTS = 3
MAX_SCALES = 16     # the pyramid's depth (both JAX forms' default)


def _fma64(a, b, c):
    """a * b + c in float64 with one rounding, as XLA's CPU code contracts
    it: the product of a float32 weight and a float64 sum is exact in
    float64 only when the sum has 29 bits or fewer, so it is split into
    two exact halves (Dekker) and summed with the error carried."""
    hi = b.to(torch.float32).to(torch.float64)
    lo = b - hi                              # exact
    p_hi = a * hi                            # exact: 24 + 24 bits
    p_lo = a * lo
    s = p_hi + c
    bv = s - p_hi
    err = (p_hi - (s - bv)) + (c - bv)       # TwoSum: exact error of s
    return s + (err + p_lo)


def integral(x):
    """[..., H, W] -> [..., H+1, W+1] zero-padded summed-area table (f32),
    jnp.cumsum's order down the rows, then along them."""
    ii = scan.cumsum(scan.cumsum(x.to(torch.float32), dim=-2), dim=-1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def _tilt_input(x):
    """[B, H, W] -> f64 [B, H, Wp] with TILT_PAD zero columns left and
    H + TILT_PAD right (beyond x >= W + y the rotated table is zero)."""
    h = x.shape[-2]
    return torch.nn.functional.pad(x.to(torch.float32).to(torch.float64),
                                   (TILT_PAD, h + TILT_PAD))


def tilted_integral_plain(x):
    """OpenCV's rotated summed-area table (RSAT) of [B, H, W] with margins:
    [B, H+1, Wp+1] float64, column TILT_PAD at image x = 0.  Row y+1 is
    t[y, x-1] + t[y, x+1] - t[y-1, x] + I[y, x-1] + I[y-1, x-1], summed
    left to right.  The JAX package's row scan carries x64's float64
    zeros, so its table is float64, and so is this one."""
    xf = _tilt_input(x)
    b, h, wp = xf.shape
    zero = torch.zeros((b, 1), dtype=torch.float64, device=x.device)
    prev = torch.zeros((b, wp + 1), dtype=torch.float64, device=x.device)
    prev2 = prev
    rows = [prev]
    i_prev = torch.zeros((b, wp), dtype=torch.float64, device=x.device)
    for y in range(h):
        left = torch.cat([zero, prev[:, :-1]], 1)
        right = torch.cat([prev[:, 1:], zero], 1)
        i1 = torch.cat([zero, xf[:, y]], 1)
        i2 = torch.cat([zero, i_prev], 1)
        new = left + right - prev2 + i1 + i2
        prev, prev2, i_prev = new, prev, xf[:, y]
        rows.append(new)
    return torch.stack(rows, 1)


# H2's launch geometry (csrc/haar_kernels.cu tilted_integral_kernel): the
# kernel is built for these columns a thread and at most TILT_MAX_THREADS
# threads; it picks the rows its bulk copies move and lays out its shared
# rings itself, and refuses a plane whose rings do not fit on the card
TILT_COLS = (1, 3, 5, 7, 9, 11, 13, 15)   # odd: conflict-free shared stores
TILT_THREADS = 256      # the block the columns are spread over, if they fit
TILT_MAX_THREADS = 512


@dataclass(frozen=True)
class TiltPlan:
    """H2's launch for an h x w plane: a block a plane of `threads`
    threads, `cols` columns each (the W + H + 129 columns of the table)."""
    cols: int
    threads: int


def tilted_plan(h: int, w: int) -> TiltPlan:
    """The fewest columns a thread (of TILT_COLS) that spread the table's
    columns over at most TILT_THREADS threads (a table wider than 15 of
    them: 15 a thread, over up to TILT_MAX_THREADS).  Raises ValueError on
    a table wider than that."""
    w1 = w + h + 2 * TILT_PAD + 1
    cols = next((c for c in TILT_COLS if -(-w1 // c) <= TILT_THREADS),
                TILT_COLS[-1])
    threads = -(-w1 // (32 * cols)) * 32    # whole warps
    if threads > TILT_MAX_THREADS:
        raise ValueError(f"tilted_integral: a {h}x{w} plane's table of {w1} "
                         f"columns is wider than {TILT_MAX_THREADS} x "
                         f"{TILT_COLS[-1]}")
    return TiltPlan(cols, threads)


def tilted_integral(x):
    """tilted_integral_plain for [B, H, W]; on a CUDA tensor the H2
    kernel, which reads the float32 planes as they are (the margins are
    implicit zeros; a tensor that does not start and end on 16-byte
    boundaries is copied first): a block a plane walks its rows
    (tilted_plan).  Raises ValueError on a table too wide for the block,
    RuntimeError where the kernel's shared rings do not fit on the card
    (nothing runs)."""
    if x.device.type == "cpu":
        return tilted_integral_plain(x)
    from gstbad_tpu_torch.ops import _cuda
    x = x.to(torch.float32).contiguous()
    b, h, w = x.shape
    p = tilted_plan(h, w)
    n = x.numel()
    if x.data_ptr() % 16 or n % 4:
        # the kernel's bulk copies read whole 16-byte units: a copy that
        # starts and ends on 16-byte boundaries (handdetect's windows of
        # 16 planes from resize_linear need none)
        buf = torch.zeros((n + 3) & ~3, dtype=torch.float32,
                          device=x.device)
        buf[:n] = x.reshape(-1)
        x = buf
    out = torch.empty((b, h + 1, w + h + 2 * TILT_PAD + 1),
                      dtype=torch.float64, device=x.device)
    _cuda.launch("gst_haar_tilted_integral", x, out, b, h, w, p.cols,
                 p.threads, x.numel())
    tilted_integral.launches += 1
    return out


tilted_integral.launches = 0


# ---------------------------------------------------------------------------
# the packed cascade
# ---------------------------------------------------------------------------


@dataclass
class Packed:
    """A cascade as flat tables, shared by the plain version and H1.
    Node n: rects (ry, rx, rh, rw) int32 [N, 3, 4] with float32 weights
    [N, 3] (0 = unused slot), tilted, threshold, leaf values and global
    child indices (-1 = leaf).  Trees are [root, end) node ranges in
    order, stages [first, last) tree ranges."""
    window: Tuple[int, int]         # (w, h)
    rects: np.ndarray
    weights: np.ndarray
    tilted: np.ndarray              # [N] int32
    thr: np.ndarray                 # [N] float32
    leaf: np.ndarray                # [N, 2] float32 (left, right)
    child: np.ndarray               # [N, 2] int32 global, -1 = leaf
    tree_nodes: np.ndarray          # [T + 1] int32 node offsets
    stage_trees: np.ndarray         # [S + 1] int32 tree offsets
    stage_thr: np.ndarray           # [S] float32
    fused_variance: bool            # the arrays form's contraction

    @property
    def any_tilted(self) -> bool:
        return bool(self.tilted.any())


def pack(cascade: HaarCascade, form: str = "arrays") -> Packed:
    """form: "arrays" (eval_cascade_arrays, facedetect and faceblur) or
    "unrolled" (eval_cascade, handdetect).  They differ only in the
    window variance: XLA contracts the arrays form's total_sq * (1/area)
    - mean*mean into one FMA and leaves the unrolled form's two roundings
    (it decides by fusion; on a flat window the two give 0 and a small
    positive variance, so a vnorm of 1 or of its root)."""
    if form not in ("arrays", "unrolled"):
        raise ValueError(f"haar: unknown form {form!r}")
    rects, wts, tilted, thr, leaf, child = [], [], [], [], [], []
    tree_nodes, stage_trees, stage_thr = [0], [0], []
    for st in cascade.stages:
        for tr in st.trees:
            base = len(thr)
            for n in tr.nodes:
                r = np.zeros((MAX_RECTS, 4), np.int32)
                w = np.zeros(MAX_RECTS, np.float32)
                if len(n.rects) > MAX_RECTS:
                    raise ValueError("haar: more than 3 rects in a feature")
                for i, (rx, ry, rw, rh, wgt) in enumerate(n.rects):
                    r[i] = (ry, rx, rh, rw)
                    w[i] = wgt
                rects.append(r)
                wts.append(w)
                tilted.append(int(n.tilted))
                thr.append(n.threshold)
                leaf.append((0.0 if n.left_val is None else n.left_val,
                             0.0 if n.right_val is None else n.right_val))
                child.append((-1 if n.left_node is None else base + n.left_node,
                              -1 if n.right_node is None
                              else base + n.right_node))
            tree_nodes.append(len(thr))
        stage_trees.append(len(tree_nodes) - 1)
        stage_thr.append(st.threshold)
    return Packed(cascade.window, np.asarray(rects, np.int32),
                  np.asarray(wts, np.float32), np.asarray(tilted, np.int32),
                  np.asarray(thr, np.float32), np.asarray(leaf, np.float32),
                  np.asarray(child, np.int32),
                  np.asarray(tree_nodes, np.int32),
                  np.asarray(stage_trees, np.int32),
                  np.asarray(stage_thr, np.float32), form == "arrays")


def grid(h: int, w: int, packed: Packed) -> Tuple[int, int]:
    """(ny, nx) stride-2 windows of the base window in an h x w plane."""
    ww, wh = packed.window
    return max((h - wh) // STRIDE + 1, 0), max((w - ww) // STRIDE + 1, 0)


def _inv_area(packed: Packed) -> float:
    """float32(1 / area): XLA turns the division by the constant window
    area into a product with its float32 reciprocal."""
    ww, wh = packed.window
    return float(np.float32(1) / np.float32(ww * wh))


def _vnorm(ii, sq, packed: Packed, ny: int, nx: int):
    """sqrt of the window's variance (1 where it is 0): [B, ny, nx]."""
    ww, wh = packed.window
    inv_area = torch.full((), _inv_area(packed), dtype=torch.float32,
                          device=ii.device)

    def rsum(t):
        g = lambda yo, xo: t[:, yo:yo + ny * STRIDE:STRIDE,  # noqa: E731
                             xo:xo + nx * STRIDE:STRIDE]
        return g(wh, ww) - g(0, ww) - g(wh, 0) + g(0, 0)

    mean = rsum(ii) * inv_area        # XLA divides by a constant so
    if packed.fused_variance:          # total_sq * (1/area) - mean*mean
        variance = fma32(rsum(sq), inv_area, -(mean * mean))
    else:
        variance = rsum(sq) * inv_area - mean * mean
    variance = torch.clamp(variance, min=0.0)
    one = torch.ones((), dtype=torch.float32, device=ii.device)
    # correctly rounded (torch's float32 sqrt on the CPU is not always)
    root = torch.sqrt(variance.to(torch.float64)).to(torch.float32)
    return torch.where(variance > 0, root, one)


def eval_cascade_plain(ii, sq, tii, packed: Packed, ny: int, nx: int,
                       count: bool = False):
    """Every tree at every window that reaches it, as the JAX package
    evaluates it.  ii, sq [B, H+1, W+1]; tii [B, H+1, Wp+1] or None.
    Returns (passed [B, ny, nx] bool, score [B, ny, nx] f32: the last
    stage's sum) and, with count, the (window, node) evaluations that a
    walk stopping at each window's first failed stage makes and the
    survival profile: int64 [S], the windows alive at each stage's
    start.

    A stage but the last is evaluated at the windows that passed every
    stage before it only: a window that failed stays failed, and its
    later stage sums are not read; the last stage at every window, which
    gives the JAX package's score everywhere.  Each window's own
    arithmetic is the same either way."""
    b = ii.shape[0]
    dev = ii.device
    wi = ii.shape[-1]
    p = ny * nx
    iy = torch.arange(ny, device=dev)[:, None] * STRIDE
    ix = torch.arange(nx, device=dev)[None, :] * STRIDE
    frame = torch.arange(b, device=dev)[:, None]
    base = (frame * ii[0].numel() + (iy * wi + ix).reshape(1, -1)
            ).reshape(-1)
    iif = ii.reshape(-1)
    if packed.any_tilted:
        wt = tii.shape[-1]
        tpad = torch.nn.functional.pad(tii, (0, 0, 0, 64))
        tbase = (frame * tpad[0].numel()
                 + (iy * wt + ix + TILT_PAD).reshape(1, -1)).reshape(-1)
        tpad = tpad.reshape(-1)
    vnorm = _vnorm(ii, sq, packed, ny, nx).reshape(-1)

    rects = torch.from_numpy(packed.rects.astype(np.int64)).to(dev)
    wts = torch.from_numpy(packed.weights).to(dev)
    thr = torch.from_numpy(packed.thr).to(dev)
    leaf = torch.from_numpy(packed.leaf).to(dev)
    child = torch.from_numpy(packed.child.astype(np.int64)).to(dev)
    tilted = packed.tilted

    inv_area = _inv_area(packed)
    inv_area64 = 1.0 / float(packed.window[0] * packed.window[1])

    def go_left(n0: int, n1: int, sel):
        """[n1 - n0, S]: node feature < threshold * vnorm for nodes
        n0..n1-1 at the windows sel.  A plain feature is float32; a
        tilted one float64, as the JAX package's float64 rotated table
        (its zeros are x64's default dtype) makes it."""
        r = rects[n0:n1]
        ry, rx, rh, rw = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
        tilt = torch.from_numpy(tilted[n0:n1].astype(bool)).to(dev)
        acc = torch.zeros((n1 - n0, sel.shape[0]), dtype=torch.float32,
                          device=dev)
        acc_t = acc.to(torch.float64)
        at = base[sel][None, :]
        for k in range(MAX_RECTS):
            a, bb, c, d = (ry[:, k], rx[:, k], rh[:, k], rw[:, k])
            w = wts[n0:n1, k][:, None]
            if not bool(tilt.all()):
                offs = [(a + c) * wi + bb + d, a * wi + bb + d,
                        (a + c) * wi + bb, a * wi + bb]
                v = [iif[o[:, None] + at] for o in offs]
                acc = fma32(w, v[0] - v[1] - v[2] + v[3], acc)
            if bool(tilt.any()):
                offs = [a * wt + bb, (a + c) * wt + bb - c,
                        (a + d) * wt + bb + d, (a + d + c) * wt + bb + d - c]
                tat = tbase[sel][None, :]
                v = [tpad[o[:, None] + tat] for o in offs]
                acc_t = _fma64(w.to(torch.float64), v[0] - v[1] - v[2] + v[3],
                               acc_t)
        limit = thr[n0:n1, None] * vnorm[sel][None, :]
        left = acc * inv_area < limit
        if bool(tilt.any()):
            left_t = acc_t * inv_area64 < limit.to(
                torch.float64)
            left = torch.where(tilt[:, None], left_t, left)
        return left

    passed = torch.ones(b * p, dtype=torch.bool, device=dev)
    score = torch.zeros(b * p, dtype=torch.float32, device=dev)
    evals = torch.zeros(b * p, dtype=torch.int64, device=dev)
    every = torch.arange(b * p, device=dev)
    tn = packed.tree_nodes
    n_stages = len(packed.stage_thr)
    alive_at = torch.zeros(n_stages, dtype=torch.int64, device=dev)
    for s_i in range(n_stages):
        if count:
            alive_at[s_i] = passed.sum()
        sel = every if s_i == n_stages - 1 else every[passed]
        n = sel.shape[0]
        if n == 0:
            continue
        t0, t1 = int(packed.stage_trees[s_i]), int(packed.stage_trees[s_i + 1])
        budget = max(1, (1 << 25) // (n * 4 * MAX_RECTS))
        st_sum = torch.zeros(n, dtype=torch.float32, device=dev)
        alive = passed[sel]
        t = t0
        while t < t1:
            t_end = t + 1
            while t_end < t1 and tn[t_end + 1] - tn[t] <= budget:
                t_end += 1
            n0, n1 = int(tn[t]), int(tn[t_end])
            left = go_left(n0, n1, sel)
            for tr in range(t, t_end):
                cur = torch.full((n,), int(tn[tr]) - n0, dtype=torch.int64,
                                 device=dev)
                val = torch.zeros(n, dtype=torch.float32, device=dev)
                done = torch.zeros(n, dtype=torch.bool, device=dev)
                for _ in range(int(tn[tr + 1] - tn[tr])):
                    gl = left.gather(0, cur[None, :])[0]
                    side = torch.where(gl, 0, 1)
                    nxt = child[n0 + cur, side]
                    lv = leaf[n0 + cur, side]
                    stop = ~done & (nxt < 0)
                    if count:
                        evals[sel] += (~done & alive).to(torch.int64)
                    val = torch.where(stop, lv, val)
                    done = done | stop
                    cur = torch.where(done, cur, nxt - n0)
                st_sum = st_sum + val
            t = t_end
        passed[sel] = alive & (st_sum >= float(packed.stage_thr[s_i]))
        score[sel] = st_sum
    out = (passed.reshape(b, ny, nx), score.reshape(b, ny, nx))
    return out + (evals.reshape(b, ny, nx), alive_at) if count else out


# ---------------------------------------------------------------------------
# H1's launch plan: the block's tile of windows, the regions of the tables
# it copies into shared memory, and the node records with their corners as
# offsets into those regions
# ---------------------------------------------------------------------------

TILE = (32, 16)         # windows a block: 32 across, 16 down
SMEM_NODES = 128        # node records a block keeps in shared memory
# the survivors at or below which a block gives each one a warp of its
# own, whose lanes take a stage's trees 32 at a time
WARP_MAX = 32
REC_INTS = 16           # a node record: 64 bytes


@dataclass
class Plan:
    """H1's launch plan for one cascade.  A region (dy0, dx0, rows,
    pitch) is the part of a table one tile reads: rows from the tile's
    first window's y + dy0, pitch (even) columns from its x + dx0, stored
    a row at a time with the even columns first and the odd ones after
    (a window steps 2 columns, so neighbouring windows read neighbouring
    words).  A record (int32 [N, 16]) holds a node's rects as four corner
    offsets each (uint16, two an int, a rect's sum is ((c0 - c1) - c2)
    + c3), its weights, threshold, leaves, children (global node
    indices, -1 a leaf) and its rect count | tilted << 8."""
    tile: Tuple[int, int]               # (tx, ty)
    region: Tuple[int, int, int, int]   # the summed-area table's
    tregion: Tuple[int, int, int, int]  # the rotated table's, or zeros
    records: np.ndarray
    n_smem: int
    warp_max: int                       # survivors a warp each from

    def smem_bytes(self) -> int:
        """The block's shared memory, as the kernel lays it out."""
        tx, ty = self.tile
        _, _, rows, pitch = self.region
        _, _, trows, tpitch = self.tregion
        return (self.n_smem * 4 * REC_INTS + 8 * trows * tpitch
                + 4 * rows * pitch + 4 * tx * ty + 2 * 2 * tx * ty)


def region_offset(region, dy: int, dx: int) -> int:
    """Where the table entry (dy, dx) from a tile's first window lies in
    its region."""
    dy0, dx0, _, pitch = region
    c = dx - dx0
    return (dy - dy0) * pitch + (c & 1) * (pitch // 2) + (c >> 1)


def _corners(r, tilted: bool):
    """A rect's four corners (dy, dx) in the order its sum takes them."""
    ry, rx, rh, rw = (int(v) for v in r)
    if tilted:
        return [(ry, rx), (ry + rh, rx - rh), (ry + rw, rx + rw),
                (ry + rw + rh, rx + rw - rh)]
    return [(ry + rh, rx + rw), (ry, rx + rw), (ry + rh, rx), (ry, rx)]


def _region(corners, tile) -> Tuple[int, int, int, int]:
    if not corners:
        return (0, 0, 0, 0)
    ys = [c[0] for c in corners]
    xs = [c[1] for c in corners]
    tx, ty = tile
    dy0, dx0 = min(ys), min(xs)
    rows = (ty - 1) * STRIDE + max(ys) - dy0 + 1
    cols = (tx - 1) * STRIDE + max(xs) - dx0 + 1
    return (dy0, dx0, rows, cols + (cols & 1))


def plan(packed: Packed) -> Plan:
    """H1's plan for packed (cached on it)."""
    cached = getattr(packed, "_plan", None)
    if cached is not None:
        return cached
    tilted = packed.tilted.astype(bool)
    ww, wh = packed.window
    live = packed.weights != 0
    plain_c = [(0, 0), (0, ww), (wh, 0), (wh, ww)]   # the variance's
    tilt_c = []
    for n in range(len(packed.thr)):
        for k in np.flatnonzero(live[n]):
            (tilt_c if tilted[n] else plain_c).extend(
                _corners(packed.rects[n, k], tilted[n]))
    region, tregion = _region(plain_c, TILE), _region(tilt_c, TILE)
    for reg in (region, tregion):
        if reg[2] * reg[3] > 1 << 16:
            raise ValueError("haar: a cascade's region does not fit "
                             "16-bit offsets")
    n = len(packed.thr)
    ends = np.repeat(packed.tree_nodes[1:], np.diff(packed.tree_nodes))
    idx = np.arange(n)[:, None]
    if not ((packed.child < 0) | ((packed.child > idx)
                                  & (packed.child < ends[:, None]))).all():
        raise ValueError("haar: a child outside its tree or before its "
                         "parent")
    rec = np.zeros((n, REC_INTS), np.int32)
    offs = np.zeros((n, 12), np.uint16)
    for i in range(n):
        reg = tregion if tilted[i] else region
        for j, k in enumerate(np.flatnonzero(live[i])):
            offs[i, 4 * j:4 * j + 4] = [
                region_offset(reg, dy, dx)
                for dy, dx in _corners(packed.rects[i, k], tilted[i])]
            rec[i, 6 + j] = packed.weights[i, k:k + 1].view(np.int32)[0]
    rec[:, 0:6] = offs.view(np.int32)    # little endian: even corner low
    rec[:, 9] = packed.thr.view(np.int32)
    rec[:, 10:12] = packed.leaf.view(np.int32)
    rec[:, 12:14] = packed.child
    rec[:, 14] = live.sum(1) | (tilted.astype(np.int32) << 8)
    out = Plan(TILE, region, tregion, rec, min(n, SMEM_NODES), WARP_MAX)
    packed._plan = out
    return out


def _device_tables(packed: Packed, device):
    cache = getattr(packed, "_dev", None)
    if cache is None or cache[0] != device:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        cache = (device, t(plan(packed).records), t(packed.tree_nodes),
                 t(packed.stage_trees), t(packed.stage_thr))
        packed._dev = cache
    return cache[1:]


def eval_cascade(plane, packed: Packed):
    """[B, H, W] float32 plane -> (passed, score) [B, ny, nx] over the
    stride-2 windows: the H1 kernel on a CUDA tensor, the plain version
    on a CPU one."""
    b, h, w = plane.shape
    ny, nx = grid(h, w, packed)
    ii = integral(plane)
    sq = integral(plane.to(torch.float32) * plane.to(torch.float32))
    tii = tilted_integral(plane) if packed.any_tilted else None
    if plane.device.type == "cpu":
        return eval_cascade_plain(ii, sq, tii, packed, ny, nx)
    return haar_cascade(ii, sq, tii, packed, ny, nx)


def haar_cascade(ii, sq, tii, packed: Packed, ny: int, nx: int):
    """H1 on CUDA tensors (eval_cascade_plain's contract: passed equal
    everywhere, score equal where passed): one launch, a block a tile of
    plan(packed).tile windows."""
    from gstbad_tpu_torch.ops import _cuda
    b = ii.shape[0]
    passed = torch.empty((b, ny, nx), dtype=torch.uint8, device=ii.device)
    score = torch.empty((b, ny, nx), dtype=torch.float32, device=ii.device)
    if b * ny * nx == 0:
        return passed.bool(), score
    pl = plan(packed)
    tabs = _device_tables(packed, ii.device)
    if tii is None:
        tii, wt = ii, 0
    else:
        wt = tii.shape[-1]
    ww, wh = packed.window
    _cuda.launch("gst_haar_cascade", ii.contiguous(), sq.contiguous(),
                 tii.contiguous(), *tabs, passed, score, b, ii.shape[-2],
                 ii.shape[-1], wt, ny, nx, ww, wh, len(packed.stage_thr),
                 int(packed.fused_variance), *pl.tile, *pl.region,
                 *pl.tregion, pl.n_smem, pl.warp_max)
    haar_cascade.launches += 1
    return passed.bool(), score


haar_cascade.launches = 0


def _neighbor_counts(passed):
    p = passed.to(torch.int32)
    pad = torch.nn.functional.pad(p, (1, 1, 1, 1))
    ny, nx = p.shape[-2:]
    counts = torch.zeros_like(p)
    for dy in range(3):
        for dx in range(3):
            counts = counts + pad[..., dy:dy + ny, dx:dx + nx]
    return counts


def detect_multi_scale(gray, packed: Packed, scale_factor: float = 1.1
                       ) -> List[dict]:
    """The pyramid over [B, H, W] frames: per scale the pass mask, the
    3x3 confirmation counts, the score and the geometry (both JAX forms,
    detect_multi_scale and detect_multi_scale_arrays, step alike)."""
    ww, wh = packed.window
    h, w = gray.shape[-2:]
    out = []
    factor = 1.0
    for _ in range(MAX_SCALES):
        sh, sw = int(h / factor), int(w / factor)
        if sh < wh or sw < ww:
            break
        scaled = resize_linear(gray, sh, sw)
        passed, score = eval_cascade(scaled, packed)
        out.append({"passed": passed, "counts": _neighbor_counts(passed),
                    "score": score, "factor": factor,
                    "size": (int(ww * factor), int(wh * factor))})
        factor *= scale_factor
    return out
