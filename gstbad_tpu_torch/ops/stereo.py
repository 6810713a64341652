"""Stereo correspondence for the disparity element (the torch form of
gstbad_tpu/ops/stereo.py; ext/opencv/gstdisparity.cpp wraps cv::StereoBM
and cv::StereoSGBM).

stereo_bm is the JAX package's transcription of cv::StereoBM (XSobel
prefilter, 9x9 SAD, the inverted scan's tie-break, the fixed-point
subpixel step, the FILTERED borders and the disp12 check) in integer
ops, so it is exact.  stereo_sgm is the published semi-global matching
shape: a 3x3 SAD cost volume aggregated along 8 paths with P1/P2.  Its
aggregation is a serial walk along each scan line, which the JAX package
runs as lax.scan (gstbad_tpu/ops/stereo.py:136-158); on the card it is the
hand-written CUDA kernel `sgm_aggregate` (H3, csrc/stereo_kernels.cu), one
warp a scan line, on the CPU its plain walk here.  Every value of the
walk is an integer well under 2^24 in float32, so the kernel and the plain
walk are exact and equal.  The diagonal passes are the JAX package's
`jnp.roll`-sheared volumes (they wrap around the frame's width), and the
kernel reads through the same roll."""

from __future__ import annotations

import torch

from gstbad_tpu_torch.ops import scan


def prefilter_xsobel(img, ftzero: int = 32):
    """OpenCV prefilterXSobel on [..., H, W] u8: [-1 0 1] x [1 2 1]
    clamped to [0, 2*ftzero] around ftzero; first and last columns
    ftzero; border rows reflect (row 1 / row H-2)."""
    i32 = img.to(torch.int32)
    up = torch.cat([i32[..., 1:2, :], i32[..., :-1, :]], -2)
    dn = torch.cat([i32[..., 1:, :], i32[..., -2:-1, :]], -2)

    def dx(a):
        return torch.nn.functional.pad(a[..., 2:] - a[..., :-2], (1, 1))

    v = dx(up) + 2 * dx(i32) + dx(dn)
    out = torch.clamp(v + ftzero, 0, 2 * ftzero)
    out[..., 0] = ftzero
    out[..., -1] = ftzero
    return out.to(torch.uint8)


def _box(x, w2: int):
    """(2*w2+1)^2 box sum of [..., H, W] ints, valid-centred (edges are
    garbage, masked by the callers' borders), as the JAX package's
    cumsum differences."""
    k = 2 * w2 + 1
    c = scan.cumsum(torch.nn.functional.pad(x, (0, 0, 1, 0)), dim=-2)
    rows = torch.nn.functional.pad(c[..., k:, :] - c[..., :-k, :],
                                   (0, 0, w2, w2))
    c2 = scan.cumsum(torch.nn.functional.pad(rows, (1, 0)), dim=-1)
    cols = c2[..., k:] - c2[..., :-k]
    return torch.nn.functional.pad(cols, (w2, w2))


def _trunc_div(num, den):
    """C integer division (truncation toward zero)."""
    q = torch.abs(num) // torch.clamp(torch.abs(den), min=1)
    return torch.where(torch.sign(num) * torch.sign(den) < 0, -q, q)


def _shifted(pr, d: int):
    """pr shifted right by d columns with zeros in front: [..., H, W]."""
    w = pr.shape[-1]
    return torch.nn.functional.pad(pr, (d, 0))[..., :w]


def stereo_bm(left, right, ndisp: int = 32, block: int = 9,
              disp12_max_diff: int = 0):
    """[B, H, W] u8 pair -> [B, H, W] int16 disparity*16 (gstdisparity's
    sbm settings: preFilterCap 32, every other post-filter off)."""
    b, h, w = left.shape
    w2 = block // 2
    dev = left.device
    pl = prefilter_xsobel(left).to(torch.int32)
    pr = prefilter_xsobel(right).to(torch.int32)
    sadv = torch.stack([_box(torch.abs(pl - _shifted(pr, d)), w2)
                        for d in range(ndisp)], 1)            # [B, D, H, W]
    # the inverted scan's tie-break: ties keep the highest disparity
    mind = (ndisp - 1 - torch.argmin(sadv.flip(1), dim=1)).to(torch.int32)
    minv = torch.amin(sadv, dim=1)
    dgrid = torch.arange(ndisp, dtype=torch.int32, device=dev)[:, None, None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    p = torch.where(dgrid == mind[:, None] - 1, sadv, zero).sum(1)
    n = torch.where(dgrid == mind[:, None] + 1, sadv, zero).sum(1)
    dd = p + n - 2 * minv + torch.abs(p - n)
    sub = torch.where((mind > 0) & (mind < ndisp - 1) & (dd != 0),
                      _trunc_div((p - n) * 256, dd), zero)
    disp = ((mind * 256 + sub + 15) >> 4).to(torch.int16)

    filtered = torch.full((), -16, dtype=torch.int16, device=dev)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    valid = ((yy >= w2) & (yy < h - w2)
             & (xx >= ndisp + w2 - 1) & (xx < w - w2))
    disp = torch.where(valid, disp, filtered)

    if disp12_max_diff >= 0:
        # validateDisparity: the right map by a scatter-min of packed
        # (cost, x) keys
        dint = (disp.to(torch.int32) + 8) >> 4
        x2 = torch.clamp(xx - dint, 0, w - 1)
        key = (minv << 13) | xx.to(torch.int32)
        big = torch.full((), 2 ** 30, dtype=torch.int32, device=dev)
        key = torch.where(valid, key, big)
        claimed = torch.full((b, h, w), 2 ** 30, dtype=torch.int32,
                             device=dev)
        claimed = claimed.scatter_reduce(2, x2.to(torch.int64), key, "amin")
        win_x = torch.gather(claimed, 2, x2.to(torch.int64)) & ((1 << 13) - 1)
        win_d = torch.gather(disp.to(torch.int32), 2, win_x.to(torch.int64))
        bad = valid & (torch.abs(win_d - disp.to(torch.int32))
                       > disp12_max_diff * 16)
        disp = torch.where(bad, filtered, disp)
    return disp


def _line_index(h: int, w: int, shear: int, device):
    """Column of the frame that position (i, j) of the sheared volume
    holds: jnp.roll(row i, shear * i) reads column (j - shear*i) mod W."""
    i = torch.arange(h, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    return (j - shear * i) % w


def sgm_aggregate_plain(cost, total, axis: int, reverse: bool, shear: int,
                        p1: int, p2: int):
    """total + one SGM path's aggregation of cost [B, H, W, D] float32:
    along rows (axis 0) or columns (axis 1), forwards or reversed, over
    the volume sheared by `shear` (0, 1 or -1, rows only).  L = C +
    min(L, L(d-1) + P1, L(d+1) + P1, min L + P2) - min L, the first
    position's L its cost (gstbad_tpu/ops/stereo.py:136-158)."""
    b, h, w, d = cost.shape
    vol = cost
    if shear:
        idx = _line_index(h, w, shear, cost.device)
        vol = torch.gather(cost, 2, idx[None, :, :, None].expand(b, h, w, d))
    moved = vol.movedim(1 + axis, 1)                  # [B, N, M, D]
    if reverse:
        moved = moved.flip(1)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=cost.device)
    prev = moved[:, 0]
    outs = [prev]
    for k in range(1, moved.shape[1]):
        m = torch.amin(prev, -1, keepdim=True)
        shift_p = torch.cat([inf.expand(b, prev.shape[1], 1),
                             prev[..., :-1]], -1)
        shift_n = torch.cat([prev[..., 1:],
                             inf.expand(b, prev.shape[1], 1)], -1)
        best = torch.minimum(torch.minimum(prev, shift_p + p1),
                             torch.minimum(shift_n + p1, m + p2))
        prev = moved[:, k] + best - m
        outs.append(prev)
    agg = torch.stack(outs, 1)
    if reverse:
        agg = agg.flip(1)
    agg = agg.movedim(1, 1 + axis)
    if shear:
        back = torch.empty_like(agg)
        back.scatter_(2, idx[None, :, :, None].expand(b, h, w, d), agg)
        agg = back
    return total + agg


def sgm_aggregate(cost, total, axis: int, reverse: bool, shear: int,
                  p1: int, p2: int):
    """sgm_aggregate_plain; on CUDA tensors the H3 kernel, which adds the
    pass into `total` in place."""
    if cost.device.type == "cpu":
        return sgm_aggregate_plain(cost, total, axis, reverse, shear, p1, p2)
    from gstbad_tpu_torch.ops import _cuda
    b, h, w, d = cost.shape
    if d > 64 or (shear and axis != 0):
        raise ValueError("sgm_aggregate: at most 64 disparities, and a "
                         "shear only along the rows")
    _cuda.launch("gst_sgm_aggregate", cost.contiguous(), total, b, h, w, d,
                 axis, int(reverse), shear, p1, p2)
    sgm_aggregate.launches += 1
    return total


sgm_aggregate.launches = 0

# the JAX package's pass order (gstbad_tpu/ops/stereo.py:160-175)
SGM_PASSES = ((0, False, 0), (0, True, 0), (1, False, 0), (1, True, 0),
              (0, False, 1), (0, True, 1), (0, False, -1), (0, True, -1))


def sgm_cost(left, right, ndisp: int = 64, min_disp: int = 1):
    """[B, H, W] u8 pair -> [B, H, W, ndisp] float32 3x3 SAD costs of the
    prefiltered images."""
    pl = prefilter_xsobel(left).to(torch.int32)
    pr = prefilter_xsobel(right).to(torch.int32)
    costs = [_box(torch.abs(pl - _shifted(pr, d)), 1)
             for d in range(min_disp, min_disp + ndisp)]
    return torch.stack(costs, -1).to(torch.float32)


def stereo_sgm(left, right, ndisp: int = 64, min_disp: int = 1,
               p1: int = 200, p2: int = 255):
    """Semi-global matching with the element's SGBM settings (3x3 cost
    window, MODE_HH's 8 paths): [B, H, W] u8 pair -> int16 disparity*16."""
    b, h, w = left.shape
    dev = left.device
    cost = sgm_cost(left, right, ndisp, min_disp)
    total = torch.zeros_like(cost)
    for axis, rev, shear in SGM_PASSES:
        total = sgm_aggregate(cost, total, axis, rev, shear, p1, p2)

    mind = torch.argmin(total, -1).to(torch.int32)
    minv = torch.amin(total, -1)
    dgrid = torch.arange(ndisp, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    p_ = torch.where(dgrid == mind[..., None] - 1, total, zero).sum(-1)
    n_ = torch.where(dgrid == mind[..., None] + 1, total, zero).sum(-1)
    denom = torch.clamp(p_ + n_ - 2 * minv, min=1e-6)
    sub = torch.where((mind > 0) & (mind < ndisp - 1),
                      (p_ - n_) * 8 / denom, zero)
    disp = ((mind + min_disp) * 16 + sub).to(torch.int16)
    xx = torch.arange(w, device=dev)[None, None, :]
    filtered = torch.full((), (min_disp - 1) * 16, dtype=torch.int16,
                          device=dev)
    return torch.where(xx >= min_disp + ndisp - 1, disp, filtered)


def normalize_minmax_u8(x):
    """cv::normalize(NORM_MINMAX, 0, 255) of each frame of [B, H, W] to
    u8 (the element's display conversion, gstdisparity.cpp:564-566):
    saturate(round(scaled)), in float64."""
    b = x.shape[0]
    flat = x.reshape(b, -1).to(torch.float64)
    lo = flat.amin(1)[:, None, None]
    hi = flat.amax(1)[:, None, None]
    span = hi - lo
    scale = torch.where(span > 0, 255.0 / torch.where(span > 0, span, 1.0),
                        torch.zeros_like(span))
    v = (x.to(torch.float64) - lo) * scale
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)
