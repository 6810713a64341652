"""Comb detection — the ivtc/combdetect run-length comb metric
(gst/ivtc/gstivtc.c:634-680, gstcombdetect.c:215-260).

The C walks rows carrying `thisline[]`: outlier cells accumulate
thisline[i] += thisline[i-1] + 1 (clamped at 1000), non-outliers reset to 0,
and cells > 100 score.  Within a row that is a segmented prefix sum of
(previous row + 1) over the outlier runs; rows chain in sequence.  The
1000-clamp is applied to the carried row only: every clamped value is
> 100 either way, so the scored cells are exactly the C's, while the
unclamped in-row sums stay well inside int32.

Two hand-written kernels carry the chain on the card, one CUDA template in
csrc/deinterlace_kernels.cu: `comb_mask` (per-pixel mask and score of whole
frames, combdetect) and `comb_score_pairs` (the score of woven (top,
bottom) pairs out of a frame pool, ivtc).  CPU tensors take the plain
chain, `_scan_rows`, through `comb_mask_plain` / `comb_score_pairs_plain`.
"""

from __future__ import annotations

import torch

PLAIN_CHUNK = 32   # pairs per pass of comb_score_pairs_plain


def _outlier(s1, s2, s3):
    """src2 < min(src1,src3) - 5 or > max + 5 (int math)."""
    a = s1.to(torch.int32)
    b = s2.to(torch.int32)
    c = s3.to(torch.int32)
    return (b < torch.minimum(a, c) - 5) | (b > torch.maximum(a, c) + 5)


def _seg_cumsum(v, m):
    """In-run inclusive prefix sum over the last axis: cumsum of v (v == 0
    outside runs) minus the running total at the last run boundary.  v >= 0
    keeps the cumsum monotone, so that total is a cummax of the masked
    cumsum (no gather)."""
    s = torch.cumsum(v, dim=-1)
    base = torch.cummax(torch.where(m, 0, s), dim=-1).values
    return torch.where(m, s - base, 0)


def _scan_rows(m):
    """Chain the thisline recurrence over the row axis of the outlier mask
    m [..., R, W] bool.  Returns the over-100 mask [..., R, W]."""
    r, w = m.shape[-2:]
    p = torch.zeros(m.shape[:-2] + (w,), dtype=torch.int64, device=m.device)
    over = torch.empty(m.shape, dtype=torch.bool, device=m.device)
    for j in range(r):
        mj = m[..., j, :]
        seg = _seg_cumsum(torch.where(mj, p + 1, 0), mj)
        over[..., j, :] = seg > 100
        p = seg.clamp(max=1000)
    return over


def comb_mask_plain(luma):
    """The plain form of comb_mask."""
    h = luma.shape[-2]
    m = _outlier(luma[..., 1:h - 3, :], luma[..., 2:h - 2, :],
                 luma[..., 3:h - 1, :])
    over = _scan_rows(m)
    mask = torch.zeros(luma.shape, dtype=torch.bool, device=luma.device)
    mask[..., 2:h - 2, :] = over
    score = over.sum(dim=(-2, -1), dtype=torch.int32)
    return mask, score


def comb_mask(luma):
    """Per-pixel over-100 mask and score for rows [2, H - 2).

    luma: [..., H, W] uint8 (woven frames).  Returns (mask [..., H, W] bool,
    False outside the scanned band; score [...] int32).

    Replaces the TPU kernel gstbad_tpu/ops/comb.py:_comb_chain_kernel.  CPU
    tensors take comb_mask_plain; CUDA tensors launch
    csrc/deinterlace_kernels.cu:comb_chain_kernel<C, true> or raise."""
    if luma.dtype != torch.uint8 or luma.ndim < 2:
        raise ValueError(f"comb_mask: luma must be uint8 [..., H, W], got "
                         f"{luma.dtype} {tuple(luma.shape)}")
    if luma.device.type == "cpu":
        return comb_mask_plain(luma)
    from gstbad_tpu_torch.ops import _cuda
    h, w = luma.shape[-2:]
    lead = luma.shape[:-2]
    frames = luma.reshape((-1, h, w)).contiguous()
    mask = torch.empty(frames.shape, dtype=torch.bool, device=luma.device)
    score = torch.empty(frames.shape[0], dtype=torch.int32,
                        device=luma.device)
    if frames.shape[0]:
        _cuda.launch("gst_comb_mask", frames, mask, score, frames.shape[0],
                     h, w)
        comb_mask.launches += 1
    return mask.reshape(luma.shape), score.reshape(lead)


comb_mask.launches = 0


def interleave(top, bottom):
    """Even rows from `top`, odd rows from `bottom` (GET_LINE_IL)."""
    h = top.shape[-2]
    even = (torch.arange(h, device=top.device) % 2 == 0)[:, None]
    return torch.where(even, top, bottom)


def comb_score(top, bottom):
    """get_comb_score (gstivtc.c:634-680) on two field-source luma frames
    (batched over leading axes)."""
    return comb_mask(interleave(top, bottom))[1]


def _check_pairs(pool, top_idx, bot_idx):
    if pool.dtype != torch.uint8 or pool.ndim != 3:
        raise ValueError(f"comb_score_pairs: pool must be uint8 [P, H, W], "
                         f"got {pool.dtype} {tuple(pool.shape)}")
    for idx in (top_idx, bot_idx):
        if idx.dtype != torch.int32 or idx.ndim != 1:
            raise ValueError("comb_score_pairs: indices must be int32 [n]")
        if idx.device != pool.device:
            raise ValueError("comb_score_pairs: pool and indices on "
                             f"different devices ({pool.device}, "
                             f"{idx.device})")
    if top_idx.shape != bot_idx.shape:
        raise ValueError("comb_score_pairs: top_idx and bot_idx differ in "
                         "shape")


def comb_score_pairs_plain(pool, top_idx, bot_idx):
    """The plain form of comb_score_pairs: interleave and chain PLAIN_CHUNK
    pairs at a time, so no more woven frames than that exist at once."""
    n = top_idx.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=pool.device)
    for lo in range(0, n, PLAIN_CHUNK):
        hi = lo + PLAIN_CHUNK
        t = pool[top_idx[lo:hi].long()]
        b = pool[bot_idx[lo:hi].long()]
        out[lo:hi] = comb_mask_plain(interleave(t, b))[1]
    return out


def comb_score_pairs(pool, top_idx, bot_idx):
    """get_comb_score for n (top, bottom) frame pairs out of a frame pool.

    pool: [P, H, W] uint8.  top_idx / bot_idx: [n] int32, the frames whose
    even / odd rows form the woven candidate.  Returns [n] int32.

    Replaces the TPU kernel gstbad_tpu/ops/comb.py:_score_kernel.  CPU
    tensors take comb_score_pairs_plain; CUDA tensors launch
    csrc/deinterlace_kernels.cu:comb_chain_kernel<C, false>, which reads the
    woven rows straight from the pool, or raise."""
    _check_pairs(pool, top_idx, bot_idx)
    if pool.device.type == "cpu":
        return comb_score_pairs_plain(pool, top_idx, bot_idx)
    from gstbad_tpu_torch.ops import _cuda
    if not (pool.is_contiguous() and top_idx.is_contiguous()
            and bot_idx.is_contiguous()):
        raise ValueError("comb_score_pairs: pool and indices must be "
                         "contiguous")
    p, h, w = pool.shape
    n = top_idx.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=pool.device)
    if n:
        _cuda.launch("gst_comb_score_pairs", pool, top_idx, bot_idx, out,
                     p, n, h, w)
        comb_score_pairs.launches += 1
    return out


comb_score_pairs.launches = 0
