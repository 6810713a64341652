"""fieldanalysis metrics (gst/fieldanalysis/gstfieldanalysisorc.orc and the
block-scored windowed comb), batched over leading frame axes.

All metrics follow the ORC semantics: per-sample contributions are kept only
when strictly above the (scaled) noise floor, summed exactly in int64 and
normalised once in float32.  The normalisation multiplies by the float32
reciprocal of the constant, as the JAX package's compiled window does (XLA
turns a division by a constant into that product; the two can differ in
the last bit, so an uncompiled JAX call may not match).  Every function
takes frames [..., H, W] uint8 and returns float32 [...]; parities are
Python ints (0 = top = even rows).

`metrics_default` computes the element's five default metrics for a window
in one pass: on a CUDA tensor it launches the hand-written kernel
csrc/deinterlace_kernels.cu:fieldanalysis_metrics_kernel, on a CPU tensor
it takes `metrics_default_plain`.  The other metrics are plain torch on
every device.
"""

from __future__ import annotations

import numpy as np
import torch


def _field(frame: torch.Tensor, parity: int) -> torch.Tensor:
    """Field rows of [..., H, W]: parity 0 = even rows (top)."""
    return frame[..., parity::2, :]


def _sum2(d: torch.Tensor) -> torch.Tensor:
    """Exact whole-plane integer sum over the last two axes."""
    return d.sum(dim=(-2, -1), dtype=torch.int64)


def _nf(noise_floor, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(noise_floor, device=like.device).to(torch.int32)


def _normalise(total: torch.Tensor, norm: float) -> torch.Tensor:
    """total / norm as the compiled JAX graph computes it: the int64 total
    rounded to float32, times the float32 reciprocal of float32(norm)."""
    # a Python float: torch rounds it to the float32 operand it already is,
    # and no device copy is made
    recip = float(np.float32(1) / np.float32(norm))
    return total.to(torch.float32) * recip


def same_parity_sad(f0, p0: int, f1, p1: int, noise_floor):
    a = _field(f0, p0).to(torch.int32)
    b = _field(f1, p1).to(torch.int32)
    d = (a - b).abs()
    d = torch.where(d > _nf(noise_floor, d), d, 0)
    h, w = f0.shape[-2:]
    return _normalise(_sum2(d), 0.5 * w * h)


def same_parity_ssd(f0, p0: int, f1, p1: int, noise_floor):
    a = _field(f0, p0).to(torch.int32)
    b = _field(f1, p1).to(torch.int32)
    d = (a - b) * (a - b)
    nf = _nf(noise_floor, d)
    d = torch.where(d > nf * nf, d, 0)
    h, w = f0.shape[-2:]
    return _normalise(_sum2(d), 0.5 * w * h)


def same_parity_3_tap(f0, p0: int, f1, p1: int, noise_floor):
    """Horizontal [1,4,1] (gstfieldanalysis.c:898-955; the first and last
    columns take the JAX package's edge rule)."""
    a = _field(f0, p0).to(torch.int32)
    b = _field(f1, p1).to(torch.int32)
    nt = _nf(noise_floor, a) * 6
    first = ((a[..., 0] << 2) + (a[..., 1] << 1)
             - ((b[..., 0] << 2) + (b[..., 1] << 1))).abs()
    mid = ((a[..., :-2] + 4 * a[..., 1:-1] + a[..., 2:])
           - (b[..., :-2] + 4 * b[..., 1:-1] + b[..., 2:])).abs()
    last = ((a[..., -2] << 1) + (a[..., -1] << 2)
            - ((b[..., -2] << 1) + (b[..., -1] << 2))).abs()
    tot = (_sum2(torch.where(mid > nt, mid, 0))
           + torch.where(first > nt, first, 0).sum(-1, dtype=torch.int64)
           + torch.where(last > nt, last, 0).sum(-1, dtype=torch.int64))
    h, w = f0.shape[-2:]
    return _normalise(tot, 3.0 * w * h)


def _interleave_by_parity(f0, p0: int, f1):
    """Even rows from the parity-selected source (gstfieldanalysis.c:972+)."""
    top, bottom = (f0, f1) if p0 == 0 else (f1, f0)
    h = f0.shape[-2]
    even = (torch.arange(h, device=f0.device) % 2 == 0)[:, None]
    return torch.where(even, top, bottom)


def opposite_parity_5_tap(f0, p0: int, f1, noise_floor):
    """Vertical [1,-3,4,-3,1] around even rows with mirrored boundaries:
    for even row c = 2k the taps are E[k-1], O[k-1], E[k], O[k], E[k+1];
    the first and last field lines mirror both outer taps
    (gstfieldanalysis.c:1007-1010 first, 1034-1040 last).  H must be even."""
    top, bottom = (f0, f1) if p0 == 0 else (f1, f0)
    h, w = f0.shape[-2:]
    if h % 2:
        raise ValueError(f"opposite_parity_5_tap: needs an even height, "
                         f"got {h}")
    E = top[..., 0::2, :].to(torch.int32)
    O = bottom[..., 1::2, :].to(torch.int32)
    nt = _nf(noise_floor, E) * 6
    v_mid = (E[..., :-2, :] - 3 * O[..., :-2, :] + 4 * E[..., 1:-1, :]
             - 3 * O[..., 1:-1, :] + E[..., 2:, :]).abs()
    v_first = (2 * E[..., 1, :] - 6 * O[..., 0, :] + 4 * E[..., 0, :]).abs()
    v_last = (2 * E[..., -2, :] - 6 * O[..., -2, :]
              + 4 * E[..., -1, :]).abs()
    tot = (_sum2(torch.where(v_mid > nt, v_mid, 0))
           + torch.where(v_first > nt, v_first, 0).sum(-1, dtype=torch.int64)
           + torch.where(v_last > nt, v_last, 0).sum(-1, dtype=torch.int64))
    return _normalise(tot, 3.0 * w * h)


def _segment_matrix(w_trunc: int, block_width: int) -> np.ndarray:
    """0/1 matrix mapping triple positions i (2..w-1) to the block
    (i-1)//bw (block_score_for_row_*, gstfieldanalysis.c)."""
    m = np.zeros((w_trunc, w_trunc // block_width), np.float32)
    for i in range(2, w_trunc):
        m[i, (i - 1) // block_width] = 1.0
    return m


def windowed_comb(f0, p0: int, f1, spatial_thresh: int, block_width: int,
                  block_height: int, block_thresh: int, ignored_lines: int,
                  interlaced_input: bool):
    """opposite_parity_windowed_comb (gstfieldanalysis.c:1337-1400) with the
    5-tap block scorer; 0.0 / 1.0 / 2.0 like the reference."""
    il = _interleave_by_parity(f0, p0, f1).to(torch.int32)
    h, w_full = il.shape[-2:]
    lead = il.shape[:-2]
    dev = il.device
    w = w_full - (w_full % block_width)
    il = il[..., :w]
    n_bands = max(0, (h - ignored_lines - block_height) // block_height + 1)
    if n_bands == 0:
        return torch.zeros(lead, dtype=torch.float32, device=dev)

    # absolute rows for every (band, row-in-band)
    c = (ignored_lines + np.arange(n_bands)[:, None] * block_height
         + np.arange(block_height)[None, :]).reshape(-1)
    rm2 = np.clip(c - 2, 0, h - 1)
    rm1 = np.clip(c - 1, 0, h - 1)
    rp1 = np.where(c + 1 <= h - 1, c + 1, c - 1)
    rp2 = np.where(c + 2 <= h - 1, c + 2, c - 2)

    def rows(r):
        return il[..., torch.as_tensor(r, device=dev), :]

    fj, fjm1, fjp1 = rows(c), rows(rm1), rows(rp1)
    diff1 = fj - fjm1
    diff2 = fj - fjp1
    st = spatial_thresh
    dir_ok = (((diff1 > st) & (diff2 > st))
              | ((diff1 < -st) & (diff2 < -st)))
    five = (rows(rm2) + (fj << 2) + rows(rp2) - 3 * (fjm1 + fjp1)).abs()
    mask = (dir_ok & (five > 6 * st)).to(torch.float32)

    # triples at i in [2, w): mask[i-2]*mask[i-1]*mask[i]
    triple = mask[..., :-2] * mask[..., 1:-1] * mask[..., 2:]
    triple = torch.nn.functional.pad(triple, (2, 0))
    seg = torch.as_tensor(_segment_matrix(w, block_width), device=dev)
    scores = triple @ seg   # [..., bands*bh, n_blocks], exact small ints
    scores[..., 0] += mask[..., 0] * mask[..., 1]
    scores[..., -1] += mask[..., -2] * mask[..., -1]
    scores = scores.reshape(lead + (n_bands, block_height, -1)).sum(-2)
    band_max = scores.amax(-1)
    combed = (band_max > block_thresh).any(-1)
    slightly = ((band_max > block_thresh // 2)
                & (band_max <= block_thresh)).any(-1)
    full = 1.0 if interlaced_input else 2.0
    return torch.where(combed, full, torch.where(slightly, 1.0, 0.0)).to(
        torch.float32)


# ---------------------------------------------------------------------------
# the five default metrics for a window — kernel 4
# ---------------------------------------------------------------------------

def _check_pool(name, pool, cur_idx, prev_idx):
    if pool.dtype != torch.uint8 or pool.ndim != 3:
        raise ValueError(f"{name}: pool must be uint8 [P, H, W], got "
                         f"{pool.dtype} {tuple(pool.shape)}")
    h = pool.shape[1]
    if h % 2 or h < 4:
        raise ValueError(f"{name}: needs an even height >= 4, got {h}")
    for idx in (cur_idx, prev_idx):
        if idx.dtype != torch.int32 or idx.ndim != 1:
            raise ValueError(f"{name}: indices must be int32 [B]")
        if idx.device != pool.device:
            raise ValueError(f"{name}: pool and indices on different "
                             f"devices ({pool.device}, {idx.device})")
    if cur_idx.shape != prev_idx.shape:
        raise ValueError(f"{name}: cur_idx and prev_idx differ in shape")


def metrics_default_plain(pool, cur_idx, prev_idx, noise_floor):
    """The plain form of metrics_default: the per-frame metric functions
    (same_parity_ssd, opposite_parity_5_tap) over the gathered frames, as
    the JAX package's vmapped path computes them."""
    y = pool[cur_idx.long()]
    prev = pool[prev_idx.long()]
    return (opposite_parity_5_tap(y, 0, y, noise_floor),
            same_parity_ssd(y, 0, prev, 0, noise_floor),
            same_parity_ssd(y, 1, prev, 1, noise_floor),
            opposite_parity_5_tap(y, 0, prev, noise_floor),
            opposite_parity_5_tap(y, 1, prev, noise_floor))


def metrics_default(pool, cur_idx, prev_idx, noise_floor):
    """All five default-config metrics (field-metric=ssd, frame-metric=
    5-tap, gstfieldanalysis.c:74-84) for a window: frame i is
    pool[cur_idx[i]] and its previous valid frame pool[prev_idx[i]].
    pool [P, H, W] uint8 (H even, >= 4), indices int32 [B], noise_floor a
    0-d int tensor or int.  Returns (f, t, b, t_b, b_t), each [B] float32.

    Replaces the TPU kernel gstbad_tpu/ops/fieldanalysis.py:_metrics_kernel.
    CPU tensors take metrics_default_plain; CUDA tensors launch
    csrc/deinterlace_kernels.cu:fieldanalysis_metrics_kernel or raise.  The
    kernel sums integers exactly and normalises them as _normalise does,
    so both give the same bits; it writes zeros for a frame whose index
    lies outside the pool."""
    _check_pool("metrics_default", pool, cur_idx, prev_idx)
    if pool.device.type == "cpu":
        return metrics_default_plain(pool, cur_idx, prev_idx, noise_floor)
    from gstbad_tpu_torch.ops import _cuda
    if not (pool.is_contiguous() and cur_idx.is_contiguous()
            and prev_idx.is_contiguous()):
        raise ValueError("metrics_default: pool and indices must be "
                         "contiguous")
    p, h, w = pool.shape
    b = cur_idx.shape[0]
    nf = torch.as_tensor(noise_floor, device=pool.device).to(
        torch.int32).reshape(1)
    # (f, t, b, t_b, b_t), normalised by the kernel (as _normalise does)
    out = torch.empty((5, b), dtype=torch.float32, device=pool.device)
    if b:
        _cuda.launch("gst_fieldanalysis_metrics", pool, cur_idx, prev_idx,
                     nf, out, p, b, h, w)
        metrics_default.launches += 1
    return tuple(out)


metrics_default.launches = 0
