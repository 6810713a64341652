"""SSIM — the gstcompare.c:355-470 oracle as integral-image sums, in
float64 on the tensors' device.

Reproduces the reference exactly: 16x16 windows stepped by 8 while
`pos + 8 < size`, integer moment sums, and the C's integer mean/variance
division before the double SSIM formula.
"""

from __future__ import annotations

import numpy as np
import torch

C1 = (0.01 * 255.0) ** 2
C2 = (0.03 * 255.0) ** 2
WIN = 16


def _window_grid(h: int, w: int):
    js = [j for j in range(0, h, WIN // 2) if j + WIN // 2 < h]
    is_ = [i for i in range(0, w, WIN // 2) if i + WIN // 2 < w]
    return js, is_


def ssim_plane(a, b):
    """[..., H, W] uint8 pair -> [...] float64 component SSIM."""
    h, w = a.shape[-2:]
    dev = a.device
    js, is_ = _window_grid(h, w)
    if not js or not is_:
        return torch.ones(a.shape[:-2], dtype=torch.float64, device=dev)

    ai = a.to(torch.int64)
    bi = b.to(torch.int64)

    def integral(x):
        c = torch.cumsum(torch.cumsum(x, dim=-2), dim=-1)
        return torch.nn.functional.pad(c, (1, 0, 1, 0))

    # window corners (clipped sizes at the right/bottom edges)
    j0 = np.array([j for j in js for _ in is_])
    i0 = np.array([i for _ in js for i in is_])
    j1 = np.minimum(j0 + WIN, h)
    i1 = np.minimum(i0 + WIN, w)
    cnt = torch.as_tensor((j1 - j0) * (i1 - i0), dtype=torch.int64,
                          device=dev)
    j0, i0, j1, i1 = (torch.as_tensor(v, device=dev)
                      for v in (j0, i0, j1, i1))

    def rect(x):
        I = integral(x)
        return (I[..., j1, i1] - I[..., j0, i1]
                - I[..., j1, i0] + I[..., j0, i0])

    avg1 = rect(ai) // cnt
    avg2 = rect(bi) // cnt
    var1 = rect(ai * ai) // cnt - avg1 * avg1
    var2 = rect(bi * bi) // cnt - avg2 * avg2
    cov = rect(ai * bi) // cnt - avg1 * avg2

    a1 = avg1.to(torch.float64)
    a2 = avg2.to(torch.float64)
    ssim = ((2 * a1 * a2 + C1) * (2 * cov.to(torch.float64) + C2)
            / ((a1 * a1 + a2 * a2 + C1)
               * ((var1 + var2).to(torch.float64) + C2)))
    return ssim.mean(dim=-1)


def ssim_weights(n_comps: int, is_yuv: bool):
    """Component weights (gstcompare.c:437-445): luma weighs as much as
    all chroma components together in YUV."""
    w = [1.0] * n_comps
    if is_yuv and n_comps > 1:
        w[0] = n_comps - 1
        norm = 2.0 * (n_comps - 1)
    else:
        norm = float(n_comps)
    return [x / norm for x in w]


def dssim_plane(a, b):
    """DSSIM = (1 - ssim) / 2 — the iqa scoring convention
    (ext/iqa/iqa.c wraps pornel/dssim; same scale)."""
    return (1.0 - ssim_plane(a, b)) / 2.0


def ssim_map(a, b, win: int = 8):
    """Per-pixel-block SSIM map in uint8 (iqa writes the SSIM map into the
    output frame, ext/iqa/iqa.c:240-263).  Non-overlapping win x win blocks
    upsampled back to frame size."""
    h, w = a.shape[-2:]
    hb, wb = h // win, w // win
    lead = a.shape[:-2]
    av = a[..., :hb * win, :wb * win].reshape(
        lead + (hb, win, wb, win)).to(torch.float64)
    bv = b[..., :hb * win, :wb * win].reshape(
        lead + (hb, win, wb, win)).to(torch.float64)
    m1 = av.mean(dim=(-3, -1))
    m2 = bv.mean(dim=(-3, -1))
    v1 = (av * av).mean(dim=(-3, -1)) - m1 * m1
    v2 = (bv * bv).mean(dim=(-3, -1)) - m2 * m2
    cv = (av * bv).mean(dim=(-3, -1)) - m1 * m2
    s = ((2 * m1 * m2 + C1) * (2 * cv + C2)
         / ((m1 * m1 + m2 * m2 + C1) * (v1 + v2 + C2)))
    s8 = (s * 255.0).clamp(0, 255).to(torch.uint8)
    up = s8.repeat_interleave(win, dim=-2).repeat_interleave(win, dim=-1)
    out = torch.zeros_like(a)
    out[..., :hb * win, :wb * win] = up
    return out
