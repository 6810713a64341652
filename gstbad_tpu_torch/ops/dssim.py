"""Multiscale DSSIM — the pornel/dssim analog behind the iqa element, in
float32 torch ops in the JAX package's order (gstbad_tpu/ops/dssim.py).

The reference's iqa (ext/iqa/iqa.c:195-290, HAVE_DSSIM) calls the external
kornelski/dssim library: images are linearized from sRGB, converted to
L*a*b*, compared with an SSIM variant over a gaussian pyramid, and the
score is 1/ssim - 1 (0 = identical).  As in the JAX package, this is the
published algorithm rather than a transcription of the library:

- sRGB -> linear (IEC 61966-2-1) -> CIE L*a*b* (D65), channels scaled to
  L/100, a/128, b/128;
- MS-SSIM pyramid (Wang et al. 2003) with the scale weights
  {0.0448, 0.2856, 0.3001, 0.2363, 0.1333}, 2x2 box downsampling, 11-tap
  sigma-1.5 gaussian windows with reflected borders;
- per-scale chroma weighted half as much as luminance;
- dssim = 1/msssim - 1.

torch has no cube root: t^(1/3) is torch.pow(t, 1/3), within 1 ulp of
jnp.cbrt in float32 on the range it sees, so the scores agree with the
JAX package's within 1e-5, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

SCALE_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
_K1, _K2 = 0.01, 0.03
_C1 = (_K1 * 1.0) ** 2  # channels are normalized to unit-ish range
_C2 = (_K2 * 1.0) ** 2
_CHROMA_WEIGHT = 0.5


def srgb_to_linear(u8):
    x = u8.to(torch.float32) / 255.0
    return torch.where(x <= 0.04045, x / 12.92,
                       torch.pow((x + 0.055) / 1.055, 2.4))


def _f_lab(t):
    d = 6.0 / 29.0
    return torch.where(t > d ** 3, torch.pow(t, 1.0 / 3.0),
                       t / (3 * d * d) + 4.0 / 29.0)


def linear_rgb_to_lab(rgb):
    """[..., 3] linear RGB -> L/100, a/128, b/128 (D65)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b
    xn, yn, zn = 0.95047, 1.0, 1.08883
    fx, fy, fz = _f_lab(x / xn), _f_lab(y / yn), _f_lab(z / zn)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L / 100.0, a / 128.0, bb / 128.0], dim=-1)


def _gauss_kernel(sigma: float = 1.5, radius: int = 5) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an n-long axis padded by r on each side with numpy's
    'reflect' mode (edge not repeated; pads wider than the axis reflect
    again)."""
    i = np.arange(-r, n + r)
    if n == 1:
        return torch.zeros(len(i), dtype=torch.int64, device=device)
    period = 2 * (n - 1)
    m = np.abs(i) % period
    m = np.where(m >= n, period - m, m)
    return torch.as_tensor(m, dtype=torch.int64, device=device)


def _blur(x, k: np.ndarray):
    """Separable gaussian of [B, H, W] float32, reflected borders: each
    pass sums the taps in order from zero."""
    r = len(k) // 2
    h, w = x.shape[1], x.shape[2]
    p = x.index_select(2, _reflect_index(w, r, x.device))
    acc = torch.zeros_like(x)
    for t, c in enumerate(k):
        acc = acc + float(c) * p[:, :, t:t + w]
    p = acc.index_select(1, _reflect_index(h, r, x.device))
    acc = torch.zeros_like(x)
    for t, c in enumerate(k):
        acc = acc + float(c) * p[:, t:t + h, :]
    return acc


def _downsample2(x):
    """2x2 box average (odd edges cropped, as MS-SSIM implementations do)."""
    b, h, w = x.shape
    h2, w2 = h // 2, w // 2
    v = x[:, :h2 * 2, :w2 * 2].reshape(b, h2, 2, w2, 2)
    return v.mean(dim=(2, 4))


def _ssim_stats(a, bch, k: np.ndarray):
    """Per-pixel luminance and contrast-structure maps (gaussian window)."""
    mu_a = _blur(a, k)
    mu_b = _blur(bch, k)
    var_a = _blur(a * a, k) - mu_a * mu_a
    var_b = _blur(bch * bch, k) - mu_b * mu_b
    cov = _blur(a * bch, k) - mu_a * mu_b
    lum = (2 * mu_a * mu_b + _C1) / (mu_a ** 2 + mu_b ** 2 + _C1)
    cs = (2 * cov + _C2) / (var_a + var_b + _C2)
    return lum, cs


def msssim_lab(lab_a, lab_b):
    """[B, H, W, 3] normalized Lab pair -> (msssim [B], finest L map).

    Scales shrink until the window no longer fits; weights of dropped
    scales are folded into the kept ones by renormalization.
    """
    k = _gauss_kernel()
    b, h, w, _ = lab_a.shape
    n_scales = 0
    th, tw = h, w
    while n_scales < len(SCALE_WEIGHTS) and th >= 11 and tw >= 11:
        n_scales += 1
        th //= 2
        tw //= 2
    n_scales = max(n_scales, 1)
    weights = np.array(SCALE_WEIGHTS[:n_scales])
    weights = weights / weights.sum()

    ch_w = np.array([1.0, _CHROMA_WEIGHT, _CHROMA_WEIGHT])
    ch_w = ch_w / ch_w.sum()

    a = [lab_a[..., c] for c in range(3)]
    bb = [lab_b[..., c] for c in range(3)]
    total = torch.ones((b,), dtype=torch.float32, device=lab_a.device)
    finest_map = None
    for s in range(n_scales):
        scale_ssim = torch.zeros((b,), dtype=torch.float32,
                                 device=lab_a.device)
        for c in range(3):
            lum, cs = _ssim_stats(a[c], bb[c], k)
            if s == n_scales - 1:
                val = (lum * cs).mean(dim=(1, 2))
            else:
                val = cs.mean(dim=(1, 2))
            if s == 0 and c == 0:
                finest_map = lum * cs
            scale_ssim = scale_ssim + float(np.float32(ch_w[c])) * val
        total = total * torch.pow(scale_ssim.clamp(min=1e-6),
                                  float(np.float32(weights[s])))
        if s != n_scales - 1:
            a = [_downsample2(x) for x in a]
            bb = [_downsample2(x) for x in bb]
    return total, finest_map


def dssim_rgb(img_a, img_b, offsets=(0, 1, 2)):
    """[B, H, W, C] u8 pair -> (dssim [B], finest-scale ssim map [B, H, W]).

    dssim = 1/msssim - 1, 0 = identical (the kornelski/dssim convention the
    reference's IQA message reports)."""
    def to_lab(img):
        rgb = torch.stack([srgb_to_linear(img[..., offsets[c]])
                           for c in range(3)], dim=-1)
        return linear_rgb_to_lab(rgb)

    ms, fmap = msssim_lab(to_lab(img_a), to_lab(img_b))
    return 1.0 / ms.clamp(min=1e-6) - 1.0, fmap
