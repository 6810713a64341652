"""GrabCut segmentation (ext/opencv/gstgrabcut.cpp wraps cv::grabCut), the
torch form of gstbad_tpu/ops/grabcut.py: the mask convention (BGD 0, FGD
1, PR_BGD 2, PR_FGD 3), rect initialisation, 5-component full-covariance
colour GMMs seeded by a deterministic quantile k-means, beta over the 4
neighbour directions, gamma 50 smoothness, lambda 9 gamma hard
constraints, and checkerboard ICM sweeps in place of the min-cut (the
JAX package's documented divergences from cv::grabCut).

Every sum over the frame's pixels is taken in float64 and rounded to
float32, the 3x3 determinants and inverses are written out by cofactors,
and exp and log go through float64 (ops/numerics.f32), so the card and
the CPU give the same masks.  Against the JAX package (LAPACK's LU, its
float32 reductions in XLA's order) the masks agree on all but a few
boundary pixels (tests/test_torch_tracker_grabcut.py states the share)."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.ops.numerics import f32

GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3
N_COMPONENTS = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
ICM_SWEEPS = 10
F = torch.float32


def _sum(x, dim):
    """A float32 sum over pixels taken in float64 (device independent)."""
    return x.to(torch.float64).sum(dim).to(F)


def _ordered_sum(x, dim: int = -1):
    """Sum along a short axis, one add at a time in index order."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _det3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cof = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    return cof / _det3(m)[..., None, None]


def _kmeans(x, weights, iters: int = 10):
    """Deterministic k-means over [N, 3] float32 with sample weights
    (0 = padding): seeds at the samples nearest the 0.1..0.9 luminance
    quantiles, then 10 Lloyd iterations."""
    dev = x.device
    lum = (x[:, 0] * 0.299 + x[:, 1] * 0.587) + x[:, 2] * 0.114
    live = weights > 0
    vals = torch.sort(lum[live]).values
    n = vals.shape[0]
    centers = []
    for q in np.linspace(0.1, 0.9, N_COMPONENTS):
        if n == 0:
            centers.append(x[0])
            continue
        pos = q * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        qv = vals[lo] + (vals[hi] - vals[lo]) * float(pos - lo)
        d = torch.where(live, torch.abs(lum - qv),
                        torch.full((), float("inf"), device=dev))
        centers.append(x[torch.argmin(d)])
    c = torch.stack(centers)
    ks = torch.arange(N_COMPONENTS, device=dev)
    for _ in range(iters):
        d2 = _ordered_sum((x[:, None, :] - c[None]) ** 2)
        lbl = torch.argmin(d2, 1)
        onehot = (lbl[:, None] == ks[None]).to(F) * weights[:, None]
        tot = torch.clamp(_sum(onehot, 0), min=1e-6)
        c = _sum(onehot[:, :, None] * x[:, None, :], 0) / tot[:, None]
    return torch.argmin(_ordered_sum((x[:, None, :] - c[None]) ** 2), 1)


def _fit_gmm(x, weights, comp):
    """Weighted per-component mean, covariance and weight (grabcut.cpp
    GMM::endLearning, with its 0.01 diagonal for a collapsed one)."""
    ks = torch.arange(N_COMPONENTS, device=x.device)
    onehot = (comp[:, None] == ks[None]).to(F) * weights[:, None]
    n_k = _sum(onehot, 0)
    pi = n_k / torch.clamp(_sum(weights, 0), min=1e-6)
    mean = _sum(onehot[:, :, None] * x[:, None, :], 0) / torch.clamp(
        n_k, min=1e-6)[:, None]
    d = x[:, None, :] - mean[None]
    cov = _sum(onehot[:, :, None, None] * d[..., :, None] * d[..., None, :],
               0) / torch.clamp(n_k, min=1e-6)[:, None, None]
    eye = torch.eye(3, dtype=F, device=x.device)[None] * 0.01
    cov = torch.where((_det3(cov) <= 1e-6)[:, None, None], cov + eye, cov)
    return pi, mean, cov


def _log_probs(x, pi, mean, cov):
    inv = _inv3(cov)
    det = torch.clamp(_det3(cov), min=1e-12)
    d = x[:, None, :] - mean[None]
    m = _ordered_sum((d[..., :, None] * inv[None] * d[..., None, :]
                      ).reshape(*d.shape[:2], 9))
    return (f32(torch.log, torch.clamp(pi, min=1e-12))[None]
            - 0.5 * f32(torch.log, det)[None] - 0.5 * m)


def _gmm_nll(x, pi, mean, cov):
    """-log sum_k pi_k N(x; mean_k, cov_k) for [N, 3] samples."""
    logp = _log_probs(x, pi, mean, cov)
    mx = logp.amax(1, keepdim=True)
    return -(mx[:, 0] + f32(torch.log, _ordered_sum(f32(torch.exp,
                                                        logp - mx))))


def _gmm_assign(x, pi, mean, cov):
    return torch.argmax(_log_probs(x, pi, mean, cov), 1)


def _beta(img):
    """beta = 1 / (2 <||z_m - z_n||^2>) over the left, up-left, up and
    up-right pairs (calcBeta)."""
    f = img.to(F)
    h, w, _ = img.shape
    diffs = (f[:, 1:] - f[:, :-1], f[1:, 1:] - f[:-1, :-1],
             f[1:, :] - f[:-1, :], f[1:, :-1] - f[:-1, 1:])
    tot = sum(float(_sum((d * d).reshape(-1), 0)) for d in diffs)
    beta = np.float32(tot) / np.float32(4.0 * w * h - 3.0 * w - 3.0 * h + 2.0)
    return 0.0 if beta <= 1e-16 else float(np.float32(1.0) / (2.0 * beta))


def _shift(x, dy: int, dx: int):
    """x[y - dy, x - dx] (zero outside)."""
    h, w = x.shape[:2]
    out = torch.zeros_like(x)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h - max(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w - max(dx, 0))
    out[ys, xs] = x[yd, xd]
    return out


def _valid(h, w, dy, dx, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return ((yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0)
            & (xx - dx < w))


_DIRS = ((0, 1, GAMMA), (1, 1, GAMMA / np.sqrt(2.0)), (1, 0, GAMMA),
         (1, -1, GAMMA / np.sqrt(2.0)))


def _smooth_weights(img, beta: float):
    """The gamma-weighted exp terms of the 4 undirected neighbour
    directions W, NW, N, NE (calcNWeights): [y, x] weighs the edge to
    (y - dy, x - dx)."""
    f = img.to(F)
    h, w, _ = img.shape
    out = []
    for dy, dx, g in _DIRS:
        d2 = _ordered_sum((f - _shift(f, dy, dx)) ** 2)
        wgt = np.float32(g) * f32(torch.exp, -np.float32(beta) * d2)
        out.append(torch.where(_valid(h, w, dy, dx, img.device), wgt,
                               torch.zeros((), device=img.device)))
    return out


def _icm(data_bg, data_fg, weights, fg, hard_bg, hard_fg,
         sweeps: int = ICM_SWEEPS):
    """Checkerboard ICM over the grabcut energy (label 1 = foreground),
    the smoothness ramped in over the sweeps; hard pixels stay."""
    h, w = data_bg.shape
    dev = data_bg.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    parity = (yy + xx) % 2
    zero = torch.zeros((), device=dev)

    def neighbor_cost(fg, want):
        cost = torch.zeros((h, w), dtype=F, device=dev)
        f = fg.to(F)
        for (dy, dx, _), wmap in zip(_DIRS, weights):
            nb_m = _shift(f, dy, dx)
            cost = cost + torch.where(_valid(h, w, dy, dx, dev),
                                      (nb_m != want).to(F) * wmap, zero)
            nb_p = _shift(f, -dy, -dx)
            w_p = _shift(wmap, -dy, -dx)
            cost = cost + torch.where(_valid(h, w, -dy, -dx, dev),
                                      (nb_p != want).to(F) * w_p, zero)
        return cost

    for s in range(sweeps):
        anneal = np.float32(s / max(sweeps - 1, 1))
        for p in (0, 1):
            cost_bg = data_bg + anneal * neighbor_cost(fg, 0.0)
            cost_fg = data_fg + anneal * neighbor_cost(fg, 1.0)
            upd = (parity == p) & ~hard_bg & ~hard_fg
            fg = torch.where(upd, cost_fg < cost_bg, fg)
    return fg


def grabcut(img, mask, iterations: int = 1):
    """img [H, W, 3] u8, mask [H, W] u8 of GC_* values -> refined mask."""
    h, w, _ = img.shape
    f = img.to(F).reshape(-1, 3)
    weights = _smooth_weights(img, _beta(img))
    hard_bg = mask == GC_BGD
    hard_fg = mask == GC_FGD
    fg = hard_fg | (mask == GC_PR_FGD)
    lam = torch.full((), LAMBDA, dtype=F, device=img.device)
    zero = torch.zeros((), dtype=F, device=img.device)
    for _ in range(iterations):
        fg_w = fg.reshape(-1).to(F)
        bg_w = 1.0 - fg_w
        gm_f = _fit_gmm(f, fg_w, _kmeans(f, fg_w))
        gm_b = _fit_gmm(f, bg_w, _kmeans(f, bg_w))
        gm_f = _fit_gmm(f, fg_w, _gmm_assign(f, *gm_f))
        gm_b = _fit_gmm(f, bg_w, _gmm_assign(f, *gm_b))
        data_fg = _gmm_nll(f, *gm_f).reshape(h, w)
        data_bg = _gmm_nll(f, *gm_b).reshape(h, w)
        data_fg = torch.where(hard_bg, lam, torch.where(hard_fg, zero,
                                                        data_fg))
        data_bg = torch.where(hard_fg, lam, torch.where(hard_bg, zero,
                                                        data_bg))
        fg = _icm(data_bg, data_fg, weights, fg, hard_bg, hard_fg)
    out = torch.where(hard_bg, GC_BGD, torch.where(
        hard_fg, GC_FGD, torch.where(fg, GC_PR_FGD, GC_PR_BGD)))
    return out.to(torch.uint8)


def init_mask_from_rect(h: int, w: int, rect, device="cpu"):
    """GC_INIT_WITH_RECT: inside PR_FGD, outside BGD."""
    x, y, rw, rh = rect
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    inside = (xx >= x) & (xx < x + rw) & (yy >= y) & (yy < y + rh)
    return torch.where(inside, GC_PR_FGD, GC_BGD).to(torch.uint8)
