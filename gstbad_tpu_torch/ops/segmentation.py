"""Per-pixel background models for the segmentation element
(ext/opencv/gstsegmentation.cpp), the torch form of
gstbad_tpu/ops/segmentation.py: MOG2 (Zivkovic, the transcription the
JAX package holds bit exact against cv2), the O'Reilly codebook and MOG
(Stauffer-Grimson), each one frame at a time over [H, W, K] mode arrays,
and the codebook's 3x3 open/close cleanup.  One set of per-pixel ops a
frame: these stay plain torch ops.  Sums of three channels are written
out in order, so the card and the CPU round them alike."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.golden.segmentation import (
    CB_BOUNDS, CB_MAX_MOD, CB_MIN_MOD,
    MOG2_CT, MOG2_K, MOG2_SHADOW, MOG2_TAU, MOG2_TB, MOG2_Tb, MOG2_Tg,
    MOG2_VAR_INIT, MOG2_VAR_MAX, MOG2_VAR_MIN,
    MOG_BACKGROUND_RATIO, MOG_INITIAL_WEIGHT, MOG_K, MOG_NOISE_SIGMA,
    MOG_VAR_THRESHOLD,
)

CB_CAP = 16   # codewords a pixel keeps (the reference grows unboundedly)
F = torch.float32


def rgb2ycrcb_u8(rgb):
    """cv::cvtColor RGB2YCrCb 8-bit fixed point ([..., 3] u8)."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    half = 1 << 13
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    delta = 128 << 14
    cr = ((r - y) * 11682 + delta + half) >> 14
    cb = ((b - y) * 9241 + delta + half) >> 14
    return torch.clamp(torch.stack([y, cr, cb], -1), 0, 255).to(torch.uint8)


def _sum3(x):
    """Sum over a last axis of 3, in order."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _cumsum_k(x):
    """Running sum along the last (mode) axis, in order."""
    out = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., k])
    return torch.stack(out, -1)


def _take(x, idx):
    """take_along_axis on the mode axis (-1), or -2 for [H, W, K, 3]."""
    if x.ndim == idx.ndim:
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, 3))


def _first_true(mask):
    return torch.argmax(mask.to(torch.int32), -1)


def _full(v, like):
    return torch.full((), v, dtype=F, device=like.device)


# ---------------------------------------------------------------------------
# MOG2
# ---------------------------------------------------------------------------


def mog2_new_state(h: int, w: int, device="cpu") -> Dict[str, torch.Tensor]:
    z = lambda *s: torch.zeros(s, dtype=F, device=device)  # noqa: E731
    return {"weight": z(h, w, MOG2_K), "mean": z(h, w, MOG2_K, 3),
            "var": z(h, w, MOG2_K),
            "nmodes": torch.zeros((h, w), dtype=torch.int32, device=device)}


def mog2_frame(state, ycc, alpha_t) -> Tuple[Dict[str, torch.Tensor],
                                             torch.Tensor]:
    """One frame of MOG2 (bgfg_gaussmix2.cpp MOG2Invoker), the JAX
    package's vectorised visit order: ycc [H, W, 3] u8 -> mask [H, W] u8
    in {0, 127, 255}."""
    w, m, v, n = (state["weight"], state["mean"], state["var"],
                  state["nmodes"])
    dev = ycc.device
    data = ycc.to(F)
    alpha_t = torch.as_tensor(alpha_t, dtype=F, device=dev)
    alpha1 = 1.0 - alpha_t
    prune = -alpha_t * MOG2_CT
    zero = _full(0.0, ycc)

    ks = torch.arange(MOG2_K, dtype=torch.int32, device=dev)[None, None]
    valid = ks < n[..., None]
    d = m - data[:, :, None, :]
    dist2 = _sum3(d * d)
    fit = valid & (dist2 < MOG2_Tg * v)
    has_fit = fit.any(-1)
    k_m = _first_true(fit)
    match_hot = (ks == k_m[..., None]) & has_fit[..., None]

    w1 = torch.where(valid, alpha1 * w + prune, w)
    w1m = torch.where(match_hot, w1 + alpha_t, w1)
    pruned = valid & (w1m < -prune)
    w2 = torch.where(pruned, zero, w1m)
    n1 = n - pruned.sum(-1).to(torch.int32)

    km_i = k_m[..., None]
    w1m_at = _take(w1m, km_i)[..., 0]
    kfac = alpha_t / torch.clamp(w1m_at, min=1e-30)
    d_at = _take(d, km_i)[..., 0, :]
    mean_at = _take(m, km_i)[..., 0, :]
    var_at = _take(v, km_i)[..., 0]
    dist2_at = _take(dist2, km_i)[..., 0]
    mean_new = mean_at - kfac[..., None] * d_at
    var_new = torch.clamp(var_at + kfac * (dist2_at - var_at),
                          MOG2_VAR_MIN, MOG2_VAR_MAX)

    cumw_excl = _cumsum_k(w2) - w2
    limit = torch.where(has_fit, k_m, torch.full_like(k_m, MOG2_K))
    bg_k = (valid & (cumw_excl < MOG2_TB) & (dist2 < MOG2_Tb * v)
            & (ks <= limit[..., None]))
    background = bg_k.any(-1)

    blocked = (ks < km_i) & (w2 > w1m_at[..., None])
    p = torch.amax(torch.where(blocked, ks + 1, 0), -1)
    m3 = torch.where(match_hot[..., None], mean_new[:, :, None, :], m)
    v3 = torch.where(match_hot, var_new[..., None], v)
    in_range = (ks >= p[..., None]) & (ks <= km_i) & has_fit[..., None]
    src = torch.where(in_range,
                      torch.where(ks == p[..., None], km_i, ks - 1),
                      ks.expand_as(in_range)).to(torch.int64)
    w4 = _take(w2, src)
    v4 = _take(v3, src)
    m4 = _take(m3, src)

    total = _cumsum_k(torch.where(valid, w2, zero))[..., -1]
    inv = torch.where(total != 0, 1.0 / total,
                      _full(float("inf"), ycc))
    w5 = torch.where(ks < n1[..., None], w4 * inv[..., None], w4)

    create = (~has_fit) & (alpha_t > 0)
    idx = torch.where(n1 == MOG2_K, MOG2_K - 1, n1).to(torch.int32)
    n2 = torch.where(create & (n1 < MOG2_K), n1 + 1, n1)
    single = n2 == 1
    scale_others = create & ~single
    w6 = torch.where(scale_others[..., None] & (ks < (n2 - 1)[..., None]),
                     w5 * alpha1, w5)
    idx_hot = (ks == idx[..., None]) & create[..., None]
    w6 = torch.where(idx_hot, torch.where(single[..., None], _full(1.0, ycc),
                                          alpha_t), w6)
    m6 = torch.where(idx_hot[..., None], data[:, :, None, :], m4)
    v6 = torch.where(idx_hot, _full(MOG2_VAR_INIT, ycc), v4)
    blocked2 = (ks < idx[..., None]) & (w6 > alpha_t)
    p2 = torch.amax(torch.where(blocked2, ks + 1, 0), -1)
    in2 = (ks >= p2[..., None]) & (ks <= idx[..., None]) & create[..., None]
    src2 = torch.where(in2, torch.where(ks == p2[..., None], idx[..., None],
                                        ks - 1),
                       ks.expand_as(in2)).to(torch.int64)
    w7 = _take(w6, src2)
    v7 = _take(v6, src2)
    m7 = _take(m6, src2)

    # detectShadowGMM on the final state: K steps with a decided carry
    result = torch.zeros(background.shape, dtype=torch.int32, device=dev)
    t_w = torch.zeros(background.shape, dtype=F, device=dev)
    one = _full(1.0, ycc)
    for mode in range(MOG2_K):
        mm = m7[:, :, mode, :]
        active = (result == 0) & (mode < n2)
        numer = _sum3(data * mm)
        denom = _sum3(mm * mm)
        result = torch.where(active & (denom == 0), 255, result)
        act = active & (denom != 0)
        a = numer / torch.where(denom == 0, one, denom)
        cond_a = (numer <= denom) & (numer >= MOG2_TAU * denom)
        dd = a[..., None] * mm - data
        dist2a = _sum3(dd * dd)
        is_sh = cond_a & (dist2a < MOG2_Tb * v7[:, :, mode] * a * a)
        result = torch.where(act & is_sh, MOG2_SHADOW, result)
        t_w = t_w + torch.where(act & ~is_sh, w7[:, :, mode], zero)
        result = torch.where(act & ~is_sh & (t_w > MOG2_TB), 255, result)
    result = torch.where(result == 0, 255, result)
    mask = torch.where(background, 0, result).to(torch.uint8)
    return ({"weight": w7, "mean": m7, "var": v7,
             "nmodes": n2.to(torch.int32)}, mask)


# ---------------------------------------------------------------------------
# Codebook
# ---------------------------------------------------------------------------


def codebook_new_state(h: int, w: int, device="cpu"):
    z = lambda: torch.zeros((h, w, CB_CAP, 3), dtype=torch.int32,  # noqa: E731
                            device=device)
    return {"lhigh": z(), "llow": z(), "vmax": z(), "vmin": z(),
            "n": torch.zeros((h, w), dtype=torch.int32, device=device)}


def _const(values, like):
    return torch.tensor(np.asarray(values, np.int32), device=like.device)


def codebook_update(state, ycc, enable: bool):
    """update_codebook (gstsegmentation.cpp:476-556) for every pixel;
    `enable` (the frame's learning cadence) False leaves the state."""
    if not enable:
        return state
    p = ycc.to(torch.int32)
    bounds = _const(CB_BOUNDS, ycc)
    high = torch.clamp(p + bounds, max=255)
    low = torch.clamp(p - bounds, min=0)
    n = state["n"]
    ks = torch.arange(CB_CAP, dtype=torch.int32, device=ycc.device)[None, None]
    valid = ks < n[..., None]
    pk = p[:, :, None, :]
    inb = ((state["llow"] <= pk) & (pk <= state["lhigh"])).all(-1) & valid
    has = inb.any(-1)
    i_m = _first_true(inb)
    match_hot = (ks == i_m[..., None]) & has[..., None]
    vmax = torch.where(match_hot[..., None], torch.maximum(state["vmax"], pk),
                       state["vmax"])
    vmin = torch.where(match_hot[..., None], torch.minimum(state["vmin"], pk),
                       state["vmin"])
    append = (~has) & (n < CB_CAP)
    app_hot = (ks == n[..., None]) & append[..., None]
    lhigh = torch.where(app_hot[..., None], high[:, :, None, :],
                        state["lhigh"])
    llow = torch.where(app_hot[..., None], low[:, :, None, :], state["llow"])
    vmax = torch.where(app_hot[..., None], pk, vmax)
    vmin = torch.where(app_hot[..., None], pk, vmin)
    n1 = n + append.to(torch.int32)
    touch = (match_hot | app_hot)[..., None]
    lhigh = torch.where(touch & (lhigh < high[:, :, None, :]), lhigh + 1,
                        lhigh)
    llow = torch.where(touch & (llow > low[:, :, None, :]), llow - 1, llow)
    return {"lhigh": lhigh, "llow": llow, "vmax": vmax, "vmin": vmin,
            "n": n1}


def codebook_diff(state, ycc):
    """background_diff (gstsegmentation.cpp:636-660): 255 where no
    codeword's [min - minMod, max + maxMod] box covers the pixel."""
    p = ycc.to(torch.int32)[:, :, None, :]
    ks = torch.arange(CB_CAP, dtype=torch.int32, device=ycc.device)[None, None]
    valid = ks < state["n"][..., None]
    cover = ((state["vmin"] - _const(CB_MIN_MOD, ycc) <= p)
             & (p <= state["vmax"] + _const(CB_MAX_MOD, ycc))).all(-1) & valid
    return torch.where(cover.any(-1), 0, 255).to(torch.uint8)


def _window3(x, pad_value, fn):
    h, w = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=pad_value)
    out = None
    for dy in range(3):
        for dx in range(3):
            s = p[..., dy:dy + h, dx:dx + w]
            out = s if out is None else fn(out, s)
    return out


def morph_open_close(mask):
    """find_connected_components' cleanup (gstsegmentation.cpp:702-703):
    3x3 OPEN then CLOSE, erode padding 255 and dilate 0.  [..., H, W] u8."""
    erode = lambda x: _window3(x, 255, torch.minimum)  # noqa: E731
    dilate = lambda x: _window3(x, 0, torch.maximum)  # noqa: E731
    return erode(dilate(dilate(erode(mask))))


# ---------------------------------------------------------------------------
# MOG (Stauffer-Grimson)
# ---------------------------------------------------------------------------


def mog_new_state(h: int, w: int, device="cpu"):
    z = lambda *s: torch.zeros(s, dtype=F, device=device)  # noqa: E731
    return {"weight": z(h, w, MOG_K), "mean": z(h, w, MOG_K, 3),
            "var": torch.full((h, w, MOG_K), MOG_NOISE_SIGMA ** 2, dtype=F,
                              device=device),
            "nmodes": torch.zeros((h, w), dtype=torch.int32, device=device)}


def mog_frame(state, ycc, alpha_t):
    dev = ycc.device
    a = torch.as_tensor(alpha_t, dtype=F, device=dev)
    data = ycc.to(F)
    w8, m8, v8, nm = (state["weight"], state["mean"], state["var"],
                      state["nmodes"])
    ks = torch.arange(MOG_K, dtype=torch.int32, device=dev)[None, None]
    valid = ks < nm[..., None]
    d = m8 - data[:, :, None, :]
    dist2 = _sum3(d * d)
    fit = valid & (dist2 < MOG_VAR_THRESHOLD * v8)
    has_fit = fit.any(-1)
    k_m = _first_true(fit)
    one_hot = (ks == k_m[..., None]) & has_fit[..., None]

    w1 = torch.where(valid, w8 * (1 - a), w8)
    w1 = torch.where(one_hot, w1 + a, w1)
    rho = a / torch.maximum(w1, a)
    m1 = torch.where(one_hot[..., None],
                     m8 + rho[..., None] * (data[:, :, None, :] - m8), m8)
    v1 = torch.where(one_hot, v8 + rho * (dist2 - v8), v8)

    grow = (~has_fit) & (nm < MOG_K)
    nm1 = nm + grow.to(torch.int32)
    repl_idx = torch.where(grow, nm, torch.clamp(nm - 1, min=0))
    repl_hot = (ks == repl_idx[..., None]) & (~has_fit[..., None])
    w1 = torch.where(repl_hot, _full(MOG_INITIAL_WEIGHT, ycc), w1)
    m1 = torch.where(repl_hot[..., None], data[:, :, None, :], m1)
    v1 = torch.where(repl_hot, _full(MOG_NOISE_SIGMA ** 2, ycc), v1)

    valid1 = ks < nm1[..., None]
    zero = _full(0.0, ycc)
    tot = _cumsum_k(torch.where(valid1, w1, zero))[..., -1:]
    w1 = torch.where(valid1, w1 / torch.clamp(tot, min=1e-12), zero)

    order = torch.sort(-w1, dim=-1, stable=True).indices
    w2 = _take(w1, order)
    v2 = _take(v1, order)
    m2 = _take(m1, order)
    src = torch.where(has_fit, k_m, repl_idx)
    pos = _first_true(order == src[..., None])
    cum = _cumsum_k(w2)
    n_bg = ((cum - w2) < MOG_BACKGROUND_RATIO).sum(-1)
    is_bg = has_fit & (pos < n_bg)
    mask = torch.where(is_bg, 0, 255).to(torch.uint8)
    return {"weight": w2, "mean": m2, "var": v2, "nmodes": nm1}, mask
