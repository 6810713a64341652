"""MOSSE correlation-filter tracking (Bolme et al., CVPR 2010), the torch
form of gstbad_tpu/ops/mosse.py: the engine behind cvtracker.

Log/normalise/Hann patch preprocessing, a filter trained to a Gaussian
response on 9 integer shifts of the first patch, online updates at
learning rate 0.125, and PSR loss detection.  The 2-D FFTs go through
ops/fft.py: on the CPU scipy.fft over the last axis first, which equals
XLA's CPU FFT bit for bit; on the card cuFFT."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.ops import fft
from gstbad_tpu_torch.ops.numerics import f32

LEARN_RATE = 0.125
EPS = 1e-5
SIGMA = 2.0          # gaussian response width (paper: 2.0)
PSR_THRESHOLD = 5.7  # below -> lost


@functools.lru_cache(maxsize=16)
def _hann(h: int, w: int) -> np.ndarray:
    wy = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(h) / (h - 1))
    wx = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(w) / (w - 1))
    return (wy[:, None] * wx[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _gauss_response(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    g = np.exp(-((yy - h // 2) ** 2 + (xx - w // 2) ** 2)
               / (2 * SIGMA ** 2)).astype(np.float32)
    return np.fft.fftshift(g)    # peak at (0, 0)


def _const(a: np.ndarray, device):
    return torch.from_numpy(a).to(device)


def preprocess(patch, hann):
    """log -> zero mean, unit norm -> cosine window (paper sec. 3.1)."""
    p = f32(torch.log, patch.to(torch.float32) + 1.0)
    p = p - p.mean()
    p = p / (torch.sqrt(torch.mean(p * p)) + EPS)
    return p * hann


def extract_patch(gray, cy: float, cx: float, h: int, w: int):
    """[h, w] crop centred at (cy, cx), edge-clamped (host floats: the
    tracker's box is a host decision per frame)."""
    H, W = gray.shape
    y0 = int(np.clip(int(np.round(np.float32(cy))) - h // 2, 0, H - h))
    x0 = int(np.clip(int(np.round(np.float32(cx))) - w // 2, 0, W - w))
    return gray[y0:y0 + h, x0:x0 + w]


def _phase(h: int, w: int, dy: int, dx: int, device):
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    return _const(np.exp(-2j * np.pi * (dy * fy + dx * fx)), device)


def init_state(gray, box: Tuple[int, int, int, int]) -> Dict:
    """tracker->init: train the filter on the initial box."""
    x, y, w, h = box
    dev = gray.device
    hann = _const(_hann(h, w), dev)
    g_hat = fft.fft2(_const(_gauss_response(h, w), dev))
    cy = float(np.float32(y + h / 2))
    cx = float(np.float32(x + w / 2))
    patch = extract_patch(gray, cy, cx, h, w)
    # the numerator sums in complex128 (x64's fftfreq phase promotes it)
    a = torch.zeros((h, w), dtype=torch.complex128, device=dev)
    b = torch.full((h, w), EPS, dtype=torch.complex64, device=dev)
    for dy in (-2, 0, 2):
        for dx in (-2, 0, 2):
            fr = preprocess(torch.roll(patch, (dy, dx), (0, 1)), hann)
            f_hat = fft.fft2(fr)
            g_shift = g_hat.to(torch.complex128) * _phase(h, w, dy, dx, dev)
            a = a + g_shift * torch.conj(f_hat).to(torch.complex128)
            b = b + f_hat * torch.conj(f_hat)
    a = a.to(torch.complex64)
    return {"a": a, "b": b, "cy": cy, "cx": cx, "ok": True}


def update(state: Dict, gray, h: int, w: int):
    """tracker->update: locate the peak, move the box, retrain.
    Returns (state, ok, cy, cx)."""
    dev = gray.device
    hann = _const(_hann(h, w), dev)
    g_hat = fft.fft2(_const(_gauss_response(h, w), dev))
    fr = preprocess(extract_patch(gray, state["cy"], state["cx"], h, w),
                    hann)
    f_hat = fft.fft2(fr)
    filt = state["a"] / state["b"]
    resp = fft.ifft2(filt * f_hat).real.to(torch.float32)
    flat = resp.reshape(-1)
    idx = int(torch.argmax(flat))
    peak = flat[idx]
    py, px = idx // w, idx % w
    dy = float(py - h if py > h // 2 else py)
    dx = float(px - w if px > w // 2 else px)
    yy = (np.arange(h)[:, None] - py + h) % h
    xx = (np.arange(w)[None, :] - px + w) % w
    near = (np.minimum(yy, h - yy) <= 5) & (np.minimum(xx, w - xx) <= 5)
    side = resp[_const(~near, dev)]
    mu = side.mean()
    sd = torch.sqrt(torch.mean((side - mu) ** 2))
    psr = (peak - mu) / (sd + EPS)
    ok = bool(psr > PSR_THRESHOLD)

    H, W = gray.shape
    cy, cx = state["cy"], state["cx"]
    if ok:
        cy = float(np.clip(np.float32(cy + dy), h / 2, H - h / 2))
        cx = float(np.clip(np.float32(cx + dx), w / 2, W - w / 2))
        f2 = preprocess(extract_patch(gray, cy, cx, h, w), hann)
        f2_hat = fft.fft2(f2)
        a2 = (LEARN_RATE * g_hat * torch.conj(f2_hat)
              + (1 - LEARN_RATE) * state["a"])
        b2 = (LEARN_RATE * (f2_hat * torch.conj(f2_hat) + EPS)
              + (1 - LEARN_RATE) * state["b"])
    else:
        a2, b2 = state["a"], state["b"]
    return ({"a": a2, "b": b2, "cy": cy, "cx": cx, "ok": ok}, ok, cy, cx)
