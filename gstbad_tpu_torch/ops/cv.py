"""Ops of the opencv element family (reference: ext/opencv), as plain torch
ops on the tensors' own device.

The arithmetic is the JAX package's (gstbad_tpu/ops/cv.py), which
reproduces OpenCV's u8 paths: integer-exact where OpenCV is (gray
conversion, Sobel saturation, box/gaussian fixed-point rounding,
median/dilate/erode, equalizeHist's table, Canny), float32 elsewhere
(retinex, bilateral, matchTemplate).

What differs from the JAX package, and why:
- Integer stencils stay shift-and-add over shifted views in the JAX
  widths (int32, and int64 for the gaussian's ufixedpoint16 sums):
  conv2d has no integer form on CUDA, and a float conv is not exact.
- Padding gathers reflected or clamped indices built on the device
  (_pad_hw), so no host table is copied inside a window.
- equalizeHist's and rgb2hsv's tables are direct gathers, not the TPU's
  bit-plane lookups.
- The median is a pruned Batcher sorting network of min/max over the k*k
  taps (median_blur_u8): the JAX package's stack-and-sort would take a
  k*k-deep uint8 stack and int64 sort indices at full width.
- Canny's hysteresis checks for its fixpoint once every 8 dilations
  rather than after each one (canny_u8).
- exp, log and pow are taken in float64 and rounded to float32 (f32,
  ops/numerics.py):
  the float32 operation order is the JAX package's, but CUDA's and the
  CPU's float32 transcendentals differ in the last ulp, and a rounded
  byte with them; the correctly rounded value is the same on both.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gstbad_tpu_torch.ops.numerics import f32, full_fp32, true_div

# ---------------------------------------------------------------------------
# kernels (host-side precompute, numpy)
# ---------------------------------------------------------------------------


def deriv_kernel(order: int, ksize: int) -> np.ndarray:
    """cv::getDerivKernels construction (modules/imgproc/src/deriv.cpp):
    Pascal smoothing [1,1]^(ksize-order-1) convolved with difference
    [-1,1]^order; ksize 1 means the 3-tap kernels without smoothing."""
    if ksize == 1:
        base = {0: [1], 1: [-1, 0, 1], 2: [1, -2, 1]}[order]
        return np.array(base, np.int64)
    k = np.array([1], np.int64)
    for _ in range(ksize - order - 1):
        k = np.convolve(k, [1, 1])
    for _ in range(order):
        k = np.convolve(k, [-1, 1])
    return k


_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125,
                 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_cv(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel (modules/imgproc/src/smooth.dispatch.cpp):
    fixed small kernels for sigma<=0 & ksize<=7, else exp in double."""
    if sigma <= 0 and ksize <= 7 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize].copy()
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    return k / k.sum()


# ---------------------------------------------------------------------------
# elementwise building blocks
# ---------------------------------------------------------------------------


def _border_index(n: int, p: int, mode: str, device) -> torch.Tensor:
    """Source index of each of the n + 2p positions of an axis padded by p
    on both sides, as numpy's pad builds it: 'reflect' (OpenCV's
    BORDER_REFLECT_101, reflected again where p >= n) or 'edge'
    (BORDER_REPLICATE)."""
    i = torch.arange(-p, n + p, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def _pad_hw(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Pad H, W of [B, H, W, ...]; 'reflect' == OpenCV BORDER_REFLECT_101,
    'edge' == BORDER_REPLICATE (the JAX package's jnp.pad modes)."""
    if pw:
        x = x.index_select(2, _border_index(x.shape[2], pw, mode, x.device))
    if ph:
        x = x.index_select(1, _border_index(x.shape[1], ph, mode, x.device))
    return x


def _pad_const(x: torch.Tensor, ph: int, pw: int, value) -> torch.Tensor:
    """Pad H, W of [B, H, W] or [B, H, W, C] with a constant."""
    pad = (pw, pw, ph, ph) if x.ndim == 3 else (0, 0, pw, pw, ph, ph)
    return F.pad(x, pad, value=value)


def _correlate_axis(x: torch.Tensor, taps, axis: int, mode: str
                    ) -> torch.Tensor:
    """sum_t taps[t] * x shifted by t - len(taps)//2 along `axis` (1 = H,
    2 = W), the border padded by `mode`, accumulated in x's dtype in tap
    order from zero."""
    r = len(taps) // 2
    n = x.shape[axis]
    xp = _pad_hw(x, r if axis == 1 else 0, r if axis == 2 else 0, mode)
    acc = torch.zeros_like(x)
    for t, c in enumerate(taps):
        if c:
            acc = acc + xp.narrow(axis, t, n) * c
    return acc


def _sep_correlate_i32(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
                       mode: str = "reflect") -> torch.Tensor:
    """Separable integer correlation of [B, H, W] int32 (shifted slices)."""
    acc = _correlate_axis(img, [int(c) for c in kx], 2, mode)
    return _correlate_axis(acc, [int(c) for c in ky], 1, mode)


def rgb2gray_u8(rgb: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor COLOR_RGB2GRAY u8 fixed point:
    (19596 R + 38470 G + 7470 B + 2^15) >> 16."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return ((r * 19596 + g * 38470 + b * 7470 + (1 << 15)) >> 16
            ).to(torch.uint8)


def gray2rgb(gray: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor COLOR_GRAY2RGB: replicate the channel."""
    return gray.unsqueeze(-1).expand(*gray.shape, 3).contiguous()


def _to_u8(v: torch.Tensor) -> torch.Tensor:
    """round-half-even, saturate to [0, 255], NaN to 0 (what the JAX
    package's cast gives on the CPU), uint8."""
    v = torch.clamp(torch.round(v), 0, 255)
    return torch.nan_to_num(v, nan=0.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# cvsobel / cvlaplace (gstcvsobel.cpp:258-273, gstcvlaplace.cpp:261-280)
# ---------------------------------------------------------------------------


def sobel_i32(gray: torch.Tensor, dx: int, dy: int, ksize: int
              ) -> torch.Tensor:
    """cv::Sobel on u8 [B, H, W] -> int32 (unsaturated), reflect101 border.
    ksize=1 selects the unsmoothed 3-tap derivative on the derivative axis
    and [1] on the other."""
    kx = deriv_kernel(dx, ksize)
    ky = deriv_kernel(dy, ksize)
    return _sep_correlate_i32(gray.to(torch.int32), kx, ky)


def sobel_u8(gray: torch.Tensor, dx: int, dy: int, ksize: int
             ) -> torch.Tensor:
    """cv::Sobel with ddepth=CV_8U: saturate_cast<uchar> of the int result."""
    return torch.clamp(sobel_i32(gray, dx, dy, ksize), 0, 255).to(torch.uint8)


def laplacian_i16(gray: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv::Laplacian to CV_16S: ksize==1 uses the fixed 3x3 kernel, else
    Sobel(2,0) + Sobel(0,2); saturates to int16 (held in int32)."""
    if ksize == 1:
        k = ((0, 1, 0), (1, -4, 1), (0, 1, 0))
        x = _pad_hw(gray.to(torch.int32), 1, 1, "reflect")
        h, w = gray.shape[1], gray.shape[2]
        out = torch.zeros(gray.shape, dtype=torch.int32, device=gray.device)
        for i in range(3):
            for j in range(3):
                if k[i][j]:
                    out = out + x[:, i:i + h, j:j + w] * k[i][j]
    else:
        out = sobel_i32(gray, 2, 0, ksize) + sobel_i32(gray, 0, 2, ksize)
    return torch.clamp(out, -32768, 32767)


def convert_scale_u8(x: torch.Tensor, scale, shift) -> torch.Tensor:
    """cv::Mat::convertTo(CV_8U, scale, shift): float32 x * scale + shift,
    round-half-even, saturate."""
    return _to_u8(x.to(torch.float32) * scale + shift)


def apply_mask_rgb(rgb: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
    """img.copyTo(outimg, mask) onto a zeroed outimg: keep rgb where
    mask != 0, else 0 (gstcvsobel.cpp:267-270)."""
    return torch.where((mask_u8 != 0).unsqueeze(-1), rgb,
                       torch.zeros((), dtype=rgb.dtype, device=rgb.device))


# ---------------------------------------------------------------------------
# cvsmooth (gstcvsmooth.cpp:385-430)
# ---------------------------------------------------------------------------


def box_blur_u8(img: torch.Tensor, kw: int, kh: int) -> torch.Tensor:
    """cv::blur u8: normalized box sum, floor(mean + 0.5), reflect101.
    img [B, H, W, C]."""
    acc = _correlate_axis(img.to(torch.int32), [1] * kw, 2, "reflect")
    acc = _correlate_axis(acc, [1] * kh, 1, "reflect")
    n = kw * kh
    return torch.div(acc * 2 + n, 2 * n, rounding_mode="floor").to(
        torch.uint8)


def gaussian_blur_u8(img: torch.Tensor, kw: int, kh: int,
                     sigma: float) -> torch.Tensor:
    """cv::GaussianBlur u8 bit-exact path: ufixedpoint16 kernel (16
    fractional bits), horizontal pass rounded to 8 fractional bits, final
    (acc + 2^23) >> 24, in int64."""
    kxf = gaussian_kernel_cv(kw, sigma)
    kyf = gaussian_kernel_cv(kh if kh > 0 else kw, sigma)
    kx = [int(c) for c in np.rint(kxf * 65536).astype(np.int64)]
    ky = [int(c) for c in np.rint(kyf * 65536).astype(np.int64)]
    acc = _correlate_axis(img.to(torch.int64), kx, 2, "reflect")
    acc = (acc + 128) >> 8  # intermediate ufixedpoint16, 8 frac bits
    acc = _correlate_axis(acc, ky, 1, "reflect")
    return torch.clamp((acc + (1 << 23)) >> 24, 0, 255).to(torch.uint8)


def gaussian_blur_f32(img: torch.Tensor, ksize: int, sigma: float
                      ) -> torch.Tensor:
    """cv::GaussianBlur on CV_32F [B, H, W, C], float64 kernel applied in
    f32 separable passes, reflect101 (retinex's blur)."""
    k = [float(c) for c in gaussian_kernel_cv(ksize, sigma).astype(np.float32)]
    acc = _correlate_axis(img, k, 2, "reflect")
    return _correlate_axis(acc, k, 1, "reflect")


def _batcher_pairs(n: int) -> List[Tuple[int, int]]:
    """Batcher's odd-even merge sort on the next power of two >= n wires,
    as compare-exchanges (lo, hi): min to lo, max to hi.  Pairs that touch
    a wire >= n are left out: those wires hold +inf, which every
    compare-exchange leaves in place."""
    size = 1
    while size < n:
        size *= 2
    pairs = []

    def merge(lo, hi, r):
        step = r * 2
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + r, hi, step)
            pairs.extend((i, i + r) for i in range(lo + r, hi - r, step))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi, 1)

    sort(0, size - 1)
    return [(a, b) for a, b in pairs if b < n]


def median_network(n: int) -> List[Tuple[int, int, bool, bool]]:
    """The compare-exchanges of _batcher_pairs(n) that the median (wire
    n // 2 of the sorted output) depends on, each as (lo, hi, keep_min,
    keep_max): a side no later step reads is not computed."""
    need = {n // 2}
    net = []
    for lo, hi in reversed(_batcher_pairs(n)):
        keep_min, keep_max = lo in need, hi in need
        if keep_min or keep_max:
            net.append((lo, hi, keep_min, keep_max))
            need |= {lo, hi}
    return net[::-1]


def median_blur_u8(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv::medianBlur u8 (BORDER_REPLICATE): the median of the k*k
    neighbourhood through median_network's min/max steps over shifted
    views of the padded frame (no stack of the taps, no sort indices)."""
    r = ksize // 2
    x = _pad_hw(img, r, r, "edge")
    h, w = img.shape[1], img.shape[2]
    wires = [x[:, i:i + h, j:j + w] for i in range(ksize)
             for j in range(ksize)]
    for lo, hi, keep_min, keep_max in median_network(ksize * ksize):
        a, b = wires[lo], wires[hi]
        if keep_min:
            wires[lo] = torch.minimum(a, b)
        if keep_max:
            wires[hi] = torch.maximum(a, b)
    return wires[(ksize * ksize) // 2].contiguous()


def bilateral_u8(img: torch.Tensor, sigma_color: float,
                 sigma_space: float) -> torch.Tensor:
    """cv::bilateralFilter u8 with d=-1, as gstcvsmooth calls it:
    sigma_space<=0 -> 1, radius = round(1.5*sigma_space), gaussian color &
    space weights over the disk within the radius, reflect101, float32."""
    sc = sigma_color if sigma_color > 0 else 1.0
    ss = sigma_space if sigma_space > 0 else 1.0
    radius = max(int(np.rint(ss * 1.5)), 1)
    gauss_color = np.float32(-0.5 / (sc * sc))
    gauss_space = -0.5 / (ss * ss)
    x = _pad_hw(img.to(torch.float32), radius, radius, "reflect")
    h, w = img.shape[1], img.shape[2]
    num = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    den = torch.zeros(img.shape[:-1] + (1,), dtype=torch.float32,
                      device=img.device)
    center = img.to(torch.float32)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            rr = i * i + j * j
            if rr > radius * radius:
                continue  # OpenCV uses the disk within radius
            sw = float(np.float32(math.exp(gauss_space * rr)))
            nb = x[:, i + radius:i + radius + h, j + radius:j + radius + w]
            # color distance = sum of |channel diffs| (OpenCV u8 path)
            cd = torch.sum(torch.abs(nb - center), dim=-1, keepdim=True)
            wgt = f32(torch.exp, cd * float(gauss_color) * cd) * sw
            num = num + wgt * nb
            den = den + wgt
    return _to_u8(num / den)


# ---------------------------------------------------------------------------
# cvdilate / cverode (gstcvdilate.cpp:104-111, gstcverode.cpp)
# ---------------------------------------------------------------------------


def _rect3(x: torch.Tensor, op, fill) -> torch.Tensor:
    """op (maximum, minimum, logical or) over each 3x3 neighbourhood of
    [B, H, W] or [B, H, W, C], the border filled with `fill`: one 3-tap
    pass along W, then one along H."""
    h, w = x.shape[1], x.shape[2]
    p = _pad_const(x, 0, 1, fill)
    x = op(op(p[:, :, 0:w], p[:, :, 1:w + 1]), p[:, :, 2:w + 2])
    p = _pad_const(x, 1, 0, fill)
    return op(op(p[:, 0:h], p[:, 1:h + 1]), p[:, 2:h + 2])


def dilate_u8(img: torch.Tensor, iterations: int) -> torch.Tensor:
    """cv::dilate default 3x3 rect kernel, iterated (the border acts as
    replicate for a rect max)."""
    x = img
    for _ in range(max(iterations, 1)):
        x = _rect3(x, torch.maximum, 0)
    return x


def erode_u8(img: torch.Tensor, iterations: int) -> torch.Tensor:
    x = img
    for _ in range(max(iterations, 1)):
        x = _rect3(x, torch.minimum, 255)
    return x


# ---------------------------------------------------------------------------
# cvequalizehist (gstcvequalizehist.cpp:117-121)
# ---------------------------------------------------------------------------


def _hist256(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame 256-bin histograms of [B, ...] u8 -> int32 [B, 256].
    torch.histc counts in float32 (exact below 2^24 pixels a frame) and,
    unlike bincount, needs no host sync on the card."""
    flat = gray.reshape(gray.shape[0], -1)
    return torch.stack([torch.histc(f.to(torch.float32), bins=256,
                                    min=-0.5, max=255.5) for f in flat]
                       ).to(torch.int32)


def equalize_hist_u8(gray: torch.Tensor) -> torch.Tensor:
    """cv::equalizeHist on [B, H, W] u8: per-frame histogram -> LUT.

    OpenCV (histogram.cpp): i0 = first nonzero bin; scale = 255/(N-hist[i0]);
    lut[i0] = 0, lut[i>i0] = round(cumsum(hist[i0+1..i]) * scale); constant
    images pass through.  The table is gathered per frame.
    """
    b, h, w = gray.shape
    n = h * w
    hist = _hist256(gray)
    i0 = torch.argmax((hist > 0).to(torch.uint8), dim=1, keepdim=True)
    h_i0 = torch.gather(hist, 1, i0)[:, 0]
    denom = torch.clamp(n - h_i0, min=1)
    denom = denom.to(torch.float64)
    scale = torch.full_like(denom, 255.0) / denom
    csum = torch.cumsum(hist, dim=1)
    c_i0 = torch.gather(csum, 1, i0)
    lut = torch.round((csum - c_i0).to(torch.float64) * scale[:, None])
    lut = torch.clamp(lut, 0, 255).to(torch.uint8)
    idx = torch.arange(256, device=gray.device)[None, :]
    lut = torch.where(idx <= i0, torch.zeros_like(lut), lut)
    out = torch.gather(lut, 1, gray.reshape(b, n).to(torch.int64)
                       ).reshape(b, h, w)
    # constant image: pass through (OpenCV early-outs when N == hist[i0])
    const_frame = (h_i0 == n)[:, None, None]
    return torch.where(const_frame, gray, out)


# ---------------------------------------------------------------------------
# edgedetect: cv::Canny (gstedgedetect.cpp:259-276)
# ---------------------------------------------------------------------------


# Canny's hysteresis grows the strong set at most this many pixels (the JAX
# package's max_hysteresis_iters default); a multiple of 8, see canny_u8
HYSTERESIS_CAP = 64


def canny_u8(gray: torch.Tensor, threshold1: float, threshold2: float,
             aperture: int) -> torch.Tensor:
    """cv::Canny, L1 gradient (L2gradient=false default): Sobel(aperture),
    |gx|+|gy|, OpenCV's fixed-point sector NMS (TG22=13573, canny.cpp),
    double-threshold hysteresis by iterated masked dilation.

    The hysteresis grows the strong set one pixel a step, at most
    HYSTERESIS_CAP steps.  The JAX package tests for a change after
    every step (lax.while_loop); here the test is made once every 8 steps
    (one host sync each): a set that did not grow in a step never grows
    again, so running on to the end of the block changes nothing and the
    mask is the same.
    """
    low = int(min(threshold1, threshold2))
    high = int(max(threshold1, threshold2))
    # Canny's internal Sobel uses BORDER_REPLICATE (opencv canny.cpp), not
    # the standalone Sobel's reflect101 default
    kx1 = deriv_kernel(1, aperture)
    k0 = deriv_kernel(0, aperture)
    gi = gray.to(torch.int32)
    gx = _sep_correlate_i32(gi, kx1, k0, mode="edge")
    gy = _sep_correlate_i32(gi, k0, kx1, mode="edge")
    mag = torch.abs(gx) + torch.abs(gy)

    # neighbor magnitudes, zero-padded (OpenCV's map border is 0)
    mp = _pad_const(mag, 1, 1, 0)
    h, w = gray.shape[1], gray.shape[2]

    def nb(di, dj):
        return mp[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]

    xs = torch.abs(gx).to(torch.int64)
    ys = torch.abs(gy).to(torch.int64) << 15
    tg22x = xs * 13573
    tg67x = tg22x + (xs << 16)
    m = mag
    # horizontal sector: a > left && a >= right
    keep_h = (m > nb(0, -1)) & (m >= nb(0, 1))
    # vertical: a > up && a >= down
    keep_v = (m > nb(-1, 0)) & (m >= nb(1, 0))
    # diagonal: sign(gx) == sign(gy) -> main diagonal, else anti
    same_sign = (gx ^ gy) >= 0
    keep_d_main = (m > nb(-1, -1)) & (m > nb(1, 1))
    keep_d_anti = (m > nb(-1, 1)) & (m > nb(1, -1))
    keep_d = torch.where(same_sign, keep_d_main, keep_d_anti)
    keep = torch.where(ys < tg22x, keep_h,
                       torch.where(ys > tg67x, keep_v, keep_d))

    cand = keep & (m > low)
    cur = cand & (m > high)
    for _ in range(HYSTERESIS_CAP // 8):
        start = cur
        for _ in range(8):
            cur = _rect3(cur, torch.logical_or, False) & cand
        if torch.equal(cur, start):
            break
    return torch.where(cur, torch.tensor(255, dtype=torch.uint8,
                                         device=gray.device),
                       torch.tensor(0, dtype=torch.uint8, device=gray.device))


# ---------------------------------------------------------------------------
# retinex (gstretinex.cpp:333-411)
# ---------------------------------------------------------------------------


def retinex_basic(rgb: torch.Tensor, sigma: float, gain: float,
                  offset: float) -> torch.Tensor:
    """METHOD_BASIC: O = gain*(log(I) - log(gauss(I))) + offset, f32,
    filter_size = floor(sigma*6)/2*2+1 (gstretinex.cpp:343-361)."""
    fs = int(math.floor(sigma * 6) / 2) * 2 + 1
    a = rgb.to(torch.float32)
    logb = f32(torch.log, a)
    logc = f32(torch.log, gaussian_blur_f32(a, fs, 0.0))
    return convert_scale_u8(logb - logc, gain, offset)


def retinex_multiscale(rgb: torch.Tensor, scales: int, gain: float,
                       offset: float) -> torch.Tensor:
    """METHOD_MULTISCALE with the reference's weights 1/scales and sigmas
    10 + 4*scales for every scale (gstretinex.cpp:374-409).  Every scale
    blurs with the same sigma, so the blur is taken once; the subtraction
    still runs once a scale, in the JAX package's order."""
    a = rgb.to(torch.float32)
    acc = f32(torch.log, a)
    weight = float(np.float32(1.0 / scales))
    sigma_i = 10.0 + 4.0 * scales
    fs = int(math.floor(sigma_i * 6) / 2) * 2 + 1
    log_blur = f32(torch.log, gaussian_blur_f32(a, fs, 0.0))
    for _ in range(scales):
        acc = acc - log_blur * weight
    return convert_scale_u8(acc, gain, offset)


# ---------------------------------------------------------------------------
# templatematch: cv::matchTemplate (gsttemplatematch.cpp:289-306)
# ---------------------------------------------------------------------------


def _correlate_valid(x: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] f32 x [th, tw, C] f32 -> [B, H-th+1, W-tw+1]: the
    VALID cross-correlation summed over channels, in full float32."""
    with full_fp32():
        return F.conv2d(x.permute(0, 3, 1, 2),
                        templ.permute(2, 0, 1).unsqueeze(0))[:, 0]


def match_template(img: torch.Tensor, templ: torch.Tensor, method: str
                   ) -> torch.Tensor:
    """[B, H, W, C] u8 x [th, tw, C] u8 -> [B, H-th+1, W-tw+1] f32 score map.

    CCORR is one float32 convolution; SQDIFF/CCOEFF and the _NORMED
    variants are assembled from CCORR, local box sums and template moments,
    matching cv::matchTemplate's definitions (templmatch.cpp)."""
    th, tw, c = templ.shape
    x = img.to(torch.float32)
    ccorr = _correlate_valid(x, templ.to(torch.float32))
    if method == "ccorr":
        return ccorr

    # exact local sums via f64 integral images (u8 data: integers < 2^53,
    # so cumsum is exact — avoids the f32 cancellation that wrecks ccoeff)
    def box_sums(v):
        ii = F.pad(torch.cumsum(torch.cumsum(v, dim=1), dim=2), (1, 0, 1, 0))
        return (ii[:, th:, tw:] - ii[:, :-th, tw:]
                - ii[:, th:, :-tw] + ii[:, :-th, :-tw])

    n_pix = th * tw
    xd = img.to(torch.float64)
    s1c = torch.stack([box_sums(xd[..., ch]) for ch in range(c)], -1)
    s2 = box_sums((xd ** 2).sum(dim=-1))
    td = templ.to(torch.float64)
    t_sum_c = torch.sum(td, dim=(0, 1))           # per-channel (OpenCV
    t_mean_c = true_div(t_sum_c, n_pix)           # subtracts means per cn)
    t_sq = torch.sum(td * td)
    t_var = t_sq - true_div(torch.sum(t_sum_c * t_sum_c), n_pix)

    if method == "sqdiff":
        return (s2 - 2.0 * ccorr.to(torch.float64) + t_sq).to(torch.float32)
    if method == "ccorr_normed":
        return (ccorr / torch.sqrt(s2 * t_sq + 1e-30)).to(torch.float32)
    if method == "sqdiff_normed":
        return ((s2 - 2.0 * ccorr.to(torch.float64) + t_sq)
                / torch.sqrt(s2 * t_sq + 1e-30)).to(torch.float32)
    if method in ("ccoeff", "ccoeff_normed"):
        # per-channel centered template -> single conv, no cancellation
        tc = (td - t_mean_c).to(torch.float32)
        num = _correlate_valid(x, tc)
        if method == "ccoeff":
            return num
        img_var = s2 - true_div(torch.sum(s1c * s1c, dim=-1), n_pix)
        return (num / torch.sqrt(torch.clamp(img_var * t_var, min=0) + 1e-30)
                ).to(torch.float32)
    raise ValueError(f"unknown matchTemplate method {method!r}")


# ---------------------------------------------------------------------------
# skindetect / motioncells building blocks
# ---------------------------------------------------------------------------


def rgb2hsv_u8(rgb: torch.Tensor) -> torch.Tensor:
    """cv::cvtColor COLOR_RGB2HSV u8 fixed point (H in 0..180):
    hsv_shift=12, the sdiv/hdiv tables gathered directly."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    c = v - m
    shift = 12
    # the tables as the JAX package's numpy builds them: rint of a float64
    # quotient, 0 at index 0
    idx = torch.arange(256, dtype=torch.float64, device=rgb.device)
    nz = idx > 0
    sdiv = torch.where(nz, torch.round(
        torch.full_like(idx, 255 * (1 << shift)) / idx), 0.0).to(torch.int64)
    hdiv = torch.where(nz, torch.round(
        torch.full_like(idx, 180 << shift) / (6 * idx)), 0.0).to(torch.int64)
    s = (c * sdiv[v] + (1 << (shift - 1))) >> shift
    hd = hdiv[c]
    h = torch.where(v == r, (g - b) * hd,
                    torch.where(v == g, ((b - r) + 2 * c) * hd,
                                ((r - g) + 4 * c) * hd))
    h = (h + (1 << (shift - 1))) >> shift
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h.to(torch.uint8), s.to(torch.uint8),
                        v.to(torch.uint8)], dim=-1)


def pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown u8: [1,4,6,4,1]/16 separable (fixed point /256 with
    +128 rounding), reflect101, decimate even rows/cols.  Each pass is
    taken only where the decimated output reads it (even columns, then
    even rows): the same integers as filtering everything first."""
    k = [1, 4, 6, 4, 1]
    h, w = img.shape[1], img.shape[2]
    x = _pad_hw(img, 0, 2, "reflect").to(torch.int32)
    acc = None
    for t, c in enumerate(k):
        term = x[:, :, t:t + w:2] * c
        acc = term if acc is None else acc + term
    x = _pad_hw(acc, 2, 0, "reflect")
    acc = None
    for t, c in enumerate(k):
        term = x[:, t:t + h:2] * c
        acc = term if acc is None else acc + term
    out = (acc + 128) >> 8
    return torch.clamp(out, 0, 255).to(torch.uint8)


def adaptive_threshold_gaussian_inv(gray: torch.Tensor, block: int,
                                    c: int) -> torch.Tensor:
    """cv::adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY_INV)
    with maxval 255: T = bit-exact u8 gaussian(block, sigma<=0) - c; dst =
    src > T ? 0 : 255."""
    t = gaussian_blur_u8(gray.unsqueeze(-1), block, block, 0.0)[..., 0]
    keep = gray.to(torch.int32) > (t.to(torch.int32) - c)
    return torch.where(keep, 0, 255).to(torch.uint8)


def threshold_binary(x: torch.Tensor, thresh, inverse: bool = False
                     ) -> torch.Tensor:
    """cv::threshold THRESH_BINARY / _INV with maxval 255: (x > thresh)
    selects 255."""
    above = x.to(torch.float32) > float(np.float32(thresh))
    if inverse:
        above = ~above
    return torch.where(above, 255, 0).to(torch.uint8)
