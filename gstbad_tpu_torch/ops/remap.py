"""Warp engine — the geometrictransform base as one gather per window
(kernel K7).

The reference precomputes a double[w*h*2] inverse map once per caps change
(gstgeometrictransform.c:80-128) and walks it per pixel with memcpy
(:167-207).  Here the map is fixed to flat int32 source indices and a
validity mask on the host (fix_map: the same double-precision math,
golden/geometric.py), and the per-frame work is one gather of packed
4-byte pixels per window: `warp_words` on the card
(csrc/warp_kernels.cu:warp_kernel; it replaces the TPU kernel
gstbad_tpu/ops/warp_pallas.py:_kernel), `warp_words_plain` in plain tensor
ops (one index_select and a where).

The opencv family's remap clients (cameraundistort, dewarp) take
cv::remap's CV_16SC2 fixed-point INTER_LINEAR path as four flat gathers
with integer weights (bilinear_taps, once per negotiation, then
remap_taps per window), over maps built on the host by the
numpy transcriptions below (the JAX package's, so that the maps are the
same bits).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gstbad_tpu_torch.golden.geometric import mod_float


def fix_map(mp: np.ndarray, width: int, height: int, off_edge: str
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the off-edge policy + truncation sampling on the host.

    Returns (flat_idx int32 [H*W], valid bool [H*W]); invalid entries index 0.
    Mirrors gst_geometric_transform_do_map (gstgeometrictransform.c:167-207).
    """
    in_x = mp[..., 0].astype(np.float64).copy()
    in_y = mp[..., 1].astype(np.float64).copy()
    if off_edge == "clamp":
        in_x = np.clip(in_x, 0, width - 1)
        in_y = np.clip(in_y, 0, height - 1)
    elif off_edge == "wrap":
        in_x = mod_float(in_x, width)
        in_y = mod_float(in_y, height)
        in_x = np.where(in_x < 0, in_x + width, in_x)
        in_y = np.where(in_y < 0, in_y + height, in_y)
    # NaNs from pathological map math (sqrt of negative in sphere/tunnel
    # edge params) become invalid pixels, not a cast RuntimeWarning — the
    # C's (gint)NaN is UB; -1 deterministically fails the bounds check
    in_x = np.nan_to_num(in_x, nan=-1.0)
    in_y = np.nan_to_num(in_y, nan=-1.0)
    tx = np.trunc(in_x).astype(np.int64)
    ty = np.trunc(in_y).astype(np.int64)
    valid = (tx >= 0) & (tx < width) & (ty >= 0) & (ty < height)
    flat = np.where(valid, ty * width + tx, 0).astype(np.int32)
    return flat.reshape(-1), valid.reshape(-1)


def word_map(flat: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """fix_map's pair as the one int32 map warp_words takes: the source
    index, or -1 for an off-edge pixel."""
    return np.where(valid, flat, -1).astype(np.int32)


def background_word(bg: bytes) -> int:
    """4 background bytes in memory order -> the int32 word value."""
    return int.from_bytes(bytes(bg), "little", signed=True)


def remap(img: torch.Tensor, flat_idx: torch.Tensor, valid: torch.Tensor,
          background: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] x flat map -> [B, H, W, C]; one gather per window."""
    b, h, w, c = img.shape
    out = img.reshape(b, h * w, c).index_select(1, flat_idx)
    out = torch.where(valid[None, :, None], out,
                      background[None, None, :].to(img.dtype))
    return out.reshape(b, h, w, c)


def warp_words_plain(src_word: torch.Tensor, mp: torch.Tensor, bg: int,
                     batch: int | None = None) -> torch.Tensor:
    """warp_words in plain tensor ops.  A [1, H, W] broadcast base is
    warped once and repeated `batch` times."""
    sb, h, w = src_word.shape
    valid = (mp >= 0) & (mp < h * w)
    out = src_word.reshape(sb, h * w).index_select(
        1, torch.where(valid, mp, 0))
    out = torch.where(valid, out, bg).reshape(sb, h, w)
    b = sb if batch is None else batch
    return out.expand(b, -1, -1).contiguous() if sb != b else out


def warp_words(src_word: torch.Tensor, mp: torch.Tensor, bg: int,
               batch: int | None = None) -> torch.Tensor:
    """[B, H, W] int32 packed pixels -> warped words, one launch:
    out[b, p] = src[b, mp[p]] where 0 <= mp[p] < H*W, else the background
    word `bg` (an int32 value, background_word).

    mp: int32 [H*W] on src_word's device (word_map of fix_map).  src_word
    may be a BROADCAST base of shape [1, H, W] with batch=B: the one frame
    is gathered once per pixel for all B output frames.

    CPU tensors take warp_words_plain; CUDA tensors launch the kernel or
    raise.
    """
    if src_word.dtype != torch.int32 or src_word.ndim != 3:
        raise ValueError("warp_words: src_word must be int32 [B, H, W], got "
                         f"{src_word.dtype} {tuple(src_word.shape)}")
    sb, h, w = src_word.shape
    b = sb if batch is None else batch
    if sb not in (1, b):
        raise ValueError(f"warp_words: {sb} source frames for batch {b}")
    if mp.dtype != torch.int32 or tuple(mp.shape) != (h * w,):
        raise ValueError(f"warp_words: map must be int32 [{h * w}], got "
                         f"{mp.dtype} {tuple(mp.shape)}")
    if not -2**31 <= bg < 2**31:
        raise ValueError(f"warp_words: background {bg} is not an int32")
    dev = src_word.device
    if dev.type == "cpu" and mp.device.type == "cpu":
        return warp_words_plain(src_word, mp, bg, batch=b)
    from gstbad_tpu_torch.ops import _cuda
    if not (src_word.is_contiguous() and mp.is_contiguous()):
        raise ValueError("warp_words: inputs must be contiguous")
    if h * w >= 2**31:
        raise ValueError(f"warp_words: {h}x{w} frames exceed int32 indices")
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    _cuda.launch("gst_warp_words", src_word, out, mp, b, h, w, bg,
                 int(sb == 1 and b > 1))
    warp_words.launches += 1
    return out


warp_words.launches = 0


def bilinear_taps(map_x: np.ndarray, map_y: np.ndarray, h: int, w: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """cv::remap INTER_LINEAR's four taps for float32 maps [OH, OW] over an
    H x W source (BORDER_CONSTANT 0), on the host: (flat int32 [4, OH*OW]
    source indices, weights int32 [4, OH*OW] in units of 2^-15, 0 for a
    tap off the frame).

    This is the CV_16SC2 fixed-point path the reference feeds remap with
    (gstcameraundistort.cpp:352-354, gstdewarp.cpp:663+): coords rounded
    to 1/32, bilinear weights ay*ax*32 (integer, /2^15).
    """
    fxq = np.rint(map_x.astype(np.float64) * 32).astype(np.int64)
    fyq = np.rint(map_y.astype(np.float64) * 32).astype(np.int64)
    x0, y0 = fxq >> 5, fyq >> 5
    fx, fy = (fxq & 31), (fyq & 31)
    wts = {(dy, dx): ((fy if dy else 32 - fy)
                      * (fx if dx else 32 - fx) * 32)
           for dy in (0, 1) for dx in (0, 1)}  # /2^15
    flats, weights = [], []
    for (dy, dx), wgt in wts.items():
        xx, yy = x0 + dx, y0 + dy
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        flats.append(np.where(inb, np.clip(yy, 0, h - 1) * w
                              + np.clip(xx, 0, w - 1), 0).reshape(-1))
        weights.append((wgt * inb).reshape(-1))
    return (np.stack(flats).astype(np.int32),
            np.stack(weights).astype(np.int32))


def remap_taps(img: torch.Tensor, flat: torch.Tensor, weights: torch.Tensor,
               out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] u8 through bilinear_taps' (flat, weights), on img's
    device -> [B, OH, OW, C] u8: four gathers, an int32 sum of weight x
    pixel, (acc + 2^14) >> 15, saturated.  Exact (integer weights): the
    JAX package's remap_bilinear bit for bit."""
    b, h, w, c = img.shape
    flat_img = img.reshape(b, h * w, c)
    acc = None
    for k in range(4):
        px = flat_img.index_select(1, flat[k]).to(torch.int32)
        term = weights[k][None, :, None] * px
        acc = term if acc is None else acc + term
    out = (acc + (1 << 14)) >> 15
    return torch.clamp(out, 0, 255).to(torch.uint8).reshape(
        b, out_hw[0], out_hw[1], c)


# ---------------------------------------------------------------------------
# cameraundistort map building (gstcameraundistort.cpp:341-357) — numpy
# transcriptions of cv::getOptimalNewCameraMatrix / initUndistortRectifyMap
# (opencv modules/calib3d/src/calibration.cpp, undistort.dispatch.cpp), the
# JAX package's line for line.
# ---------------------------------------------------------------------------


def _distort(x, y, dist):
    """Apply the Brown-Conrady model to normalized coords."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    kr = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * kr + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * kr + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_points(pts: np.ndarray, K: np.ndarray, dist) -> np.ndarray:
    """cv::undistortPoints (fixed-point iteration, 5 iters like
    cvUndistortPointsInternal's default criteria)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (pts[:, 0] - cx) / fx
    y0 = (pts[:, 1] - cy) / fy
    x, y = x0.copy(), y0.copy()
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    for _ in range(5):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return np.stack([x, y], -1)


def _get_rectangles(K, dist, size):
    """icvGetRectangles: undistort a 9x9 border grid, compute the outer
    (bounding) and inner (inscribed) rectangles in normalized coords."""
    w, h = size
    n = 9
    xs, ys = np.meshgrid(np.arange(n), np.arange(n))
    pts = np.stack([xs.ravel() * (w - 1) / (n - 1),
                    ys.ravel() * (h - 1) / (n - 1)], -1).astype(np.float64)
    und = undistort_points(pts, K, dist)
    ox0, oy0 = und[:, 0].min(), und[:, 1].min()
    ox1, oy1 = und[:, 0].max(), und[:, 1].max()
    ix0, iy0, ix1, iy1 = -np.inf, -np.inf, np.inf, np.inf
    for k in range(n * n):
        i, j = k // n, k % n
        x, y = und[k]
        if j == 0:
            ix0 = max(ix0, x)
        if j == n - 1:
            ix1 = min(ix1, x)
        if i == 0:
            iy0 = max(iy0, y)
        if i == n - 1:
            iy1 = min(iy1, y)
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


def get_optimal_new_camera_matrix(K: np.ndarray, dist, size,
                                  alpha: float) -> np.ndarray:
    """cv::getOptimalNewCameraMatrix (newImgSize == imageSize)."""
    w, h = size
    inner, outer = _get_rectangles(K, dist, size)
    fx0 = (w - 1) / inner[2]
    fy0 = (h - 1) / inner[3]
    cx0 = -fx0 * inner[0]
    cy0 = -fy0 * inner[1]
    fx1 = (w - 1) / outer[2]
    fy1 = (h - 1) / outer[3]
    cx1 = -fx1 * outer[0]
    cy1 = -fy1 * outer[1]
    newK = np.eye(3)
    newK[0, 0] = fx0 * (1 - alpha) + fx1 * alpha
    newK[1, 1] = fy0 * (1 - alpha) + fy1 * alpha
    newK[0, 2] = cx0 * (1 - alpha) + cx1 * alpha
    newK[1, 2] = cy0 * (1 - alpha) + cy1 * alpha
    return newK


def init_undistort_map(K: np.ndarray, dist, newK: np.ndarray, size):
    """cv::initUndistortRectifyMap with R = I: output pixel -> distorted
    source pixel (float64 maps [H, W])."""
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    x = (u - newK[0, 2]) / newK[0, 0]
    y = (v - newK[1, 2]) / newK[1, 1]
    xd, yd = _distort(x, y, dist)
    return (K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2])


def dewarp_map(in_w: int, in_h: int, out_w: int, out_h: int,
               x_center: float, y_center: float, inner_radius: float,
               outer_radius: float, corr_x: float, corr_y: float):
    """gst_dewarp_update_map (gstdewarp.cpp:438-478) in C float precision:
    polar unwrap of the fisheye donut."""
    r1 = np.float64(in_w * inner_radius)
    r2 = np.float64(in_w * outer_radius)
    cx = np.float64(x_center * in_w)
    cy = np.float64(y_center * in_h)
    y, x = np.meshgrid(np.arange(out_h, dtype=np.float32),
                       np.arange(out_w, dtype=np.float32), indexing="ij")
    r = (y / np.float32(out_h)) * np.float32(r2 - r1) + np.float32(r1)
    theta = (x / np.float32(out_w)) * np.float32(2.0 * np.pi)
    map_x = (np.float32(cx) + r * np.sin(theta) * np.float32(corr_x))
    map_y = (np.float32(cy) + r * np.cos(theta) * np.float32(corr_y))
    return map_x.astype(np.float32), map_y.astype(np.float32)
