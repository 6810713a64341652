"""Separable gaussian blur with border-truncated normalization (kernel K3).

gaussian_smooth (gst/gaudieffects/gstgaussblur.c:260-356) runs two float
passes, x then y, with per-position kernel windows clipped to the frame
and normalized by the partial kernel sum.  A zero-padded correlation
divided by the per-position partial sums reproduces that exactly: padding
contributes 0.0 to the numerator, and the denominator is the same
prefix-sum difference the C uses (border_sums).

`gaussian_blur_words` runs the whole blur in one pass over the packed
AYUV words (csrc/blur_kernels.cu:blur_kernel; it replaces the TPU kernel
gstbad_tpu/ops/blur_pallas.py:_kernel).  `gaussian_blur_words_plain` is
the same function in plain tensor ops, with the same float32 operation
order: taps k = 0 .. 2c from 0.0, each a product then a sum, the IEEE
division by the border sum, then +0.5, the clamp to [0, 255] and a
truncating cast.  `gaussian_blur` applies it to [B, H, W, C] bytes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gstbad_tpu_torch.golden.gaudieffects import gaussian_kernel


def border_sums(n: int, kern: np.ndarray, ksum: np.ndarray) -> np.ndarray:
    """Per-position normalization sums (gstgaussblur.c:268-276,319-321)."""
    window = kern.shape[0]
    center = window // 2
    out = np.empty(n, np.float32)
    for c in range(n):
        kmin = max(0, center - c)
        base = c - center + kmin
        kmax = min(window, n - base)
        out[c] = ksum[kmax - 1] - (ksum[kmin - 1] if kmin else np.float32(0))
    return out


def make_blur_tables(sigma: float, height: int, width: int):
    """Host-side precompute: (kernel f32 [window], row_sums [H],
    col_sums [W])."""
    kern, ksum = gaussian_kernel(sigma)
    return kern, border_sums(height, kern, ksum), border_sums(width, kern, ksum)


def _blur_plane(x: torch.Tensor, kern: torch.Tensor, row_sums: torch.Tensor,
                col_sums: torch.Tensor) -> torch.Tensor:
    """[..., H, W] float32 channel plane -> int32 bytes in [0, 255]."""
    h, w = x.shape[-2:]
    center = kern.shape[0] // 2
    xp = F.pad(x, (center, center))
    acc = torch.zeros_like(x)
    for k in range(kern.shape[0]):
        acc = acc + xp[..., k:k + w] * kern[k]
    tmp = acc / col_sums
    tp = F.pad(tmp, (0, 0, center, center))
    acc = torch.zeros_like(tmp)
    for k in range(kern.shape[0]):
        acc = acc + tp[..., k:k + h, :] * kern[k]
    out = (acc / row_sums[:, None] + 0.5).clamp(0.0, 255.0)
    # a border sum of 0 (frames narrower than the window) makes a black
    # pixel 0/0: NaN casts to 0, as the JAX package's XLA blur and the
    # card's kernel give it (a plain cast gives INT_MIN on the CPU)
    return torch.nan_to_num(out, nan=0.0).to(torch.int32)


def _tables(kern, row_sums, col_sums, device):
    """The three tables as float32 tensors on `device` (no copy for
    tensors already there: an element uploads them once, at prepare)."""
    return [torch.as_tensor(t, dtype=torch.float32, device=device)
            for t in (kern, row_sums, col_sums)]


def gaussian_blur(img: torch.Tensor, kern, row_sums, col_sums
                  ) -> torch.Tensor:
    """[B, H, W, C] uint8 -> uint8, each channel blurred on its own."""
    k, r, c = _tables(kern, row_sums, col_sums, img.device)
    planes = [_blur_plane(img[..., ch].to(torch.float32), k, r, c)
              for ch in range(img.shape[-1])]
    return torch.stack(planes, -1).to(torch.uint8)


def gaussian_blur_words_plain(src_word: torch.Tensor, kern, row_sums,
                              col_sums, batch: int | None = None
                              ) -> torch.Tensor:
    """gaussian_blur_words in plain tensor ops.  A [1, H, W] broadcast
    base is blurred once and repeated `batch` times."""
    k, r, c = _tables(kern, row_sums, col_sums, src_word.device)
    out = None
    for ch in range(4):
        plane = ((src_word >> (8 * ch)) & 255).to(torch.float32)
        byte = _blur_plane(plane, k, r, c)
        out = byte if out is None else out | (byte << (8 * ch))
    b = src_word.shape[0] if batch is None else batch
    return out.expand(b, -1, -1).contiguous() if out.shape[0] != b else out


def gaussian_blur_words(src_word: torch.Tensor, kern, row_sums, col_sums,
                        batch: int | None = None) -> torch.Tensor:
    """[B, H, W] int32 packed AYUV words -> blurred words, one launch.

    kern/row_sums/col_sums: the float32 tables of make_blur_tables, as
    arrays or as tensors on src_word's device; a window of up to 101 taps
    (|sigma| <= 20) and any H, W.  src_word may
    be a BROADCAST base of shape [1, H, W] with batch=B (a static
    videotestsrc frame): the one frame is read for every output frame.

    CPU tensors take gaussian_blur_words_plain; CUDA tensors launch the
    kernel or raise.
    """
    if src_word.dtype != torch.int32 or src_word.ndim != 3:
        raise ValueError("gaussian_blur_words: src_word must be int32 "
                         f"[B, H, W], got {src_word.dtype} "
                         f"{tuple(src_word.shape)}")
    sb, h, w = src_word.shape
    b = sb if batch is None else batch
    if sb not in (1, b):
        raise ValueError(f"gaussian_blur_words: {sb} source frames for "
                         f"batch {b}")
    dev = src_word.device
    k, r, c = _tables(kern, row_sums, col_sums, dev)
    n = k.shape[0] if k.ndim == 1 else 0
    if (n % 2 != 1 or n > 101 or tuple(r.shape) != (h,)
            or tuple(c.shape) != (w,)):
        raise ValueError("gaussian_blur_words: tables must be an odd "
                         f"window of at most 101 taps, [{h}] row sums and "
                         f"[{w}] column sums")
    if dev.type == "cpu":
        return gaussian_blur_words_plain(src_word, k, r, c, batch=b)
    from gstbad_tpu_torch.ops import _cuda
    if not src_word.is_contiguous():
        raise ValueError("gaussian_blur_words: src_word must be contiguous")
    if b > 65535:
        raise ValueError(f"gaussian_blur_words: batch {b} > 65535")
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    _cuda.launch("gst_gaussian_blur", src_word, out, k, r, c, b, h, w,
                 n // 2, int(sb == 1 and b > 1))
    gaussian_blur_words.launches += 1
    return out


gaussian_blur_words.launches = 0
