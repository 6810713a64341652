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
