"""Bayer demosaic — vectorized rebuild of the ORC split/merge scheme
(gst/bayer/gstbayerorc.orc, gstbayer2rgb.c:355-447).

The reference splits each bayer row into even/odd phase planes with a
horizontal rounded-average upsample, then merges three row-pairs vertically
per output row.  Here both stages are batched tensor ops; avgub =
(a+b+1)>>1 runs in int16 (exact: torch's uint16 has few operators), and
the reference's 8-line ring quirks stay: row 0's "above" is row 1, and the
last row's "below" is row H-4.
"""

from __future__ import annotations

import numpy as np
import torch


def _avgub(a, b):
    return ((a.to(torch.int16) + b.to(torch.int16) + 1) >> 1
            ).to(torch.uint8)


def split_rows(raw: torch.Tensor):
    """[B, H, W] bayer -> (d0, d1) phase planes, each [B, H, W]."""
    w = raw.shape[-1]
    left = torch.cat([raw[..., :1], raw[..., :-1]], dim=-1)
    right = torch.cat([raw[..., 1:], raw[..., -1:]], dim=-1)
    avg = _avgub(left, right)
    even = (torch.arange(w, device=raw.device) % 2) == 0
    d0 = torch.where(even, raw, avg)
    d1 = torch.where(even, avg, raw)
    # scalar edge overrides (gstbayer2rgb.c:360-379)
    d0[..., w - 1] = raw[..., w - 2]
    d1[..., 0] = raw[..., 1]
    d1[..., w - 2] = raw[..., w - 3]
    return d0, d1


def neighbor_rows(h: int) -> tuple[np.ndarray, np.ndarray]:
    """Above/below row indices with the 8-line-ring behavior."""
    above = np.arange(h) - 1
    above[0] = 1
    below = np.arange(h) + 1
    below[h - 1] = h - 4
    return above, below


def demosaic(raw: torch.Tensor, fmt: str, out_offsets) -> torch.Tensor:
    """[B, H, W] bayer -> [B, H, W, 4] with (r, g, b, alpha) at
    `out_offsets` channel positions; alpha = 255.

    fmt in {bggr, gbrg, grbg, rggb}; H >= 4, W even.
    """
    b, h, w = raw.shape
    dev = raw.device
    d0, d1 = split_rows(raw)
    above, below = (torch.as_tensor(r, device=dev) for r in neighbor_rows(h))
    d0a, d1a = d0.index_select(1, above), d1.index_select(1, above)
    d0b, d1b = d0.index_select(1, below), d1.index_select(1, below)

    swap_merge = fmt in ("grbg", "gbrg")
    swap_rb = fmt in ("rggb", "gbrg")
    row_is_bg = ((torch.arange(h, device=dev) % 2) == 0) != swap_merge
    col_even = (torch.arange(w, device=dev) % 2) == 0

    # bg rows: cur = (B, G) phases, neighbors GR
    bg_R = _avgub(d1a, d1b)
    bg_B = d0
    bg_G = torch.where(col_even, _avgub(_avgub(d0a, d0b), d1), d1)
    # gr rows: cur = (G, R) phases, neighbors BG
    gr_B = _avgub(d0a, d0b)
    gr_R = d1
    gr_G = torch.where(col_even, d0, _avgub(_avgub(d1a, d1b), d0))

    is_bg = row_is_bg[:, None]
    R = torch.where(is_bg, bg_R, gr_R)
    G = torch.where(is_bg, bg_G, gr_G)
    B = torch.where(is_bg, bg_B, gr_B)
    if swap_rb:
        R, B = B, R

    r_off, g_off, b_off, a_off = out_offsets
    out = torch.empty((b, h, w, 4), dtype=torch.uint8, device=dev)
    out[..., r_off] = R
    out[..., g_off] = G
    out[..., b_off] = B
    out[..., a_off] = 255
    return out


def to_bayer(argb_like: torch.Tensor, fmt: str, offsets) -> torch.Tensor:
    """rgb2bayer decimation (gstrgb2bayer.c:236-262). argb_like [B,H,W,4]
    with (r, g, b) channel positions in `offsets`."""
    fmt_idx = {"bggr": 0, "gbrg": 1, "grbg": 2, "rggb": 3}[fmt]
    h, w = argb_like.shape[1:3]
    dev = argb_like.device
    i = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    j = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    pos = ((j & 1) << 1) | (i & 1)
    r_off, g_off, b_off = offsets[:3]
    out = argb_like[..., g_off]
    out = torch.where(pos == fmt_idx, argb_like[..., b_off], out)
    return torch.where((pos ^ 3) == fmt_idx, argb_like[..., r_off], out)
