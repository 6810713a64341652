"""256-entry tables: builders, plain lookups, and the whole-word lookup
kernel.

The JAX package packs byte tables into bit planes because a gather is slow
on the TPU.  On the card a gather out of a 256-entry table is cheap, so
`lookup` is a plain `table[idx]`.  `apply_word_table` — the lookup of a
whole packed 32-bit pixel per entry over a full index plane — is the one
hand-written kernel here (csrc/tablefuse_kernels.cu).
"""

from __future__ import annotations

import torch


def lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[..., idx] for idx in [0, 256).  table is [256] or carries
    per-frame leading dims ([B, 256], the controllable-curve path) that
    broadcast against idx's leading dims."""
    if table.ndim == 1:
        return table[idx]
    lead = table.shape[:-1]
    t = table.reshape(lead + (1,) * (idx.ndim - len(lead)) + (256,))
    shape = torch.broadcast_shapes(t.shape[:-1], idx.shape)
    return torch.gather(t.expand(shape + (256,)), -1,
                        idx.long().expand(shape).unsqueeze(-1))[..., 0]


# ---------------------------------------------------------------------------
# whole-word table lookup — kernel K2
# ---------------------------------------------------------------------------

def apply_word_table_plain(idx: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """The plain form of apply_word_table (the kernel masks idx to 8 bits
    to stay inside its shared-memory table; so does this)."""
    return table[idx & 255]


def apply_word_table(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 256-entry int32 table (e.g. a whole packed pixel
    per entry) over an int32 idx plane in [0, 256) of any shape.

    Replaces the TPU kernel gstbad_tpu/ops/lut.py:_word_lut_kernel.  CPU
    tensors take the plain form; CUDA tensors launch
    csrc/tablefuse_kernels.cu:word_lut_kernel or raise."""
    if table.dtype != torch.int32 or table.shape != (256,):
        raise ValueError(f"apply_word_table: table must be int32 [256], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise ValueError(f"apply_word_table: idx must be int32, got "
                         f"{idx.dtype}")
    if idx.device != table.device:
        raise ValueError("apply_word_table: idx and table on different "
                         f"devices ({idx.device}, {table.device})")
    if idx.device.type == "cpu":
        return apply_word_table_plain(idx, table)
    from gstbad_tpu_torch.ops import _cuda
    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("apply_word_table: idx and table must be contiguous")
    out = torch.empty_like(idx)
    _cuda.launch("gst_word_lut", idx, table, out, idx.numel())
    apply_word_table.launches += 1
    return out


apply_word_table.launches = 0


# ---------------------------------------------------------------------------
# composed per-byte tables for the gaudieffects/coloreffects math.  Each
# builds the full 256-entry output table from the dynamic params (256-entry
# vector math, never per pixel).  A param with a leading [B] dim (a
# controllable curve) gives a [B, 256] table.
# ---------------------------------------------------------------------------


def burn_table(adjustment: torch.Tensor) -> torch.Tensor:
    """gaudi_orc_burn as a byte map (ops/pointops.burn semantics)."""
    c = torch.arange(256, dtype=torch.int32, device=adjustment.device)
    adj = adjustment.to(torch.int32)
    if adj.ndim:
        adj = adj[..., None]  # per-frame curve -> [B, 256] table
    # divluw saturates the quotient to 255 and yields 255 on /0 — verified
    # against the compiled reference backup (gstgaudieffectsorc-dist.c,
    # "/* 10: divluw */"); the divisor is the low byte of the shifted word.
    a = ((c + adj) >> 1) & 0xFF
    t = (255 - c) << 7
    q = torch.where(a == 0, 255, (t // a.clamp(min=1)).clamp(max=255))
    return (255 - q).to(torch.uint8)


def chromium_table(edge_a: torch.Tensor, edge_b: torch.Tensor,
                   cos_table: torch.Tensor) -> torch.Tensor:
    """chromium composed to a byte map: only 256 of the 1024 cosine entries
    are reachable for a given (edge-a, edge-b)."""
    c = torch.arange(256, dtype=torch.int32, device=cos_table.device)
    ea = edge_a.to(torch.int32)
    eb = edge_b.to(torch.int32)
    if ea.ndim:
        ea = ea[..., None]
    if eb.ndim:
        eb = eb[..., None]
    i = (c + ea + (c * eb) // 2) & 1023
    return cos_table[i].abs().clamp(0, 255).to(torch.uint8)


def dodge_table(device="cpu") -> torch.Tensor:
    c = torch.arange(256, dtype=torch.int32, device=device)
    return ((256 * c) // (256 - c)).clamp(0, 255).to(torch.uint8)


def solarize_table(threshold: torch.Tensor, start: torch.Tensor,
                   end: torch.Tensor) -> torch.Tensor:
    """solarize's ramp as a byte map with exact C int/uint32 semantics
    (int64 math runs on 256 entries, never per pixel)."""
    threshold = threshold.to(torch.int32)
    start = start.to(torch.int32)
    end = end.to(torch.int32)
    if threshold.ndim or start.ndim or end.ndim:
        threshold, start, end = (v[..., None] for v in torch.broadcast_tensors(
            threshold, start, end))
    period = torch.where(end != start, end - start, 1).to(torch.int64)
    up_length = torch.where(threshold != start, threshold - start, 1
                            ).to(torch.int64)
    down_length = torch.where(threshold != end, end - threshold, 1
                              ).to(torch.int64)
    c = torch.arange(256, dtype=torch.int64, device=threshold.device)
    param = c + 256 - start.to(torch.int64)
    # C's int division: a float64 true division truncated toward zero
    param = param - (param.double() / period.double()).to(torch.int64) * period
    M = 0xFFFFFFFF
    up = ((param * 255) & M) // (up_length & M)
    v = (down_length - (param - up_length)) & M
    down = ((v * 255) & M) // (down_length & M)
    col = torch.where(param < up_length, up, down)
    return torch.where(col > 255, 255, col).to(torch.uint8)
