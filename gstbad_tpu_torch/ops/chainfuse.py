"""Fused chain kernel — the whole headline tail in one pass (kernel K1).

The table-fusion pass (core/tablefuse.py) reduces a chain like
sepia!solarize!...!exclusion!dilate!chromahold!videoconvert!zebrastripe
to: idx = index(src); idx' = dilate3(idx, rank[idx]); out =
word_table[idx'] with a positional stripe select.  `dilate_zebra_fused`
runs all of that in one pass over the source words, so the only full-size
traffic is one read of the source and one write of the output
(csrc/tablefuse_kernels.cu:dilate_zebra_kernel; it replaces the TPU kernel
gstbad_tpu/ops/chainfuse.py:_kernel).  `dilate_zebra_plain` is the same
function in plain tensor ops.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.ops.pointops import (byte_of, i32, shift_down,
                                           shift_left, shift_right,
                                           stripe_mask)

_ZEBRA_KEEP = i32(0xFFFF00FF)  # clear the AYUV Y byte


def _per_frame_i32(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.int32).expand(b)


def dilate_zebra_plain(src_word: torch.Tensor, rank_table: torch.Tensor,
                       word_table: torch.Tensor, index, scal: torch.Tensor
                       ) -> torch.Tensor:
    """dilate_zebra_fused in plain tensor ops.  scal: [3, B] int32 rows
    (erode, thr, phase); src_word [B, H, W] or a [1, H, W] broadcast
    base."""
    b = scal.shape[1]
    h, w = src_word.shape[-2:]
    idx = index(src_word)
    rank = rank_table[idx]
    erode = scal[0].view(b, 1, 1) != 0
    out_i, out_k = idx, rank
    for shift in (shift_down, shift_right, shift_left):
        n_i, n_k = shift(idx), shift(rank)
        take = torch.where(erode, n_k < out_k, n_k > out_k)
        out_i = torch.where(take, n_i, out_i)
        out_k = torch.where(take, n_k, out_k)
    word = word_table[out_i]
    y = byte_of(word, 1)
    stripe = stripe_mask(h, w, scal[2].view(b, 1, 1))
    zebra = (word & _ZEBRA_KEEP) | (16 << 8)
    return torch.where(stripe & (y >= scal[1].view(b, 1, 1)), zebra, word)


def dilate_zebra_fused(src_word: torch.Tensor, rank_table: torch.Tensor,
                       word_table: torch.Tensor, index, erode, thr, phase,
                       batch: int | None = None) -> torch.Tensor:
    """[B, H, W] int32 source words -> final AYUV words.

    rank_table/word_table: int32 [256]; the ranks lie in [0, 256), as
    TableChain.rank_table gives them (the kernel packs a rank into 8 bits).
    erode/thr/phase: per-frame [B] (or scalar) ints.  index: a
    tablefuse.LinearIndex, the chain head's word -> [0, 256) index.

    src_word may be a BROADCAST base of shape [1, H, W] with batch=B (the
    videotestsrc static-pattern path): the single source frame is read for
    every output frame.

    CPU tensors take dilate_zebra_plain; CUDA tensors launch the kernel or
    raise.
    """
    if src_word.dtype != torch.int32 or src_word.ndim != 3:
        raise ValueError("dilate_zebra_fused: src_word must be int32 "
                         f"[B, H, W], got {src_word.dtype} "
                         f"{tuple(src_word.shape)}")
    sb, h, w = src_word.shape
    b = sb if batch is None else batch
    if sb not in (1, b):
        raise ValueError(f"dilate_zebra_fused: {sb} source frames for "
                         f"batch {b}")
    for name, t in (("rank_table", rank_table), ("word_table", word_table)):
        if t.dtype != torch.int32 or t.shape != (256,):
            raise ValueError(f"dilate_zebra_fused: {name} must be int32 "
                             f"[256], got {t.dtype} {tuple(t.shape)}")
    dev = src_word.device
    scal = torch.stack([_per_frame_i32(v, b, dev)
                        for v in (erode, thr, phase)])
    if dev.type == "cpu":
        return dilate_zebra_plain(src_word, rank_table, word_table, index,
                                  scal)
    from gstbad_tpu_torch.ops import _cuda
    if not all(t.is_contiguous() for t in (src_word, rank_table,
                                           word_table)):
        raise ValueError("dilate_zebra_fused: inputs must be contiguous")
    if b > 65535:
        raise ValueError(f"dilate_zebra_fused: batch {b} > 65535")
    out = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    _cuda.launch("gst_dilate_zebra", src_word, out, rank_table, word_table,
                 scal, b, h, w, int(sb == 1 and b > 1), *index.weights,
                 index.pre_shift, index.post_shift)
    dilate_zebra_fused.launches += 1
    return out


dilate_zebra_fused.launches = 0
