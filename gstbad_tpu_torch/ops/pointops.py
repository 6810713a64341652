"""Per-pixel point ops in PyTorch — exact int32 transcriptions of the
gaudieffects / coloreffects / videofilters math.

All ops take [..., 4] uint8 (channel order = memory byte order) and return
uint8.  Channel-asymmetric ops take rgb channel indices (static Python ints)
so one function serves every packed format.  Each op views the 4-byte pixel
as ONE int32 word (pack32 is a free dtype view of a contiguous [..., 4]
uint8 tensor), computes on shift/mask byte planes and views the result
back.  Table lookups are plain `table[idx]` gathers (ops/lut.lookup).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gstbad_tpu_torch.ops import lut


def i32(mask: int) -> int:
    """A 32-bit pattern as the int32 value with the same bits."""
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def _per_frame(p, ndim):
    """Broadcast a per-frame [B] param against [B, ...spatial] data."""
    return p.reshape(p.shape + (1,) * (ndim - p.ndim)) if p.ndim else p


def _word_viewable(img: torch.Tensor) -> bool:
    """True when a [..., 4] uint8 tensor can be viewed as int32 in place
    (a broadcast source frame qualifies: its batch stride is 0)."""
    return (img.stride(-1) == 1 and img.storage_offset() % 4 == 0
            and all(s % 4 == 0 for s in img.stride()[:-1]))


def pack32(img: torch.Tensor) -> torch.Tensor:
    """[..., 4] uint8 -> int32 word [...] (byte c of the word ==
    img[..., c] on little-endian).  A dtype view: no copy when the layout
    allows one."""
    if not _word_viewable(img):
        img = img.contiguous()
    return img.view(torch.int32)[..., 0]


def word_source(batch) -> torch.Tensor:
    """The int32 words of a packed 4-byte FrameBatch for a word kernel:
    its [1, H, W] broadcast base when it has one (a static source, read
    once for the whole window), else its word view, else pack32 of its
    bytes."""
    if batch.word_base is not None:
        return batch.word_base
    if batch.word is not None:
        return batch.word
    return pack32(batch.data)


def unpack32(p: torch.Tensor) -> torch.Tensor:
    """int32 word [...] -> [..., 4] uint8 (a dtype view, no copy)."""
    return p.unsqueeze(-1).view(torch.uint8)


def byte_of(p: torch.Tensor, c: int) -> torch.Tensor:
    return (p >> (8 * c)) & 255 if c else p & 255


def repack(bytes_by_channel, passthrough=None, mask: int = 0):
    """Rebuild a packed word from {channel: byte plane}; bytes of
    `passthrough` selected by `mask` (e.g. 0xFF000000) pass unchanged,
    everything else not named is zero (the C codes rebuild the guint32
    word without the fill byte)."""
    out = None
    for c, v in bytes_by_channel.items():
        v = v.to(torch.int32)
        w = v << (8 * c) if c else v
        out = w if out is None else out | w
    if passthrough is not None and mask:
        keep = passthrough & i32(mask)
        out = keep if out is None else out | keep
    return out


def identity_table(device="cpu") -> torch.Tensor:
    return torch.arange(256, dtype=torch.int32, device=device)


def _lut_bytes(img, table, channels) -> torch.Tensor:
    """table[byte] on the named channels, other bytes zeroed."""
    p = pack32(img)
    return unpack32(repack({c: lut.lookup(byte_of(p, c), table)
                            for c in channels}))


def burn(img: torch.Tensor, adjustment: torch.Tensor) -> torch.Tensor:
    """gaudi_orc_burn (gstgaudieffectsorc.orc:1-26); all 4 bytes processed,
    as a composed byte table (ops/lut.burn_table)."""
    return _lut_bytes(img, lut.burn_table(adjustment), range(4))


def chromium(img: torch.Tensor, edge_a: torch.Tensor, edge_b: torch.Tensor,
             cos_table: torch.Tensor, rgb: Sequence[int],
             fill: Optional[int]) -> torch.Tensor:
    """gstchromium.c:315-360 cosine fold; cos_table from
    golden.gaudieffects.chromium_cos_table (int32 [1024])."""
    return _lut_bytes(img, lut.chromium_table(edge_a, edge_b, cos_table),
                      rgb)


def dodge(img: torch.Tensor, rgb: Sequence[int], fill: Optional[int]
          ) -> torch.Tensor:
    """gstdodge.c:232-255."""
    return _lut_bytes(img, lut.dodge_table(img.device), rgb)


def exclusion_word(p: torch.Tensor, factor: torch.Tensor, rgb: Sequence[int]
                   ) -> torch.Tensor:
    """exclusion on packed words (any shape — pixels or 256-entry tables).
    Every dividend is >= 0 and f >= 1, so // is C's truncating division
    (the JAX package's idiv_pos gives the same quotient on this domain)."""
    f = _per_frame(factor.to(torch.int32), p.ndim)
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    rr = f - ((f - r) * (f - r) // f + g * r // f)
    gg = f - ((f - g) * (f - g) // f + g * g // f)
    bb = f - ((f - b) * (f - b) // f + b * b // f)
    return repack({rgb[0]: rr.clamp(0, 255), rgb[1]: gg.clamp(0, 255),
                   rgb[2]: bb.clamp(0, 255)})


def exclusion(img: torch.Tensor, factor: torch.Tensor, rgb: Sequence[int],
              fill: Optional[int]) -> torch.Tensor:
    """gstexclusion.c:257-290 (the green-in-red-term quirk preserved);
    factor is 1..175 (gstexclusion.c:156)."""
    return unpack32(exclusion_word(pack32(img), factor, rgb))


def solarize(img: torch.Tensor, threshold: torch.Tensor, start: torch.Tensor,
             end: torch.Tensor, rgb: Sequence[int], fill: Optional[int]
             ) -> torch.Tensor:
    """gstsolarize.c:287-339 as a composed byte table (the exact C
    int/uint32 wrap semantics run on the 256 table entries,
    ops/lut.solarize_table)."""
    return _lut_bytes(img, lut.solarize_table(threshold, start, end), rgb)


def shift_down(p):
    """Down neighbour with edge replication (axis -2)."""
    return torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)


def shift_right(p):
    """Right neighbour with edge replication (axis -1)."""
    return torch.cat([p[..., :, 1:], p[..., :, -1:]], dim=-1)


def shift_left(p):
    """Left neighbour with edge replication (axis -1)."""
    return torch.cat([p[..., :, :1], p[..., :, :-1]], dim=-1)


def dilate(img: torch.Tensor, erode: torch.Tensor, rgb: Sequence[int]
           ) -> torch.Tensor:
    """gstdilate.c:273-350: sequential neighbor propagation over
    down, right, left (the reference's `up` pointer always clamps to self).
    Whole pixels copy (packed words); luminance = 90r + 115g + 51b."""
    p = pack32(img)

    def lum(w):
        return (90 * byte_of(w, rgb[0]) + 115 * byte_of(w, rgb[1])
                + 51 * byte_of(w, rgb[2]))

    out = p
    out_lum = lum(p)
    for shift in (shift_down, shift_right, shift_left):
        n = shift(p)
        n_lum = lum(n)
        take = torch.where(_per_frame(erode, n_lum.ndim),
                           n_lum < out_lum, n_lum > out_lum)
        out = torch.where(take, n, out)
        out_lum = torch.where(take, n_lum, out_lum)
    return unpack32(out)


def lut_rgb(img: torch.Tensor, table: torch.Tensor, map_luma: bool,
            rgb: Sequence[int]) -> torch.Tensor:
    """coloreffects RGB path (gstcoloreffects.c:306-360); table int32
    [256, 3]; the non-rgb (fill) byte passes through unchanged."""
    p = pack32(img)
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    fill_mask = 0xFFFFFFFF ^ sum(0xFF << (8 * c) for c in rgb)
    if map_luma:
        luma = (((r << 8) * 54) + ((g << 8) * 183) + ((b << 8) * 19)) >> 16
        srcs = (luma, luma, luma)
    else:
        srcs = (r, g, b)
    out = repack({rgb[c]: lut.lookup(srcs[c], table[:, c]) & 255
                  for c in range(3)}, passthrough=p, mask=fill_mask)
    return unpack32(out)


_YCBCR2RGB = ((298, 0, 409, -57068),
              (298, -100, -208, 34707),
              (298, 516, 0, -70870))
_RGB2YCBCR = ((66, 129, 25, 4096),
              (-38, -74, 112, 32768),
              (112, -94, -18, 32768))


def _apply_matrix(m, v1, v2, v3):
    """APPLY_MATRIX (gstcoloreffects.c:303-304) — >> 8 is arithmetic."""
    return [(m[o][0] * v1 + m[o][1] * v2 + m[o][2] * v3 + m[o][3]) >> 8
            for o in range(3)]


def lut_ayuv(img: torch.Tensor, table: torch.Tensor, map_luma: bool
             ) -> torch.Tensor:
    """coloreffects AYUV path (gstcoloreffects.c:362-430); img byte order
    A,Y,U,V; alpha passes through."""
    p = pack32(img)
    y = byte_of(p, 1)
    u = byte_of(p, 2)
    v = byte_of(p, 3)
    if map_luma:
        r, g, b = (lut.lookup(y, table[:, c]) & 255 for c in range(3))
    else:
        r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
        r = lut.lookup(r.clamp(0, 255), table[:, 0]) & 255
        g = lut.lookup(g.clamp(0, 255), table[:, 1]) & 255
        b = lut.lookup(b.clamp(0, 255), table[:, 2]) & 255
    yy, uu, vv = _apply_matrix(_RGB2YCBCR, r, g, b)
    out = repack({1: yy.clamp(0, 255), 2: uu.clamp(0, 255),
                  3: vv.clamp(0, 255)}, passthrough=p, mask=0xFF)
    return unpack32(out)


def rgb_to_hue(r, g, b):
    """gstchromahold.c:271-299 in int32; -1 for achromatic."""
    m = torch.minimum(torch.minimum(r, g), b)
    M = torch.maximum(torch.maximum(r, g), b)
    C = M - m
    C2 = C >> 1
    Cs = C.clamp(min=1)

    def cdiv(a, d):  # C division truncates toward zero
        return torch.div(a, d, rounding_mode="trunc")

    h_r = cdiv(256 * 60 * (g - b) + C2, Cs)
    h_g = cdiv(256 * 60 * (b - r) + C2, Cs) + 120 * 256
    h_b = cdiv(256 * 60 * (r - g) + C2, Cs) + 240 * 256
    h = torch.where(M == r, h_r, torch.where(M == g, h_g, h_b))
    h = h >> 8
    h = torch.where(h >= 360, h - 360, h)
    h = torch.where(h < 0, h + 360, h)
    return torch.where(C == 0, -1, h)


def chromahold_word(p: torch.Tensor, target_hue: torch.Tensor,
                    tolerance: torch.Tensor, rgb: Sequence[int]
                    ) -> torch.Tensor:
    """chromahold on packed words (any shape — pixels or tables)."""
    r = byte_of(p, rgb[0])
    g = byte_of(p, rgb[1])
    b = byte_of(p, rgb[2])
    h1 = _per_frame(target_hue.to(torch.int32), p.ndim)
    tolerance = _per_frame(tolerance, p.ndim)
    h2 = rgb_to_hue(r, g, b)
    d1 = h1 - h2
    d2 = h2 - h1
    d1 = torch.where(d1 < 0, d1 + 360, d1)
    d2 = torch.where(d2 < 0, d2 + 360, d2)
    diff = torch.minimum(d1, d2)
    grey = ((13938 * r + 46869 * g + 4730 * b) >> 16).clamp(0, 255)
    make_grey = (h1 == -1) | (diff > tolerance.to(torch.int32))
    fill_mask = 0xFFFFFFFF ^ sum(0xFF << (8 * c) for c in rgb)
    return repack({rgb[0]: torch.where(make_grey, grey, r),
                   rgb[1]: torch.where(make_grey, grey, g),
                   rgb[2]: torch.where(make_grey, grey, b)},
                  passthrough=p, mask=fill_mask)


def chromahold(img: torch.Tensor, target_hue: torch.Tensor,
               tolerance: torch.Tensor, rgb: Sequence[int]) -> torch.Tensor:
    """gstchromahold.c:318-360; the fill byte passes through."""
    return unpack32(chromahold_word(pack32(img), target_hue, tolerance, rgb))


def rgb_word_to_ayuv_word(p: torch.Tensor, offs, has_alpha: bool
                          ) -> torch.Tensor:
    """Packed-RGB4 word -> AYUV word (videoconvert math on words; the same
    fixed-point SDTV matrix as elements/video/convert._to_ayuv)."""
    r = byte_of(p, offs[0])
    g = byte_of(p, offs[1])
    b = byte_of(p, offs[2])
    a = byte_of(p, offs[3]) if has_alpha else torch.full_like(p, 255)
    y, u, v = _apply_matrix(_RGB2YCBCR, r, g, b)
    return repack({0: a, 1: y.clamp(0, 255), 2: u.clamp(0, 255),
                   3: v.clamp(0, 255)})


def rgb_word_permute(p: torch.Tensor, s_off, d_off, src_has_alpha: bool
                     ) -> torch.Tensor:
    """Packed-RGB4 word -> packed-RGB4 word channel shuffle
    (videoconvert's RGB fast path on words)."""
    out = {d_off[i]: byte_of(p, s_off[i]) for i in range(3)}
    if d_off[3] is not None:
        out[d_off[3]] = (byte_of(p, s_off[3]) if src_has_alpha
                         else torch.full_like(p, 255))
    return repack(out)


def stripe_mask(h: int, w: int, phase: torch.Tensor) -> torch.Tensor:
    """gstzebrastripe.c's diagonal: ((col + row + phase) & 4) != 0 over
    [..., H, W]; phase broadcasts per frame ([..., 1, 1] for a batch)."""
    i = torch.arange(w, dtype=torch.int32, device=phase.device)[None, :]
    j = torch.arange(h, dtype=torch.int32, device=phase.device)[:, None]
    return ((i + j + phase) & 0x4) != 0


def zebrastripe(y: torch.Tensor, y_threshold: torch.Tensor, t: torch.Tensor
                ) -> torch.Tensor:
    """gstzebrastripe.c:205-253 on a luma plane [..., H, W]; t broadcasts
    per frame ([..., 1, 1] for a batch)."""
    stripe = stripe_mask(y.shape[-2], y.shape[-1], t)
    return y.masked_fill((y >= y_threshold.to(torch.uint8)) & stripe, 16)


def videodiff(cur: torch.Tensor, old: torch.Tensor, threshold: int,
              t: int) -> torch.Tensor:
    """gstvideodiff.c:91-116 on luma planes [..., H, W]: a pixel that moved
    by more than threshold from `old` turns 16 on the stripe, else 240."""
    s1 = old.to(torch.int32)
    s2 = cur.to(torch.int32)
    moved = (s2 < s1 - threshold) | (s2 > s1 + threshold)
    stripe = stripe_mask(cur.shape[-2], cur.shape[-1],
                         torch.tensor(t, dtype=torch.int32,
                                      device=cur.device))
    mark = torch.where(stripe, 16, 240).to(torch.uint8)
    return torch.where(moved, mark, cur)


def sad(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """orc_sad_nxm_u8 (gstscenechangeorc.orc) over [..., H, W] luma ->
    [...] float64 mean score (gstscenechange.c:146-160).  The mean is the
    total times the reciprocal of the area, as the JAX package's compiled
    window computes total / area."""
    d = (f1.to(torch.int32) - f2.to(torch.int32)).abs()
    total = d.sum(dim=(-2, -1), dtype=torch.int64)
    return total.to(torch.float64) * (1.0 / (f1.shape[-2] * f1.shape[-1]))
