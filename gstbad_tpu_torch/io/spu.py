"""(A copy of gstbad_tpu/io/spu.py, numpy only.)

DVD subpicture (VobSub SPU) bitstream decode — gst/dvdspu/gstspu-vobsub.c.

A subpicture packet is `u16 total_size, u16 dcsqt_offset`, RLE pixel data,
then a Display Control Sequence Table: each DCSQ is `u16 delay (90 kHz
ticks / 1024), u16 next_dcsq_offset, commands...` with the command set of
gstspu-vobsub.c:130-245 (display on/off, SET_COLOR/SET_ALPHA nibble
palettes, SET_DAREA 12-bit rectangle, DSPXA field offsets, CHG_COLCON
parsed but not applied per-line here — documented).

RLE (gstspu-vobsub-render.c:134-260): nibble stream per interlaced field,
variable-length codes (1-4 nibbles), run = code >> 2 (0 = to end of
line), colour = code & 3; every line starts byte-aligned.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class LineCtrl:
    """One CHG_COLCON LN_CTLI entry (gstspu-vobsub.c:96-120): video
    lines [top, bottom] switch palettes at the pix-ctrl `left` columns;
    each 32-bit palette word packs index nibbles (bits 28..16) and alpha
    nibbles (bits 12..0), colour 3 high."""
    top: int
    bottom: int
    changes: List[Tuple[int, int]]      # (left, palette word)


@dataclass
class SpuPicture:
    rect: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top,left,bottom,right
    pix_offsets: Tuple[int, int] = (0, 0)           # top/bottom field
    main_idx: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    main_alpha: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    forced: bool = False
    show_ticks: Optional[int] = None   # delay of the DCSQ with DSP
    hide_ticks: Optional[int] = None   # delay of the DCSQ with STP_DSP
    line_ctrl: List[LineCtrl] = field(default_factory=list)
    data: bytes = b""

    @property
    def width(self) -> int:
        return self.rect[3] - self.rect[1] + 1

    @property
    def height(self) -> int:
        return self.rect[2] - self.rect[0] + 1

    def show_ns(self) -> int:
        t = self.show_ticks or 0
        return t * 1024 * 1_000_000_000 // 90_000

    def hide_ns(self) -> Optional[int]:
        if self.hide_ticks is None:
            return None
        return self.hide_ticks * 1024 * 1_000_000_000 // 90_000


def parse_spu(data: bytes) -> SpuPicture:
    """Walk the DCSQT and execute the command blocks
    (gst_dvd_spu_exec_cmd_blk, gstspu-vobsub.c:122-245)."""
    pic = SpuPicture(data=bytes(data))
    if len(data) < 4:
        raise ValueError("spu: packet too short")
    dcsqt = (data[2] << 8) | data[3]
    off = dcsqt
    seen = set()
    while off not in seen and off + 4 <= len(data):
        seen.add(off)
        delay = (data[off] << 8) | data[off + 1]
        next_off = (data[off + 2] << 8) | data[off + 3]
        i = off + 4
        end = len(data)
        while i < end:
            cmd = data[i]
            if cmd == 0x00:                 # FSTA_DSP
                pic.forced = True
                pic.show_ticks = delay if pic.show_ticks is None else \
                    pic.show_ticks
                i += 1
            elif cmd == 0x01:               # DSP
                pic.show_ticks = delay
                i += 1
            elif cmd == 0x02:               # STP_DSP
                pic.hide_ticks = delay
                i += 1
            elif cmd == 0x03:               # SET_COLOR
                if i + 3 >= end:
                    break
                pic.main_idx = [data[i + 2] & 0x0F, data[i + 2] >> 4,
                                data[i + 1] & 0x0F, data[i + 1] >> 4]
                i += 3
            elif cmd == 0x04:               # SET_ALPHA
                if i + 3 >= end:
                    break
                pic.main_alpha = [data[i + 2] & 0x0F, data[i + 2] >> 4,
                                  data[i + 1] & 0x0F, data[i + 1] >> 4]
                i += 3
            elif cmd == 0x05:               # SET_DAREA
                if i + 7 >= end:
                    break
                d = data
                top = ((d[i + 4] & 0xFF) << 4) | ((d[i + 5] & 0xF0) >> 4)
                left = ((d[i + 1] & 0xFF) << 4) | ((d[i + 2] & 0xF0) >> 4)
                right = ((d[i + 2] & 0x0F) << 8) | d[i + 3]
                bottom = ((d[i + 5] & 0x0F) << 8) | d[i + 6]
                pic.rect = (top, left, bottom, right)
                i += 7
            elif cmd == 0x06:               # DSPXA
                if i + 5 >= end:
                    break
                pic.pix_offsets = ((data[i + 1] << 8) | data[i + 2],
                                   (data[i + 3] << 8) | data[i + 4])
                i += 5
            elif cmd == 0x07:               # CHG_COLCON
                if i + 3 >= end:
                    break
                fs = (data[i + 1] << 8) | data[i + 2]
                if i + 1 + fs >= end + 1:
                    break
                pic.line_ctrl = _parse_chg_colcon(
                    data[i + 3:i + 1 + fs])
                i += 1 + fs
            else:                           # END / unknown
                break
        if next_off == off:
            break
        off = next_off
    return pic


def _parse_chg_colcon(body: bytes) -> List[LineCtrl]:
    """gst_dvd_spu_parse_chg_colcon (gstspu-vobsub.c:55-121): LN_CTLI
    entries until the 0x0FFFFFFF terminator, each with 1-8 clamped
    PX_CTLI changes."""
    out: List[LineCtrl] = []
    pos = 0
    while pos + 4 <= len(body):
        code = int.from_bytes(body[pos:pos + 4], "big")
        if code == 0x0FFFFFFF:
            break
        n_changes = min(max(body[pos + 2] >> 4, 1), 8)
        end = pos + 4 + 6 * n_changes
        if end > len(body):
            break
        top = ((body[pos] << 8) & 0x300) | body[pos + 1]
        bottom = ((body[pos + 2] << 8) & 0x300) | body[pos + 3]
        changes = []
        cur = pos + 4
        for _ in range(n_changes):
            left = ((body[cur] << 8) & 0x300) | body[cur + 1]
            palette = int.from_bytes(body[cur + 2:cur + 6], "big")
            changes.append((left, palette))
            cur += 6
        out.append(LineCtrl(top, bottom, changes))
        pos = end
    return out


def decode_rle(pic: SpuPicture) -> np.ndarray:
    """-> [H, W] uint8 palette indices (0-3), fields interleaved."""
    data = pic.data
    h, w = pic.height, pic.width
    out = np.zeros((h, w), np.uint8)
    max_nib = 2 * len(data)

    def nibble(off):
        if off >= max_nib:
            return 0, off
        b = data[off // 2]
        v = (b >> 4) if (off & 1) == 0 else (b & 0x0F)
        return v, off + 1

    def rle_code(off):
        code, off = nibble(off)
        if code < 0x4:
            n, off = nibble(off)
            code = (code << 4) | n
            if code < 0x10:
                n, off = nibble(off)
                code = (code << 4) | n
                if code < 0x40:
                    n, off = nibble(off)
                    code = (code << 4) | n
        return code, off

    offs = [pic.pix_offsets[0] * 2, pic.pix_offsets[1] * 2]
    for y in range(h):
        f = y & 1  # top field = even lines of the rect
        off = (offs[f] + 1) & ~1  # byte-align at line start
        x = 0
        while x < w:
            code, off = rle_code(off)
            run = code >> 2
            end = w if run == 0 else min(w, x + run)
            out[y, x:end] = code & 3
            x = end
        offs[f] = off
    return out


def _palette(main_idx: List[int], main_alpha: List[int],
             clut: Optional[np.ndarray]) -> np.ndarray:
    """gstspu_vobsub_recalc_palette (gstspu-vobsub-render.c:40-66):
    CLUT-backed colours, or the reference's guessed white/grey ramp."""
    pal = np.zeros((4, 4), np.uint8)  # A,Y,U,V per colour
    if clut is not None and int(clut[main_idx[0]]) != 0:
        for i in range(4):
            col = int(clut[main_idx[i]])
            a = (main_alpha[i] << 4) | main_alpha[i]
            pal[i] = (a, (col >> 16) & 0xFF, col & 0xFF, (col >> 8) & 0xFF)
    else:
        y = 240
        for i in range(4):
            a = (main_alpha[i] << 4) | main_alpha[i]
            yv = 0
            if main_alpha[i] != 0:
                yv = y
                y = max(y - 112, 0)
            pal[i] = (a, yv, 128, 128)
    return pal


def spu_to_ayuv(pic: SpuPicture, clut: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Indices + palette -> [H, W, 4] AYUV overlay.

    clut: 16 u32 words 0x00YVU (V and U swapped in the word, like the DVD
    CLUT the reference receives in events, gstspu-vobsub-render.c:40-49);
    None uses the reference's guessed white/grey/black ramp (:51-66).

    CHG_COLCON per-line palettes apply afterwards: video lines within a
    LN_CTLI's [top, bottom] re-map their indices from each PX_CTLI
    `left` column on with that change's palette
    (gstspu_vobsub_render_line_with_chgcol,
    gstspu-vobsub-render.c:224-231, 108-129)."""
    idx = decode_rle(pic)
    out = _palette(pic.main_idx, pic.main_alpha, clut)[idx]
    top, left = pic.rect[0], pic.rect[1]
    h, w = idx.shape
    for lc in pic.line_ctrl:
        y0 = max(lc.top - top, 0)
        y1 = min(lc.bottom - top, h - 1)
        if y1 < y0:
            continue
        for c, (seg_left, word) in enumerate(lc.changes):
            seg_idx = [(word >> 16) & 0xF, (word >> 20) & 0xF,
                       (word >> 24) & 0xF, (word >> 28) & 0xF]
            seg_alpha = [word & 0xF, (word >> 4) & 0xF,
                         (word >> 8) & 0xF, (word >> 12) & 0xF]
            x0 = max(seg_left - left, 0)
            x1 = (min(lc.changes[c + 1][0] - left, w)
                  if c + 1 < len(lc.changes) else w)
            if x1 <= x0:
                continue
            pal = _palette(seg_idx, seg_alpha, clut)
            out[y0:y1 + 1, x0:x1] = pal[idx[y0:y1 + 1, x0:x1]]
    return out
