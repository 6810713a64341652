"""(A copy of gstbad_tpu/io/dvbsubenc.py, numpy only.)

DVB subtitle ENCODER (gst/dvbsubenc/) — the byte-level spec.

Counterpart of io/dvbsub.py (the EN 300 743 decoder): AYUV subtitle
pictures -> paletted bitmaps -> RLE -> segment stream in a private PES
payload (0x20 0x00 prefix, 0xFF terminator).

Transcribed exactly from gstdvbsubenc.c / gstdvbsubenc-util.c:
- find_largest_subregion's both-ends alpha scan that stops at the row
  middle (gstdvbsubenc.c:223-268);
- the histogram path of gst_dvbsubenc_ayuv_to_ayuv8p for images with
  <= max-colours distinct AYUV values: pixels sorted by DESCENDING
  big-endian AYUV word (highest alpha first), palette in first-seen
  order of that sort (gstdvbsubenc-util.c:133-308);
- encode_rle2/4/8 with their exact branch structure, including the
  quirks: 2-bit runs of exactly 11 or 28 pixels fall through to
  single-pixel encoding, 4-bit runs of 8-24 pixels are clamped to 7
  (gstdvbsubenc-util.c:344-379, 437-474), and 8-bit lines end with the
  spec's double 0x00 that ffmpeg dislikes (the comment is part of the
  reference, gstdvbsubenc-util.c:538-541);
- the segment writers: page composition (state=2 mode change), region
  composition, CLUT definition (YVUT order, T = 255-A), object data
  with interleaved top/bottom fields and the even-size stuffing byte
  (gstdvbsubenc-util.c:550-802).

Divergences (documented):
- images with more than max-colours distinct colours go through a
  median-cut quantizer in AYUV space instead of the vendored
  libimagequant (a perceptual RGBA quantizer fed AYUV bytes in the
  reference — its FIXME acknowledges the mismatch); palette choice
  differs, round-trip fidelity is tested via io/dvbsub.py instead.
- the both-ends scan stops where the pointers cross (row middle), so
  content entirely within ONE horizontal half leaves `left`/`right` at
  their sentinels: the reference then hands a negative width to
  create_cropped_frame and errors the stream (gstdvbsubenc.c:344).
  Such frames (and all-transparent ones) are SKIPPED here instead —
  fixed, not reproduced; the detection itself is transcribed exactly,
  so content straddling the middle crops identically.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def find_largest_subregion(ayuv: np.ndarray
                           ) -> Optional[Tuple[int, int, int, int]]:
    """[H, W, 4] AYUV -> (left, right, top, bottom) of visible alpha,
    via the reference's both-ends row scan (gstdvbsubenc.c:223-268).
    None if nothing is visible or only the degenerate sentinel case
    remains (see module doc)."""
    h, w = ayuv.shape[:2]
    a = ayuv[..., 0]
    left, right, top, bottom = w, 0, h, 0
    for y in range(h):
        visible = False
        li, ri = 0, w - 1
        for x in range(w):
            if a[y, li] != 0:
                visible = True
                left = min(left, x)
            if a[y, ri] != 0:
                visible = True
                right = max(right, w - 1 - x)
            li += 1
            ri -= 1
            if li >= ri:
                break
        if visible:
            top = min(top, y)
            bottom = max(bottom, y)
    if left > right or top > bottom:
        return None
    return left, right, top, bottom


def _ayuv_word(pix: np.ndarray) -> np.ndarray:
    """Big-endian u32 of the A,Y,U,V bytes (GST_READ_UINT32_BE)."""
    p = pix.astype(np.uint32)
    return (p[..., 0] << 24) | (p[..., 1] << 16) | (p[..., 2] << 8) \
        | p[..., 3]


def ayuv_to_paletted(ayuv: np.ndarray, max_colours: int
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
    """[H, W, 4] AYUV -> (indices [H, W] u8, palette [N, 4] AYUV,
    num_colours) per gst_dvbsubenc_ayuv_to_ayuv8p."""
    h, w = ayuv.shape[:2]
    words = _ayuv_word(ayuv).reshape(-1)
    uniq, counts = np.unique(words, return_counts=True)
    if len(uniq) <= max_colours:
        # histogram path: palette ordered by descending AYUV word
        pal_words = uniq[::-1]
        lut = {int(c): i for i, c in enumerate(pal_words)}
        idx = np.array([lut[int(v)] for v in words],
                       np.uint8).reshape(h, w)
        palette = np.stack([(pal_words >> 24) & 0xFF,
                            (pal_words >> 16) & 0xFF,
                            (pal_words >> 8) & 0xFF,
                            pal_words & 0xFF], axis=-1).astype(np.uint8)
        return idx, palette, len(pal_words)
    # median-cut in AYUV space (libimagequant replacement — module doc)
    pix = ayuv.reshape(-1, 4).astype(np.int32)
    boxes = [np.arange(pix.shape[0])]
    while len(boxes) < max_colours:
        # split the box with the largest (range * population) extent
        best, best_score = -1, -1
        for bi, box in enumerate(boxes):
            if len(box) < 2:
                continue
            rng = pix[box].max(axis=0) - pix[box].min(axis=0)
            score = int(rng.max()) * len(box)
            if score > best_score and rng.max() > 0:
                best, best_score = bi, score
        if best < 0:
            break
        box = boxes.pop(best)
        ch = int(np.argmax(pix[box].max(axis=0) - pix[box].min(axis=0)))
        order = box[np.argsort(pix[box, ch], kind="stable")]
        mid = len(order) // 2
        boxes += [order[:mid], order[mid:]]
    palette = np.stack([np.round(pix[b].mean(axis=0)) for b in boxes]
                       ).astype(np.uint8)
    # order like the histogram path: descending AYUV word
    pw = _ayuv_word(palette)
    order = np.argsort(pw, kind="stable")[::-1]
    palette = palette[order]
    diff = pix[:, None, :] - palette[None, :, :].astype(np.int32)
    idx = np.argmin((diff * diff).sum(axis=-1), axis=1
                    ).astype(np.uint8).reshape(h, w)
    return idx, palette, len(palette)


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def align_bytes(self) -> bytes:
        while len(self.bits) % 8:
            self.bits.append(0)
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        self.bits = []
        return bytes(out)


PIXEL_DATA_2BIT = 0x10
PIXEL_DATA_4BIT = 0x11
PIXEL_DATA_8BIT = 0x12
PIXEL_DATA_END_OF_LINE = 0xF0


def _runs(row: np.ndarray):
    """(start, run_length, value) run scan like the x_end walk."""
    x = 0
    w = len(row)
    while x < w:
        x_end = x + 1
        pix = int(row[x])
        while x_end < w and int(row[x_end]) == pix:
            x_end += 1
        yield x, x_end - x, pix
        x = x_end


def encode_rle2(rows: np.ndarray) -> bytes:
    out = bytearray()
    for row in rows:
        out.append(PIXEL_DATA_2BIT)
        bits = _BitWriter()
        x = 0
        w = len(row)
        while x < w:
            x_end = x + 1
            pix = int(row[x])
            while x_end < w and int(row[x_end]) == pix:
                x_end += 1
            run = min(x_end - x, 284)
            if run >= 29:
                bits.put(0x03, 6)
                bits.put(run - 29, 8)
                bits.put(pix, 2)
            elif 12 <= run <= 27:
                bits.put(0x02, 6)
                bits.put(run - 12, 4)
                bits.put(pix, 2)
            elif 3 <= run <= 10:
                bits.put(0, 2)
                bits.put(0x8 + run - 3, 4)
                bits.put(pix, 2)
            # missed cases: 11 or 28 pixels, or short 1-2 runs
            elif pix != 0:
                bits.put(pix, 2)
                run = 1
            elif run == 2:
                bits.put(0x1, 6)
                run = 2
            else:
                bits.put(0x1, 4)
                run = 1
            x += run
        bits.put(0x00, 8)                    # end of line
        out += bits.align_bytes()
        out.append(PIXEL_DATA_END_OF_LINE)
    return bytes(out)


def encode_rle4(rows: np.ndarray) -> bytes:
    out = bytearray()
    for row in rows:
        out.append(PIXEL_DATA_4BIT)
        bits = _BitWriter()
        x = 0
        w = len(row)
        while x < w:
            x_end = x + 1
            pix = int(row[x])
            while x_end < w and int(row[x_end]) == pix:
                x_end += 1
            run = min(x_end - x, 280)
            if pix == 0 and 3 <= run <= 9:
                bits.put(0, 4)
                bits.put(run - 2, 4)
            elif 4 <= run < 25:
                # 8-24 pixel runs clamp to 7 (reference quirk)
                if run > 7:
                    run = 7
                bits.put(0, 4)
                bits.put(0x8 + run - 4, 4)
                bits.put(pix, 4)
            elif run >= 25:
                bits.put(0x0F, 8)
                bits.put(run - 25, 8)
                bits.put(pix, 4)
            elif pix != 0:
                bits.put(pix, 4)
                run = 1
            elif run > 1:
                bits.put(0xD, 8)
                run = 2
            else:
                bits.put(0xC, 8)
                run = 1
            x += run
        bits.put(0x00, 8)
        out += bits.align_bytes()
        out.append(PIXEL_DATA_END_OF_LINE)
    return bytes(out)


def encode_rle8(rows: np.ndarray) -> bytes:
    out = bytearray()
    for row in rows:
        out.append(PIXEL_DATA_8BIT)
        for _x, run_in, pix in _runs(row):
            x_left = run_in
            while x_left > 0:
                run = min(x_left, 127)
                if run == 1 and pix != 0:
                    out.append(pix)
                elif pix == 0:
                    out += bytes([0, run])
                elif run > 2:
                    out += bytes([0, 0x80 | run, pix])
                else:
                    if run == 2:
                        out.append(pix)
                    out.append(pix)
                x_left -= run
        # spec's double 0x00 end-of-line (ffmpeg-unfriendly, faithful)
        out += bytes([0x00, 0x00, PIXEL_DATA_END_OF_LINE])
    return bytes(out)


SEG_PAGE_COMPOSITION = 0x10
SEG_REGION_COMPOSITION = 0x11
SEG_CLUT_DEFINITION = 0x12
SEG_OBJECT_DATA = 0x13
SEG_END_OF_DISPLAY = 0x80
SYNC_BYTE = 0x0F


def _u16(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _write_object_data(object_version: int, page_id: int, object_id: int,
                       indices: np.ndarray, nb_colours: int) -> bytes:
    if nb_colours <= 4:
        enc = encode_rle2
    elif nb_colours <= 16:
        enc = encode_rle4
    else:
        enc = encode_rle8
    top = enc(indices[0::2])
    bottom = enc(indices[1::2]) if indices.shape[0] > 1 else b""
    body = bytearray()
    body.append((object_version << 4) | 0x01)
    body += _u16(len(top))
    body += _u16(len(bottom))
    body += top + bottom
    if (len(top) + len(bottom)) % 2 == 0:
        body.append(0)                       # stuffing byte
    seg = bytearray([SYNC_BYTE, SEG_OBJECT_DATA])
    seg += _u16(page_id)
    seg += _u16(len(body) + 2)
    seg += _u16(object_id)
    seg += body
    return bytes(seg)


def _write_clut(object_version: int, page_id: int, clut_id: int,
                palette: np.ndarray, nb_colours: int) -> bytes:
    if nb_colours <= 4:
        flag = 4
    elif nb_colours <= 16:
        flag = 2
    else:
        flag = 1
    body = bytearray([clut_id, (object_version << 4) | 0x0F])
    for i in range(nb_colours):
        a, y, u, v = (int(c) for c in palette[i])
        body += bytes([i, (flag << 5) | 0x1F, y, v, u, 255 - a])
    seg = bytearray([SYNC_BYTE, SEG_CLUT_DEFINITION])
    seg += _u16(page_id)
    seg += _u16(len(body))
    seg += body
    return bytes(seg)


def _write_region(object_version: int, page_id: int, region_id: int,
                  w: int, h: int, nb_colours: int) -> bytes:
    if nb_colours <= 4:
        depth = 1
    elif nb_colours <= 16:
        depth = 2
    else:
        depth = 3
    body = bytearray([region_id, (object_version << 4) | 0x07])
    body += _u16(w) + _u16(h)
    body.append((depth << 5) | (depth << 2) | 0x03)
    body.append(region_id)                   # CLUT id
    body += _u16(0x0003)                     # dummy fill colours
    body += _u16(region_id)                  # object id
    body += _u16(0x0000) + _u16(0xF000)      # type/corner
    seg = bytearray([SYNC_BYTE, SEG_REGION_COMPOSITION])
    seg += _u16(page_id)
    seg += _u16(len(body))
    seg += body
    return bytes(seg)


def encode_display_set(object_version: int, page_id: int,
                       subpictures: List[Tuple[np.ndarray, np.ndarray,
                                               int, int, int]]) -> bytes:
    """gst_dvbenc_encode: subpictures = [(indices [h, w], palette,
    nb_colours, x, y)]; empty list writes the end-of-page set."""
    out = bytearray(b"\x20\x00")             # private PES prefix
    page = bytearray([30,
                      (object_version << 4) | (2 << 2) | 0x3])
    for i, (_idx, _pal, _n, x, y) in enumerate(subpictures):
        page += bytes([i, 0xFF]) + _u16(x) + _u16(y)
    out += bytes([SYNC_BYTE, SEG_PAGE_COMPOSITION]) + _u16(page_id) \
        + _u16(len(page)) + page
    for i, (idx, _pal, n, _x, _y) in enumerate(subpictures):
        out += _write_region(object_version, page_id, i,
                             idx.shape[1], idx.shape[0], n)
    for i, (_idx, pal, n, _x, _y) in enumerate(subpictures):
        out += _write_clut(object_version, page_id, i, pal, n)
    for i, (idx, _pal, n, _x, _y) in enumerate(subpictures):
        out += _write_object_data(object_version, page_id, i, idx, n)
    out += bytes([SYNC_BYTE, SEG_END_OF_DISPLAY]) + _u16(page_id) \
        + _u16(0)
    out.append(0xFF)                         # end of PES data
    return bytes(out)


def encode_frame(ayuv: np.ndarray, object_version: int,
                 max_colours: int = 16, page_id: int = 1
                 ) -> Optional[Tuple[bytes, int, int]]:
    """Full per-frame path (process_largest_subregion): returns
    (packet, x, y) or None for an invisible frame."""
    region = find_largest_subregion(ayuv)
    if region is None:
        return None
    left, right, top, bottom = region
    crop = ayuv[top:bottom + 1, left:right + 1]
    idx, palette, n = ayuv_to_paletted(crop, max_colours)
    packet = encode_display_set(object_version & 0xF, page_id,
                                [(idx, palette, n, left, top)])
    return packet, left, top
