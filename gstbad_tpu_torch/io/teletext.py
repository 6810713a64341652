"""(A copy of gstbad_tpu/io/teletext.py, numpy only.)

Teletext (ETS 300 706 Level 1) decoder — the engine behind
teletextdec (ext/teletextdec/gstteletextdec.c).

The reference wraps libzvbi: the element's own logic (transcribed
exactly here and in the element) is the PES data-unit walk —
data_unit_id 0x02/0x03 with length 44, the line-address new-frame
detection, the bad-line check, vbi_rev8 bit reversal
(gstteletextdec.c:1053-1130) — plus page selection and the
text/subtitle export shapes.  The decoding itself is zvbi's; this
module implements it from the ETS 300 706 spec:

- Hamming 8/4 with single-bit correction (table 36 code words) and
  odd-parity 7-bit characters (bad parity renders as space);
- magazine/packet addressing, X/0 page headers (BCD page number,
  subcode S1-S4, control bits C4 erase / C7 suppress-header /
  C11 magazine-serial), parallel and serial collection modes;
- Level 1 spacing attributes with their Set-At / Set-After semantics
  (alpha/mosaic colours, steady/flash, double height, conceal,
  contiguous/separated mosaics, black/new background, hold/release
  mosaics) over the 25x40 grid;
- G1 block mosaics drawn exactly (2x3 cells from bits 0,1,2,3,4,6;
  separated mode insets each cell); G0 alphanumerics use the
  framework's bitmap face downsampled to the 12x10 teletext cell
  (zvbi's wstfont glyph shapes are not reproduced — documented), cell
  geometry matching the element's COLUMNS_TO_WIDTH/ROWS_TO_HEIGHT
  (gstteletextdec.c:128-129).

Level 1.5 (r3): X/26 enhancement packets are decoded — hamming 24/18
with single-bit correction, the designation-ordered triplet stream,
set-active-position (address 40 = row 24, data = column), the
forward-clamping column walk, G2 Latin characters (table 37,
zvbi-calibrated incl. the U+2126 ohm sign) and G0-with-diacritic
composition via NFC — applied by page_to_text at level >= 1.5 (the
default; the reference asks zvbi for VBI_WST_LEVEL_3p5).  All
semantics cross-validated against libzvbi (tests/test_teletext_zvbi).
Divergence: combinations outside Unicode's precomposed set render the
base character (zvbi NULs them).

Level 2.5 (r3): X/28/0 and M/29/0 page/magazine extension packets —
CLUT 2/3 redefinition (16 x 12-bit RGB), default screen / row colour,
black background substitution, the table 33 colour-table remapping —
plus X/26 colour triplets (foreground / background / full screen /
full row colour) and X/28/4 CLUT 0/1 redefinition at level 3.5.  Per-
cell fg/bg and the colour map are cross-validated against libzvbi's
vbi_page via the io/zvbi.py fetch_page oracle (struct layout
calibrated empirically).  X/27, X/30, X/31 (links / TSDP) remain
ignored (documented).

National option subsets (r3): the header's C12-C14 designation picks
one of the ETS 300 706 table 36 Latin national subsets — 13 G0
positions substituted per language.  The tables below are calibrated
byte-for-byte against libzvbi's rendering (io/zvbi.py oracle;
designation code = (c11_14 >> 1) & 7 in this module's nibble order):
0 English, 1 French, 2 Swedish/Finnish/Hungarian, 3 Turkish (0x23 is
zvbi's private-use U+E800 lira glyph, kept for oracle agreement),
4 German, 5 Portuguese/Spanish, 6 Italian, 7 no subset (zvbi's
fallback draws 0x24 as ¤ and 0x7C as ¦).  page_to_text maps them;
the bitmap renderer keeps the base ASCII glyph (documented)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# ETS 300 706 table 36: Hamming 8/4 code words for nibbles 0-15
_HAM84 = (0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
          0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA)

_HAM_DEC = np.full(256, -1, np.int32)
for _v, _code in enumerate(_HAM84):
    _HAM_DEC[_code] = _v
    for _b in range(8):
        _c = _code ^ (1 << _b)
        if _HAM_DEC[_c] < 0:
            _HAM_DEC[_c] = _v


def hamming84(byte: int) -> int:
    """-> nibble 0-15, or -1 on a double-bit error."""
    return int(_HAM_DEC[byte & 0xFF])


def parity7(byte: int) -> int:
    """Odd-parity byte -> 7-bit char, or -1 on bad parity."""
    b = byte & 0xFF
    if bin(b).count("1") % 2 == 1:
        return b & 0x7F
    return -1


def rev8(byte: int) -> int:
    """vbi_rev8: bit reversal (the PES carries bits LSB-first)."""
    b = byte & 0xFF
    b = ((b & 0x0F) << 4) | (b >> 4)
    b = ((b & 0x33) << 2) | ((b & 0xCC) >> 2)
    b = ((b & 0x55) << 1) | ((b & 0xAA) >> 1)
    return b


# teletext colour palette (Level 1): black..white
PALETTE = np.array([
    [0, 0, 0], [255, 0, 0], [0, 255, 0], [255, 255, 0],
    [0, 0, 255], [255, 0, 255], [0, 255, 255], [255, 255, 255],
], np.uint8)

# Level 2.5 default colour map, 40 entries of vbi_rgba (R | G<<8 |
# B<<16 | A<<24), calibrated byte-for-byte against this libzvbi build
# (io/zvbi.py fetch_page on an untouched page; CLUT 2/3 match ETS 300
# 706 table 30 — CLUT 1 entries 13/14 are zvbi's own quirky defaults,
# kept verbatim for oracle agreement).  CLUT 0 = entries 0-7 (the
# Level 1 PALETTE), CLUT 1 = 8-15, CLUT 2 = 16-23, CLUT 3 = 24-31;
# 32-39 are zvbi-private (navigation etc.).
ZVBI_DEFAULT_COLOR_MAP = (
    0xFF000000, 0xFF0000FF, 0xFF00FF00, 0xFF00FFFF,
    0xFFFF0000, 0xFFFF00FF, 0xFFFFFF00, 0xFFFFFFFF,
    0xFF000000, 0xFF000077, 0xFF007700, 0xFF007777,
    0xFF770000, 0xFF007777, 0x00200000, 0xFF777777,
    0xFF5500FF, 0xFF0077FF, 0xFF77FF00, 0xFFBBFFFF,
    0xFFAACC00, 0xFF000055, 0xFF225566, 0xFF7777CC,
    0xFF333333, 0xFF7777FF, 0xFF77FF77, 0xFF77FFFF,
    0xFFFF7777, 0xFFFF77FF, 0xFFFFFF77, 0xFFDDDDDD,
    0xFF000000, 0xFF99AAFF, 0xFF00EE44, 0xFF00DDFF,
    0xFF99AAFF, 0xFFFF00FF, 0xFFFFFF00, 0xFFEEEEEE,
)


def color_map_rgb(cmap=ZVBI_DEFAULT_COLOR_MAP) -> np.ndarray:
    """40 vbi_rgba entries -> [40, 3] u8 RGB."""
    out = np.zeros((40, 3), np.uint8)
    for i, v in enumerate(cmap):
        out[i] = (v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF)
    return out


# ETS 300 706 table 33: X/28 "colour table remapping" -> the CLUT
# offsets added to Level 1 spacing-attribute colours (zvbi-probed:
# remap 7 renders white text as colour 23 on background 24)
REMAP_OFFSETS = ((0, 0), (0, 8), (0, 16), (8, 8),
                 (8, 16), (16, 8), (16, 16), (16, 24))


@dataclass
class TeletextPage:
    pgno: int                  # BCD, e.g. 0x100
    subno: int                 # BCD subcode
    erase: bool
    suppress_header: bool
    chars: np.ndarray          # [26, 40] int (7-bit codes; row 0 header)
    rows_received: set = field(default_factory=set)
    charset: int = 0           # C12-C14 national designation
    # X/26 enhancement packets: (designation, 39 triplet bytes)
    enhancements: list = field(default_factory=list)
    # X/28 packets: designation -> 13 decoded 18-bit triplets
    x28: dict = field(default_factory=dict)
    # M/29 magazine defaults captured at completion time (same shape)
    m29: dict = field(default_factory=dict)


# G0 positions substituted by the national option subsets
NATIONAL_POSITIONS = (0x23, 0x24, 0x40, 0x5B, 0x5C, 0x5D, 0x5E,
                      0x5F, 0x60, 0x7B, 0x7C, 0x7D, 0x7E)

# ETS 300 706 table 36 Latin subsets, zvbi-calibrated (module doc)
NATIONAL_SUBSETS = {
    0: "£$@←½→↑#—¼‖¾÷",          # English
    1: "éïàëêùî#èâôûç",          # French
    2: "#¤ÉÄÖÅÜ_éäöåü",          # Swedish/Finnish/Hungarian
    3: "\ue800ğİŞÖÇÜĞışöçü",   # Turkish (U+E800 = zvbi lira glyph)
    4: "#$§ÄÖÜ^_°äöüß",          # German
    5: "ç$¡áéíóú¿üñèà",          # Portuguese/Spanish
    6: "£$é°ç→↑#ùàòèì",          # Italian
    7: "#¤@[\\]^_`{¦}~",         # no subset (zvbi fallback)
}


def national_char(code: int, charset: int) -> str:
    """7-bit G0 code -> displayed character under the page's national
    option subset."""
    try:
        idx = NATIONAL_POSITIONS.index(code)
    except ValueError:
        return chr(code)
    return NATIONAL_SUBSETS[charset & 0x7][idx]


class TeletextDecoder:
    """Page collector (the vbi_decode/vbi_fetch_vt_page analog)."""

    def __init__(self):
        self._collect: Dict[int, TeletextPage] = {}   # per magazine
        self._serial: Dict[int, bool] = {}
        self.pages: Dict[Tuple[int, int], TeletextPage] = {}
        self.events: List[Tuple[int, int]] = []       # (pgno, subno)
        # M/29 magazine-level extension packets: mag -> {des: triplets}
        self._m29: Dict[int, Dict[int, list]] = {}

    def _complete(self, mag: int) -> None:
        page = self._collect.pop(mag, None)
        if page is None:
            return
        page.m29 = dict(self._m29.get(mag, {}))
        self.pages[(page.pgno, page.subno)] = page
        self.events.append((page.pgno, page.subno))

    def feed_line(self, data42: bytes) -> None:
        """One 42-byte teletext line (already bit-reversed, i.e. after
        the element's vbi_rev8)."""
        n1 = hamming84(data42[0])
        n2 = hamming84(data42[1])
        if n1 < 0 or n2 < 0:
            return
        mag = n1 & 0x7
        row = (n1 >> 3) | (n2 << 1)
        if mag == 0:
            mag = 8
        if row == 0:
            nibs = [hamming84(b) for b in data42[2:10]]
            if any(n < 0 for n in nibs):
                return
            units, tens, s1, s2c4, s3, s4c56, c7_10, c11_14 = nibs
            serial = bool(c11_14 & 0x1)
            for m in (range(1, 9) if serial else (mag,)):
                if serial or m == mag:
                    if m in self._collect:
                        self._complete(m)
            self._serial[mag] = serial
            if tens >= 10 or units >= 10:
                return                        # non-BCD: time-fill page
            pgno = (mag << 8) | (tens << 4) | units
            subno = s1 | ((s2c4 & 0x7) << 4) | (s3 << 8) \
                | ((s4c56 & 0x3) << 12)
            chars = np.full((26, 40), 0x20, np.int64)
            for i in range(8, 40):
                c = parity7(data42[2 + i])
                chars[0, i] = c if c >= 0 else 0x20
            self._collect[mag] = TeletextPage(
                pgno=pgno, subno=subno,
                erase=bool(s2c4 & 0x8),
                suppress_header=bool(c7_10 & 0x1),
                chars=chars,
                charset=(c11_14 >> 1) & 0x7)
        elif 1 <= row <= 25:
            page = self._collect.get(mag)
            if page is None:
                return
            for i in range(40):
                c = parity7(data42[2 + i])
                page.chars[row, i] = c if c >= 0 else 0x20
            page.rows_received.add(row)
        elif row == 26:
            # X/26: Level 1.5 enhancement triplets, applied at render
            # via apply_x26 (designation + 13 hamming-24/18 triplets)
            page = self._collect.get(mag)
            if page is None:
                return
            designation = hamming84(data42[2])
            if designation >= 0:
                page.enhancements.append((designation,
                                          bytes(data42[3:42])))
        elif row == 28:
            # X/28: page-level presentation extension (Level 2.5/3.5)
            page = self._collect.get(mag)
            if page is None:
                return
            designation = hamming84(data42[2])
            if designation >= 0:
                trips = _decode_triplets(data42[3:42])
                if trips is not None:
                    page.x28[designation] = trips
        elif row == 29:
            # M/29: magazine-level default extension (applies to every
            # page of the magazine until replaced)
            designation = hamming84(data42[2])
            if designation >= 0:
                trips = _decode_triplets(data42[3:42])
                if trips is not None:
                    self._m29.setdefault(mag, {})[designation] = trips
        # X/27, X/30, X/31: linked pages / TSDP / independent data —
        # accepted and ignored (module doc)

    def flush(self) -> None:
        for mag in list(self._collect):
            self._complete(mag)

    def fetch(self, pgno: int, subno: int = -1
              ) -> Optional[TeletextPage]:
        if subno >= 0:
            return self.pages.get((pgno, subno))
        for (pg, _sub), page in reversed(list(self.pages.items())):
            if pg == pgno:
                return page
        return None


# -- Level 1 row attribute walk ---------------------------------------------

@dataclass
class Cell:
    char: int          # 7-bit code (or mosaic code)
    fg: int
    bg: int
    mosaic: bool
    separated: bool
    double_height: bool
    conceal: bool


def render_row_attrs(codes: np.ndarray) -> List[Cell]:
    """One 40-char row -> per-cell attributes (ETS 300 706 12.2
    spacing attributes with Set-At / Set-After semantics)."""
    fg, bg = 7, 0
    mosaic = False
    separated = False
    double_h = False
    conceal = False
    hold = False
    held = 0x20
    held_sep = False
    out: List[Cell] = []
    for code in codes:
        code = int(code)
        at_char = code
        is_attr = code < 0x20
        # Set-At attributes apply before this cell renders
        if is_attr:
            if code == 0x09:
                pass                         # steady (set-at, no render)
            elif code == 0x0C:
                double_h = False             # normal size: set-at
            elif code == 0x18:
                conceal = True               # set-at
            elif code == 0x19:
                separated = False            # contiguous: set-at
            elif code == 0x1A:
                separated = True             # separated: set-at
            elif code == 0x1C:
                bg = 0                       # black background: set-at
            elif code == 0x1D:
                bg = fg                      # new background: set-at
            elif code == 0x1E:
                hold = True                  # hold mosaics: set-at
        disp = at_char
        if is_attr:
            disp = held if (hold and mosaic) else 0x20
        use_sep = held_sep if (is_attr and hold and mosaic) else separated
        out.append(Cell(disp, fg, bg,
                        mosaic and (not is_attr or hold),
                        use_sep, double_h, conceal))
        # Set-After attributes apply from the NEXT cell
        if is_attr:
            if code <= 0x07:
                fg = code
                mosaic = False
                conceal = False
                hold = False
            elif code == 0x08:
                pass                         # flash (set-after)
            elif code == 0x0D:
                double_h = True              # double height: set-after
            elif 0x10 <= code <= 0x17:
                fg = code - 0x10
                mosaic = True
                conceal = False
            elif code == 0x1F:
                hold = False                 # release mosaics: set-after
        elif mosaic and (0x20 <= code < 0x40 or 0x60 <= code < 0x80):
            held = code
            held_sep = separated
    return out


# -- pixel rendering --------------------------------------------------------

CELL_W, CELL_H = 12, 10        # COLUMNS_TO_WIDTH / ROWS_TO_HEIGHT

_GLYPHS: Optional[np.ndarray] = None


def _glyphs() -> np.ndarray:
    """96-glyph [96, CELL_H, CELL_W] bool atlas: the framework's
    bitmap face downsampled to the teletext cell (module doc)."""
    global _GLYPHS
    if _GLYPHS is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "cc_font.npz")
        with np.load(path) as z:
            atlas = z[z.files[0]]            # [96, h, w] bool-ish
        g = np.zeros((96, CELL_H, CELL_W), bool)
        ah, aw = atlas.shape[1:]
        ys = (np.arange(CELL_H) * ah) // CELL_H
        xs = (np.arange(CELL_W) * aw) // CELL_W
        # 2x2 max-pool style sample to keep thin strokes
        for i in range(96):
            a = atlas[i] > 0
            s = a[np.ix_(ys, xs)]
            s |= a[np.ix_(np.minimum(ys + 1, ah - 1), xs)]
            s |= a[np.ix_(ys, np.minimum(xs + 1, aw - 1))]
            g[i] = s
        _GLYPHS = g
    return _GLYPHS


def _mosaic_bitmap(code: int, separated: bool) -> np.ndarray:
    """2x3 block mosaic cell [CELL_H, CELL_W] bool (G1 set: bits
    0,1,2,3,4,6 of code-0x20)."""
    # six cells live in bits 0-4 and 6 of the code itself (bit 5 is
    # the 0x20 column flag, bit 6 distinguishes the 0x60 column)
    cells = [(code >> 0) & 1, (code >> 1) & 1, (code >> 2) & 1,
             (code >> 3) & 1, (code >> 4) & 1, (code >> 6) & 1]
    out = np.zeros((CELL_H, CELL_W), bool)
    ys = (0, 3, 7, CELL_H)                  # 3/4/3 rows
    for cy in range(3):
        for cx in range(2):
            if not cells[cy * 2 + cx]:
                continue
            y0, y1 = ys[cy], ys[cy + 1]
            x0 = cx * (CELL_W // 2)
            x1 = x0 + CELL_W // 2
            if separated:
                y1 -= 1
                x1 -= 1
            out[y0:y1, x0:x1] = True
    return out


def render_page_rgba(page: TeletextPage, reveal: bool = False,
                     level: float = 3.5) -> np.ndarray:
    """[25*CELL_H, 40*CELL_W, 4] RGBA render of rows 0-24.

    level >= 2.5 renders through the full colour pipeline (X/28/M/29
    CLUT redefinitions + remapping, X/26 colour triplets, black
    background substitution by the row colour — ETS 300 706 9.4.2 /
    12.3.2; zvbi-probed semantics where the spec is loose)."""
    H, W = 25 * CELL_H, 40 * CELL_W
    out = np.zeros((H, W, 4), np.uint8)
    out[..., 3] = 255
    glyphs = _glyphs()
    rp = render_cells(page, level)
    cmap = rp.color_map
    for r in range(25):
        cells = rp.cells[r]
        if r == 0 and page.suppress_header:
            cells = [Cell(0x20, 7 + rp.ext.fg_offset,
                          rp.ext.bg_offset, False, False, False,
                          False) for _ in range(40)]
        row_color = rp.row_colors.get(r, rp.ext.def_row_color)
        for c, cell in enumerate(cells):
            y0, x0 = r * CELL_H, c * CELL_W
            fgc = cmap[cell.fg % 40]
            bg_idx = cell.bg % 40
            if (rp.ext.black_bg_subst and not rp.x26_bg[r, c]
                    and bg_idx == rp.ext.bg_offset):
                bg_idx = row_color % 40
            bgc = cmap[bg_idx]
            block = out[y0:y0 + CELL_H, x0:x0 + CELL_W]
            block[..., :3] = bgc
            ch = cell.char
            if cell.conceal and not reveal:
                continue
            if cell.mosaic and (0x20 <= ch < 0x40 or 0x60 <= ch < 0x80):
                m = _mosaic_bitmap(ch, cell.separated)
                block[..., :3][m] = fgc
            elif 0x20 <= ch < 0x80 and not (cell.mosaic):
                m = glyphs[ch - 0x20]
                block[..., :3][m] = fgc
    return out


# -- X/26 Level 1.5 enhancements (ETS 300 706 12.3; zvbi-calibrated) ---------

# data-bit positions of the hamming 24/18 code word (bits 0-23; parity
# at 0, 1, 3, 7, 15, 23)
_H24_DATA_POS = (2, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14,
                 16, 17, 18, 19, 20, 21, 22)


def hamming2418(b3: bytes) -> int:
    """3 bytes -> 18-bit value with single-bit correction, or -1 on a
    double-bit error (matches vbi_unham24p on all tested words)."""
    v = b3[0] | (b3[1] << 8) | (b3[2] << 16)
    syndrome = 0
    for pbit in range(5):
        mask = 0
        for pos in range(23):        # bit 23 = overall parity only
            if ((pos + 1) >> pbit) & 1:
                mask |= 1 << pos
        if bin(v & mask).count("1") & 1 == 0:   # groups are odd parity
            syndrome |= 1 << pbit
    total_odd = bin(v).count("1") & 1
    if syndrome:
        if total_odd:
            return -1          # syndrome + intact overall parity:
        v ^= 1 << (syndrome - 1)                # correct single error
    out = 0
    for i, pos in enumerate(_H24_DATA_POS):
        if (v >> pos) & 1:
            out |= 1 << i
    return out


def hamming2418_encode(value18: int) -> bytes:
    """18-bit value -> hamming 24/18 triplet (test/encoder side)."""
    v = 0
    for i, pos in enumerate(_H24_DATA_POS):
        if (value18 >> i) & 1:
            v |= 1 << pos
    for pbit, ppos in ((0, 0), (1, 1), (2, 3), (3, 7), (4, 15)):
        mask = 0
        for pos in range(24):
            if pos in (0, 1, 3, 7, 15, 23):
                continue
            if ((pos + 1) >> pbit) & 1:
                mask |= 1 << pos
        if bin(v & mask).count("1") & 1 == 0:
            v |= 1 << ppos
    if bin(v).count("1") % 2 == 0:
        v |= 1 << 23
    return bytes([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF])


# -- X/28 / M/29 page extensions (ETS 300 706 9.4.2; Level 2.5) --------------

def _decode_triplets(b39: bytes) -> Optional[list]:
    """39 payload bytes -> 13 hamming 24/18 triplets, or None when any
    triplet has an uncorrectable error (zvbi drops the packet then)."""
    trips = []
    for k in range(13):
        v = hamming2418(b39[3 * k:3 * k + 3])
        if v < 0:
            return None
        trips.append(v)
    return trips


@dataclass
class PageExtension:
    """Resolved presentation state for one page (defaults + M/29 +
    X/28).  color_map holds 40 vbi_rgba entries; fg/bg offsets are the
    table 33 remapping applied to Level 1 spacing-attribute colours."""
    color_map: list = field(
        default_factory=lambda: list(ZVBI_DEFAULT_COLOR_MAP))
    def_screen_color: int = 0
    def_row_color: int = 0
    black_bg_subst: bool = False
    fg_offset: int = 0
    bg_offset: int = 0


def _ext_bits(trips: list, pos: int, n: int) -> int:
    """n bits starting at global bit position pos (0-based, LSB-first
    within each 18-bit triplet) of the 13-triplet payload."""
    v = 0
    for k in range(n):
        p = pos + k
        if (trips[p // 18] >> (p % 18)) & 1:
            v |= 1 << k
    return v


def parse_x28_format1(trips: list, ext: PageExtension,
                      clut_base: int) -> None:
    """X/28/0 Format 1 (or X/28/4 / M/29/0 / M/29/4) into ext.

    Bit layout (zvbi-probed, matching 9.4.2): colour data = 16 entries
    x 12 bits (R, G, B nibbles in transmission order, LSB-first)
    starting at global bit 28 (after page function/coding, charset
    designations and side-panel flags); triplet 13 carries default
    screen colour (bits 220-224), default row colour (225-229), black
    background substitution (230) and the CLUT remapping (231-233).
    4-bit components scale to 8 bits via x17, alpha 0xFF."""
    pos = 28
    for i in range(16):
        r = _ext_bits(trips, pos, 4) * 17
        g = _ext_bits(trips, pos + 4, 4) * 17
        b = _ext_bits(trips, pos + 8, 4) * 17
        ext.color_map[clut_base + i] = (0xFF << 24) | (b << 16) \
            | (g << 8) | r
        pos += 12
    if clut_base == 0:
        # zvbi CLUT 1 quirks, reproduced verbatim for oracle parity
        # (probed: tests/test_teletext_zvbi.py x28_4): entry 8
        # (transparent black) is never redefined; entry 13 aliases
        # the transmitted entry 11; entry 14 takes entry 12's R/G
        # over its default B/alpha
        ext.color_map[8] = ZVBI_DEFAULT_COLOR_MAP[8]
        ext.color_map[13] = ext.color_map[11]
        ext.color_map[14] = (ZVBI_DEFAULT_COLOR_MAP[14]
                             & 0xFFFF0000) \
            | (ext.color_map[12] & 0x0000FFFF)
    ext.def_screen_color = _ext_bits(trips, 220, 5)
    ext.def_row_color = _ext_bits(trips, 225, 5)
    ext.black_bg_subst = bool(_ext_bits(trips, 230, 1))
    fg_off, bg_off = REMAP_OFFSETS[_ext_bits(trips, 231, 3)]
    ext.fg_offset, ext.bg_offset = fg_off, bg_off


def page_extension(page: TeletextPage,
                   level: float = 3.5) -> PageExtension:
    """Merge defaults <- M/29 <- X/28 (per designation; the page
    packet wins).  zvbi-probed: the formatter applies BOTH
    designations at every fetch level (ETS 9.4.2.2 would gate X/28/4
    CLUT 0/1 at level 3.5, but the reference's zvbi does not — its
    max_level only gates the X/26 enhancement walk), so `level` is
    accepted for interface symmetry and unused here."""
    del level
    ext = PageExtension()
    # designation 4 first so X/28/0's scalar fields (screen/row/remap)
    # win when both packets are present
    for des, base in ((4, 0), (0, 16)):
        trips = page.x28.get(des, page.m29.get(des))
        if trips is not None:
            parse_x28_format1(trips, ext, base)
    return ext


# G2 Latin set (ETS 300 706 table 37), calibrated cell-for-cell against
# zvbi's level-1.5 rendering; None = no mapping (cell keeps its char)
G2_LATIN = (
    " ¡¢£$¥#§¤‘“«←↑→↓°±²³×µ¶·÷’”»¼½¾¿"
    " ˋˊˆ˜ˉ˘˙¨\x00˚ˏˍ˝˛ˇ—¹®©™♪₠‰ɑ   ⅛⅜⅝⅞"
    "ΩÆÐªĦ ĲĿŁØŒºÞŦŊŉĸæđðħıĳŀłøœßþŧŋ■")

# diacritical marks (G2 column 4): mark index -> combining codepoint
COMBINING_MARKS = {1: "̀", 2: "́", 3: "̂", 4: "̃",
                   5: "̄", 6: "̆", 7: "̇", 8: "̈",
                   10: "̊", 11: "̧", 13: "̋",
                   14: "̨", 15: "̌"}


def compose_mark(base: str, mark: int) -> str:
    """G0 char + diacritic -> precomposed unicode (NFC); mark 0 or an
    unknown combination keeps the base char (zvbi renders its own
    smaller precomposed table and NULs unknowns — divergence noted)."""
    import unicodedata
    if mark == 0 or mark not in COMBINING_MARKS:
        return base
    composed = unicodedata.normalize("NFC", base + COMBINING_MARKS[mark])
    return composed if len(composed) == 1 else base


def apply_x26_full(page: TeletextPage, level: float = 3.5) -> tuple:
    """The enhancement walk (zvbi-calibrated): triplets stream across
    packets in designation order; active position starts at (0, 0);
    row-address triplets (address >= 40) with mode 0x04 set row =
    address-40 (40 -> 24) and column = data; column triplets clamp the
    column FORWARD (col = max(col, address)) and apply there; mode
    0x0F = G2 character, 0x10-0x1F = G0 char with diacritic; 0x1F at a
    row address terminates.

    Level 2.5 additions (zvbi-probed semantics): column mode 0x00 =
    foreground colour, 0x03 = background colour — the 5-bit value
    applies from the addressed column to the end of the row until a
    Level 1 spacing attribute re-sets that channel or a later triplet
    overrides it; row mode 0x00 = full screen colour; row mode 0x01 =
    full row colour (data bits 6-7 = 00 this row, 11 = this row and
    below — not visible in zvbi's pg->text, applied at RGBA render).

    -> (char_overrides, color_cmds, screen_color, row_colors) where
    color_cmds = [(row, col, 'fg'|'bg', value)] in stream order."""
    overrides: Dict[Tuple[int, int], str] = {}
    color_cmds: List[Tuple[int, int, str, int]] = []
    screen_color: Optional[int] = None
    row_colors: Dict[int, int] = {}
    row, col = 0, 0
    stream = b"".join(p for _d, p in sorted(page.enhancements,
                                            key=lambda t: t[0]))
    for k in range(len(stream) // 3):
        v = hamming2418(stream[3 * k:3 * k + 3])
        if v < 0:
            continue
        address = v & 0x3F
        mode = (v >> 6) & 0x1F
        data = (v >> 11) & 0x7F
        if address >= 40:                       # row address group
            if mode == 0x1F:
                break                           # termination
            if mode == 0x04:
                row = 24 if address == 40 else address - 40
                if data < 40:
                    col = data
            elif mode == 0x00 and level >= 2.5:
                # full screen colour (data bits 6-7 must be 00)
                if (data >> 5) == 0:
                    screen_color = data & 0x1F
            elif mode == 0x01 and level >= 2.5:
                # full row colour for the addressed row
                s = data >> 5
                r = 24 if address == 40 else address - 40
                if s == 0:
                    row_colors[r] = data & 0x1F
                elif s == 3:
                    for rr in range(r, 25):
                        row_colors[rr] = data & 0x1F
            continue
        col = max(col, address)
        if mode == 0x0F and 0x20 <= data < 0x80:
            g2 = G2_LATIN[data - 0x20]
            if g2 != "\x00":
                overrides[(row, col)] = g2
        elif 0x10 <= mode <= 0x1F and 0x20 <= data < 0x80:
            overrides[(row, col)] = compose_mark(chr(data), mode - 0x10)
        elif mode == 0x00 and level >= 2.5 and (data >> 5) == 0:
            color_cmds.append((row, col, "fg", data & 0x1F))
        elif mode == 0x03 and level >= 2.5 and (data >> 5) == 0:
            color_cmds.append((row, col, "bg", data & 0x1F))
    return overrides, color_cmds, screen_color, row_colors


def apply_x26(page: TeletextPage) -> Dict[Tuple[int, int], str]:
    """Character overrides only (Level 1.5 view of the X/26 walk)."""
    return apply_x26_full(page, level=1.5)[0]


@dataclass
class RenderedPage:
    """Per-cell presentation state after the full Level <=2.5 walk."""
    cells: list                 # 25 rows x 40 Cell (fg/bg are 5-bit)
    x26_bg: np.ndarray          # [25, 40] bool: bg set by X/26
    color_map: np.ndarray       # [40, 3] u8 RGB
    screen_color: int
    row_colors: Dict[int, int]
    ext: PageExtension


def _fg_reset_at(codes: np.ndarray, c: int) -> bool:
    """Level 1 spacing attr re-sets the foreground at cell c (the
    colour codes are Set-After, so the change lands at c when the
    attribute sits at c-1)."""
    prev = int(codes[c - 1])
    return prev <= 0x07 or 0x10 <= prev <= 0x17


def _bg_reset_at(codes: np.ndarray, c: int) -> bool:
    """Black/new background are Set-At: they re-set bg at their own
    cell."""
    cur = int(codes[c])
    return cur in (0x1C, 0x1D)


def render_cells(page: TeletextPage, level: float = 3.5
                 ) -> RenderedPage:
    """The merged Level 1 + X/26 + X/28/M/29 presentation walk:
    Level 1 spacing attributes produce CLUT 0 colours, the X/28
    remapping lifts them into the selected CLUTs, and X/26 colour
    triplets overlay absolute 5-bit colours from their column to the
    end of the row until a spacing attribute re-sets that channel
    (zvbi-probed semantics; tests/test_teletext_zvbi.py)."""
    ext = page_extension(page, level)
    if page.enhancements:
        _ovr, cmds, screen, row_colors = apply_x26_full(page, level)
    else:
        cmds, screen, row_colors = [], None, {}
    screen_color = ext.def_screen_color if screen is None else screen
    grid = []
    for r in range(25):
        cells = render_row_attrs(page.chars[r])
        for cell in cells:
            cell.fg += ext.fg_offset
            cell.bg += ext.bg_offset
        grid.append(cells)
    x26_bg = np.zeros((25, 40), bool)
    for r, c0, kind, val in cmds:
        if not (0 <= r < 25 and 0 <= c0 < 40):
            continue
        codes = page.chars[r]
        for c in range(c0, 40):
            if c > c0 and (kind == "fg" and _fg_reset_at(codes, c)
                           or kind == "bg" and _bg_reset_at(codes, c)):
                break
            if kind == "fg":
                grid[r][c].fg = val
            else:
                grid[r][c].bg = val
                x26_bg[r, c] = True
    return RenderedPage(cells=grid, x26_bg=x26_bg,
                        color_map=color_map_rgb(ext.color_map),
                        screen_color=screen_color,
                        row_colors=row_colors, ext=ext)


def page_to_text(page: TeletextPage, start: int = 0, stop: int = 24,
                 level: float = 3.5) -> List[str]:
    """Rows as UTF-8 text lines (vbi_print_page_region analog: spacing
    attributes and mosaics print as spaces).  level >= 1.5 applies the
    page's X/26 enhancements (the reference asks zvbi for
    VBI_WST_LEVEL_3p5, so enhancements are on by default)."""
    overrides = apply_x26(page) if (level >= 1.5
                                    and page.enhancements) else {}
    lines = []
    for r in range(start, stop + 1):
        cells = render_row_attrs(page.chars[r])
        row_chars = []
        for c, cell in enumerate(cells):
            ov = overrides.get((r, c))
            if ov is not None:
                row_chars.append(ov)
            elif (0x20 <= cell.char < 0x7F and not cell.mosaic
                    and not cell.conceal):
                row_chars.append(national_char(cell.char, page.charset))
            else:
                row_chars.append(" ")
        lines.append("".join(row_chars))
    return lines


# -- the element's data-unit walk (gstteletextdec.c:1053-1130) --------------

DATA_UNIT_STUFFING = 0xFF
DATA_UNIT_EBU_TELETEXT_NON_SUBTITLE = 0x02
DATA_UNIT_EBU_TELETEXT_SUBTITLE = 0x03
_SKIP_UNITS = (0xB4, 0xB5, 0xB6, 0xC3, 0xC4, 0xC5, 0xC6)


def _lofp_to_line(lofp: int) -> Tuple[int, int, int]:
    """lofp byte -> (field, field_line, frame_line) for SYSTEM_625."""
    field = 0 if (lofp & 0x20) else 1
    field_line = lofp & 0x1F
    if field_line == 0:
        frame_line = 0
    elif field == 0:
        frame_line = field_line
    else:
        frame_line = field_line + 312
    return field, field_line, frame_line


def extract_frames(packet: bytes) -> Tuple[List[List[bytes]], bool]:
    """PES payload -> list of frames, each a list of 42-byte
    bit-reversed teletext lines; returns (frames, ok).  Mirrors the
    extract_data_units / line_address flow including the new-frame
    split on non-increasing frame lines and the bad-line error."""
    frames: List[List[bytes]] = []
    cur: List[bytes] = []
    last_frame_line = 0
    offset = 0
    n = len(packet)
    while offset < n:
        uid = packet[offset]
        if offset + 2 > n:
            break
        ulen = packet[offset + 1]
        if uid == DATA_UNIT_STUFFING or uid in _SKIP_UNITS:
            offset += 2 + ulen
            continue
        if uid in (DATA_UNIT_EBU_TELETEXT_NON_SUBTITLE,
                   DATA_UNIT_EBU_TELETEXT_SUBTITLE):
            if ulen != 44:
                offset += 2 + ulen
                continue
            if offset + 46 > n:
                break
            lofp = packet[offset + 2]
            _field, field_line, frame_line = _lofp_to_line(lofp)
            if frame_line != 0:
                if frame_line <= last_frame_line and cur:
                    frames.append(cur)
                    cur = []
                    last_frame_line = 0
                if field_line > 0 and field_line - 7 >= 23 - 7:
                    return frames, False     # bad line (reference error)
                last_frame_line = frame_line
                line = bytes(rev8(b)
                             for b in packet[offset + 4:offset + 46])
                cur.append(line)
            offset += 46
            continue
        offset += 1                          # corrupted: resync by one
    if cur:
        frames.append(cur)
    return frames, True


# -- helpers for building streams (tests / encoders) ------------------------

def hamming84_encode(nibble: int) -> int:
    return _HAM84[nibble & 0xF]


def parity_encode(char: int) -> int:
    c = char & 0x7F
    if bin(c).count("1") % 2 == 0:
        c |= 0x80
    return c


def build_line(mag: int, row: int, payload: bytes) -> bytes:
    """42-byte line (bit order already MSB-first / post-rev8)."""
    m = mag & 0x7
    n1 = m | ((row & 0x1) << 3)
    n2 = row >> 1
    return bytes([hamming84_encode(n1), hamming84_encode(n2)]) \
        + payload


def build_header(mag: int, tens: int, units: int, subno: int = 0,
                 erase: bool = False, serial: bool = False,
                 charset: int = 0, text: bytes = b" " * 32) -> bytes:
    s1 = subno & 0xF
    s2 = ((subno >> 4) & 0x7) | (0x8 if erase else 0)
    s3 = (subno >> 8) & 0xF
    s4 = (subno >> 12) & 0x3
    c7_10 = 0
    c11_14 = (0x1 if serial else 0) | ((charset & 0x7) << 1)
    payload = bytes(hamming84_encode(x)
                    for x in (units, tens, s1, s2, s3, s4, c7_10,
                              c11_14))
    payload += bytes(parity_encode(b) for b in text[:32].ljust(32))
    return build_line(mag, 0, payload)


def build_row(mag: int, row: int, text: bytes) -> bytes:
    payload = bytes(parity_encode(b) for b in text[:40].ljust(40))
    return build_line(mag, row, payload)


def build_x28(mag: int, designation: int = 0,
              colors: Optional[list] = None, screen_color: int = 0,
              row_color: int = 0, black_bg_subst: bool = False,
              remap: int = 0, row: int = 28) -> bytes:
    """X/28 (or M/29 via row=29) extension packet.  colors = 16
    (r, g, b) 4-bit tuples for the redefined CLUT pair; layout per
    parse_x28_format1."""
    bits = [0] * 234

    def put(pos, val, n):
        for k in range(n):
            bits[pos + k] = (val >> k) & 1

    pos = 28
    for i in range(16):
        r, g, b = colors[i] if colors else (0, 0, 0)
        put(pos, r, 4)
        put(pos + 4, g, 4)
        put(pos + 8, b, 4)
        pos += 12
    put(220, screen_color, 5)
    put(225, row_color, 5)
    put(230, 1 if black_bg_subst else 0, 1)
    put(231, remap, 3)
    payload = bytes([hamming84_encode(designation)])
    for t in range(13):
        v = 0
        for b in range(18):
            if bits[t * 18 + b]:
                v |= 1 << b
        payload += hamming2418_encode(v)
    return build_line(mag, row, payload)
