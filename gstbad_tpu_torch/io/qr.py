"""(A copy of gstbad_tpu/io/qr.py, numpy only.)

QR code encoder (ISO/IEC 18004) — the engine behind qroverlay /
debugqroverlay (ext/qroverlay/gstbaseqroverlay.c uses libqrencode's
QRcode_encodeString(content, 0, level, QR_MODE_8, 0)).

libqrencode is a native dependency absent here; this is a from-spec
encoder producing the same symbol family: automatic version selection
(version arg 0), byte/alphanumeric/numeric mode segmentation, the four
QRecLevel error-correction levels, and ISO mask selection.

Documented divergences from libqrencode (unobservable in this
environment — no libqrencode oracle; cv2.QRCodeDetector round-trips are
the tests' ground truth, and any spec-conformant decoder reads both):
- segmentation: libqrencode's Split_splitStringToQRinput is a greedy
  run-length heuristic; this encoder uses the exact dynamic program
  (cost in 1/6-bit units, ceil at mode switches) so segment boundaries
  can differ (ours is never longer).
- mask choice: both evaluate the ISO 18004 penalty rules N1-N4, but
  libqrencode's N3 counting differs slightly from the spec text; a
  different (equally valid) mask may win.

All tables below are fixed public data from the standard.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# -- error-correction levels (libqrencode QRecLevel order: L=0 M=1 Q=2 H=3;
#    gstbaseqroverlay.c DEFAULT_PROP_QUALITY = 1 = M) -----------------------

LEVELS = ("L", "M", "Q", "H")
_LEVEL_FORMAT_BITS = {"L": 1, "M": 0, "Q": 3, "H": 2}

# ECC codewords per block, versions 1..40 (index v-1), per level.
_ECC_PER_BLOCK = {
    "L": (7, 10, 15, 20, 26, 18, 20, 24, 30, 18, 20, 24, 26, 30, 22, 24,
          28, 30, 28, 28, 28, 28, 30, 30, 26, 28, 30, 30, 30, 30, 30, 30,
          30, 30, 30, 30, 30, 30, 30, 30),
    "M": (10, 16, 26, 18, 24, 16, 18, 22, 22, 26, 30, 22, 22, 24, 24, 28,
          28, 26, 26, 26, 26, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28, 28,
          28, 28, 28, 28, 28, 28, 28, 28),
    "Q": (13, 22, 18, 26, 18, 24, 18, 22, 20, 24, 28, 26, 24, 20, 30, 24,
          28, 28, 26, 30, 28, 30, 30, 30, 30, 28, 30, 30, 30, 30, 30, 30,
          30, 30, 30, 30, 30, 30, 30, 30),
    "H": (17, 28, 22, 16, 22, 28, 26, 26, 24, 28, 24, 28, 22, 24, 24, 30,
          28, 28, 26, 28, 30, 24, 30, 30, 30, 30, 30, 30, 30, 30, 30, 30,
          30, 30, 30, 30, 30, 30, 30, 30),
}

# Number of error-correction blocks, versions 1..40, per level.
_NUM_BLOCKS = {
    "L": (1, 1, 1, 1, 1, 2, 2, 2, 2, 4, 4, 4, 4, 4, 6, 6, 6, 6, 7, 8, 8,
          9, 9, 10, 12, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21,
          22, 24, 25),
    "M": (1, 1, 1, 2, 2, 4, 4, 4, 5, 5, 5, 8, 9, 9, 10, 10, 11, 13, 14,
          16, 17, 17, 18, 20, 21, 23, 25, 26, 28, 29, 31, 33, 35, 37, 38,
          40, 43, 45, 47, 49),
    "Q": (1, 1, 2, 2, 4, 4, 6, 6, 8, 8, 8, 10, 12, 16, 12, 17, 16, 18,
          21, 20, 23, 23, 25, 27, 29, 34, 34, 35, 38, 40, 43, 45, 48, 51,
          53, 56, 59, 62, 65, 68),
    "H": (1, 1, 2, 4, 4, 4, 5, 6, 8, 8, 11, 11, 16, 16, 18, 16, 19, 21,
          25, 25, 25, 34, 30, 32, 35, 37, 40, 42, 45, 48, 51, 54, 57, 60,
          63, 66, 70, 74, 77, 81),
}


def symbol_size(version: int) -> int:
    return 17 + 4 * version


def total_codewords(version: int) -> int:
    """Raw data+ECC codeword count from the symbol geometry (total
    modules minus function patterns, floor to bytes)."""
    v = version
    bits = (16 * v + 128) * v + 64
    if v >= 2:
        n = v // 7 + 2
        bits -= (25 * n - 10) * n - 55
        if v >= 7:
            bits -= 36
    return bits // 8


def data_codewords(version: int, level: str) -> int:
    return (total_codewords(version)
            - _ECC_PER_BLOCK[level][version - 1]
            * _NUM_BLOCKS[level][version - 1])


def _block_structure(version: int, level: str
                     ) -> List[Tuple[int, int]]:
    """[(data_cw, ecc_cw)] per block: the first (nb - rem) blocks are
    short, the last rem blocks carry one extra data codeword."""
    nb = _NUM_BLOCKS[level][version - 1]
    ecc = _ECC_PER_BLOCK[level][version - 1]
    data = data_codewords(version, level)
    short, rem = divmod(data, nb)
    return [(short + (1 if i >= nb - rem else 0), ecc) for i in range(nb)]


# -- GF(256) Reed-Solomon (poly 0x11d) --------------------------------------

_GF_EXP = np.zeros(512, np.int32)
_GF_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _GF_EXP[_i] = _x
    _GF_LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11d
_GF_EXP[255:510] = _GF_EXP[0:255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_GF_EXP[_GF_LOG[a] + _GF_LOG[b]])


def _rs_generator(n: int) -> List[int]:
    g = [1]
    for i in range(n):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, int(_GF_EXP[i]))
            g2[j + 1] ^= c
        g = g2
    return g


def _rs_ecc(data: bytes, n_ecc: int) -> bytes:
    # _rs_generator returns lowest-degree-first; division wants
    # highest-first
    gen = _rs_generator(n_ecc)[::-1]
    rem = [0] * n_ecc
    for b in data:
        factor = b ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            lf = int(_GF_LOG[factor])
            for j in range(n_ecc):
                if gen[j + 1]:
                    rem[j] ^= int(_GF_EXP[lf + _GF_LOG[gen[j + 1]]])
    return bytes(rem)


# -- mode segmentation ------------------------------------------------------

_ALNUM = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ $%*+-./:"
_ALNUM_IDX = {c: i for i, c in enumerate(_ALNUM)}

_MODE_NUM, _MODE_ALNUM, _MODE_BYTE = 0, 1, 2
_MODE_INDICATOR = (0b0001, 0b0010, 0b0100)
# char-count field widths for version classes (1-9, 10-26, 27-40)
_COUNT_BITS = ((10, 9, 8), (12, 11, 16), (14, 13, 16))
# per-char cost in 1/6 bits (numeric 10/3, alnum 11/2, byte 8)
_CHAR_COST6 = (20, 33, 48)


def _version_class(version: int) -> int:
    return 0 if version <= 9 else (1 if version <= 26 else 2)


def _char_modes(data: bytes) -> List[int]:
    out = []
    for b in data:
        c = chr(b)
        if c.isdigit():
            out.append(_MODE_NUM)
        elif c in _ALNUM_IDX:
            out.append(_MODE_ALNUM)
        else:
            out.append(_MODE_BYTE)
    return out


def _segment(data: bytes, vclass: int) -> List[Tuple[int, bytes]]:
    """Minimal-bit segmentation [(mode, chunk)] via DP in 1/6-bit units
    (costs ceil'd to whole bits at each mode switch)."""
    if not data:
        return [(_MODE_BYTE, b"")]
    cm = _char_modes(data)
    counts = _COUNT_BITS[vclass]
    header6 = [(4 + counts[m]) * 6 for m in range(3)]
    INF = 1 << 60
    # dp[m] = min cost ending at current char with segment of mode m
    dp = [INF] * 3
    prev_choice: List[List[int]] = []
    # a char of mode cm can be carried by mode m iff m >= cm in the
    # (num < alnum < byte) containment order
    for m in range(3):
        if m >= cm[0]:
            dp[m] = header6[m] + _CHAR_COST6[m]
    prev_choice.append([-1, -1, -1])
    for i in range(1, len(data)):
        ndp = [INF] * 3
        choice = [-1] * 3
        for m in range(3):
            if m < cm[i]:
                continue
            # continue in mode m
            best = dp[m] + _CHAR_COST6[m] if dp[m] < INF else INF
            choice[m] = m
            # or switch from another mode (close its segment: ceil)
            for pm in range(3):
                if pm == m or dp[pm] >= INF:
                    continue
                c = -(-dp[pm] // 6) * 6 + header6[m] + _CHAR_COST6[m]
                if c < best:
                    best = c
                    choice[m] = pm
            ndp[m] = best
        dp = ndp
        prev_choice.append(choice)
    m = int(np.argmin(dp))
    # backtrack
    modes = [0] * len(data)
    for i in range(len(data) - 1, -1, -1):
        modes[i] = m
        m = prev_choice[i][m] if prev_choice[i][m] >= 0 else m
    segs: List[Tuple[int, bytes]] = []
    start = 0
    for i in range(1, len(data) + 1):
        if i == len(data) or modes[i] != modes[start]:
            segs.append((modes[start], data[start:i]))
            start = i
    return segs


def _segment_bits(segs: List[Tuple[int, bytes]], vclass: int) -> int:
    total = 0
    counts = _COUNT_BITS[vclass]
    for mode, chunk in segs:
        n = len(chunk)
        total += 4 + counts[mode]
        if mode == _MODE_NUM:
            total += 10 * (n // 3) + (0, 4, 7)[n % 3]
        elif mode == _MODE_ALNUM:
            total += 11 * (n // 2) + 6 * (n % 2)
        else:
            total += 8 * n
    return total


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            b <<= (8 - min(8, len(self.bits) - i))
            out.append(b)
        return bytes(out)


def _encode_segments(segs: List[Tuple[int, bytes]], version: int,
                     level: str) -> bytes:
    vclass = _version_class(version)
    counts = _COUNT_BITS[vclass]
    w = _BitWriter()
    for mode, chunk in segs:
        if not chunk:
            continue
        w.put(_MODE_INDICATOR[mode], 4)
        w.put(len(chunk), counts[mode])
        if mode == _MODE_NUM:
            s = chunk.decode("ascii")
            for i in range(0, len(s), 3):
                g = s[i:i + 3]
                w.put(int(g), (4, 7, 10)[len(g) - 1])
        elif mode == _MODE_ALNUM:
            s = chunk.decode("ascii")
            for i in range(0, len(s), 2):
                g = s[i:i + 2]
                if len(g) == 2:
                    w.put(_ALNUM_IDX[g[0]] * 45 + _ALNUM_IDX[g[1]], 11)
                else:
                    w.put(_ALNUM_IDX[g[0]], 6)
        else:
            for b in chunk:
                w.put(b, 8)
    cap = data_codewords(version, level) * 8
    assert len(w.bits) <= cap
    w.put(0, min(4, cap - len(w.bits)))            # terminator
    if len(w.bits) % 8:
        w.put(0, 8 - len(w.bits) % 8)
    pads = (0xEC, 0x11)
    i = 0
    while len(w.bits) < cap:
        w.put(pads[i % 2], 8)
        i += 1
    return w.to_bytes()


def pick_version(data: bytes, level: str) -> Tuple[int,
                                                   List[Tuple[int, bytes]]]:
    """Smallest version fitting the optimally segmented payload."""
    segs = None
    vclass = -1
    for v in range(1, 41):
        vc = _version_class(v)
        if vc != vclass:
            vclass = vc
            segs = _segment(data, vclass)
        if _segment_bits(segs, vclass) <= data_codewords(v, level) * 8:
            return v, segs
    raise ValueError(f"qr: payload of {len(data)} bytes does not fit "
                     f"any version at level {level}")


# -- matrix construction ----------------------------------------------------

def alignment_positions(version: int) -> List[int]:
    if version == 1:
        return []
    n = version // 7 + 2
    size = symbol_size(version)
    step = 26 if version == 32 else \
        (version * 4 + n * 2 + 1) // (n * 2 - 2) * 2
    pos = [6]
    p = size - 7
    for _ in range(n - 1):
        pos.append(p)
        p -= step
    return sorted(set(pos[:1] + pos[1:][::-1] + [size - 7]))


def _bch(value: int, poly: int, poly_deg: int, total_deg: int) -> int:
    rem = value << (total_deg - poly_deg)
    v = rem
    for i in range(total_deg - 1, poly_deg - 1, -1):
        if v & (1 << i):
            v ^= poly << (i - poly_deg)
    return (value << (total_deg - poly_deg)) | v


def format_bits(level: str, mask: int) -> int:
    data = (_LEVEL_FORMAT_BITS[level] << 3) | mask
    rem = data << 10
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= 0x537 << (i - 10)
    return ((data << 10) | rem) ^ 0x5412


def version_bits(version: int) -> int:
    rem = version << 12
    for i in range(17, 11, -1):
        if rem & (1 << i):
            rem ^= 0x1F25 << (i - 12)
    return (version << 12) | rem


def _function_mask(version: int) -> np.ndarray:
    """True where modules are function patterns / format / version."""
    size = symbol_size(version)
    f = np.zeros((size, size), bool)
    for (r, c) in ((0, 0), (0, size - 8), (size - 8, 0)):
        f[r:r + 8, c:c + 8] = True            # finder + separator
    f[8, :9] = True
    f[:9, 8] = True                           # format info (TL)
    f[8, size - 8:] = True                    # format info (TR)
    f[size - 8:, 8] = True                    # format info (BL) + dark
    f[6, :] = True
    f[:, 6] = True                            # timing
    ap = alignment_positions(version)
    for r in ap:
        for c in ap:
            # only the three finder-corner positions are omitted;
            # centers on the timing pattern (v>=7) are real patterns
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) \
                    or (r > size - 10 and c < 9):
                continue
            f[r - 2:r + 3, c - 2:c + 3] = True
    if version >= 7:
        f[size - 11:size - 8, :6] = True
        f[:6, size - 11:size - 8] = True
    return f


def _draw_function_patterns(m: np.ndarray, version: int) -> None:
    size = m.shape[0]

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < size and 0 <= cc < size):
                    continue
                d = max(abs(dr - 3), abs(dc - 3))
                m[rr, cc] = d != 2 and d != 4

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    for i in range(8, size - 8):
        m[6, i] = m[i, 6] = (i % 2 == 0)
    ap = alignment_positions(version)
    for r in ap:
        for c in ap:
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) \
                    or (r > size - 10 and c < 9):
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    m[r + dr, c + dc] = max(abs(dr), abs(dc)) != 1
    m[size - 8, 8] = True                      # dark module
    if version >= 7:
        vb = version_bits(version)
        for i in range(18):
            bit = (vb >> i) & 1
            m[size - 11 + i % 3, i // 3] = bit
            m[i // 3, size - 11 + i % 3] = bit


def _draw_format(m: np.ndarray, level: str, mask: int) -> None:
    size = m.shape[0]
    fb = format_bits(level, mask)
    bits = [(fb >> i) & 1 for i in range(15)]  # bit 0 = LSB
    # first copy around the top-left finder: col 8 top-down holds bits
    # 0-5 (rows 0-5), bit 6 at (7,8), bit 7 at (8,8), bit 8 at (8,7),
    # bits 9-14 along row 8 right-to-left (cols 5-0)
    for i in range(6):
        m[i, 8] = bits[i]
    m[7, 8] = bits[6]
    m[8, 8] = bits[7]
    m[8, 7] = bits[8]
    for i in range(9, 15):
        m[8, 14 - i] = bits[i]
    # second copy: row 8 right edge holds bits 0-7 (cols size-1 down to
    # size-8); col 8 bottom edge holds bits 8-14 (rows size-7 to size-1)
    for i in range(8):
        m[8, size - 1 - i] = bits[i]
    for i in range(8, 15):
        m[size - 15 + i, 8] = bits[i]


def _place_data(m: np.ndarray, func: np.ndarray, codewords: bytes) -> None:
    size = m.shape[0]
    bits = []
    for b in codewords:
        for i in range(7, -1, -1):
            bits.append((b >> i) & 1)
    bi = 0
    col = size - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for c in (col, col - 1):
                if func[r, c]:
                    continue
                m[r, c] = bits[bi] if bi < len(bits) else 0
                bi += 1
        upward = not upward
        col -= 2


_MASK_FNS = (
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
)


def _mask_grid(size: int, mask: int) -> np.ndarray:
    rr, cc = np.mgrid[0:size, 0:size]
    fn = _MASK_FNS[mask]
    return fn(rr, cc)


def _penalty(m: np.ndarray) -> int:
    size = m.shape[0]
    score = 0
    # N1: runs of >=5 same-colour modules
    for grid in (m, m.T):
        for row in grid:
            run = 1
            for i in range(1, size):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + (run - 5)
                    run = 1
            if run >= 5:
                score += 3 + (run - 5)
    # N2: 2x2 blocks
    blocks = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    score += 3 * int(blocks.sum())
    # N3: finder-like 1011101 with 4 light on either side
    pat = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], bool)
    for grid in (m, m.T):
        g = grid.astype(bool)
        for row in g:
            for i in range(size - 10):
                w = row[i:i + 11]
                if (w == pat).all() or (w == pat[::-1]).all():
                    score += 40
    # N4: dark-module balance in 5% steps away from 50%
    dark = int(m.sum())
    k = 0
    pct = dark * 100 / (size * size)
    while not (50 - 5 * (k + 1) <= pct <= 50 + 5 * (k + 1)):
        k += 1
    return score + 10 * k


def encode(content: bytes | str, level: str = "M",
           version: Optional[int] = None,
           mask: Optional[int] = None) -> np.ndarray:
    """Encode to a [N, N] bool module matrix (True = dark).

    `level` in L/M/Q/H (gstbaseqroverlay's qrcode-error-correction enum;
    default M = DEFAULT_PROP_QUALITY 1).  `version` None = automatic
    (QRcode_encodeString version 0); `mask` None = best-penalty.
    """
    if isinstance(content, str):
        content = content.encode("utf-8")
    if level not in LEVELS:
        raise ValueError(f"qr: level must be one of {LEVELS}")
    auto_v, segs = pick_version(content, level)
    if version is None:
        version = auto_v
    else:
        segs = _segment(content, _version_class(version))
        if _segment_bits(segs, _version_class(version)) \
                > data_codewords(version, level) * 8:
            raise ValueError("qr: payload does not fit requested version")
    data = _encode_segments(segs, version, level)

    # split into blocks, compute ECC, interleave
    blocks = []
    pos = 0
    for (dn, en) in _block_structure(version, level):
        chunk = data[pos:pos + dn]
        pos += dn
        blocks.append((chunk, _rs_ecc(chunk, en)))
    inter = bytearray()
    max_d = max(len(b[0]) for b in blocks)
    for i in range(max_d):
        for d, _ in blocks:
            if i < len(d):
                inter.append(d[i])
    for i in range(len(blocks[0][1])):
        for _, e in blocks:
            inter.append(e[i])

    size = symbol_size(version)
    m = np.zeros((size, size), bool)
    func = _function_mask(version)
    _draw_function_patterns(m, version)
    _place_data(m, func, bytes(inter))

    if mask is None:
        best, best_score = 0, None
        for mk in range(8):
            cand = m ^ (_mask_grid(size, mk) & ~func)
            _draw_format(cand, level, mk)
            s = _penalty(cand)
            if best_score is None or s < best_score:
                best, best_score = mk, s
        mask = best
    out = m ^ (_mask_grid(size, mask) & ~func)
    _draw_format(out, level, mask)
    return out
