"""(A copy of gstbad_tpu/io/barcode1d.py, numpy only.)

1-D barcode symbologies beyond EAN-13/EAN-8: Code 128, Code 39,
Code 93, Interleaved 2-of-5, Codabar and UPC-E — the rest of libzbar's
linear decoder set (ext/zbar/gstzbar.c hands frames to zbar_scan_image;
zbar/decoder/{code128,code39,code93,i25,codabar,ean}.c are the upstream
engines these replace).

Each symbology ships a `render_*` (the test oracle: text -> u8 image)
and a `scan_*` (gray image -> (text, votes) or None) built on the same
scanline run-length sweep io/qrdecode.py uses for EAN.  Decoders follow
the public symbology specs (ISO/IEC 15417 Code 128, ISO/IEC 16388
Code 39, ISO/IEC 15438-adjacent Code 93, ISO/IEC 16390 ITF, AIM
BC3-2000 Codabar, GS1 spec for UPC-E), not zbar's edge-delta internals
— detection parity is the goal, per the divergence ledger.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from gstbad_tpu_torch.io.qrdecode import _EAN_L, _EAN_G, ean13_checksum_ok

# ---------------------------------------------------------------------------
# shared scanline machinery

def _rle(row: np.ndarray) -> Tuple[List[int], List[bool]]:
    """Run-length encode a boolean (dark) scanline."""
    runs: List[int] = []
    vals: List[bool] = []
    w = len(row)
    x = 0
    while x < w:
        x2 = x + 1
        v = row[x]
        while x2 < w and row[x2] == v:
            x2 += 1
        runs.append(x2 - x)
        vals.append(bool(v))
        x = x2
    return runs, vals


def _sweep(gray: np.ndarray, decode, min_runs: int,
           min_votes: int = 1):
    """Generic scanline sweep: try `decode(tail_runs)` at every dark run
    of every sampled scanline; majority-vote agreeing decodes.

    min_votes: scanline-agreement floor — the checksum-weak
    symbologies (EAN-2's mod-4 parity, ITF/Codabar with none) demand
    >= 2 agreeing lines, which uncorrelated noise rows essentially
    never produce while a real symbol yields dozens (libzbar's
    inter-scanline consistency requirement plays the same role)."""
    h, w = gray.shape
    thresh = (int(gray.min()) + int(gray.max())) / 2.0
    votes: Dict[str, int] = {}
    for y in range(0, h, max(1, h // 32)):
        runs, vals = _rle(gray[y] < thresh)
        for i in range(len(runs) - min_runs + 1):
            if not vals[i]:
                continue
            text = decode([float(r) for r in runs[i:]])
            if text:
                votes[text] = votes.get(text, 0) + 1
    votes = {t: v for t, v in votes.items() if v >= min_votes}
    if not votes:
        return None
    return max(votes.items(), key=lambda kv: kv[1])


def _bits_to_image(bits: str, module_px: int, height: int,
                   quiet: int = 10) -> np.ndarray:
    row = np.array([c == "1" for c in bits])
    img = np.where(np.repeat(row, module_px), 0, 255).astype(np.uint8)
    img = np.tile(img[None, :], (height, 1))
    pad = quiet * module_px
    return np.pad(img, ((pad, pad), (pad, pad)), constant_values=255)


def _wide_narrow(runs: List[float], nwide: int):
    """Classify a fixed-length run group into wide(1)/narrow(0) with
    exactly `nwide` wides, or None if the widths don't separate."""
    lo, hi = min(runs), max(runs)
    if hi < 1.6 * lo:
        return None
    t = (lo + hi) / 2.0
    pat = "".join("1" if r > t else "0" for r in runs)
    if pat.count("1") != nwide:
        return None
    return pat


# ---------------------------------------------------------------------------
# Code 39 (ISO/IEC 16388): 9 elements/char (5 bars, 4 spaces), 3 wide;
# chars separated by a narrow inter-character gap; '*' start/stop.

_C39 = {
    "0": "000110100", "1": "100100001", "2": "001100001",
    "3": "101100000", "4": "000110001", "5": "100110000",
    "6": "001110000", "7": "000100101", "8": "100100100",
    "9": "001100100", "A": "100001001", "B": "001001001",
    "C": "101001000", "D": "000011001", "E": "100011000",
    "F": "001011000", "G": "000001101", "H": "100001100",
    "I": "001001100", "J": "000011100", "K": "100000011",
    "L": "001000011", "M": "101000010", "N": "000010011",
    "O": "100010010", "P": "001010010", "Q": "000000111",
    "R": "100000110", "S": "001000110", "T": "000010110",
    "U": "110000001", "V": "011000001", "W": "111000000",
    "X": "010010001", "Y": "110010000", "Z": "011010000",
    "-": "010000101", ".": "110000100", " ": "011000100",
    "*": "010010100", "$": "010101000", "/": "010100010",
    "+": "010001010", "%": "000101010",
}
_C39_REV = {v: k for k, v in _C39.items()}


def render_code39(text: str, module_px: int = 2, height: int = 40,
                  wide: int = 3) -> np.ndarray:
    """'*TEXT*' as a u8 image; wide elements are `wide` modules."""
    bits = ""
    for ch in "*" + text.upper() + "*":
        pat = _C39[ch]
        for i, wn in enumerate(pat):
            n = wide if wn == "1" else 1
            bits += ("1" if i % 2 == 0 else "0") * n
        bits += "0"                       # inter-character narrow gap
    return _bits_to_image(bits[:-1], module_px, height)


def _decode_code39(runs: List[float]) -> Optional[str]:
    out = []
    pos = 0
    while True:
        if pos + 9 > len(runs):
            return None
        pat = _wide_narrow(runs[pos:pos + 9], 3)
        ch = _C39_REV.get(pat) if pat else None
        if ch is None:
            return None
        if not out and ch != "*":
            return None
        out.append(ch)
        pos += 9
        if len(out) > 1 and ch == "*":
            # checksum-less symbology: demand the trailing quiet zone
            # after the closing '*' so a slice of another symbol can't
            # decode as Code 39 (mirrors the Codabar decoder; ADVICE r4)
            narrow = min(runs[pos - 9:pos])
            if pos < len(runs) and runs[pos] < 4.0 * narrow:
                return None
            break
        # inter-character gap: one light run no wider than a wide element
        if pos >= len(runs):
            return None
        narrow = min(runs[pos - 9:pos])
        if runs[pos] > 4.0 * narrow:
            return None
        pos += 1
    body = "".join(out[1:-1])
    return body if body else None


def scan_code39(gray: np.ndarray):
    # no checksum -> gate at 2 agreeing scanlines like ITF/Codabar
    return _sweep(gray, _decode_code39, 9 + 1 + 9, min_votes=2)


# ---------------------------------------------------------------------------
# Code 128 (ISO/IEC 15417): 11-module chars of 6 elements, mod-103
# checksum, 13-module stop.

_C128 = (
    "212222", "222122", "222221", "121223", "121322", "131222",
    "122213", "122312", "132212", "221213", "221312", "231212",
    "112232", "122132", "122231", "113222", "123122", "123221",
    "223211", "221132", "221231", "213212", "223112", "312131",
    "311222", "321122", "321221", "312212", "322112", "322211",
    "212123", "212321", "232121", "111323", "131123", "131321",
    "112313", "132113", "132311", "211313", "231113", "231311",
    "112133", "112331", "132131", "113123", "113321", "133121",
    "313121", "211331", "231131", "213113", "213311", "213131",
    "311123", "311321", "331121", "312113", "312311", "332111",
    "314111", "221411", "431111", "111224", "111422", "121124",
    "121421", "141122", "141221", "112214", "112412", "122114",
    "122411", "142112", "142211", "241211", "221114", "413111",
    "241112", "134111", "111242", "121142", "121241", "114212",
    "124112", "124211", "411212", "421112", "421211", "212141",
    "214121", "412121", "111143", "111341", "131141", "114113",
    "114311", "411113", "411311", "113141", "114131", "311141",
    "411131", "211412", "211214", "211232",
)
_C128_REV = {p: i for i, p in enumerate(_C128)}
_C128_STOP = "2331112"


def _c128_char_b(ch: str) -> int:
    o = ord(ch)
    if not 32 <= o <= 127:
        raise ValueError(f"code128 set B cannot encode {ch!r}")
    return o - 32


def render_code128(text: str, module_px: int = 2,
                   height: int = 40, digits_as_c: bool = False
                   ) -> np.ndarray:
    """Set-B encoding (or Set C when digits_as_c and text is an
    even-length digit string) with the mod-103 check character."""
    if digits_as_c:
        assert text.isdigit() and len(text) % 2 == 0
        vals = [105] + [int(text[i:i + 2]) for i in range(0, len(text), 2)]
    else:
        vals = [104] + [_c128_char_b(c) for c in text]
    check = vals[0]
    for i, v in enumerate(vals[1:], start=1):
        check += i * v
    vals.append(check % 103)
    bits = ""
    for v in vals:
        for i, wstr in enumerate(_C128[v]):
            bits += ("1" if i % 2 == 0 else "0") * int(wstr)
    for i, wstr in enumerate(_C128_STOP):
        bits += ("1" if i % 2 == 0 else "0") * int(wstr)
    return _bits_to_image(bits, module_px, height)


def _c128_read(runs: List[float], nmod: int) -> Optional[str]:
    unit = sum(runs) / nmod
    if unit <= 0:
        return None
    out = ""
    total = 0
    for r in runs:
        m = int(round(r / unit))
        if not 1 <= m <= 4:
            return None
        out += str(m)
        total += m
    return out if total == nmod else None


def _decode_code128(runs: List[float]) -> Optional[str]:
    if len(runs) < 6:
        return None
    start = _C128_REV.get(_c128_read(runs[:6], 11) or "")
    if start not in (103, 104, 105):
        return None
    vals = [start]
    pos = 6
    while True:
        if pos + 7 <= len(runs) \
                and _c128_read(runs[pos:pos + 7], 13) == _C128_STOP:
            break
        if pos + 6 > len(runs) or len(vals) > 256:
            return None
        v = _C128_REV.get(_c128_read(runs[pos:pos + 6], 11) or "")
        if v is None:
            return None
        vals.append(v)
        pos += 6
    if len(vals) < 3:
        return None
    check = vals[0]
    for i, v in enumerate(vals[1:-1], start=1):
        check += i * v
    if check % 103 != vals[-1]:
        return None
    # translate vals[1:-1] per code-set semantics
    code = {103: "A", 104: "B", 105: "C"}[vals[0]]
    shift = None
    text = ""
    for v in vals[1:-1]:
        cur = shift or code
        shift = None
        if cur == "C":
            if v < 100:
                text += f"{v:02d}"
            elif v == 100:
                code = "B"
            elif v == 101:
                code = "A"
            continue
        if v == 99:
            code = "C"
        elif v == 100:
            code = "B" if cur == "A" else code   # B: FNC4 — ignored
        elif v == 101:
            code = "A" if cur == "B" else code   # A: FNC4 — ignored
        elif v == 98:
            shift = "B" if cur == "A" else "A"
        elif v >= 96:                            # FNC1-3
            continue
        elif cur == "A":
            text += chr(v + 32) if v < 64 else chr(v - 64)
        else:
            text += chr(v + 32)
    return text or None


def scan_code128(gray: np.ndarray):
    return _sweep(gray, _decode_code128, 6 + 6 + 7)


# ---------------------------------------------------------------------------
# Code 93: 9-module chars of 6 elements, C+K check chars, '*' delimiters
# plus a termination bar.

_C93_CHARS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ-. $/+%\x01\x02\x03\x04"
_C93 = (
    "131112", "111213", "111312", "111411", "121113", "121212",
    "121311", "111114", "131211", "141111", "211113", "211212",
    "211311", "221112", "221211", "231111", "112113", "112212",
    "112311", "122112", "132111", "111123", "111222", "111321",
    "121122", "131121", "212112", "212211", "211122", "211221",
    "221121", "222111", "112122", "112221", "122121", "123111",
    "121131", "311112", "311211", "321111", "112131", "113121",
    "211131", "121221", "312111", "311121", "122211",
)
_C93_START = "111141"
_C93_REV = {p: i for i, p in enumerate(_C93)}


def render_code93(text: str, module_px: int = 2,
                  height: int = 40) -> np.ndarray:
    vals = [_C93_CHARS.index(c) for c in text.upper()]
    # check chars C (weights 1..20) then K (weights 1..15)
    c = sum(v * (1 + (len(vals) - 1 - i) % 20)
            for i, v in enumerate(vals)) % 47
    vk = vals + [c]
    k = sum(v * (1 + (len(vk) - 1 - i) % 15)
            for i, v in enumerate(vk)) % 47
    seq = [_C93_START] + [_C93[v] for v in vals + [c, k]] + [_C93_START]
    bits = ""
    for pat in seq:
        for i, wstr in enumerate(pat):
            bits += ("1" if i % 2 == 0 else "0") * int(wstr)
    bits += "1"                                   # termination bar
    return _bits_to_image(bits, module_px, height)


def _decode_code93(runs: List[float]) -> Optional[str]:
    if len(runs) < 6 or _c128_read(runs[:6], 9) != _C93_START:
        return None
    vals: List[int] = []
    pos = 6
    while True:
        if pos + 6 > len(runs) or len(vals) > 256:
            return None
        pat = _c128_read(runs[pos:pos + 6], 9)
        if pat == _C93_START:
            pos += 6
            break
        v = _C93_REV.get(pat or "")
        if v is None:
            return None
        vals.append(v)
        pos += 6
    if len(vals) < 3 or pos >= len(runs):
        return None
    if len(vals) > 2:
        body, cc, kk = vals[:-2], vals[-2], vals[-1]
        c = sum(v * (1 + (len(body) - 1 - i) % 20)
                for i, v in enumerate(body)) % 47
        vk = body + [cc]
        k = sum(v * (1 + (len(vk) - 1 - i) % 15)
                for i, v in enumerate(vk)) % 47
        if c != cc or k != kk:
            return None
    text = "".join(_C93_CHARS[v] for v in body)
    return text if text and all(ord(ch) >= 32 for ch in text) else None


def scan_code93(gray: np.ndarray):
    return _sweep(gray, _decode_code93, 6 * 5 + 1)


# ---------------------------------------------------------------------------
# Interleaved 2-of-5: digit pairs (bars = first digit, spaces = second),
# 2 of 5 elements wide; start 4 narrow, stop wide-narrow-narrow.

_I25 = ("00110", "10001", "01001", "11000", "00101",
        "10100", "01100", "00011", "10010", "01010")


def render_itf(digits: str, module_px: int = 2, height: int = 40,
               wide: int = 3) -> np.ndarray:
    assert digits.isdigit() and len(digits) % 2 == 0
    bits = "1010"
    for i in range(0, len(digits), 2):
        b = _I25[int(digits[i])]
        s = _I25[int(digits[i + 1])]
        for j in range(5):
            bits += "1" * (wide if b[j] == "1" else 1)
            bits += "0" * (wide if s[j] == "1" else 1)
    bits += "1" * wide + "0" + "1"
    return _bits_to_image(bits, module_px, height)


def _decode_itf(runs: List[float]) -> Optional[str]:
    if len(runs) < 4 + 10 * 2 + 3:
        return None
    # start: 4 narrow runs
    narrow = sum(runs[:4]) / 4.0
    if max(runs[:4]) > 1.5 * min(runs[:4]):
        return None
    digits = ""
    pos = 4
    while True:
        # stop: wide bar, narrow space, narrow bar, then the quiet zone
        # (a digit pair can open with the same three elements — '8' has
        # a wide first bar — so the quiet zone is what disambiguates)
        if pos + 3 <= len(runs) and runs[pos] > 1.6 * narrow \
                and runs[pos + 1] < 1.6 * narrow \
                and runs[pos + 2] < 1.6 * narrow \
                and (pos + 3 == len(runs)
                     or runs[pos + 3] >= 4.0 * narrow) \
                and len(digits) >= 4:
            break
        if pos + 10 > len(runs) or len(digits) > 64:
            return None
        grp = runs[pos:pos + 10]
        bars = _wide_narrow(grp[0::2], 2)
        spcs = _wide_narrow(grp[1::2], 2)
        if bars is None or spcs is None or bars not in _I25 \
                or spcs not in _I25:
            return None
        digits += str(_I25.index(bars)) + str(_I25.index(spcs))
        pos += 10
    return digits


def scan_itf(gray: np.ndarray):
    return _sweep(gray, _decode_itf, 4 + 20 + 3, min_votes=2)


# ---------------------------------------------------------------------------
# Codabar (AIM BC3): 7 elements/char, narrow inter-character gaps,
# A-D start/stop characters (reported in the symbol, like zbar).

_CODABAR = {
    "0": "0000011", "1": "0000110", "2": "0001001", "3": "1100000",
    "4": "0010010", "5": "1000010", "6": "0100001", "7": "0100100",
    "8": "0110000", "9": "1001000", "-": "0001100", "$": "0011000",
    ":": "1000101", "/": "1010001", ".": "1010100", "+": "0010101",
    "A": "0011010", "B": "0101001", "C": "0001011", "D": "0001110",
}
_CODABAR_REV = {v: k for k, v in _CODABAR.items()}


def render_codabar(text: str, module_px: int = 2, height: int = 40,
                   wide: int = 3) -> np.ndarray:
    """`text` must include the A-D start/stop chars, e.g. 'A40156B'."""
    assert text[0] in "ABCD" and text[-1] in "ABCD"
    bits = ""
    for ch in text.upper():
        pat = _CODABAR[ch]
        for i, wn in enumerate(pat):
            bits += ("1" if i % 2 == 0 else "0") * (
                wide if wn == "1" else 1)
        bits += "0"
    return _bits_to_image(bits[:-1], module_px, height)


def _decode_codabar(runs: List[float]) -> Optional[str]:
    out = []
    pos = 0
    while True:
        if pos + 7 > len(runs):
            return None
        grp = runs[pos:pos + 7]
        pat = _wide_narrow(grp, 2) or _wide_narrow(grp, 3)
        ch = _CODABAR_REV.get(pat) if pat else None
        if ch is None:
            return None
        if not out and ch not in "ABCD":
            return None
        out.append(ch)
        pos += 7
        if len(out) > 1 and ch in "ABCD":
            # checksum-less symbology: demand the trailing quiet zone
            # so a slice of another symbol can't decode as Codabar
            narrow = min(grp)
            if pos < len(runs) and runs[pos] < 4.0 * narrow:
                return None
            break
        if pos >= len(runs):
            return None
        narrow = min(grp)
        if runs[pos] > 4.0 * narrow:
            return None
        pos += 1
    # min 2 body chars (zbar won't report shorter codabar either)
    return "".join(out) if len(out) > 3 else None


def scan_codabar(gray: np.ndarray):
    return _sweep(gray, _decode_codabar, 7 + 1 + 7 + 1 + 7,
                  min_votes=2)


# ---------------------------------------------------------------------------
# UPC-E: 51 modules — start 101, six L/G digits (parity encodes the
# check digit + number system), end guard 010101.

_UPCE_PARITY = ("EEEOOO", "EEOEOO", "EEOOEO", "EEOOOE", "EOEEOO",
                "EOOEEO", "EOOOEE", "EOEOEO", "EOEOOE", "EOOEOE")


def upce_expand(digits8: str) -> str:
    """UPC-E -> UPC-A 12-digit expansion (GS1 rules)."""
    ns, body, check = digits8[0], digits8[1:7], digits8[7]
    last = body[5]
    if last in "012":
        upca = ns + body[:2] + last + "0000" + body[2:5]
    elif last == "3":
        upca = ns + body[:3] + "00000" + body[3:5]
    elif last == "4":
        upca = ns + body[:4] + "00000" + body[4]
    else:
        upca = ns + body[:5] + "0000" + last
    return upca + check


def render_upce(digits8: str, module_px: int = 3,
                height: int = 60) -> np.ndarray:
    assert len(digits8) == 8 and digits8.isdigit()
    assert digits8[0] in "01"
    assert ean13_checksum_ok("0" + upce_expand(digits8))
    parity = _UPCE_PARITY[int(digits8[7])]
    if digits8[0] == "1":                       # NS 1 inverts the parity
        parity = parity.translate(str.maketrans("EO", "OE"))
    bits = "101"
    for i, d in enumerate(digits8[1:7]):
        bits += (_EAN_G[int(d)] if parity[i] == "E" else _EAN_L[int(d)])
    bits += "010101"
    row = np.array([c == "1" for c in bits])
    img = np.where(np.repeat(row, module_px), 0, 255).astype(np.uint8)
    img = np.tile(img[None, :], (height, 1))
    pad = 9 * module_px
    return np.pad(img, ((pad, pad), (pad, pad)), constant_values=255)


def _decode_upce_runs(widths: List[float]) -> Optional[str]:
    if len(widths) != 33:
        return None
    unit = sum(widths) / 51.0
    guard = widths[:3] + widths[27:]
    if any(abs(g - unit) > 0.6 * unit for g in guard):
        return None

    def match(pats, runs):
        best, besterr = None, None
        for di, pat in enumerate(pats):
            prun = []
            cur, cnt = pat[0], 0
            for ch in pat:
                if ch == cur:
                    cnt += 1
                else:
                    prun.append(cnt)
                    cur, cnt = ch, 1
            prun.append(cnt)
            if len(prun) != 4:
                continue
            err = sum(abs(r - p * unit) for r, p in zip(runs, prun))
            if besterr is None or err < besterr:
                best, besterr = di, err
        if best is None or besterr > 3.5 * unit:
            return None
        return best

    digits = ""
    parity = ""
    pos = 3
    for _ in range(6):
        runs = widths[pos:pos + 4]
        dl = match(_EAN_L, runs)
        dg = match(_EAN_G, runs)
        if dl is not None and dg is not None:
            # both matched: keep the closer fit (same tiebreak as EAN-13)
            dl_err = _pat_err(_EAN_L[dl], runs, unit)
            dg_err = _pat_err(_EAN_G[dg], runs, unit)
            if dl_err <= dg_err:
                dg = None
            else:
                dl = None
        if dl is not None:
            digits += str(dl)
            parity += "O"
        elif dg is not None:
            digits += str(dg)
            parity += "E"
        else:
            return None
        pos += 4
    for ns in "01":
        p = parity if ns == "0" else parity.translate(
            str.maketrans("EO", "OE"))
        if p in _UPCE_PARITY:
            check = _UPCE_PARITY.index(p)
            full = ns + digits + str(check)
            if ean13_checksum_ok("0" + upce_expand(full)):
                return full
    return None


def _pat_err(pat: str, runs: List[float], unit: float) -> float:
    prun: List[int] = []
    cur, cnt = pat[0], 0
    for ch in pat:
        if ch == cur:
            cnt += 1
        else:
            prun.append(cnt)
            cur, cnt = ch, 1
    prun.append(cnt)
    return sum(abs(r - p * unit) for r, p in zip(runs, prun))


def _decode_upce(runs: List[float]) -> Optional[str]:
    if len(runs) < 33:
        return None
    return _decode_upce_runs(runs[:33])


def scan_upce(gray: np.ndarray):
    return _sweep(gray, _decode_upce, 33, min_votes=2)


# ---------------------------------------------------------------------------
# EAN-2 / EAN-5 add-ons (GS1: supplement symbols; zbar ZBAR_EAN2/EAN5).
# Structure: guard 1011, digits of 7 modules L/G separated by 01;
# EAN-2 parity = value mod 4, EAN-5 parity = (3*odd + 9*even) mod 10.

_EAN5_PARITY = ("GGLLL", "GLGLL", "GLLGL", "GLLLG", "LGGLL",
                "LLGGL", "LLLGG", "LGLGL", "LGLLG", "LLGLG")
_EAN2_PARITY = ("LL", "LG", "GL", "GG")


def _addon_bits(digits: str, parity: str) -> str:
    bits = "1011"
    for i, d in enumerate(digits):
        if i:
            bits += "01"
        bits += (_EAN_L if parity[i] == "L" else _EAN_G)[int(d)]
    return bits


def render_ean2(digits: str, module_px: int = 3,
                height: int = 60) -> np.ndarray:
    assert len(digits) == 2 and digits.isdigit()
    parity = _EAN2_PARITY[int(digits) % 4]
    return _bits_to_image(_addon_bits(digits, parity), module_px,
                          height, quiet=9)


def render_ean5(digits: str, module_px: int = 3,
                height: int = 60) -> np.ndarray:
    assert len(digits) == 5 and digits.isdigit()
    c = (3 * (int(digits[0]) + int(digits[2]) + int(digits[4]))
         + 9 * (int(digits[1]) + int(digits[3]))) % 10
    return _bits_to_image(_addon_bits(digits, _EAN5_PARITY[c]),
                          module_px, height, quiet=9)


def _decode_addon(runs: List[float], ndig: int) -> Optional[str]:
    nruns = 3 + 4 * ndig + 2 * (ndig - 1)
    nmod = 4 + 7 * ndig + 2 * (ndig - 1)
    if len(runs) < nruns:
        return None
    tail = runs[nruns:]
    runs = runs[:nruns]
    unit = sum(runs) / nmod
    # add-ons have no end guard: the RIGHT quiet zone is the delimiter
    # (and the only thing separating a 2-digit parse from the middle of
    # some other symbol — EAN-2's mod-4 parity alone is 1-in-4)
    if tail and tail[0] < 5.0 * unit:
        return None
    # guard 1011 -> runs 1,1,2
    if abs(runs[0] - unit) > 0.6 * unit or \
            abs(runs[1] - unit) > 0.6 * unit or \
            abs(runs[2] - 2 * unit) > 0.7 * unit:
        return None
    digits = ""
    parity = ""
    pos = 3
    for i in range(ndig):
        if i:
            # 01 separator
            if abs(runs[pos] - unit) > 0.6 * unit or \
                    abs(runs[pos + 1] - unit) > 0.6 * unit:
                return None
            pos += 2
        grp = runs[pos:pos + 4]
        dl = dg = None
        el = eg = None
        for di in range(10):
            e = _pat_err(_EAN_L[di], grp, unit)
            if el is None or e < el:
                dl, el = di, e
            e = _pat_err(_EAN_G[di], grp, unit)
            if eg is None or e < eg:
                dg, eg = di, e
        if min(el, eg) > 3.5 * unit:
            return None
        if el <= eg:
            digits += str(dl)
            parity += "L"
        else:
            digits += str(dg)
            parity += "G"
        pos += 4
    if ndig == 2:
        if _EAN2_PARITY[int(digits) % 4] != parity:
            return None
    else:
        c = (3 * (int(digits[0]) + int(digits[2]) + int(digits[4]))
             + 9 * (int(digits[1]) + int(digits[3]))) % 10
        if _EAN5_PARITY[c] != parity:
            return None
    return digits


def scan_ean2(gray: np.ndarray):
    return _sweep(gray, lambda r: _decode_addon(r, 2), 11,
                  min_votes=2)


def scan_ean5(gray: np.ndarray):
    return _sweep(gray, lambda r: _decode_addon(r, 5), 29,
                  min_votes=2)
