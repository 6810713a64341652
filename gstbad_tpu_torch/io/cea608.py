"""(A copy of gstbad_tpu/io/cea608.py, numpy only.)

CEA-608/708 caption format conversions (ext/closedcaption/
gstccconverter.c).

Byte-level converters between the caption representations the reference's
ccconverter element negotiates:

- raw CEA-608: byte pairs (field 1 assumed, gstccconverter.c:1521-1528)
- CEA-608 S334-1A: triplets (field byte, pair) — the in-framework "cc"
  plane layout
- CEA-708 cc_data: triplets (0xF8|valid|type, pair)
- CEA-708 CDP: the 0x9669 packet (framerate id, flags, sequence counter,
  0x72 cc_data section padded to the framerate's max_cc_count with
  0xFA 00 00, 0x74 footer with additive checksum,
  gstccconverter.c:1037-1153)

Timecode sections (0x71) are parsed and skipped on input and not written
on output (our frames carry PTS, not SMPTE timecodes — documented
divergence from cdp-mode=time-code).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# (fps_n, fps_d) -> (fps_idx, max_cc_count) (gstccconverter.c:483-492)
CDP_FPS_TABLE = {
    (24000, 1001): (0x1F, 25),
    (24, 1): (0x2F, 25),
    (25, 1): (0x3F, 24),
    (30000, 1001): (0x4F, 20),
    (30, 1): (0x5F, 20),
    (50, 1): (0x6F, 12),
    (60000, 1001): (0x7F, 10),
    (60, 1): (0x8F, 10),
}
FPS_BY_IDX = {v[0]: (k, v[1]) for k, v in CDP_FPS_TABLE.items()}


def raw_to_s334(raw: bytes) -> bytes:
    """Pairs -> S334 triplets, all field 1 (gstccconverter.c:1521-1528)."""
    n = min(len(raw) // 2, 3)
    out = bytearray()
    for i in range(n):
        out += bytes([0x80, raw[i * 2], raw[i * 2 + 1]])
    return bytes(out)


def s334_to_raw(s334: bytes) -> bytes:
    """Keep field-1 pairs only (gstccconverter.c:1671-1677)."""
    n = min(len(s334) // 3, 3)
    out = bytearray()
    for i in range(n):
        if s334[i * 3] & 0x80:
            out += s334[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def s334_to_cc_data(s334: bytes) -> bytes:
    """0xFC (field 1) / 0xFD (field 2) triplets
    (gstccconverter.c:1712-1716)."""
    n = min(len(s334) // 3, 3)
    out = bytearray()
    for i in range(n):
        out.append(0xFC if s334[i * 3] & 0x80 else 0xFD)
        out += s334[i * 3 + 1:i * 3 + 3]
    return bytes(out)


def compact_cc_data(cc_data: bytes) -> bytes:
    """Drop padding/invalid triplets before the CCP section
    (gstccconverter.c:603-648)."""
    n = len(cc_data) // 3
    out = bytearray()
    started_ccp = False
    for i in range(n):
        b = cc_data[i * 3]
        cc_valid = (b & 0x04) == 0x04
        cc_type = b & 0x03
        if not started_ccp and cc_type in (0, 1):
            if cc_valid:
                out += cc_data[i * 3:i * 3 + 3]
            continue
        if cc_type & 0x10:
            started_ccp = True
        if not cc_valid:
            continue
        if cc_type in (0, 1):
            return b""         # cea608 bytes after cea708: invalid
        out += cc_data[i * 3:i * 3 + 3]
    return bytes(out)


def cc_data_to_s334(cc_data: bytes) -> bytes:
    """Extract the leading 608 triplets as S334 (cc_data_extract_cea608,
    gstccconverter.c:651-719; type 0 = field 1 -> 0x80)."""
    n = len(cc_data) // 3
    out = bytearray()
    for i in range(n):
        b = cc_data[i * 3]
        cc_valid = (b & 0x04) == 0x04
        cc_type = b & 0x03
        if cc_type == 0x00:
            if cc_valid:
                out += bytes([0x80]) + cc_data[i * 3 + 1:i * 3 + 3]
        elif cc_type == 0x01:
            if cc_valid:
                out += bytes([0x00]) + cc_data[i * 3 + 1:i * 3 + 3]
        else:
            break              # 608 only at the start of cc_data
    return bytes(out)


def cc_data_to_cdp(cc_data: bytes, fps: Tuple[int, int],
                   sequence: int = 0) -> bytes:
    """convert_cea708_cc_data_cea708_cdp_internal
    (gstccconverter.c:1037-1153), cdp-mode=cc-data."""
    fps_idx, max_cc = CDP_FPS_TABLE[fps]
    cc_data = cc_data[:3 * max_cc]
    out = bytearray()
    out += (0x9669).to_bytes(2, "big")
    out.append(0)                       # length, patched below
    out.append(fps_idx)
    out.append(0x02 | 0x40 | 0x01)      # active | ccdata_present | reserved
    out += (sequence & 0xFFFF).to_bytes(2, "big")
    out.append(0x72)
    out.append(0xE0 | max_cc)
    out += cc_data
    pad = max_cc - len(cc_data) // 3
    out += bytes([0xFA, 0x00, 0x00]) * pad
    out.append(0x74)
    out += (sequence & 0xFFFF).to_bytes(2, "big")
    out.append(0)                       # checksum, patched below
    out[2] = len(out)
    checksum = (256 - (sum(out) & 0xFF)) & 0xFF
    out[-1] = checksum
    return bytes(out)


def cdp_to_cc_data(cdp: bytes) -> Tuple[bytes, Optional[Tuple[int, int]]]:
    """convert_cea708_cdp_cea708_cc_data_internal
    (gstccconverter.c:1155-1300): returns (cc_data, fps) or (b'', None)."""
    if len(cdp) < 11 or cdp[0] != 0x96 or cdp[1] != 0x69:
        return b"", None
    if cdp[2] != len(cdp):
        return b"", None
    if cdp[3] not in FPS_BY_IDX:
        return b"", None
    fps, _max_cc = FPS_BY_IDX[cdp[3]]
    flags = cdp[4]
    if (flags & 0x40) == 0:
        return b"", None
    pos = 7
    if flags & 0x80:                    # time_code section
        if len(cdp) - pos < 5 or cdp[pos] != 0x71:
            return b"", None
        pos += 5
    if pos >= len(cdp) or cdp[pos] != 0x72:
        return b"", None
    count = cdp[pos + 1] & 0x1F
    pos += 2
    cc_data = cdp[pos:pos + 3 * count]
    return cc_data, fps
