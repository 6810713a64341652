"""Dirac / VC-2 parse-unit model (gst/videoparsers/dirac_parse.c,
dirac_parse.h, gstdiracparse.c).

A Dirac stream is a sequence of parse units, each headed by
  'BBCD' (0x42424344) | parse_code u8 | next_parse_offset u32be |
  prev_parse_offset u32be                      (SCHRO_PARSE_HEADER_SIZE = 13)

The sequence header payload (after the 13-byte parse-info header) is an
interleaved-exp-Golomb bitstream: `decode_uint` reads count leading 0-bits
interleaved with value bits and yields (1 << count) - 1 + value
(dirac_parse.c:477-492 schro_unpack_decode_uint); reads past the end
return the guard bit 1 (dirac_parse.c:456-470).

Citations are to gst-plugins-bad 1.19.2 gst/videoparsers/dirac_parse.{c,h}.
A copy of the JAX package's io/dirac.py: only its imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# SchroParseCode (dirac_parse.h:15-56)
PARSE_CODE_SEQUENCE_HEADER = 0x00
PARSE_CODE_END_OF_SEQUENCE = 0x10
PARSE_CODE_AUXILIARY_DATA = 0x20
PARSE_CODE_PADDING = 0x30

PARSE_INFO_PREFIX = b"BBCD"          # 0x42424344
PARSE_HEADER_SIZE = 13               # 4 + 1 + 4 + 4 (dirac_parse.h:58)


def is_picture(parse_code: int) -> bool:
    """SCHRO_PARSE_CODE_IS_PICTURE (dirac_parse.h:49)."""
    return bool(parse_code & 0x8)


def is_seq_header(parse_code: int) -> bool:
    return parse_code == PARSE_CODE_SEQUENCE_HEADER


def is_end_of_sequence(parse_code: int) -> bool:
    return parse_code == PARSE_CODE_END_OF_SEQUENCE


def num_refs(parse_code: int) -> int:
    return parse_code & 0x3


def is_reference(parse_code: int) -> bool:
    return (parse_code & 0xC) == 0xC


def profile_name(profile: int) -> str:
    """gstdiracparse.c:219-236 get_profile_name."""
    return {0: "vc2-low-delay", 1: "vc2-simple", 2: "vc2-main",
            8: "main"}.get(profile, "unknown")


def level_name(level: int) -> str:
    """gstdiracparse.c:238-252 get_level_name (unknown levels -> '0')."""
    return {0: "0", 1: "1", 128: "128"}.get(level, "0")


class Unpack:
    """schro_unpack (dirac_parse.c:444-492): MSB-first bit reader whose
    out-of-data reads return the guard bit."""

    def __init__(self, data: bytes, guard_bit: int = 1):
        self.data = data
        self.index = 0
        self.n_bits_left = 8 * len(data)
        self.guard_bit = guard_bit

    def decode_bit(self) -> int:
        if self.n_bits_left < 1:
            return self.guard_bit
        bit = (self.data[self.index >> 3] >> (7 - (self.index & 7))) & 1
        self.index += 1
        self.n_bits_left -= 1
        return bit

    def decode_uint(self) -> int:
        count = 0
        value = 0
        while not self.decode_bit():
            count += 1
            value = (value << 1) | self.decode_bit()
        return (1 << count) - 1 + value


class Pack:
    """Inverse of Unpack for building test vectors / seq headers."""

    def __init__(self):
        self.bits: list = []

    def put_bit(self, b: int) -> "Pack":
        self.bits.append(b & 1)
        return self

    def put_uint(self, v: int) -> "Pack":
        # (1 << count) - 1 + value == v; emit count 0-bits interleaved
        # with the value bits, then the terminating 1
        count = 0
        while (1 << (count + 1)) - 1 <= v:
            count += 1
        value = v - ((1 << count) - 1)
        for i in range(count - 1, -1, -1):
            self.put_bit(0)
            self.put_bit((value >> i) & 1)
        self.put_bit(1)
        return self

    def bytes(self) -> bytes:
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            byte = 0
            for j, b in enumerate(self.bits[i:i + 8]):
                byte |= b << (7 - j)
            out.append(byte)
        return bytes(out)


@dataclasses.dataclass
class SequenceHeader:
    """DiracSequenceHeader (dirac_parse.h:130-168)."""
    major_version: int = 0
    minor_version: int = 0
    profile: int = 0
    level: int = 0
    index: int = 0
    width: int = 0
    height: int = 0
    chroma_format: int = 0
    interlaced: int = 0
    top_field_first: int = 0
    frame_rate_numerator: int = 0
    frame_rate_denominator: int = 0
    aspect_ratio_numerator: int = 0
    aspect_ratio_denominator: int = 0
    clean_width: int = 0
    clean_height: int = 0
    left_offset: int = 0
    top_offset: int = 0
    luma_offset: int = 0
    luma_excursion: int = 0
    chroma_offset: int = 0
    chroma_excursion: int = 0
    colour_primaries: int = 0
    colour_matrix: int = 0
    transfer_function: int = 0
    interlaced_coding: int = 0


# schro_video_formats (dirac_parse.c:166-302): per std index —
# (index, width, height, chroma, interlaced, tff, fr_num, fr_den,
#  par_num, par_den, clean_w, clean_h, left_off, top_off,
#  luma_off, luma_exc, chroma_off, chroma_exc,
#  colour_primaries, colour_matrix, transfer_function)
_STD_FORMATS = [
    (0, 640, 480, 2, 0, 0, 24000, 1001, 1, 1, 640, 480, 0, 0,
     0, 255, 128, 255, 0, 0, 0),
    (1, 176, 120, 2, 0, 0, 15000, 1001, 10, 11, 176, 120, 0, 0,
     0, 255, 128, 255, 1, 1, 0),
    (2, 176, 144, 2, 0, 1, 25, 2, 12, 11, 176, 144, 0, 0,
     0, 255, 128, 255, 2, 1, 0),
    (3, 352, 240, 2, 0, 0, 15000, 1001, 10, 11, 352, 240, 0, 0,
     0, 255, 128, 255, 1, 1, 0),
    (4, 352, 288, 2, 0, 1, 25, 2, 12, 11, 352, 288, 0, 0,
     0, 255, 128, 255, 2, 1, 0),
    (5, 704, 480, 2, 0, 0, 15000, 1001, 10, 11, 704, 480, 0, 0,
     0, 255, 128, 255, 1, 1, 0),
    (6, 704, 576, 2, 0, 1, 25, 2, 12, 11, 704, 576, 0, 0,
     0, 255, 128, 255, 2, 1, 0),
    (7, 720, 480, 1, 1, 0, 30000, 1001, 10, 11, 704, 480, 8, 0,
     64, 876, 512, 896, 1, 1, 0),
    (8, 720, 576, 1, 1, 1, 25, 1, 12, 11, 704, 576, 8, 0,
     64, 876, 512, 896, 2, 1, 0),
    (9, 1280, 720, 1, 0, 1, 60000, 1001, 1, 1, 1280, 720, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (10, 1280, 720, 1, 0, 1, 50, 1, 1, 1, 1280, 720, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (11, 1920, 1080, 1, 1, 1, 30000, 1001, 1, 1, 1920, 1080, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (12, 1920, 1080, 1, 1, 1, 25, 1, 1, 1, 1920, 1080, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (13, 1920, 1080, 1, 0, 1, 60000, 1001, 1, 1, 1920, 1080, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (14, 1920, 1080, 1, 0, 1, 50, 1, 1, 1, 1920, 1080, 0, 0,
     64, 876, 512, 896, 0, 0, 0),
    (15, 2048, 1080, 0, 0, 1, 24, 1, 1, 1, 2048, 1080, 0, 0,
     256, 3504, 2048, 3584, 3, 0, 0),
    (16, 4096, 2160, 0, 0, 1, 24, 1, 1, 1, 2048, 1536, 0, 0,
     256, 3504, 2048, 3584, 3, 0, 0),
]

# schro_frame_rates (dirac_parse.c:322-334) — index 0 invalid
_STD_FRAME_RATES = [(0, 0), (24000, 1001), (24, 1), (25, 1),
                    (30000, 1001), (30, 1), (50, 1), (60000, 1001),
                    (60, 1), (15000, 1001), (25, 2)]

# schro_aspect_ratios (dirac_parse.c:355-363)
_STD_ASPECT_RATIOS = [(0, 0), (1, 1), (10, 11), (12, 11), (40, 33),
                      (16, 11), (4, 3)]

# schro_signal_ranges (dirac_parse.c:386-392)
_STD_SIGNAL_RANGES = [(0, 0, 0, 0), (0, 255, 128, 255),
                      (16, 219, 128, 224), (64, 876, 512, 896),
                      (256, 3504, 2048, 3584)]

# schro_colour_specs (dirac_parse.c:414-435)
_STD_COLOUR_SPECS = [(0, 0, 0), (1, 1, 0), (2, 1, 0), (0, 0, 0),
                     (3, 0, 0)]


def _set_std_video_format(h: SequenceHeader, index: int) -> None:
    """schro_video_format_set_std_video_format (dirac_parse.c:304-315):
    out-of-range indexes leave the header untouched."""
    if not 0 <= index < len(_STD_FORMATS):
        return
    f = _STD_FORMATS[index]
    (h.index, h.width, h.height, h.chroma_format, h.interlaced,
     h.top_field_first, h.frame_rate_numerator, h.frame_rate_denominator,
     h.aspect_ratio_numerator, h.aspect_ratio_denominator,
     h.clean_width, h.clean_height, h.left_offset, h.top_offset,
     h.luma_offset, h.luma_excursion, h.chroma_offset,
     h.chroma_excursion, h.colour_primaries, h.colour_matrix,
     h.transfer_function) = f


def parse_sequence_header(data: bytes) -> SequenceHeader:
    """dirac_sequence_header_parse (dirac_parse.c:36-161): `data` is the
    payload AFTER the 13-byte parse-info header."""
    h = SequenceHeader()
    u = Unpack(data, guard_bit=1)

    major = u.decode_uint()
    minor = u.decode_uint()
    profile = u.decode_uint()
    level = u.decode_uint()

    index = u.decode_uint()
    _set_std_video_format(h, index)

    h.major_version, h.minor_version = major, minor
    h.profile, h.level = profile, level

    if u.decode_bit():                        # custom frame dimensions
        h.width = u.decode_uint()
        h.height = u.decode_uint()
    if u.decode_bit():                        # custom chroma format
        h.chroma_format = u.decode_uint()
    if u.decode_bit():                        # custom scan format
        h.interlaced = u.decode_uint()
    if u.decode_bit():                        # frame rate
        index = u.decode_uint()
        if index == 0:
            h.frame_rate_numerator = u.decode_uint()
            h.frame_rate_denominator = u.decode_uint()
        elif 1 <= index < len(_STD_FRAME_RATES):
            (h.frame_rate_numerator,
             h.frame_rate_denominator) = _STD_FRAME_RATES[index]
    if u.decode_bit():                        # pixel aspect ratio
        index = u.decode_uint()
        if index == 0:
            h.aspect_ratio_numerator = u.decode_uint()
            h.aspect_ratio_denominator = u.decode_uint()
        elif 1 <= index < len(_STD_ASPECT_RATIOS):
            (h.aspect_ratio_numerator,
             h.aspect_ratio_denominator) = _STD_ASPECT_RATIOS[index]
    if u.decode_bit():                        # clean area
        h.clean_width = u.decode_uint()
        h.clean_height = u.decode_uint()
        h.left_offset = u.decode_uint()
        h.top_offset = u.decode_uint()
    if u.decode_bit():                        # signal range
        index = u.decode_uint()
        if index == 0:
            h.luma_offset = u.decode_uint()
            h.luma_excursion = u.decode_uint()
            h.chroma_offset = u.decode_uint()
            h.chroma_excursion = u.decode_uint()
        elif 1 <= index < len(_STD_SIGNAL_RANGES):
            (h.luma_offset, h.luma_excursion, h.chroma_offset,
             h.chroma_excursion) = _STD_SIGNAL_RANGES[index]
    if u.decode_bit():                        # colour spec
        index = u.decode_uint()
        if 0 <= index < len(_STD_COLOUR_SPECS):
            (h.colour_primaries, h.colour_matrix,
             h.transfer_function) = _STD_COLOUR_SPECS[index]
        if index == 0:
            if u.decode_bit():
                h.colour_primaries = u.decode_uint()
            if u.decode_bit():
                h.colour_matrix = u.decode_uint()
            if u.decode_bit():
                h.transfer_function = u.decode_uint()

    h.interlaced_coding = u.decode_uint()
    return h


def build_parse_unit(parse_code: int, payload: bytes = b"",
                     prev_offset: int = 0) -> bytes:
    """Serialize one parse unit with a correct next_parse_offset."""
    total = PARSE_HEADER_SIZE + len(payload)
    next_off = 0 if is_end_of_sequence(parse_code) and not payload \
        else total
    return (PARSE_INFO_PREFIX + bytes([parse_code])
            + next_off.to_bytes(4, "big") + prev_offset.to_bytes(4, "big")
            + payload)


def build_sequence_header_payload(h: SequenceHeader) -> bytes:
    """Serialize a SequenceHeader back to the interleaved-exp-Golomb
    payload (custom everything — no std-index shortcuts — so parsing it
    round-trips every field)."""
    p = Pack()
    p.put_uint(h.major_version).put_uint(h.minor_version)
    p.put_uint(h.profile).put_uint(h.level)
    p.put_uint(h.index)
    p.put_bit(1).put_uint(h.width).put_uint(h.height)
    p.put_bit(1).put_uint(h.chroma_format)
    p.put_bit(1).put_uint(h.interlaced)
    p.put_bit(1).put_uint(0)
    p.put_uint(h.frame_rate_numerator).put_uint(h.frame_rate_denominator)
    p.put_bit(1).put_uint(0)
    p.put_uint(h.aspect_ratio_numerator)
    p.put_uint(h.aspect_ratio_denominator)
    p.put_bit(1).put_uint(h.clean_width).put_uint(h.clean_height)
    p.put_uint(h.left_offset).put_uint(h.top_offset)
    p.put_bit(1).put_uint(0)
    p.put_uint(h.luma_offset).put_uint(h.luma_excursion)
    p.put_uint(h.chroma_offset).put_uint(h.chroma_excursion)
    p.put_bit(1).put_uint(0)                 # colour spec custom
    p.put_bit(1).put_uint(h.colour_primaries)
    p.put_bit(1).put_uint(h.colour_matrix)
    p.put_bit(1).put_uint(h.transfer_function)
    p.put_uint(h.interlaced_coding)
    return p.bytes()
