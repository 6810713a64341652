"""MPEG-1/2 video elementary stream parsing
(gst/videoparsers/gstmpegvideoparse.c over codecparsers'
gstmpegvideoparser.c).

Sequence header (start code 0xB3): 12-bit width/height, aspect code,
frame-rate code (the MPEG table), 18-bit bitrate.  Sequence extension
(0xB5, id 1): profile/level, progressive, chroma format, 2-bit size
extensions, fps extension.  Picture headers (0x00) carry the 3-bit
coding type.  GA94 user data (0xB2) carries CEA-708 cc triplets
(ATSC A/53: 'GA94' 0x03, process_cc_data/cc_count, 3-byte cc packets)
— what the upstream test_parse_cea708_captions pulls as
GstVideoCaptionMeta.

Frame splitting follows gst_mpeg_video_parse's state walk
(gstmpegvideoparse.c:495-545): a PICTURE ends the previous frame when
one is already open, SEQUENCE always starts a frame, GOP starts one
only with gop-split (else it aggregates with the sequence header).
A copy of the JAX package's io/mpegvideo.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PACKET_PICTURE = 0x00
PACKET_SLICE_MIN = 0x01
PACKET_SLICE_MAX = 0xAF
PACKET_USER_DATA = 0xB2
PACKET_SEQUENCE = 0xB3
PACKET_EXTENSION = 0xB5
PACKET_SEQUENCE_END = 0xB7
PACKET_GOP = 0xB8

PICTURE_I = 1
PICTURE_P = 2
PICTURE_B = 3

# MPEG frame_rate_code table
FPS_TABLE = [(0, 0), (24000, 1001), (24, 1), (25, 1), (30000, 1001),
             (30, 1), (50, 1), (60000, 1001), (60, 1)]

# MPEG-2 aspect_ratio_information: 1 = square PAR, others are DARs
DAR_TABLE = {2: (4, 3), 3: (16, 9), 4: (221, 100)}

# MPEG-1 pel_aspect_ratio table (par as height:width scaled), the
# common entries gst exposes
MPEG1_PAR = {1: (1, 1), 2: (10000, 6735), 3: (10000, 7031),
             8: (10000, 11250), 12: (10000, 15000)}

PROFILES = {1: "high", 2: "spatial", 3: "snr", 4: "main", 5: "simple"}
LEVELS = {4: "high", 6: "high-1440", 8: "main", 10: "low"}


@dataclass
class SeqHdr:
    width: int = 0
    height: int = 0
    aspect_code: int = 0
    fps_code: int = 0
    fps_n: int = 0
    fps_d: int = 0
    bitrate: int = 0
    # from the sequence extension (MPEG-2)
    mpeg2: bool = False
    profile: Optional[str] = None
    level: Optional[str] = None
    progressive: bool = True
    raw: bytes = b""


def split_startcodes(data: bytes) -> List[Tuple[int, int]]:
    """[(offset_of_startcode, code), ...] for 00 00 01 xx."""
    out = []
    i = 0
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0 or i + 3 >= len(data):
            break
        out.append((i, data[i + 3]))
        i += 3
    return out


def parse_sequence_header(data: bytes) -> SeqHdr:
    """data starts AFTER the 00 00 01 B3 start code."""
    hdr = SeqHdr()
    v = int.from_bytes(data[:8], "big")
    hdr.width = (v >> 52) & 0xFFF
    hdr.height = (v >> 40) & 0xFFF
    hdr.aspect_code = (v >> 36) & 0xF
    hdr.fps_code = (v >> 32) & 0xF
    hdr.bitrate = (v >> 14) & 0x3FFFF
    if hdr.fps_code < len(FPS_TABLE):
        hdr.fps_n, hdr.fps_d = FPS_TABLE[hdr.fps_code]
    return hdr


def parse_sequence_extension(data: bytes, hdr: SeqHdr) -> None:
    """0xB5 payload with extension id 1 (after the start code)."""
    if (data[0] >> 4) != 1:
        return
    hdr.mpeg2 = True
    profile = data[0] & 0x7 if not (data[0] & 0x8) else 0
    level = (data[1] >> 4) & 0xF
    hdr.profile = PROFILES.get(profile)
    hdr.level = LEVELS.get(level)
    hdr.progressive = bool(data[1] & 0x08)
    horiz_ext = ((data[1] & 0x01) << 1) | (data[2] >> 7)
    vert_ext = (data[2] >> 5) & 0x3
    hdr.width |= horiz_ext << 12
    hdr.height |= vert_ext << 12
    fps_ext_n = (data[5] >> 5) & 0x3
    fps_ext_d = data[5] & 0x1F
    if hdr.fps_n:
        hdr.fps_n *= fps_ext_n + 1
        hdr.fps_d *= fps_ext_d + 1


def picture_type(data: bytes) -> int:
    """Picture header payload: 10-bit temporal ref then 3-bit type."""
    v = int.from_bytes(data[:2], "big")
    return (v >> 3) & 0x7


# ---------------------------------------------- decoder-layer parses
# (gstmpegvideoparser.c parse_picture_header / parse_picture_extension
#  / parse_gop — the fields gstmpeg2decoder.c consumes)

PICTURE_STRUCTURE_TOP = 1
PICTURE_STRUCTURE_BOTTOM = 2
PICTURE_STRUCTURE_FRAME = 3


@dataclass
class PictureHdr:
    tsn: int = 0          # temporal_sequence_number
    pic_type: int = 0     # PICTURE_I/P/B


def parse_picture_header(data: bytes) -> PictureHdr:
    """Payload after 00 00 01 00."""
    v = int.from_bytes(data[:2], "big")
    return PictureHdr(tsn=v >> 6, pic_type=(v >> 3) & 0x7)


@dataclass
class PictureExt:
    picture_structure: int = PICTURE_STRUCTURE_FRAME
    top_field_first: int = 0
    progressive_frame: int = 1


def parse_picture_ext(data: bytes) -> PictureExt:
    """0xB5 payload with extension id 8 (picture coding extension)."""
    ext = PictureExt()
    if (data[0] >> 4) != 8 or len(data) < 5:
        return ext
    # f_codes: 16 bits spanning data[0..2] low nibble + data[1] +
    # data[2] high nibble; intra_dc_precision 2, picture_structure 2
    ext.picture_structure = data[2] & 0x3
    ext.top_field_first = (data[3] >> 7) & 1
    ext.progressive_frame = (data[4] >> 7) & 1
    return ext


@dataclass
class Gop:
    closed_gop: int = 0
    broken_link: int = 0
    hour: int = 0
    minute: int = 0
    second: int = 0
    frame: int = 0


def parse_gop(data: bytes) -> Gop:
    """Payload after 00 00 01 B8 (6.3.8 group_of_pictures_header)."""
    v = int.from_bytes(data[:4], "big")
    return Gop(
        hour=(v >> 26) & 0x1F, minute=(v >> 20) & 0x3F,
        second=(v >> 13) & 0x3F, frame=(v >> 7) & 0x3F,
        closed_gop=(v >> 6) & 1, broken_link=(v >> 5) & 1)


def parse_ga94_captions(data: bytes) -> Optional[bytes]:
    """ATSC A/53 user data -> raw cc triplets (cc_valid|cc_type byte +
    2 data bytes each), what GstVideoCaptionMeta CEA708_RAW holds."""
    if data[:4] != b"\x47\x41\x39\x34" or len(data) < 6:  # 'GA94'
        return None
    if data[4] != 0x03:  # user_data_type_code: cc_data
        return None
    if not data[5] & 0x40:  # process_cc_data_flag
        return None
    cc_count = data[5] & 0x1F
    payload = data[7:7 + 3 * cc_count]
    if len(payload) < 3 * cc_count:
        return None
    return payload


def par_from_aspect(hdr: SeqHdr) -> Optional[Tuple[int, int]]:
    """gstmpegvideoparse.c caps: MPEG-2 DAR codes -> PAR via the
    frame size; MPEG-1 uses the pel aspect table."""
    if hdr.mpeg2:
        if hdr.aspect_code == 1:
            return (1, 1)
        dar = DAR_TABLE.get(hdr.aspect_code)
        if dar and hdr.width and hdr.height:
            return (dar[0] * hdr.height, dar[1] * hdr.width)
        return None
    return MPEG1_PAR.get(hdr.aspect_code)
