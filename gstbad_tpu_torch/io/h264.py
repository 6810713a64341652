"""H.264 sequence parameter set parsing, the part of the JAX package's
io/h264.py (gst-libs codecparsers/gsth264parser.c) that the MSS manifest
needs: an SPS's framerate from the VUI timing (fps = time_scale / (2 *
num_units_in_tick)), with profile, level, chroma format, cropping and
aspect ratio on the way (ITU-T H.264 7.3.2.1.1, E.1.1).  A copy: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise ValueError("bitstream truncated")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb")
        return (1 << zeros) - 1 + (self.read(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def remove_emulation(data: bytes) -> bytes:
    """Strip 00 00 03 emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(data):
        b = data[i]
        if zeros >= 2 and b == 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# H.264 table E-1 aspect ratios
_ASPECT_RATIOS = [
    (0, 0), (1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
    (20, 11), (32, 11), (80, 33), (18, 11), (15, 11), (64, 33),
    (160, 99), (4, 3), (3, 2), (2, 1),
]


@dataclass
class Sps:
    profile_idc: int = 0
    constraint_flags: int = 0
    level_idc: int = 0
    sps_id: int = 0
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_frame_num: int = 4
    pic_order_cnt_type: int = 0
    log2_max_pic_order_cnt_lsb: int = 4
    width: int = 0
    height: int = 0
    frame_mbs_only: int = 1
    mb_adaptive_frame_field: int = 0
    par_n: int = 0
    par_d: int = 0
    fps_n: int = 0
    fps_d: int = 0
    raw: bytes = b""
    # decoder-layer fields (gst-libs/gst/codecs/gsth264decoder.c)
    constraint_byte: int = 0          # full constraint_set_flags byte
    num_ref_frames: int = 0           # max_num_ref_frames
    gaps_in_frame_num_allowed: int = 0
    # pic_order_cnt_type == 1 (spec 8.2.1.2)
    delta_pic_order_always_zero: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: Tuple[int, ...] = ()
    # VUI bitstream restriction (gsth264decoder.c
    # update_max_num_reorder_frames / process_sps)
    vui_present: int = 0
    bitstream_restriction: int = 0
    max_num_reorder_frames: int = 0
    max_dec_frame_buffering: int = 0

    @property
    def max_frame_num(self) -> int:
        return 1 << self.log2_max_frame_num

    @property
    def max_pic_order_cnt_lsb(self) -> int:
        return 1 << self.log2_max_pic_order_cnt_lsb


def parse_sps(nal: bytes) -> Sps:
    """7.3.2.1.1 seq_parameter_set_data."""
    rbsp = remove_emulation(nal[1:])
    r = BitReader(rbsp)
    sps = Sps(raw=bytes(nal))
    sps.profile_idc = r.read(8)
    cbyte = r.read(8)
    sps.constraint_byte = cbyte
    sps.constraint_flags = cbyte >> 2
    r_level = r.read(8)
    sps.level_idc = r_level
    sps.sps_id = r.ue()
    if sps.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128,
                           138, 139, 134, 135):
        sps.chroma_format_idc = r.ue()
        if sps.chroma_format_idc == 3:
            sps.separate_colour_plane = r.read(1)
        sps.bit_depth_luma = r.ue() + 8
        sps.bit_depth_chroma = r.ue() + 8
        r.read(1)  # qpprime_y_zero_transform_bypass
        if r.read(1):  # seq_scaling_matrix_present
            for i in range(8 if sps.chroma_format_idc != 3 else 12):
                if r.read(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    sps.log2_max_frame_num = r.ue() + 4
    sps.pic_order_cnt_type = r.ue()
    if sps.pic_order_cnt_type == 0:
        sps.log2_max_pic_order_cnt_lsb = r.ue() + 4
    elif sps.pic_order_cnt_type == 1:
        sps.delta_pic_order_always_zero = r.read(1)
        sps.offset_for_non_ref_pic = r.se()
        sps.offset_for_top_to_bottom_field = r.se()
        sps.offset_for_ref_frame = tuple(r.se() for _ in range(r.ue()))
    sps.num_ref_frames = r.ue()
    sps.gaps_in_frame_num_allowed = r.read(1)
    pw = r.ue() + 1
    ph = r.ue() + 1
    sps.frame_mbs_only = r.read(1)
    if not sps.frame_mbs_only:
        sps.mb_adaptive_frame_field = r.read(1)
    r.read(1)  # direct_8x8_inference
    crop_l = crop_r = crop_t = crop_b = 0
    if r.read(1):  # frame_cropping
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()
    # CropUnit per 7.4.2.1.1
    sub_wc = [1, 2, 2, 1][sps.chroma_format_idc]
    sub_hc = [1, 2, 1, 1][sps.chroma_format_idc]
    crop_x = sub_wc if sps.chroma_format_idc else 1
    crop_y = (sub_hc if sps.chroma_format_idc else 1) \
        * (2 - sps.frame_mbs_only)
    sps.width = pw * 16 - (crop_l + crop_r) * crop_x
    sps.height = (2 - sps.frame_mbs_only) * ph * 16 \
        - (crop_t + crop_b) * crop_y
    if r.read(1):  # vui_parameters_present
        sps.vui_present = 1
        _parse_vui(r, sps)
    return sps


def _skip_scaling_list(r: BitReader, size: int) -> None:
    last, nxt = 8, 8
    for _ in range(size):
        if nxt != 0:
            nxt = (last + r.se() + 256) % 256
        last = nxt if nxt else last


def _parse_vui(r: BitReader, sps: Sps) -> None:
    if r.read(1):  # aspect_ratio_info_present
        idc = r.read(8)
        if idc == 255:  # Extended_SAR
            sps.par_n = r.read(16)
            sps.par_d = r.read(16)
        elif idc < len(_ASPECT_RATIOS):
            sps.par_n, sps.par_d = _ASPECT_RATIOS[idc]
    if r.read(1):  # overscan_info_present
        r.read(1)
    if r.read(1):  # video_signal_type_present
        r.read(4)
        if r.read(1):  # colour_description_present
            r.read(24)
    if r.read(1):  # chroma_loc_info_present
        r.ue()
        r.ue()
    if r.read(1):  # timing_info_present
        num_units_in_tick = r.read(32)
        time_scale = r.read(32)
        if num_units_in_tick and time_scale:
            # a frame is two fields' ticks (gsth264parser fps derivation)
            sps.fps_n = time_scale
            sps.fps_d = 2 * num_units_in_tick
        r.read(1)  # fixed_frame_rate_flag
    try:
        nal_hrd = r.read(1)
        if nal_hrd:
            _skip_hrd(r)
        vcl_hrd = r.read(1)
        if vcl_hrd:
            _skip_hrd(r)
        if nal_hrd or vcl_hrd:
            r.read(1)  # low_delay_hrd_flag
        r.read(1)  # pic_struct_present_flag
        if r.read(1):  # bitstream_restriction_flag (E.1.1)
            sps.bitstream_restriction = 1
            r.read(1)  # motion_vectors_over_pic_boundaries
            r.ue()     # max_bytes_per_pic_denom
            r.ue()     # max_bits_per_mb_denom
            r.ue()     # log2_max_mv_length_horizontal
            r.ue()     # log2_max_mv_length_vertical
            sps.max_num_reorder_frames = r.ue()
            sps.max_dec_frame_buffering = r.ue()
    except ValueError:
        # tolerate VUIs truncated after timing info (legacy vectors)
        pass


def _skip_hrd(r: BitReader) -> None:
    """E.1.2 hrd_parameters."""
    cpb_cnt = r.ue() + 1
    r.read(8)  # bit_rate_scale + cpb_size_scale
    for _ in range(cpb_cnt):
        r.ue()
        r.ue()
        r.read(1)
    r.read(20)  # 4x length-minus1 5-bit fields
