"""H.264 bitstream parsing (gst/videoparsers/gsth264parse.c over the
gst-libs codecparsers/gsth264parser.c layer).

From-spec (ITU-T H.264) implementation of the pieces the parser element
uses:
  - Annex-B NAL splitting (3/4-byte start codes) and AVC
    length-prefixed framing; emulation-prevention removal.
  - SPS parse: profile/constraints/level, chroma format, frame
    cropping -> width/height (CropUnit math per 7.4.2.1.1), VUI aspect
    ratio table and timing (fps = time_scale / (2 * num_units_in_tick)),
    interlace via frame_mbs_only_flag.
  - PPS id walk; slice header first_mb_in_slice for AU boundaries.
  - SEI: content light level (type 144) and mastering display colour
    volume (type 137) with the caps strings the reference emits
    (R,G,B re-ordered from the SEI's G,B,R —
    gstvideo mastering-display-info string; h264parse.c unit test pins
    "7500:3000:34000:16000:13200:34500:15635:16450:10000000:1").
  - avcC codec_data build/parse (byte-exact against the upstream
    test's h264_avc_codec_data vector).
  - profile/level caps names and the compatible-profile expansion
    (gsth264parse.c get_compatible_profile_caps).
A copy of the JAX package's io/h264.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

NAL_SLICE = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9

SEI_MDCV = 137
SEI_CLLI = 144


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


def split_bytestream(data: bytes) -> List[bytes]:
    """Annex-B: NAL payloads between start codes (codes stripped)."""
    nals = []
    i = 0
    n = len(data)
    start = -1
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            if start >= 0:
                end = i
                while end > start and data[end - 1] == 0:
                    end -= 1
                nals.append(data[start:end])
            start = i + 3
            i += 3
        else:
            i += 1
    if start >= 0:
        nals.append(data[start:])
    return [x for x in nals if x]


def split_avc(data: bytes, length_size: int = 4) -> List[bytes]:
    nals = []
    pos = 0
    while pos + length_size <= len(data):
        ln = int.from_bytes(data[pos:pos + length_size], "big")
        pos += length_size
        nals.append(data[pos:pos + ln])
        pos += ln
    return nals


def to_bytestream(nals: List[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def to_avc(nals: List[bytes], length_size: int = 4) -> bytes:
    return b"".join(len(n).to_bytes(length_size, "big") + n
                    for n in nals)


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F if nal else 0


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


@dataclass
class Pps:
    pps_id: int = 0
    sps_id: int = 0
    raw: bytes = b""
    # decoder-layer fields (7.3.2.2, needed by the slice-header parse)
    entropy_coding_mode: int = 0
    pic_order_present: int = 0     # bottom_field_pic_order_in_frame
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    weighted_pred: int = 0
    weighted_bipred_idc: int = 0
    deblocking_filter_control_present: int = 0
    redundant_pic_cnt_present: int = 0
    num_slice_groups: int = 1


def parse_pps(nal: bytes) -> Pps:
    """7.3.2.2 pic_parameter_set_rbsp (through the fields the slice
    header parse depends on; gsth264parser.c gst_h264_parser_parse_pps)."""
    r = BitReader(remove_emulation(nal[1:]))
    pps = Pps(pps_id=r.ue(), sps_id=r.ue(), raw=bytes(nal))
    try:
        pps.entropy_coding_mode = r.read(1)
        pps.pic_order_present = r.read(1)
        pps.num_slice_groups = r.ue() + 1
        if pps.num_slice_groups > 1:
            map_type = r.ue()
            if map_type == 0:
                for _ in range(pps.num_slice_groups):
                    r.ue()
            elif map_type == 2:
                for _ in range(pps.num_slice_groups - 1):
                    r.ue()
                    r.ue()
            elif map_type in (3, 4, 5):
                r.read(1)
                r.ue()
            elif map_type == 6:
                n = r.ue() + 1
                bits = max(1, (pps.num_slice_groups - 1).bit_length())
                for _ in range(n):
                    r.read(bits)
        pps.num_ref_idx_l0_default = r.ue() + 1
        pps.num_ref_idx_l1_default = r.ue() + 1
        pps.weighted_pred = r.read(1)
        pps.weighted_bipred_idc = r.read(2)
        r.se()  # pic_init_qp_minus26
        r.se()  # pic_init_qs_minus26
        r.se()  # chroma_qp_index_offset
        pps.deblocking_filter_control_present = r.read(1)
        r.read(1)  # constrained_intra_pred
        pps.redundant_pic_cnt_present = r.read(1)
    except ValueError:
        pass  # tolerate minimal legacy vectors
    return pps


def first_mb_in_slice(nal: bytes) -> int:
    r = BitReader(remove_emulation(nal[1:1 + 8]))
    return r.ue()


# ------------------------------------------------------- slice header
# (7.3.3, parsed through dec_ref_pic_marking — everything the codecs
# DPB layer consumes; gsth264parser.c gst_h264_parser_parse_slice_hdr)

SLICE_P, SLICE_B, SLICE_I, SLICE_SP, SLICE_SI = 0, 1, 2, 3, 4

MMCO_END = 0
MMCO_SHORT_TO_UNUSED = 1
MMCO_LONG_TO_UNUSED = 2
MMCO_SHORT_TO_LONG = 3
MMCO_SET_MAX_LONG = 4
MMCO_ALL_TO_UNUSED = 5
MMCO_CURRENT_TO_LONG = 6


@dataclass
class RefPicListMod:
    """8.2.4.3 modification_of_pic_nums_idc entry."""
    idc: int
    value: int  # abs_diff_pic_num_minus1 or long_term_pic_num


@dataclass
class RefPicMarking:
    """dec_ref_pic_marking (7.3.3.3)."""
    # IDR only
    no_output_of_prior_pics: int = 0
    long_term_reference_flag: int = 0
    # non-IDR
    adaptive_marking: int = 0
    ops: List[Tuple[int, int, int]] = field(default_factory=list)
    # ops entries: (mmco, difference_of_pic_nums_minus1 OR
    #               long_term_pic_num OR max_long_term_frame_idx_plus1,
    #               long_term_frame_idx)


@dataclass
class SliceHdr:
    first_mb_in_slice: int = 0
    slice_type: int = 0            # reduced mod 5
    pps_id: int = 0
    frame_num: int = 0
    field_pic_flag: int = 0
    bottom_field_flag: int = 0
    idr_pic_flag: int = 0
    idr_pic_id: int = 0
    nal_ref_idc: int = 0
    pic_order_cnt_lsb: int = 0
    delta_pic_order_cnt_bottom: int = 0
    delta_pic_order_cnt: Tuple[int, int] = (0, 0)
    redundant_pic_cnt: int = 0
    num_ref_idx_l0_active: int = 0
    num_ref_idx_l1_active: int = 0
    ref_pic_list_modification_l0: List[RefPicListMod] = \
        field(default_factory=list)
    ref_pic_list_modification_l1: List[RefPicListMod] = \
        field(default_factory=list)
    dec_ref_pic_marking: RefPicMarking = field(default_factory=RefPicMarking)

    @property
    def max_pic_num(self) -> int:
        # filled by parse_slice_header from the active SPS
        return self._max_pic_num

    _max_pic_num: int = 0

    def is_p(self) -> bool:
        return self.slice_type in (SLICE_P, SLICE_SP)

    def is_b(self) -> bool:
        return self.slice_type == SLICE_B


def _parse_ref_pic_list_modification(r: BitReader,
                                     out: List[RefPicListMod]) -> None:
    """7.3.3.1 (one list)."""
    if r.read(1):  # ref_pic_list_modification_flag_lX
        while True:
            idc = r.ue()
            if idc == 3:
                break
            if idc not in (0, 1, 2):
                raise ValueError(f"bad modification_of_pic_nums_idc {idc}")
            out.append(RefPicListMod(idc, r.ue()))
            if len(out) > 32:
                raise ValueError("runaway ref_pic_list_modification")


def _skip_pred_weight_table(r: BitReader, hdr: SliceHdr,
                            chroma_array_type: int) -> None:
    """7.3.3.2 pred_weight_table (values unused by the DPB layer)."""
    r.ue()  # luma_log2_weight_denom
    if chroma_array_type != 0:
        r.ue()  # chroma_log2_weight_denom
    for n_active in (hdr.num_ref_idx_l0_active,
                     hdr.num_ref_idx_l1_active
                     if hdr.is_b() else 0):
        for _ in range(n_active):
            if r.read(1):  # luma_weight_lx_flag
                r.se()
                r.se()
            if chroma_array_type != 0 and r.read(1):
                for _ in range(2):
                    r.se()
                    r.se()


def parse_slice_header(nal: bytes, sps_by_id: Dict[int, Sps],
                       pps_by_id: Dict[int, Pps]) -> SliceHdr:
    """Parse a slice header through dec_ref_pic_marking.

    gsth264parser.c gst_h264_parser_parse_slice_hdr with
    parse_pred_weight_table=TRUE, parse_dec_ref_pic_marking=TRUE —
    the exact call the decoder base class makes
    (gsth264decoder.c:1211 gst_h264_decoder_parse_slice)."""
    ntype = nal_type(nal)
    hdr = SliceHdr()
    hdr.nal_ref_idc = (nal[0] >> 5) & 3
    hdr.idr_pic_flag = 1 if ntype == NAL_SLICE_IDR else 0
    r = BitReader(remove_emulation(nal[1:]))
    hdr.first_mb_in_slice = r.ue()
    hdr.slice_type = r.ue() % 5
    hdr.pps_id = r.ue()
    pps = pps_by_id.get(hdr.pps_id)
    if pps is None:
        raise ValueError(f"slice references unknown PPS {hdr.pps_id}")
    sps = sps_by_id.get(pps.sps_id)
    if sps is None:
        raise ValueError(f"PPS references unknown SPS {pps.sps_id}")
    if sps.separate_colour_plane:
        r.read(2)  # colour_plane_id
    hdr.frame_num = r.read(sps.log2_max_frame_num)
    if not sps.frame_mbs_only:
        hdr.field_pic_flag = r.read(1)
        if hdr.field_pic_flag:
            hdr.bottom_field_flag = r.read(1)
    hdr._max_pic_num = (sps.max_frame_num if not hdr.field_pic_flag
                        else 2 * sps.max_frame_num)
    if hdr.idr_pic_flag:
        hdr.idr_pic_id = r.ue()
    if sps.pic_order_cnt_type == 0:
        hdr.pic_order_cnt_lsb = r.read(sps.log2_max_pic_order_cnt_lsb)
        if pps.pic_order_present and not hdr.field_pic_flag:
            hdr.delta_pic_order_cnt_bottom = r.se()
    elif sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero:
        d0 = r.se()
        d1 = 0
        if pps.pic_order_present and not hdr.field_pic_flag:
            d1 = r.se()
        hdr.delta_pic_order_cnt = (d0, d1)
    if pps.redundant_pic_cnt_present:
        hdr.redundant_pic_cnt = r.ue()
    if hdr.is_b():
        r.read(1)  # direct_spatial_mv_pred_flag
    hdr.num_ref_idx_l0_active = pps.num_ref_idx_l0_default
    hdr.num_ref_idx_l1_active = pps.num_ref_idx_l1_default
    if hdr.slice_type in (SLICE_P, SLICE_SP, SLICE_B):
        if r.read(1):  # num_ref_idx_active_override_flag
            hdr.num_ref_idx_l0_active = r.ue() + 1
            if hdr.is_b():
                hdr.num_ref_idx_l1_active = r.ue() + 1
    # ref_pic_list_modification (7.3.3.1); SLICE_EXT (MVC) not handled
    if hdr.slice_type not in (SLICE_I, SLICE_SI):
        _parse_ref_pic_list_modification(
            r, hdr.ref_pic_list_modification_l0)
    if hdr.is_b():
        _parse_ref_pic_list_modification(
            r, hdr.ref_pic_list_modification_l1)
    if ((pps.weighted_pred and hdr.slice_type in (SLICE_P, SLICE_SP))
            or (pps.weighted_bipred_idc == 1 and hdr.is_b())):
        chroma_array_type = (0 if sps.separate_colour_plane
                             else sps.chroma_format_idc)
        _skip_pred_weight_table(r, hdr, chroma_array_type)
    if hdr.nal_ref_idc != 0:
        m = hdr.dec_ref_pic_marking
        if hdr.idr_pic_flag:
            m.no_output_of_prior_pics = r.read(1)
            m.long_term_reference_flag = r.read(1)
        else:
            m.adaptive_marking = r.read(1)
            if m.adaptive_marking:
                while True:
                    mmco = r.ue()
                    if mmco == MMCO_END:
                        break
                    val = lt_idx = 0
                    if mmco in (MMCO_SHORT_TO_UNUSED, MMCO_SHORT_TO_LONG):
                        val = r.ue()  # difference_of_pic_nums_minus1
                    if mmco == MMCO_LONG_TO_UNUSED:
                        val = r.ue()  # long_term_pic_num
                    if mmco in (MMCO_SHORT_TO_LONG, MMCO_CURRENT_TO_LONG):
                        lt_idx = r.ue()  # long_term_frame_idx
                    if mmco == MMCO_SET_MAX_LONG:
                        val = r.ue()  # max_long_term_frame_idx_plus1
                    m.ops.append((mmco, val, lt_idx))
                    if len(m.ops) > 10:
                        raise ValueError("runaway MMCO list")
    return hdr


def parse_sei(nal: bytes) -> List[Tuple[int, bytes]]:
    """7.3.2.3: (payload_type, payload_bytes) messages."""
    rbsp = remove_emulation(nal[1:])
    out = []
    pos = 0
    while pos < len(rbsp) and rbsp[pos] != 0x80:
        ptype = 0
        while pos < len(rbsp) and rbsp[pos] == 0xFF:
            ptype += 255
            pos += 1
        if pos >= len(rbsp):
            break
        ptype += rbsp[pos]
        pos += 1
        size = 0
        while pos < len(rbsp) and rbsp[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= len(rbsp):
            break
        size += rbsp[pos]
        pos += 1
        out.append((ptype, rbsp[pos:pos + size]))
        pos += size
    return out


def content_light_level_string(payload: bytes) -> str:
    """SEI 144 -> the caps string "max:maxavg"."""
    mx, avg = struct.unpack_from(">HH", payload, 0)
    return f"{mx}:{avg}"


def mastering_display_string(payload: bytes) -> str:
    """SEI 137 (G,B,R order) -> the R,G,B-ordered gstvideo string."""
    vals = struct.unpack_from(">8H2I", payload, 0)
    g = (vals[0], vals[1])
    b = (vals[2], vals[3])
    r = (vals[4], vals[5])
    wx, wy = vals[6], vals[7]
    mx, mn = vals[8], vals[9]
    return (f"{r[0]}:{r[1]}:{g[0]}:{g[1]}:{b[0]}:{b[1]}"
            f":{wx}:{wy}:{mx}:{mn}")


# ---------------------------------------------------------------- names

def profile_name(profile_idc: int, constraint_flags: int) -> str:
    """gst_codec_utils_h264_get_profile."""
    csf1 = bool(constraint_flags & 0x20)  # constraint_set1
    csf3 = bool(constraint_flags & 0x08)
    csf4 = bool(constraint_flags & 0x04)
    csf5 = bool(constraint_flags & 0x02)
    if profile_idc == 66:
        return "constrained-baseline" if csf1 else "baseline"
    if profile_idc == 77:
        return "main"
    if profile_idc == 88:
        return "extended"
    if profile_idc == 100:
        if csf4 and csf5:
            return "constrained-high"
        if csf4:
            return "progressive-high"
        return "high"
    if profile_idc == 110:
        return "high-10-intra" if csf3 else "high-10"
    if profile_idc == 122:
        return "high-4:2:2-intra" if csf3 else "high-4:2:2"
    if profile_idc == 244:
        return "high-4:4:4-intra" if csf3 else "high-4:4:4"
    if profile_idc == 44:
        return "cavlc-4:4:4-intra"
    if profile_idc == 118:
        return "multiview-high"
    if profile_idc == 128:
        return "stereo-high"
    if profile_idc == 83:
        return "scalable-constrained-baseline" if csf5 \
            else "scalable-baseline"
    if profile_idc == 86:
        if csf3:
            return "scalable-high-intra"
        if csf5:
            return "scalable-constrained-high"
        return "scalable-high"
    return str(profile_idc)


def level_name(level_idc: int, constraint_flags: int) -> str:
    """gst_codec_utils_h264_get_level: '1b' when level 11 + cs3."""
    csf3 = bool(constraint_flags & 0x08)
    if level_idc == 11 and csf3:
        return "1b"
    if level_idc % 10 == 0:
        return str(level_idc // 10)
    return f"{level_idc // 10}.{level_idc % 10}"


# Constraint flag bit positions within the 6-bit field (cs0 is MSB)
CS0 = 0x80 >> 0
CS1 = 0x40 >> 0


def compatible_profiles(profile_idc: int,
                        constraint_byte: int) -> List[str]:
    """get_compatible_profile_caps (gsth264parse.c): the profiles a
    peer may require that this SPS also satisfies.  constraint_byte is
    the full constraint_set_flags byte (cs0 = 0x80)."""
    cs0 = bool(constraint_byte & 0x80)
    cs1 = bool(constraint_byte & 0x40)
    cs3 = bool(constraint_byte & 0x10)
    out: List[str] = []
    if profile_idc == 88:  # extended
        if cs0 and cs1:
            out += ["constrained-baseline", "baseline", "main", "high",
                    "high-10", "high-4:2:2", "high-4:4:4"]
        elif cs0:
            out += ["baseline"]
        elif cs1:
            out += ["main", "high", "high-10", "high-4:2:2",
                    "high-4:4:4"]
    elif profile_idc == 66:  # baseline
        if cs1:
            out += ["baseline", "main", "high", "high-10", "high-4:2:2",
                    "high-4:4:4"]
        else:
            out += ["extended"]
    elif profile_idc == 77:  # main
        out += ["high", "high-10", "high-4:2:2", "high-4:4:4"]
    elif profile_idc == 100:  # high
        out += ["high-10", "high-4:2:2", "high-4:4:4"]
    elif profile_idc == 110:  # high-10
        if cs3:
            out += ["high-10-intra", "high-4:2:2-intra",
                    "high-4:4:4-intra"]
        out += ["high-4:2:2", "high-4:4:4"]
    elif profile_idc == 122:  # high-4:2:2
        if cs3:
            out += ["high-4:2:2-intra", "high-4:4:4-intra"]
        out += ["high-4:4:4"]
    elif profile_idc == 244:  # high-4:4:4
        if cs3:
            out += ["high-4:4:4-intra"]
    return out


# ---------------------------------------------------------------- avcC

def build_avcc(sps_list: List[bytes], pps_list: List[bytes],
               length_size: int = 4) -> bytes:
    """ISO 14496-15 AVCDecoderConfigurationRecord
    (gst_h264_parse_make_codec_data)."""
    if not sps_list:
        raise ValueError("avcC needs at least one SPS")
    sps0 = sps_list[0]
    out = bytearray()
    out.append(1)                       # configurationVersion
    out += sps0[1:4]                    # profile, compat, level
    out.append(0xFC | (length_size - 1))
    out.append(0xE0 | len(sps_list))
    for s in sps_list:
        out += struct.pack(">H", len(s)) + s
    out.append(len(pps_list))
    for p in pps_list:
        out += struct.pack(">H", len(p)) + p
    return bytes(out)


def parse_avcc(data: bytes) -> Tuple[int, List[bytes], List[bytes]]:
    """-> (nal_length_size, sps_list, pps_list)."""
    if len(data) < 7 or data[0] != 1:
        raise ValueError("bad avcC")
    length_size = (data[4] & 0x3) + 1
    n_sps = data[5] & 0x1F
    pos = 6
    sps_list = []
    for _ in range(n_sps):
        (ln,) = struct.unpack_from(">H", data, pos)
        pos += 2
        sps_list.append(data[pos:pos + ln])
        pos += ln
    n_pps = data[pos]
    pos += 1
    pps_list = []
    for _ in range(n_pps):
        (ln,) = struct.unpack_from(">H", data, pos)
        pos += 2
        pps_list.append(data[pos:pos + ln])
        pos += ln
    return length_size, sps_list, pps_list
