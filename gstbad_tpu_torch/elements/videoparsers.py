"""h264parse + h265parse (gst/videoparsers/gsth264parse.c,
gsth265parse.c) over io/h264.py and io/h265nal.py.

Host byte-domain parser element:
  - accepts byte-stream (nal or au aligned) or avc/avc3 input
    (codec-data carries the avcC record);
  - emits byte-stream or avc output at nal or au alignment
    (gsth264parse.c format negotiation);
  - collects SPS/PPS, produces caps (width/height/profile/level/
    par/framerate/interlace + HDR SEI strings) and byte-exact avcC
    codec_data (the upstream test's h264_avc_codec_data vector);
  - AU boundaries: AUD, or a slice with first_mb_in_slice == 0
    following slice data, or SPS/PPS/SEI after slice data
    (gsth264parse.c collect_nal);
  - config-interval property: in byte-stream output, re-inject
    SPS/PPS before IDR frames every N seconds (-1 = before every IDR,
    gsth264parse.c "config-interval");
  - avc output strips in-band SPS/PPS into codec_data.
A port of the JAX package's elements/videoparsers.py, on the host as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import h264 as h
from gstbad_tpu_torch.io import vc1

NSEC = 1_000_000_000


@register
class H264Parse(Element):
    NAME = "h264parse"
    KIND = "host-source"
    PROPERTIES = (
        Property("config-interval", int, 0, -1, 3600, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.in_format = "byte-stream"
        self.out_format = "byte-stream"
        self.out_alignment = "au"
        self.nal_length_size = 4
        self.sps: Dict[int, h.Sps] = {}
        self.pps: Dict[int, h.Pps] = {}
        self.src_caps: Optional[Dict] = None
        self._pending: List[bytes] = []      # nals of the open AU
        self._have_slice = False
        self._last_config_ts = None
        self._sei_caps: Dict[str, str] = {}
        self._buf = b""

    # -- negotiation -------------------------------------------------------

    def set_caps(self, stream_format: str = "byte-stream",
                 codec_data: Optional[bytes] = None) -> None:
        self.in_format = stream_format
        if codec_data is not None:
            self.nal_length_size, sps_list, pps_list = \
                h.parse_avcc(codec_data)
            for s in sps_list:
                self._take_nal_headers(s)
            for p in pps_list:
                self._take_nal_headers(p)

    def set_output(self, stream_format: str = "byte-stream",
                   alignment: str = "au") -> None:
        self.out_format = stream_format
        self.out_alignment = alignment

    # -- caps --------------------------------------------------------------

    def _update_caps(self) -> None:
        if not self.sps:
            return
        sps = next(iter(self.sps.values()))
        caps = {
            "media": "video/x-h264",
            "parsed": True,
            "stream-format": self.out_format,
            "alignment": self.out_alignment,
            "width": sps.width,
            "height": sps.height,
            "profile": h.profile_name(sps.profile_idc,
                                      sps.constraint_flags),
            "level": h.level_name(sps.level_idc, sps.constraint_flags),
            "interlace-mode": ("progressive" if sps.frame_mbs_only
                               else "mixed"),
        }
        if sps.par_n and sps.par_d:
            caps["pixel-aspect-ratio"] = (sps.par_n, sps.par_d)
        if sps.fps_n and sps.fps_d:
            caps["framerate"] = (sps.fps_n, sps.fps_d)
        caps.update(self._sei_caps)
        if self.out_format in ("avc", "avc3") and self.sps and self.pps:
            caps["codec_data"] = h.build_avcc(
                [s.raw for s in self.sps.values()],
                [p.raw for p in self.pps.values()],
                self.nal_length_size)
        self.src_caps = caps

    def _take_nal_headers(self, nal: bytes) -> None:
        t = h.nal_type(nal)
        try:
            if t == h.NAL_SPS:
                sps = h.parse_sps(nal)
                self.sps[sps.sps_id] = sps
            elif t == h.NAL_PPS:
                pps = h.parse_pps(nal)
                self.pps[pps.pps_id] = pps
            elif t == h.NAL_SEI:
                for ptype, payload in h.parse_sei(nal):
                    if ptype == h.SEI_CLLI and len(payload) >= 4:
                        self._sei_caps["content-light-level"] = \
                            h.content_light_level_string(payload)
                    elif ptype == h.SEI_MDCV and len(payload) >= 24:
                        self._sei_caps["mastering-display-info"] = \
                            h.mastering_display_string(payload)
        except (ValueError, IndexError):
            # corrupted parameter sets are skipped, like the
            # reference's parser warnings
            pass

    # -- push --------------------------------------------------------------

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        """Feed bytes; returns finished output buffers."""
        if self.in_format in ("avc", "avc3"):
            nals = h.split_avc(data, self.nal_length_size)
            # avc input is au-aligned: each buffer is one AU
            for nal in nals:
                self._take_nal_headers(nal)
            self._update_caps()
            return self._emit_au(nals, pts_ns)
        # byte-stream: bytes before the LAST start code are complete
        # nals; everything from that code on stays buffered until the
        # next code or EOS (finish())
        self._buf += data
        cut = self._buf.rfind(b"\x00\x00\x01")
        if cut <= 0:
            return []
        if self._buf[cut - 1] == 0:
            cut -= 1  # 4-byte start code
        region, self._buf = self._buf[:cut], self._buf[cut:]
        out: List[Dict] = []
        for nal in h.split_bytestream(region):
            out += self._collect_nal(nal, pts_ns)
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        """EOS drain: flush the held-back nal and the open AU."""
        out = []
        for nal in h.split_bytestream(self._buf):
            out += self._collect_nal(nal, pts_ns)
        self._buf = b""
        if self._pending:
            au, self._pending = self._pending, []
            self._have_slice = False
            out += self._emit_au(au, pts_ns)
        return out

    def _collect_nal(self, nal: bytes, pts_ns: int) -> List[Dict]:
        t = h.nal_type(nal)
        if not 0 < t <= 31:
            return []  # garbage nal: drop (gst_parser_test_skip_garbage)
        self._take_nal_headers(nal)
        self._update_caps()
        out: List[Dict] = []
        starts_new = False
        if t == h.NAL_AUD:
            starts_new = True
        elif t in (h.NAL_SPS, h.NAL_PPS, h.NAL_SEI) and self._have_slice:
            starts_new = True
        elif t in (h.NAL_SLICE, h.NAL_SLICE_IDR) and self._have_slice \
                and h.first_mb_in_slice(nal) == 0:
            starts_new = True
        if starts_new and self._pending:
            au, self._pending = self._pending, []
            self._have_slice = False
            out += self._emit_au(au, pts_ns)
        self._pending.append(nal)
        if t in (h.NAL_SLICE, h.NAL_SLICE_IDR):
            self._have_slice = True
        if self.out_alignment == "nal":
            self._pending = []
            self._have_slice = False
            out += self._emit_au([nal], pts_ns)
        return out

    def _emit_au(self, nals: List[bytes], pts_ns: int) -> List[Dict]:
        if not nals:
            return []
        keyframe = any(h.nal_type(n) == h.NAL_SLICE_IDR for n in nals)
        if self.out_format in ("avc", "avc3"):
            # headers ride in codec_data (gst_h264_parse_prepare_nals)
            payload_nals = [n for n in nals
                            if h.nal_type(n) not in (h.NAL_SPS,
                                                     h.NAL_PPS)]
            if not payload_nals:
                return []
            data = h.to_avc(payload_nals, self.nal_length_size)
        else:
            nals = list(nals)
            if keyframe and self._config_due(pts_ns):
                have = {h.nal_type(n) for n in nals}
                inject = []
                if h.NAL_SPS not in have:
                    inject += [s.raw for s in self.sps.values()]
                if h.NAL_PPS not in have:
                    inject += [p.raw for p in self.pps.values()]
                nals = inject + nals
            data = h.to_bytestream(nals)
        return [dict(data=data, pts=pts_ns, keyframe=keyframe,
                     caps=self.src_caps)]

    def _config_due(self, pts_ns: int) -> bool:
        interval = self.props["config-interval"]
        if interval == 0:
            return False
        if interval < 0:
            return True  # before every IDR
        if pts_ns < 0:
            return False
        if self._last_config_ts is None \
                or pts_ns - self._last_config_ts >= interval * NSEC:
            self._last_config_ts = pts_ns
            return True
        return False

    def process(self, params, state, batch):
        return state, batch


from gstbad_tpu_torch.io import h265nal as h265


@register
class H265Parse(Element):
    """h265parse (gsth265parse.c): byte-stream/hvc1/hev1 framing, caps
    from the SPS profile_tier_level (profile/tier/level strings the
    upstream test pins: main/main/2.1), hvcC codec_data, AU grouping on
    AUD / first_slice_segment_in_pic_flag / VPS-SPS-PPS-SEI after
    slices, config-interval VPS/SPS/PPS re-injection."""

    NAME = "h265parse"
    KIND = "host-source"
    PROPERTIES = (
        Property("config-interval", int, 0, -1, 3600, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.in_format = "byte-stream"
        self.out_format = "byte-stream"
        self.out_alignment = "au"
        self.nal_length_size = 4
        self.vps: Dict[int, bytes] = {}
        self.sps: Dict[int, h265.Sps] = {}
        self.pps: Dict[int, bytes] = {}
        self.src_caps: Optional[Dict] = None
        self._pending: List[bytes] = []
        self._have_slice = False
        self._last_config_ts = None
        self._sei_caps: Dict[str, str] = {}
        self._buf = b""

    def set_caps(self, stream_format: str = "byte-stream",
                 codec_data: Optional[bytes] = None) -> None:
        self.in_format = stream_format
        if codec_data is not None:
            self.nal_length_size, nals = h265.parse_hvcc(codec_data)
            for n in nals:
                self._take_nal_headers(n)

    def set_output(self, stream_format: str = "byte-stream",
                   alignment: str = "au") -> None:
        self.out_format = stream_format
        self.out_alignment = alignment

    def _take_nal_headers(self, nal: bytes) -> None:
        t = h265.nal_type(nal)
        try:
            if t == h265.NAL_VPS:
                self.vps[0] = bytes(nal)
            elif t == h265.NAL_SPS:
                sps = h265.parse_sps(nal)
                self.sps[sps.sps_id] = sps
            elif t == h265.NAL_PPS:
                self.pps[len(self.pps)] = bytes(nal)
            elif t == h265.NAL_PREFIX_SEI:
                for ptype, payload in h265.parse_sei(nal):
                    if ptype == h265.SEI_CLLI and len(payload) >= 4:
                        self._sei_caps["content-light-level"] = \
                            h.content_light_level_string(payload)
                    elif ptype == h265.SEI_MDCV and len(payload) >= 24:
                        self._sei_caps["mastering-display-info"] = \
                            h.mastering_display_string(payload)
        except (ValueError, IndexError):
            pass

    def _update_caps(self) -> None:
        if not self.sps:
            return
        sps = next(iter(self.sps.values()))
        caps = {
            "media": "video/x-h265",
            "parsed": True,
            "stream-format": self.out_format,
            "alignment": self.out_alignment,
            "width": sps.width,
            "height": sps.height,
            "profile": h265.profile_name(sps.ptl),
            "tier": h265.tier_name(sps.ptl),
            "level": h265.level_name(sps.ptl),
        }
        if sps.par_n and sps.par_d:
            caps["pixel-aspect-ratio"] = (sps.par_n, sps.par_d)
        if sps.fps_n and sps.fps_d:
            caps["framerate"] = (sps.fps_n, sps.fps_d)
        caps.update(self._sei_caps)
        if self.out_format in ("hvc1", "hev1") and self.sps \
                and self.pps:
            caps["codec_data"] = h265.build_hvcc(
                list(self.vps.values()),
                [s.raw for s in self.sps.values()],
                list(self.pps.values()), self.nal_length_size)
        self.src_caps = caps

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        if self.in_format in ("hvc1", "hev1"):
            nals = h.split_avc(data, self.nal_length_size)
            for nal in nals:
                self._take_nal_headers(nal)
            self._update_caps()
            return self._emit_au(nals, pts_ns)
        self._buf += data
        cut = self._buf.rfind(b"\x00\x00\x01")
        if cut <= 0:
            return []
        if self._buf[cut - 1] == 0:
            cut -= 1
        region, self._buf = self._buf[:cut], self._buf[cut:]
        out: List[Dict] = []
        for nal in h.split_bytestream(region):
            out += self._collect_nal(nal, pts_ns)
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        out = []
        for nal in h.split_bytestream(self._buf):
            out += self._collect_nal(nal, pts_ns)
        self._buf = b""
        if self._pending:
            au, self._pending = self._pending, []
            self._have_slice = False
            out += self._emit_au(au, pts_ns)
        return out

    def _collect_nal(self, nal: bytes, pts_ns: int) -> List[Dict]:
        t = h265.nal_type(nal)
        if len(nal) < 2 or t > 40:
            return []
        self._take_nal_headers(nal)
        self._update_caps()
        out: List[Dict] = []
        starts_new = False
        if t == h265.NAL_AUD:
            starts_new = True
        elif t in (h265.NAL_VPS, h265.NAL_SPS, h265.NAL_PPS,
                   h265.NAL_PREFIX_SEI) and self._have_slice:
            starts_new = True
        elif h265.is_slice(t) and self._have_slice \
                and h265.first_slice_segment_in_pic(nal):
            starts_new = True
        if starts_new and self._pending:
            au, self._pending = self._pending, []
            self._have_slice = False
            out += self._emit_au(au, pts_ns)
        self._pending.append(nal)
        if h265.is_slice(t):
            self._have_slice = True
        if self.out_alignment == "nal":
            self._pending = []
            self._have_slice = False
            out += self._emit_au([nal], pts_ns)
        return out

    def _emit_au(self, nals: List[bytes], pts_ns: int) -> List[Dict]:
        if not nals:
            return []
        keyframe = any(h265.is_irap(h265.nal_type(n)) for n in nals)
        if self.out_format in ("hvc1", "hev1"):
            payload = [n for n in nals
                       if h265.nal_type(n) not in (h265.NAL_VPS,
                                                   h265.NAL_SPS,
                                                   h265.NAL_PPS)]
            if not payload:
                return []
            data = h.to_avc(payload, self.nal_length_size)
        else:
            nals = list(nals)
            if keyframe and self._config_due(pts_ns):
                have = {h265.nal_type(n) for n in nals}
                inject = []
                if h265.NAL_VPS not in have:
                    inject += list(self.vps.values())
                if h265.NAL_SPS not in have:
                    inject += [s.raw for s in self.sps.values()]
                if h265.NAL_PPS not in have:
                    inject += list(self.pps.values())
                nals = inject + nals
            data = h.to_bytestream(nals)
        return [dict(data=data, pts=pts_ns, keyframe=keyframe,
                     caps=self.src_caps)]

    def _config_due(self, pts_ns: int) -> bool:
        interval = self.props["config-interval"]
        if interval == 0:
            return False
        if interval < 0:
            return True
        if pts_ns < 0:
            return False
        if self._last_config_ts is None \
                or pts_ns - self._last_config_ts >= interval * NSEC:
            self._last_config_ts = pts_ns
            return True
        return False

    def process(self, params, state, batch):
        return state, batch


from gstbad_tpu_torch.io import mpegvideo as mpv


@register
class MpegVideoParse(Element):
    """mpegvideoparse (gstmpegvideoparse.c): MPEG-1/2 ES framing with
    the reference's split walk (picture ends the open frame, sequence
    always starts one, GOP only with gop-split), caps from the sequence
    header (+extension), and CEA-708 caption extraction from GA94 user
    data (each output carries captions=[cc triplet bytes])."""

    NAME = "mpegvideoparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("gop-split", bool, False, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.seq: Optional[mpv.SeqHdr] = None
        self.src_caps: Optional[Dict] = None
        self._buf = b""
        self._frame = bytearray()
        self._have_picture = False
        self._captions: List[bytes] = []
        self._frame_type = 0

    def _update_caps(self) -> None:
        if self.seq is None:
            return
        caps = {
            "media": "video/mpeg",
            "mpegversion": 2 if self.seq.mpeg2 else 1,
            "systemstream": False,
            "parsed": True,
            "width": self.seq.width,
            "height": self.seq.height,
        }
        if self.seq.fps_n:
            caps["framerate"] = (self.seq.fps_n, self.seq.fps_d)
        par = mpv.par_from_aspect(self.seq)
        if par:
            caps["pixel-aspect-ratio"] = par
        if self.seq.profile:
            caps["profile"] = self.seq.profile
        if self.seq.level:
            caps["level"] = self.seq.level
        if self.seq.mpeg2:
            caps["interlace-mode"] = ("progressive" if
                                      self.seq.progressive else "mixed")
        self.src_caps = caps

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        cut = self._buf.rfind(b"\x00\x00\x01")
        if cut <= 0:
            return []
        region, self._buf = self._buf[:cut], self._buf[cut:]
        return self._scan(region, pts_ns, final=False)

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        region, self._buf = self._buf, b""
        out = self._scan(region, pts_ns, final=True)
        if self._frame:
            out += self._emit(pts_ns)
        return out

    def _scan(self, region: bytes, pts_ns: int,
              final: bool) -> List[Dict]:
        out: List[Dict] = []
        codes = mpv.split_startcodes(region)
        for idx, (off, code) in enumerate(codes):
            end = codes[idx + 1][0] if idx + 1 < len(codes) \
                else len(region)
            packet = region[off:end]
            payload = packet[4:]
            # frame boundary walk (gstmpegvideoparse.c:495-545)
            boundary = False
            if code == mpv.PACKET_PICTURE:
                boundary = self._have_picture
            elif code == mpv.PACKET_SEQUENCE:
                boundary = bool(self._frame)
            elif code == mpv.PACKET_GOP:
                boundary = bool(self._frame) and (
                    self.props["gop-split"] or not self._seq_open())
            if boundary:
                out += self._emit(pts_ns)
            # content handling
            if code == mpv.PACKET_SEQUENCE:
                self.seq = mpv.parse_sequence_header(payload)
                self._update_caps()
            elif code == mpv.PACKET_EXTENSION and self.seq is not None \
                    and not self._have_picture:
                mpv.parse_sequence_extension(payload, self.seq)
                self._update_caps()
            elif code == mpv.PACKET_PICTURE:
                self._have_picture = True
                self._frame_type = mpv.picture_type(payload)
            elif code == mpv.PACKET_USER_DATA:
                cc = mpv.parse_ga94_captions(payload)
                if cc is not None:
                    self._captions.append(cc)
            self._frame += packet
        return out

    def _seq_open(self) -> bool:
        """True when the open frame already contains a sequence header
        (GOP then aggregates, gstmpegvideoparse.c:519-523)."""
        return self._frame.startswith(b"\x00\x00\x01\xb3")

    def _emit(self, pts_ns: int) -> List[Dict]:
        if not self._frame:
            return []
        data = bytes(self._frame)
        self._frame = bytearray()
        self._have_picture = False
        captions, self._captions = self._captions, []
        ftype, self._frame_type = self._frame_type, 0
        return [dict(data=data, pts=pts_ns,
                     keyframe=ftype in (0, mpv.PICTURE_I),
                     frame_type=ftype, captions=captions,
                     caps=self.src_caps)]

    def process(self, params, state, batch):
        return state, batch


from gstbad_tpu_torch.io import av1obu as av1


@register
class Av1Parse(Element):
    """av1parse (gstav1parse.c): re-frames AV1 between the low-overhead
    obu-stream and annex-b formats at obu / frame / tu alignment.

    Frame completion follows gstav1parse.c:1167-1199: an OBU_FRAME
    always completes (its embedded tile group must cover the frame,
    5.10.1), a FRAME_HEADER completes when show_existing_frame is set,
    and a standalone TILE_GROUP completes when tg_end == num_tiles - 1
    — via the full uncompressed-header/tile_info parse
    (io/av1obu.parse_frame_header) with the reference frame store
    carried across frames.  When the header parse fails (damaged
    stream), the element degrades to the round-2 heuristics:
    FRAME/show-existing-bit completion, tile groups flushed at the
    next temporal delimiter.
    """

    NAME = "av1parse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.in_format = "obu-stream"   # or "annexb"
        self.out_format = "obu-stream"
        self.out_alignment = "tu"       # obu | frame | tu
        self.seq: Optional[av1.SequenceHeader] = None
        self.src_caps: Optional[Dict] = None
        self._buf = b""
        self._pending: List[av1.Obu] = []   # obus of the open frame
        self._tu_frames: List[List[av1.Obu]] = []
        self._pstate = av1.ParserState()
        self._seq_raw: Optional[bytes] = None

    def set_caps(self, stream_format: str = "obu-stream") -> None:
        self.in_format = stream_format

    def set_output(self, stream_format: str = "obu-stream",
                   alignment: str = "tu") -> None:
        self.out_format = stream_format
        self.out_alignment = alignment

    def _update_caps(self) -> None:
        if self.seq is None:
            return
        self.src_caps = {
            "media": "video/x-av1",
            "parsed": True,
            "stream-format": self.out_format,
            "alignment": self.out_alignment,
            "width": self.seq.max_width,
            "height": self.seq.max_height,
            "profile": str(self.seq.profile),
            "bit-depth-luma": self.seq.bit_depth,
            "bit-depth-chroma": self.seq.bit_depth,
        }

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        obus = []
        if self.in_format == "annexb":
            # consume only complete TUs (leb128 tu_size known up front)
            while self._buf:
                try:
                    size, pos = av1.read_leb128(self._buf, 0)
                except (IndexError, ValueError):
                    break
                if len(self._buf) < pos + size:
                    break
                tu = av1.split_annexb(self._buf[:pos + size])
                self._buf = self._buf[pos + size:]
                for frames in tu:
                    for frame in frames:
                        obus += frame
        else:
            # low-overhead: consume whole OBUs, keep the partial tail
            pos = 0
            while pos < len(self._buf):
                try:
                    obu, nxt = av1.parse_obu(self._buf, pos)
                except (IndexError, ValueError):
                    break
                obus.append(obu)
                pos = nxt
            self._buf = self._buf[pos:]
        out: List[Dict] = []
        for obu in obus:
            out += self._collect(obu, pts_ns)
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        out = []
        if self._pending:
            self._tu_frames.append(self._pending)
            self._pending = []
        if self._tu_frames:
            out += self._emit_tu(pts_ns)
        return out

    def _collect(self, obu: av1.Obu, pts_ns: int) -> List[Dict]:
        out: List[Dict] = []
        if obu.obu_type == av1.OBU_SEQUENCE_HEADER:
            self.seq = av1.parse_sequence_header(obu.payload)
            if self._seq_raw is not None and self._seq_raw != obu.payload:
                self._pstate.sequence_changed = True
            self._seq_raw = obu.payload
            self._update_caps()
        if self.out_alignment == "obu":
            # every obu is its own buffer, TDs included (the upstream
            # byte_to_obu expectation starts with the 2-byte TD)
            out.append(self._mk([obu], pts_ns))
            return out
        if obu.obu_type == av1.OBU_TEMPORAL_DELIMITER:
            # TU boundary: flush everything before it
            if self._pending:
                self._tu_frames.append(self._pending)
                self._pending = []
            if self._tu_frames:
                out += self._emit_tu(pts_ns)
        self._pending.append(obu)
        complete = self._frame_complete(obu)
        if complete:
            self._tu_frames.append(self._pending)
            self._pending = []
            if self.out_alignment == "frame":
                out += [self._mk(f, pts_ns) for f in self._tu_frames]
                self._tu_frames = []
        return out

    def _frame_complete(self, obu: av1.Obu) -> bool:
        """gstav1parse.c:1167-1199 over the full header parse, with
        the round-2 heuristics as the damaged-stream fallback."""
        st = self._pstate
        if obu.obu_type in (av1.OBU_FRAME, av1.OBU_FRAME_HEADER,
                            av1.OBU_REDUNDANT_FRAME_HEADER):
            # OBU-ordering guards (gstav1parser.c:4591-4600,4637): a
            # FRAME/FRAME_HEADER while seen_frame_header is set, or a
            # REDUNDANT_FRAME_HEADER with it clear, is a bitstream error
            # upstream — do NOT re-parse (it would overwrite the open
            # frame's tile layout and re-apply reference_frame_update);
            # fall to the degraded heuristics instead.
            ordering_ok = (
                (obu.obu_type == av1.OBU_REDUNDANT_FRAME_HEADER)
                == st.seen_frame_header)
            fh = None
            if self.seq is not None and ordering_ok:
                try:
                    fh = av1.parse_frame_header(obu, self.seq, st)
                except (ValueError, IndexError):
                    fh = None
            if fh is None:  # degraded path
                return obu.obu_type == av1.OBU_FRAME or (
                    obu.obu_type == av1.OBU_FRAME_HEADER
                    and bool(obu.payload) and bool(obu.payload[0] & 0x80))
            if not fh.show_existing_frame or fh.frame_type == av1.FRAME_KEY:
                try:
                    av1.reference_frame_update(st, fh)
                except ValueError:
                    pass
            if obu.obu_type == av1.OBU_FRAME:
                # the embedded tile group must cover the whole frame
                # (5.10.1: tile_start_and_end_present_flag == 0)
                st.seen_frame_header = False
                return True
            return fh.show_existing_frame
        if obu.obu_type == av1.OBU_TILE_GROUP:
            try:
                tg = av1.parse_tile_group(obu.payload, st)
            except (ValueError, IndexError):
                return False  # degraded: flush at the next TD
            return tg.tg_end == tg.num_tiles - 1
        return False

    def _emit_tu(self, pts_ns: int) -> List[Dict]:
        frames, self._tu_frames = self._tu_frames, []
        if self.out_alignment == "frame":
            return [self._mk(f, pts_ns) for f in frames]
        if self.out_format == "annexb":
            return [dict(data=av1.to_annexb_tu(frames), pts=pts_ns,
                         caps=self.src_caps)]
        data = b"".join(o.with_size_field() for f in frames for o in f)
        return [dict(data=data, pts=pts_ns, caps=self.src_caps)]

    def _mk(self, obus: List[av1.Obu], pts_ns: int) -> Dict:
        if self.out_format == "annexb":
            data = av1.to_annexb_tu([obus])
        else:
            data = b"".join(o.with_size_field() for o in obus)
        return dict(data=data, pts=pts_ns, caps=self.src_caps)


from gstbad_tpu_torch.io import vp9


@register
class Vp9Parse(Element):
    """vp9parse (gstvp9parse.c): splits superframes into frames when
    the downstream alignment is frame, produces caps from the keyframe
    header (width/height/profile/bit-depth/chroma), marks delta units
    and decode-only (not-shown) frames — the upstream
    test_split_superframe behaviors."""

    NAME = "vp9parse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.out_alignment = "frame"   # frame | super-frame
        self.hdr: Optional[vp9.FrameHdr] = None
        self.src_caps: Optional[Dict] = None

    def set_output(self, alignment: str = "frame") -> None:
        self.out_alignment = alignment

    def _update_caps(self) -> None:
        h = self.hdr
        if h is None or not h.width:
            return
        self.src_caps = {
            "media": "video/x-vp9",
            "parsed": True,
            "alignment": self.out_alignment,
            "width": h.width,
            "height": h.height,
            "profile": str(h.profile),
            "bit-depth-luma": h.bit_depth,
            "bit-depth-chroma": h.bit_depth,
            "chroma-format": vp9.chroma_format(h),
        }

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        """One input buffer = one (super)frame, like the harness."""
        frames = vp9.split_superframe(data) \
            if self.out_alignment == "frame" else [data]
        out: List[Dict] = []
        for i, f in enumerate(frames):
            hdr = vp9.parse_frame_header(f)
            if hdr.frame_type == vp9.FRAME_KEY \
                    and not hdr.show_existing_frame:
                self.hdr = hdr
                self._update_caps()
            out.append(dict(
                data=f, pts=pts_ns,
                keyframe=(hdr.frame_type == vp9.FRAME_KEY
                          and not hdr.show_existing_frame),
                decode_only=(not hdr.show_frame
                             and not hdr.show_existing_frame),
                caps=self.src_caps))
        return out


from gstbad_tpu_torch.io import mpeg4video as m4


@register
class Mpeg4VideoParse(Element):
    """mpeg4videoparse (gstmpeg4videoparse.c): frames split at VOPs
    with the config block (VOS..VOL[..GOP]) attached to the frame it
    precedes and exposed as codec_data; caps from the VOL (width/
    height/par/fps) and VOS profile/level; config-interval re-inserts
    the config before I-VOPs."""

    NAME = "mpeg4videoparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("config-interval", int, 0, -1, 3600, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.vol: Optional[m4.Vol] = None
        self.config: Optional[bytes] = None
        self.src_caps: Optional[Dict] = None
        self._buf = b""
        self._frame = bytearray()
        self._have_vop = False
        self._vop_type = 0
        self._last_config_ts = None

    def _update_caps(self) -> None:
        if self.vol is None:
            return
        caps = {
            "media": "video/mpeg",
            "mpegversion": 4,
            "systemstream": False,
            "parsed": True,
            "width": self.vol.width,
            "height": self.vol.height,
        }
        if self.vol.par_n:
            caps["pixel-aspect-ratio"] = (self.vol.par_n,
                                          self.vol.par_d)
        if self.vol.fps_n:
            caps["framerate"] = (self.vol.fps_n, self.vol.fps_d)
        if self.vol.profile:
            caps["profile"] = self.vol.profile
            caps["level"] = self.vol.level
        if self.config:
            caps["codec_data"] = self.config
        self.src_caps = caps

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        cut = self._buf.rfind(b"\x00\x00\x01")
        if cut <= 0:
            return []
        region, self._buf = self._buf[:cut], self._buf[cut:]
        return self._scan(region, pts_ns)

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        region, self._buf = self._buf, b""
        out = self._scan(region, pts_ns)
        if self._frame:
            out += self._emit(pts_ns)
        return out

    def _scan(self, region: bytes, pts_ns: int) -> List[Dict]:
        out: List[Dict] = []
        codes = mpv.split_startcodes(region)
        for idx, (off, code) in enumerate(codes):
            end = codes[idx + 1][0] if idx + 1 < len(codes) \
                else len(region)
            packet = region[off:end]
            payload = packet[4:]
            if code == m4.SC_VOP and self._have_vop:
                out += self._emit(pts_ns)
            if code == m4.SC_VOS:
                if self._have_vop:
                    out += self._emit(pts_ns)
                self.vol = self.vol or m4.Vol()
                m4.parse_vos(payload, self.vol)
                self._config_acc = bytearray(packet)
            elif m4.SC_VOL_MIN <= code <= m4.SC_VOL_MAX:
                self.vol = self.vol or m4.Vol()
                m4.parse_vol(payload, self.vol)
                if hasattr(self, "_config_acc"):
                    self._config_acc += packet
                self._update_caps()
            elif code in (m4.SC_VISUAL_OBJECT, m4.SC_GOP,
                          m4.SC_USER_DATA) or code < m4.SC_VOL_MIN:
                if hasattr(self, "_config_acc") and not self._have_vop:
                    self._config_acc += packet
            elif code == m4.SC_VOP:
                if hasattr(self, "_config_acc") and self.config is None:
                    self.config = bytes(self._config_acc)
                    self._update_caps()
                self._have_vop = True
                self._vop_type = m4.vop_coding_type(payload)
            self._frame += packet
        return out

    def _emit(self, pts_ns: int) -> List[Dict]:
        if not self._frame:
            return []
        data = bytes(self._frame)
        self._frame = bytearray()
        had_vop, self._have_vop = self._have_vop, False
        vtype, self._vop_type = self._vop_type, 0
        keyframe = vtype == m4.VOP_I
        if keyframe and had_vop and self.config \
                and not data.startswith(bytes(self.config[:4])) \
                and self._config_due(pts_ns):
            data = self.config + data
        return [dict(data=data, pts=pts_ns, keyframe=keyframe,
                     caps=self.src_caps)]

    def _config_due(self, pts_ns: int) -> bool:
        interval = self.props["config-interval"]
        if interval == 0:
            return False
        if interval < 0:
            return True
        if pts_ns < 0:
            return False
        if self._last_config_ts is None \
                or pts_ns - self._last_config_ts >= interval * NSEC:
            self._last_config_ts = pts_ns
            return True
        return False

    def process(self, params, state, batch):
        return state, batch


from gstbad_tpu_torch.io import h263


@register
class H263Parse(Element):
    """h263parse (gsth263parse.c): frames split at picture start codes;
    caps (width/height/framed/variant) from the picture header."""

    NAME = "h263parse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.src_caps: Optional[Dict] = None
        self._buf = b""

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        out: List[Dict] = []
        while True:
            start = h263.find_psc(self._buf)
            if start < 0:
                # keep a possible partial start code tail
                self._buf = self._buf[-2:]
                break
            nxt = h263.find_psc(self._buf, start + 3)
            if nxt < 0:
                if start:
                    self._buf = self._buf[start:]
                break
            out.append(self._emit(self._buf[start:nxt], pts_ns))
            self._buf = self._buf[nxt:]
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        start = h263.find_psc(self._buf)
        out = []
        if start >= 0:
            out.append(self._emit(self._buf[start:], pts_ns))
        self._buf = b""
        return out

    def _emit(self, frame: bytes, pts_ns: int) -> Dict:
        keyframe = False
        try:
            pic = h263.parse_picture(frame)
            keyframe = pic.intra
            if pic.width:
                self.src_caps = {
                    "media": "video/x-h263",
                    "variant": "itu",
                    "parsed": True,
                    "width": pic.width,
                    "height": pic.height,
                    "h263version": ("h263p" if pic.plusptype
                                    else "h263"),
                }
        except (ValueError, IndexError):
            pass
        return dict(data=frame, pts=pts_ns, keyframe=keyframe,
                    caps=self.src_caps)


import struct as _struct


@register
class Jpeg2000Parse(Element):
    """jpeg2000parse (gstjpeg2000parse.c): frames JPEG 2000
    codestreams (SOC..EOC), unwraps jp2 / j2c 'jp2c' contiguous
    codestream boxes, and produces caps from the SIZ marker: width/
    height from the image area minus offsets, sampling inferred from
    the component subsampling factors (GRAYSCALE / RGB / YBR422 /
    YBR420 / YBR411 / YBR410), colorspace GRAY / sRGB / sYUV, profile
    from Rsiz."""

    NAME = "jpeg2000parse"
    KIND = "host-source"
    PROPERTIES = ()

    MAGIC = b"\xff\x4f\xff\x51"  # SOC + SIZ

    def __init__(self, **props):
        super().__init__(**props)
        self.src_caps: Optional[Dict] = None
        self._buf = b""

    def _siz_caps(self, frame: bytes) -> None:
        """SIZ: Rsiz, Xsiz, Ysiz, XOsiz, YOsiz, tiles..., Csiz,
        per-component (Ssiz, XRsiz, YRsiz)."""
        if frame[:4] != self.MAGIC:
            return
        (lsiz,) = _struct.unpack_from(">H", frame, 4)
        # Rsiz, Xsiz, Ysiz, XOsiz, YOsiz, XTsiz, YTsiz, XTOsiz, YTOsiz
        rsiz, x, y, xo, yo = _struct.unpack_from(">HIIII", frame, 6)
        (csiz,) = _struct.unpack_from(">H", frame, 40)
        comps = [(frame[42 + 3 * i], frame[43 + 3 * i],
                  frame[44 + 3 * i]) for i in range(csiz)]
        width, height = x - xo, y - yo
        dx = [c[1] for c in comps]
        dy = [c[2] for c in comps]
        if csiz == 1:
            sampling, colorspace = "GRAYSCALE", "GRAY"
        elif csiz >= 3 and dx[1] == dx[2] and dy[1] == dy[2]:
            if dx[1] == 1 and dy[1] == 1:
                sampling, colorspace = "RGB", "sRGB"
            elif dx[1] == 2 and dy[1] == 1:
                sampling, colorspace = "YCbCr-4:2:2", "sYUV"
            elif dx[1] == 2 and dy[1] == 2:
                sampling, colorspace = "YCbCr-4:2:0", "sYUV"
            elif dx[1] == 4 and dy[1] == 1:
                sampling, colorspace = "YCbCr-4:1:1", "sYUV"
            elif dx[1] == 4 and dy[1] == 4:
                sampling, colorspace = "YCbCr-4:1:0", "sYUV"
            else:
                sampling, colorspace = "RGB", "sRGB"
        else:
            sampling, colorspace = "RGB", "sRGB"
        self.src_caps = {
            "media": "image/x-jpc",
            "parsed": True,
            "width": width,
            "height": height,
            "sampling": sampling,
            "colorspace": colorspace,
            "profile": rsiz & 0x0FFF,
        }

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        out: List[Dict] = []
        while True:
            start = self._buf.find(self.MAGIC)
            if start < 0:
                self._buf = self._buf[-3:]
                break
            end = self._buf.find(b"\xff\xd9", start + 4)
            if end < 0:
                if start:
                    self._buf = self._buf[start:]
                break
            frame = self._buf[start:end + 2]
            self._buf = self._buf[end + 2:]
            self._siz_caps(frame)
            out.append(dict(data=frame, pts=pts_ns,
                            caps=self.src_caps))
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        return self.push(b"", pts_ns)


# ---------------------------------------------------------------- vc1


@register
class Vc1Parse(Element):
    """vc1parse (gst/videoparsers/gstvc1parse.c): VC-1 / WMV3 stream
    repackaging between the eight stream-formats x three
    header-formats.

    - input framing per stream-format (gstvc1parse.c:1173-1293): 36-byte
      Annex-L sequence layer, BDU start-code scan, packetized ASF/raw
      frames, 8-byte Annex-L frame-layer headers;
    - codec_data sniffing (gstvc1parse.c:2375-2470): 4/5 bytes = ASF
      simple/main STRUCT_C, 36 bytes with 0xC5 = sequence layer,
      longer = advanced ASF (binding byte + 0x0F seq hdr BDU + 0x0E
      entrypoint BDU);
    - stream-format detection when caps don't say
      (gst_vc1_parse_detect, gstvc1parse.c:634-729): scan 4-byte steps
      for the sequence-layer fingerprint, then BDU-startcode check
      behind it, then header-format heuristics;
    - the conversion matrix (gst_vc1_parse_pre_push_frame,
      gstvc1parse.c:1710-2035): drop the sequence-layer unit, emit a
      synthesized sequence layer first, prepend 0x0000010D to raw ASF
      frames (never in simple profile), or wrap in frame-layer headers
      (first frame carries seq hdr + entrypoint BDUs in advanced
      profile, keyframes re-carry the entrypoint);
    - output caps (gst_vc1_parse_update_caps, gstvc1parse.c:876-1094):
      WVC1/advanced + level "0".."4" or WMV3 + simple/main + level
      low/medium/high, codec_data per output header-format.

    Reference quirks reproduced faithfully (documented):
    - gst_vc1_parse_set_caps inverts its profile strcmp tests
      (gstvc1parse.c:2357-2363): caps profile "simple" selects MAIN and
      anything else selects SIMPLE;
    - gst_vc1_parse_handle_seq_layer assigns width from struct A's
      VERT_SIZE and height from HORIZ_SIZE (gstvc1parse.c:2229-2230),
      swapped relative to gst_vc1_parse_make_sequence_layer which
      writes height first (gstvc1parse.c:838-840).
    """

    NAME = "vc1parse"
    KIND = "host-source"

    HEADER_FORMATS = ("none", "asf", "sequence-layer")
    STREAM_FORMATS = ("bdu", "bdu-frame", "sequence-layer-bdu",
                      "sequence-layer-bdu-frame",
                      "sequence-layer-raw-frame",
                      "sequence-layer-frame-layer", "asf", "frame-layer")

    def __init__(self, **props):
        super().__init__(**props)
        self.format = "WMV3"
        self.profile = -1
        self.level = -1
        self.width = 0
        self.height = 0
        self.fps_n = self.fps_d = 0
        self.par_n = self.par_d = 0
        self.fps_from_caps = False
        self.par_from_caps = False
        self.in_header_format = "none"
        self.in_stream_format: Optional[str] = None
        self.out_header_format: Optional[str] = None
        self.out_stream_format: Optional[str] = None
        self.detecting = False
        self.seq_hdr: Optional[vc1.SeqHdr] = None
        self.seq_hdr_data: Optional[bytes] = None
        self.seq_layer: Optional[vc1.SeqLayer] = None
        self.seq_layer_data: Optional[bytes] = None
        self.entrypoint_data: Optional[bytes] = None
        self.src_caps: Optional[Dict] = None
        self._seq_layer_sent = False
        self._frame_layer_first_sent = False
        self._buf = b""

    # -- negotiation ---------------------------------------------------

    def set_caps(self, format: str = "WMV3",
                 profile: Optional[str] = None,
                 width: int = 0, height: int = 0,
                 framerate: Optional[tuple] = None,
                 par: Optional[tuple] = None,
                 header_format: Optional[str] = None,
                 stream_format: Optional[str] = None,
                 codec_data: Optional[bytes] = None) -> None:
        """gst_vc1_parse_set_caps (gstvc1parse.c:2317-2488)."""
        self.width, self.height = width, height
        if framerate and framerate[1]:
            self.fps_n, self.fps_d = framerate
            self.fps_from_caps = True
        if par and par[0] and par[1]:
            self.par_n, self.par_d = par
            self.par_from_caps = True
        self.format = "WVC1" if format == "WVC1" else "WMV3"
        # faithful inverted-strcmp selection (gstvc1parse.c:2357-2363):
        # strcmp()!=0 is truthy, so "simple" falls through to the MAIN
        # branch and every other string takes the SIMPLE branch
        if profile is not None and profile != "simple":
            self.profile = vc1.PROFILE_SIMPLE
        elif profile is not None and profile != "main":
            self.profile = vc1.PROFILE_MAIN
        elif profile is not None and profile != "advanced":
            self.profile = vc1.PROFILE_ADVANCED
        elif self.format == "WVC1":
            self.profile = vc1.PROFILE_ADVANCED
        else:
            self.profile = vc1.PROFILE_MAIN  # or SIMPLE
        self.level = -1
        self.seq_hdr = self.seq_layer = None
        self.seq_hdr_data = self.seq_layer_data = None
        self.entrypoint_data = None
        if codec_data is not None:
            if len(codec_data) in (4, 5):
                # ASF simple/main: STRUCT_C without start codes
                self._handle_seq_hdr(codec_data)
                self.in_header_format = "asf"
            elif len(codec_data) == 36 and codec_data[3] == 0xC5:
                self._handle_seq_layer(codec_data)
                self.in_header_format = "sequence-layer"
            else:
                if len(codec_data) < 1 + 4 + 4 + 4 + 2:
                    raise vc1.Vc1Error(
                        "too small for advanced-profile ASF header")
                if codec_data[1:5] != b"\x00\x00\x01\x0f":
                    raise vc1.Vc1Error(
                        "advanced ASF header must start with the "
                        "SequenceHeader startcode")
                self._handle_bdus(codec_data[1:])
                if self.seq_hdr_data is None \
                        or self.entrypoint_data is None:
                    raise vc1.Vc1Error("advanced ASF codec_data needs "
                                       "sequence + entrypoint headers")
                self.in_header_format = "asf"
        else:
            self.in_header_format = "none"
        if stream_format is None:
            self.detecting = True
        else:
            if stream_format not in self.STREAM_FORMATS:
                raise vc1.Vc1Error(f"bad stream-format {stream_format}")
            self.in_stream_format = stream_format
        self._seq_layer_sent = False
        self._frame_layer_first_sent = False

    def set_output(self, header_format: Optional[str] = None,
                   stream_format: Optional[str] = None) -> None:
        """Downstream fixation (gst_vc1_parse_renegotiate,
        gstvc1parse.c:480-577): unset fields inherit the input."""
        self.out_header_format = header_format
        self.out_stream_format = stream_format

    def _resolved_output(self) -> tuple:
        hf = self.out_header_format or self.in_header_format
        sf = self.out_stream_format or self.in_stream_format
        return hf, sf

    def _check_format_allowed(self) -> None:
        """gst_vc1_parse_is_format_allowed (gstvc1parse.c:326-478)."""
        hf, sf = self._resolved_output()
        inf = self.in_stream_format
        if self.profile == vc1.PROFILE_ADVANCED \
                and sf == "sequence-layer-raw-frame":
            raise vc1.Vc1Error("sequence-layer-raw-frame is not "
                               "allowed in advanced profile")
        if self.profile == vc1.PROFILE_SIMPLE and sf in (
                "bdu", "bdu-frame", "sequence-layer-bdu",
                "sequence-layer-bdu-frame"):
            raise vc1.Vc1Error(
                "output stream-format not allowed in simple profile")
        if hf in ("asf", "sequence-layer") \
                and sf and sf.startswith("sequence-layer-"):
            raise vc1.Vc1Error("sequence-layer-* stream-format makes "
                               f"no sense with header-format {hf}")
        if hf == "none":
            if self.profile != vc1.PROFILE_ADVANCED and sf in (
                    "bdu", "bdu-frame", "frame-layer"):
                raise vc1.Vc1Error("simple/main profile has no "
                                   "sequence header BDU")
            if sf == "asf":
                raise vc1.Vc1Error(
                    "ASF stream-format doesn't carry sequence header")
        if sf == inf:
            return
        allowed = {
            "bdu": ("sequence-layer-bdu", "asf"),
            "bdu-frame": ("sequence-layer-bdu-frame",),
            "sequence-layer-bdu": ("bdu", "asf"),
            "sequence-layer-bdu-frame": ("bdu-frame",),
            "sequence-layer-raw-frame": ("asf",),
            "sequence-layer-frame-layer": ("frame-layer", "asf"),
            "asf": (),
            "frame-layer": ("sequence-layer-frame-layer", "asf"),
        }
        if inf not in allowed.get(sf, ()):
            raise vc1.Vc1Error(
                f"stream conversion {inf} -> {sf} not implemented")

    # -- header handling -----------------------------------------------

    def _handle_seq_hdr(self, data: bytes) -> None:
        """gst_vc1_parse_handle_seq_hdr (gstvc1parse.c:2068-2195)."""
        hdr = vc1.parse_sequence_header(data)
        self.seq_hdr = hdr
        self.seq_hdr_data = bytes(data)
        self.profile = hdr.profile
        if not self.fps_from_caps and hdr.profile != vc1.PROFILE_ADVANCED:
            fps = hdr.struct_c.framerate
            if fps:
                self.fps_n, self.fps_d = fps, 1
        if hdr.profile == vc1.PROFILE_ADVANCED:
            adv = hdr.advanced
            self.level = adv.level
            self.width = adv.max_coded_width
            self.height = adv.max_coded_height
            if not self.fps_from_caps and adv.framerate:
                self.fps_n, self.fps_d = adv.framerate, 1
            if adv.display_ext:
                if not self.par_from_caps and adv.aspect_ratio_flag \
                        and adv.par_n and adv.par_d:
                    self.par_n, self.par_d = adv.par_n, adv.par_d
                if not self.fps_from_caps and adv.framerate_flag \
                        and adv.fps_n and adv.fps_d:
                    self.fps_n, self.fps_d = adv.fps_n, adv.fps_d
        self._update_caps()

    def _handle_seq_layer(self, data: bytes) -> None:
        """gst_vc1_parse_handle_seq_layer (gstvc1parse.c:2197-2264).
        NOTE the faithful width/height swap: width <- VERT_SIZE,
        height <- HORIZ_SIZE (gstvc1parse.c:2229-2230)."""
        sl = vc1.parse_sequence_layer(data)
        self.seq_layer = sl
        self.seq_layer_data = bytes(data)
        self.profile = sl.struct_c.profile
        width = sl.struct_a.vert_size
        height = sl.struct_a.horiz_size
        if width > 0 and height > 0:
            self.width, self.height = width, height
        self.level = sl.struct_b.level
        if not self.fps_from_caps \
                and sl.struct_c.profile != vc1.PROFILE_ADVANCED:
            fps = sl.struct_c.framerate
            if fps in (0, 0xFFFFFFFF, -1):
                fps = sl.struct_b.framerate
            if fps and fps != 0xFFFFFFFF:
                self.fps_n, self.fps_d = fps, 1
        self._update_caps()

    def _handle_bdu(self, typ: int, payload: bytes) -> None:
        if typ == vc1.SEQUENCE:
            self._handle_seq_hdr(payload)
        elif typ == vc1.ENTRYPOINT:
            self.entrypoint_data = bytes(payload)

    def _handle_bdus(self, data: bytes) -> None:
        for typ, off, size in vc1.split_bdus(data):
            self._handle_bdu(typ, data[off:off + size])

    # -- caps ------------------------------------------------------------

    def _update_caps(self) -> None:
        hf, sf = self._resolved_output()
        caps: Dict = {"media": "video/x-wmv", "wmvversion": 3,
                      "header-format": hf, "stream-format": sf}
        if self.width and self.height:
            caps["width"] = self.width
            caps["height"] = self.height
        if self.fps_d:
            caps["framerate"] = (self.fps_n, self.fps_d)
        if self.par_n and self.par_d:
            caps["pixel-aspect-ratio"] = (self.par_n, self.par_d)
        if self.profile == vc1.PROFILE_ADVANCED:
            caps["format"] = "WVC1"
            caps["profile"] = "advanced"
            if self.seq_hdr:
                caps["level"] = str(self.seq_hdr.advanced.level)
        else:
            caps["format"] = "WMV3"
            caps["profile"] = ("simple" if self.profile ==
                               vc1.PROFILE_SIMPLE else "main")
            if self.seq_layer:
                caps["level"] = {0: "low", 1: "medium",
                                 2: "high"}.get(self.level, "high")
        if hf == "asf":
            caps["codec_data"] = self._make_asf_codec_data()
        elif hf == "sequence-layer":
            caps["codec_data"] = self.seq_layer_data \
                or self._make_sequence_layer()
        self.src_caps = caps

    def _make_asf_codec_data(self) -> Optional[bytes]:
        if self.profile != vc1.PROFILE_ADVANCED:
            if self.seq_hdr_data:
                return self.seq_hdr_data[:4]
            if self.seq_layer:
                word = vc1.make_struct_c_from_fields(
                    self.profile, self.seq_layer.struct_c)
                return word.to_bytes(4, "big")
            return None
        if not (self.seq_hdr_data and self.entrypoint_data):
            return None
        binding = 0x29 if self.profile == vc1.PROFILE_SIMPLE else 0x2B
        return bytes([binding]) + b"\x00\x00\x01\x0f" \
            + self.seq_hdr_data + b"\x00\x00\x01\x0e" \
            + self.entrypoint_data

    def _make_sequence_layer(self) -> bytes:
        struct_c = self.seq_hdr.struct_c if self.seq_hdr \
            else vc1.StructC(profile=self.profile)
        return vc1.make_sequence_layer(self.profile, struct_c,
                                       self.width, self.height,
                                       self.level, self.fps_n,
                                       self.fps_d)

    # -- framing ---------------------------------------------------------

    def _detect(self, data: bytes) -> bool:
        """gst_vc1_parse_detect (gstvc1parse.c:634-729)."""
        size = len(data)
        pos = 0
        while size - pos >= 40:
            if data[pos + 3] == 0xC5 \
                    and data[pos + 4:pos + 8] == b"\x04\x00\x00\x00" \
                    and data[pos + 20:pos + 24] == b"\x0c\x00\x00\x00":
                nxt = data[pos + 36:pos + 39]
                if nxt == b"\x00\x00\x01":
                    self.in_stream_format = \
                        "sequence-layer-bdu-frame"
                else:
                    self.in_stream_format = \
                        "sequence-layer-frame-layer"
                self.detecting = False
                return True
            pos += 4
        if size <= 128:
            return False  # request more data
        if self.in_header_format == "asf":
            self.in_stream_format = "asf"
        elif self.in_header_format == "sequence-layer":
            self.in_stream_format = "frame-layer"
        else:
            raise vc1.Vc1Error("can't detect or assume a stream format")
        self.detecting = False
        return True

    def chain(self, data: bytes, pts_ns: int = 0,
              keyframe: bool = True) -> List[Dict]:
        """Push one buffer.  ASF / raw inputs are packetized (one frame
        per call); BDU / frame-layer inputs may carry partial units
        which are buffered across calls."""
        self._buf += data
        if self.detecting:
            if not self._detect(self._buf):
                return []
        out: List[Dict] = []
        for frame, no_frame in self._split_frames():
            out += self._push_one(frame, no_frame, pts_ns, keyframe)
        return out

    def finish(self, pts_ns: int = 0, keyframe: bool = True
               ) -> List[Dict]:
        """EOS drain (GST_BASE_PARSE_DRAINING: an unterminated BDU is
        assumed complete)."""
        out: List[Dict] = []
        if self.detecting and self._buf:
            try:
                self._detect(self._buf)
            except vc1.Vc1Error:
                self._buf = b""
                raise
        for frame, no_frame in self._split_frames():
            out += self._push_one(frame, no_frame, pts_ns, keyframe)
        sf = self.in_stream_format
        bdu_mode = sf in ("bdu", "bdu-frame") or (
            self.seq_layer_data is not None
            and sf in ("sequence-layer-bdu", "sequence-layer-bdu-frame"))
        if bdu_mode and len(self._buf) >= 4:
            # draining: an unterminated BDU is assumed complete
            bdu = vc1.identify_next_bdu(self._buf)
            if bdu is not None:
                frame = self._buf[bdu.sc_offset:]
                self._buf = b""
                self._handle_bdu(frame[3], frame[4:])
                out += self._push_one(frame, False, pts_ns, keyframe)
        self._buf = b""
        return out

    def _split_frames(self):
        """Incremental framing (gst_vc1_parse_handle_frame,
        gstvc1parse.c:1209-1293).  Yields (frame_bytes, no_frame)."""
        sf = self.in_stream_format
        while True:
            buf = self._buf
            if self.seq_layer_data is None and sf in (
                    "sequence-layer-bdu", "sequence-layer-bdu-frame",
                    "sequence-layer-raw-frame",
                    "sequence-layer-frame-layer"):
                if len(buf) < 36:
                    return
                if buf[3] == 0xC5 \
                        and buf[4:8] == b"\x04\x00\x00\x00" \
                        and buf[20:24] == b"\x0c\x00\x00\x00":
                    self._handle_seq_layer(buf[:36])
                    self._buf = buf[36:]
                    yield buf[:36], True
                    continue
                self._buf = buf[1:]  # skipsize 1
                continue
            if sf in ("bdu", "bdu-frame") or (
                    self.seq_layer_data is not None and sf in (
                        "sequence-layer-bdu",
                        "sequence-layer-bdu-frame")):
                if len(buf) < 4:
                    return
                bdu = vc1.identify_next_bdu(buf)
                if bdu is None:
                    self._buf = buf[max(0, len(buf) - 3):]
                    return
                if bdu.sc_offset > 4:
                    self._buf = buf[bdu.sc_offset:]
                    continue
                if bdu.size < 0:
                    return  # need more data
                end = bdu.offset + bdu.size
                frame = buf[bdu.sc_offset:end]
                self._buf = buf[end:]
                startcode = frame[3]
                if startcode != vc1.SEQUENCE and \
                        self.seq_hdr_data is None \
                        and self.seq_layer_data is None:
                    raise vc1.Vc1Error("need sequence header/layer "
                                       "before anything else")
                self._handle_bdu(startcode, frame[4:])
                yield frame, False
                continue
            if sf == "asf" or (self.seq_layer_data is not None
                               and sf == "sequence-layer-raw-frame"):
                if not buf:
                    return
                if self.seq_hdr_data is None \
                        and self.seq_layer_data is None:
                    raise vc1.Vc1Error(
                        "need a sequence header or sequence layer")
                self._buf = b""
                if self.profile == vc1.PROFILE_ADVANCED \
                        and len(buf) >= 8 \
                        and buf[0:3] == b"\x00\x00\x01":
                    self._handle_bdus(buf)
                yield buf, False
                continue
            # frame-layer or sequence-layer-frame-layer
            if len(buf) < 8:
                return
            size = int.from_bytes(buf[0:3], "little") + 8
            if len(buf) < size:
                return
            self._buf = buf[size:]
            yield buf[:size], False

    # -- output conversion -------------------------------------------------

    def _push_one(self, frame: bytes, no_frame: bool, pts_ns: int,
                  keyframe: bool) -> List[Dict]:
        """gst_vc1_parse_pre_push_frame (gstvc1parse.c:1710-2035)."""
        self._check_format_allowed()
        self._update_caps()
        hf, sf = self._resolved_output()
        inf = self.in_stream_format
        out: List[Dict] = []

        def emit(payload: bytes) -> None:
            out.append(dict(data=payload, pts=pts_ns,
                            keyframe=keyframe, caps=self.src_caps))

        if sf == inf:
            emit(frame)
            return out
        needs_seq_layer_first = (
            (sf == "sequence-layer-bdu" and inf in ("bdu", "asf"))
            or (sf == "sequence-layer-bdu-frame" and inf == "bdu-frame")
            or (sf == "sequence-layer-raw-frame" and inf == "asf")
            or (sf == "sequence-layer-frame-layer"
                and inf in ("asf", "frame-layer")))
        drops_seq_layer = (
            (sf == "bdu" and inf == "sequence-layer-bdu")
            or (sf == "bdu-frame" and inf == "sequence-layer-bdu-frame")
            or (sf == "frame-layer"
                and inf == "sequence-layer-frame-layer"))
        if drops_seq_layer and no_frame:
            return out  # GST_BASE_PARSE_FLOW_DROPPED
        if needs_seq_layer_first and not self._seq_layer_sent:
            emit(self.seq_layer_data or self._make_sequence_layer())
            self._seq_layer_sent = True
        if inf == "asf" and sf in ("bdu", "sequence-layer-bdu"):
            emit(self._asf_to_bdu(frame))
        elif inf == "asf" and sf in ("frame-layer",
                                     "sequence-layer-frame-layer"):
            emit(self._to_frame_layer(frame, pts_ns, keyframe))
        else:
            emit(frame)
        return out

    def _asf_to_bdu(self, frame: bytes) -> bytes:
        """gst_vc1_parse_convert_asf_to_bdu (gstvc1parse.c:1568-1623):
        prepend the 0x0000010D frame startcode unless one is already
        there; impossible in simple profile."""
        if self.profile == vc1.PROFILE_SIMPLE:
            raise vc1.Vc1Error("can't convert to bdu in simple profile")
        if len(frame) >= 4 and frame[0:3] == b"\x00\x00\x01":
            return frame
        return b"\x00\x00\x01\x0d" + frame

    def _to_frame_layer(self, frame: bytes, pts_ns: int,
                        keyframe: bool) -> bytes:
        """gst_vc1_parse_convert_to_frame_layer
        (gstvc1parse.c:1625-1709)."""
        header = vc1.make_frame_layer_header(len(frame), keyframe,
                                             pts_ns)
        mid = b""
        if self.profile == vc1.PROFILE_ADVANCED:
            if not self._frame_layer_first_sent:
                mid += b"\x00\x00\x01\x0f" + (self.seq_hdr_data or b"")
                mid += b"\x00\x00\x01\x0e" + (self.entrypoint_data
                                              or b"")
            elif keyframe:
                mid += b"\x00\x00\x01\x0e" + (self.entrypoint_data
                                              or b"")
            if not (len(frame) >= 4 and frame[0:3] == b"\x00\x00\x01"):
                mid += b"\x00\x00\x01\x0d"
        self._frame_layer_first_sent = True
        return header + mid + frame


# ---------------------------------------------------------------- png


@register
class PngParse(Element):
    """pngparse (gst/videoparsers/gstpngparse.c): frames whole PNG files
    out of a byte stream and produces image/png caps from the IHDR.

    Framing walk (gstpngparse.c:127-246 handle_frame): scan to the
    8-byte signature 0x89504E470D0A1A0A (resync scans for the 0x89504E47
    prefix and skips until a full signature lines up), then walk
    length/fourcc chunks — IHDR carries width/height (big-endian at
    payload offsets 0/4); IEND ends the frame.  Caps update only when
    width/height change; an upstream framerate is carried through
    (gstpngparse.c:216-230)."""

    NAME = "pngparse"
    KIND = "host-source"
    PROPERTIES = ()

    SIGNATURE = b"\x89PNG\r\n\x1a\n"     # gstpngparse.c:31

    def __init__(self, **props):
        super().__init__(**props)
        self.width = 0                   # gstpngparse.c:103-104
        self.height = 0
        self.framerate = None            # (num, den) from sink caps
        self.src_caps: Optional[Dict] = None
        self._buf = b""

    def set_caps(self, framerate=None) -> None:
        self.framerate = framerate

    def _parse_one(self) -> Optional[bytes]:
        """One handle_frame pass over the buffered bytes; returns a
        whole signature..IEND frame or None (more data needed)."""
        buf = self._buf
        if len(buf) < 8:
            return None
        if buf[:8] != self.SIGNATURE:
            # resync on the 4-byte prefix, then demand the full
            # signature (gstpngparse.c:145-168)
            off = buf.find(self.SIGNATURE[:4])
            while off >= 0:
                if len(buf) - off < 8:
                    break
                if buf[off:off + 8] == self.SIGNATURE:
                    break
                off = buf.find(self.SIGNATURE[:4], off + 4)
            if off <= 0:
                # keep a 7-byte tail so a split signature can complete
                self._buf = buf[max(0, len(buf) - 7):]
                return None
            self._buf = buf = buf[off:]
            if buf[:8] != self.SIGNATURE:
                return None
        pos = 8
        width = height = 0
        while True:
            if pos + 8 > len(buf):
                return None
            length = int.from_bytes(buf[pos:pos + 4], "big")
            code = buf[pos + 4:pos + 8]
            pos += 8
            if code == b"IHDR":
                if pos + 8 > len(buf):
                    return None
                width = int.from_bytes(buf[pos:pos + 4], "big")
                height = int.from_bytes(buf[pos + 4:pos + 8], "big")
            # chunk payload + CRC (gstpngparse.c:196-197)
            if pos + length + 4 > len(buf):
                return None
            pos += length + 4
            if code == b"IEND":
                break
        if (self.width, self.height) != (width, height):
            self.width, self.height = width, height
            caps = {"media": "image/png", "parsed": True,
                    "width": width, "height": height}
            if self.framerate is not None:
                caps["framerate"] = tuple(self.framerate)
            self.src_caps = caps
        frame, self._buf = buf[:pos], buf[pos:]
        return frame

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        out: List[Dict] = []
        while True:
            frame = self._parse_one()
            if frame is None:
                break
            out.append(dict(data=frame, pts=pts_ns, caps=self.src_caps))
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        return self.push(b"", pts_ns)


# ---------------------------------------------------------------- dirac

from gstbad_tpu_torch.io import dirac as _dirac  # noqa: E402


@register
class DiracParse(Element):
    """diracparse (gst/videoparsers/gstdiracparse.c): frames Dirac/VC-2
    parse units into picture-terminated frames and produces
    video/x-dirac caps from the sequence header.

    Framing (gstdiracparse.c:255-383 handle_frame): resync to 'BBCD',
    then chain parse units by next_parse_offset (0 -> 13) until one
    with SCHRO_PARSE_CODE_IS_PICTURE ends the frame.  A frame whose
    first unit is a sequence header re-parses caps: width/height/
    framerate/PAR/interlace-mode/profile/level
    (gstdiracparse.c:341-372)."""

    NAME = "diracparse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.sequence_header: Optional[_dirac.SequenceHeader] = None
        self.src_caps: Optional[Dict] = None
        self._buf = b""

    def _caps_from_seq_header(self, h: _dirac.SequenceHeader) -> Dict:
        return {
            "media": "video/x-dirac",
            "parsed": True,
            "width": h.width,
            "height": h.height,
            "framerate": (h.frame_rate_numerator,
                          h.frame_rate_denominator),
            "pixel-aspect-ratio": (h.aspect_ratio_numerator,
                                   h.aspect_ratio_denominator),
            "interlace-mode": ("interleaved" if h.interlaced
                               else "progressive"),
            "profile": _dirac.profile_name(h.profile),
            "level": _dirac.level_name(h.level),
        }

    def _parse_one(self) -> Optional[bytes]:
        buf = self._buf
        if len(buf) < 13:
            return None
        if buf[:4] != _dirac.PARSE_INFO_PREFIX:
            off = buf.find(_dirac.PARSE_INFO_PREFIX)
            if off < 0:
                self._buf = buf[max(0, len(buf) - 3):]
                return None
            self._buf = buf = buf[off:]
            if len(buf) < 13:
                return None
        offset = 0
        while True:
            if offset + 13 >= len(buf) + 1:
                return None
            if buf[offset:offset + 4] != _dirac.PARSE_INFO_PREFIX:
                # bad chained header: skip 3 and resync
                # (gstdiracparse.c:310-314)
                self._buf = buf[3:]
                return None
            parse_code = buf[offset + 4]
            next_header = int.from_bytes(buf[offset + 5:offset + 9],
                                         "big")
            if next_header == 0:
                next_header = 13       # gstdiracparse.c:319-320
            have_picture = _dirac.is_picture(parse_code)
            offset += next_header
            if offset > len(buf):
                return None
            if have_picture:
                break
        if buf[4] == _dirac.PARSE_CODE_SEQUENCE_HEADER:
            h = _dirac.parse_sequence_header(buf[13:offset])
            self.sequence_header = h
            self.src_caps = self._caps_from_seq_header(h)
        frame, self._buf = buf[:offset], buf[offset:]
        return frame

    def push(self, data: bytes, pts_ns: int = -1) -> List[Dict]:
        self._buf += data
        out: List[Dict] = []
        while True:
            frame = self._parse_one()
            if frame is None:
                break
            out.append(dict(data=frame, pts=pts_ns, caps=self.src_caps))
        return out

    def finish(self, pts_ns: int = -1) -> List[Dict]:
        return self.push(b"", pts_ns)
