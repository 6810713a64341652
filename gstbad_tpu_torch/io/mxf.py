"""MXF (SMPTE 377M) container demux + OP1a mux (gst/mxf/).

The reference's mxf plugin is a ~40 kLoC metadata framework; this
module implements the operational core a user of mxfdemux/mxfmux needs:

Demux (gst/mxf/mxfdemux.c essentials):
  - KLV triplet walk (16-byte ULs, BER lengths);
  - partition packs (header/body/footer, status byte), primer pack,
    RIP skip;
  - header metadata: local sets via the primer's tag->UL mapping with
    the SMPTE-static tags for Track (TrackID 0x4801, TrackNumber
    0x4804, EditRate 0x4B01) to resolve essence element keys (generic
    container keys 0D 01 03 01, last four bytes = track number, byte
    12 = item type: 05/15 picture, 06/16 sound, 07/17 data);
  - essence elements -> per-track frames with edit-rate timestamps.

Mux: a closed/complete OP1a file with one content package per edit
unit: header partition + primer + minimal-but-valid metadata graph
(preface, identification, content storage, material/source packages,
timeline tracks + sequences + source clips, MPEG video + AES3/wave
audio descriptors, essence container data) and a footer partition.
Validated in tests by ffmpeg's MXF demuxer recovering every essence
byte, and our demuxer round-tripping ffmpeg-muxed MXF (the tsoracle
sample maker encodes real mpeg2video+pcm).

A copy of the JAX package's io/mxf.py: only its imports differ.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Item types in generic-container essence keys (byte 12)
ITEM_CP_PICTURE = 0x05
ITEM_CP_SOUND = 0x06
ITEM_CP_DATA = 0x07
ITEM_GC_PICTURE = 0x15
ITEM_GC_SOUND = 0x16
ITEM_GC_DATA = 0x17

_PICTURE = (ITEM_CP_PICTURE, ITEM_GC_PICTURE)
_SOUND = (ITEM_CP_SOUND, ITEM_GC_SOUND)

KEY_PREFIX_PARTITION = bytes.fromhex("060e2b34020501010d010201")
KEY_PRIMER = bytes.fromhex("060e2b34020501010d01020101050100")
KEY_ESSENCE_PREFIX = bytes.fromhex("060e2b34010201010d010301")
KEY_FILL = bytes.fromhex("060e2b34010101020301021001000000")
KEY_RIP = bytes.fromhex("060e2b34020501010d01020101110100")

# SMPTE-static local tags (377M) used without primer lookup
TAG_INSTANCE_UID = 0x3C0A
TAG_TRACK_ID = 0x4801
TAG_TRACK_NUMBER = 0x4804
TAG_EDIT_RATE = 0x4B01

# metadata set keys (byte 13 is the set kind)
SET_PREFIX = bytes.fromhex("060e2b34025301010d010101")


def ber_length(data: bytes, pos: int) -> Tuple[int, int]:
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    n = b & 0x7F
    return int.from_bytes(data[pos + 1:pos + 1 + n], "big"), pos + 1 + n


def ber_encode(length: int, long_form: int = 0) -> bytes:
    """BER length; long_form forces an n-byte long form (mxf partitions
    conventionally use 4-byte long form)."""
    if not long_form and length < 0x80:
        return bytes([length])
    n = max(long_form, (length.bit_length() + 7) // 8 or 1)
    return bytes([0x80 | n]) + length.to_bytes(n, "big")


@dataclass
class Klv:
    key: bytes
    value: bytes
    offset: int


def walk_klv(data: bytes, pos: int = 0):
    """Yield KLV triplets; stops at truncation."""
    while pos + 17 <= len(data):
        key = data[pos:pos + 16]
        try:
            length, vpos = ber_length(data, pos + 16)
        except IndexError:
            return
        if vpos + length > len(data):
            return
        yield Klv(key, data[vpos:vpos + length], pos)
        pos = vpos + length


def parse_local_set(value: bytes) -> Dict[int, bytes]:
    """Local set: 2-byte tag + 2-byte length items."""
    out = {}
    pos = 0
    while pos + 4 <= len(value):
        tag, ln = struct.unpack_from(">HH", value, pos)
        pos += 4
        out[tag] = value[pos:pos + ln]
        pos += ln
    return out


@dataclass
class MxfTrack:
    track_id: int = 0
    track_number: int = 0
    edit_rate: Tuple[int, int] = (25, 1)
    kind: str = "unknown"     # picture | sound | data


# ------------------------------------------------------------------
# Essence descriptors (gst/mxf/mxfmetadata.c) — the metadata sets that
# map essence to caps.  Set types (metadata_class->type):
#   0x25 FileDescriptor, 0x27 GenericPicture, 0x28 CDCI, 0x29 RGBA,
#   0x42 GenericSound, 0x47 AES3, 0x48 WaveAudio (mxfaes-bwf.c),
#   0x51 MPEGVideo (mxfmpeg.c:394), 0x44 MultipleDescriptor.

@dataclass
class MxfPictureDescriptor:
    """GenericPicture/CDCI/RGBA/MPEGVideo essence descriptor
    (mxfmetadata.c:4343-4528 generic tags, 5437-5500 CDCI tags,
    5770-5800 RGBA pixel layout)."""
    kind: str = "generic"     # generic | cdci | rgba | mpeg
    linked_track_id: int = 0  # 0x3006 (mxfmetadata.c:4171)
    sample_rate: Tuple[int, int] = (0, 1)          # 0x3001
    essence_container: bytes = b""                 # 0x3004
    picture_essence_coding: bytes = b""            # 0x3201
    signal_standard: int = 0                       # 0x3215
    frame_layout: int = 255                        # 0x320c
    stored_width: int = 0                          # 0x3203
    stored_height: int = 0                         # 0x3202
    display_width: int = 0                         # 0x3209
    display_height: int = 0                        # 0x3208
    aspect_ratio: Tuple[int, int] = (0, 0)         # 0x320e
    # CDCI (mxfmetadata.c:5437-5500)
    component_depth: int = 0                       # 0x3301
    horizontal_subsampling: int = 0                # 0x3302
    vertical_subsampling: int = 0                  # 0x3308
    color_siting: int = 0xFF                       # 0x3303
    black_ref_level: int = 0                       # 0x3304
    white_ref_level: int = 0                       # 0x3305
    color_range: int = 0                           # 0x3306
    # RGBA (mxfmetadata.c:5770)
    pixel_layout: bytes = b""                      # 0x3401

    @property
    def codec(self) -> str:
        """Picture essence coding UL -> codec name (the mapping the
        reference's mxfmpeg.c/mxfup.c essence handlers key on)."""
        ul = self.picture_essence_coding
        if len(ul) != 16:
            return "unknown"
        if ul[8:13] == bytes.fromhex("0401020201"):
            sub = ul[13]
            if sub in (0x01, 0x02, 0x03):   # MPEG-2 profiles
                return "mpeg2"
            if sub == 0x20:
                return "mpeg4"
            if 0x31 <= sub <= 0x34:         # AVC byte stream profiles
                return "h264"
        if ul[8:13] == bytes.fromhex("0401020203"):
            return "jpeg2000"
        if ul[8:11] == bytes.fromhex("040201"):
            return "raw"
        return "unknown"


@dataclass
class MxfSoundDescriptor:
    """GenericSound/AES3/WaveAudio essence descriptor
    (mxfmetadata.c:5094-5165 generic tags, mxfaes-bwf.c:125-200
    wave tags)."""
    kind: str = "generic"     # generic | aes3 | wave
    linked_track_id: int = 0                       # 0x3006
    sample_rate: Tuple[int, int] = (0, 1)          # 0x3001
    essence_container: bytes = b""                 # 0x3004
    audio_sampling_rate: Tuple[int, int] = (0, 1)  # 0x3d03
    locked: bool = False                           # 0x3d02
    channel_count: int = 0                         # 0x3d07
    quantization_bits: int = 0                     # 0x3d01
    sound_essence_compression: bytes = b""         # 0x3d06
    block_align: int = 0                           # 0x3d0a (wave)
    avg_bps: int = 0                               # 0x3d09 (wave)

    @property
    def codec(self) -> str:
        ul = self.sound_essence_compression
        if len(ul) != 16 or ul[8:12] == bytes.fromhex("04020201") \
                or not any(ul):
            return "pcm"    # uncompressed sound coding (or unset)
        if ul[8:13] == bytes.fromhex("0402020303"):
            return "ac3"
        if ul[8:13] == bytes.fromhex("0402020302"):
            return "mpeg-audio"
        return "unknown"


@dataclass
class MxfFrame:
    track_number: int
    kind: str
    data: bytes
    position: int             # edit unit index within the track
    pts_ns: int = -1


class MxfDemux:
    """Incremental MXF demuxer (mxfdemux.c's pull walk, push-mode)."""

    def __init__(self):
        self._buf = b""
        self._pos = 0  # consumed bytes (for partition offsets)
        self.tracks: Dict[int, MxfTrack] = {}   # by track_number
        self.partitions = 0
        self._counts: Dict[int, int] = {}
        # essence descriptors, in metadata order
        self.descriptors: List[object] = []

    def push(self, data: bytes) -> List[MxfFrame]:
        self._buf += data
        out: List[MxfFrame] = []
        pos = 0
        while pos + 17 <= len(self._buf):
            key = self._buf[pos:pos + 16]
            if key[:4] != b"\x06\x0e\x2b\x34":
                # resync to the next UL prefix
                idx = self._buf.find(b"\x06\x0e\x2b\x34", pos + 1)
                if idx < 0:
                    pos = len(self._buf)
                    break
                pos = idx
                continue
            try:
                length, vpos = ber_length(self._buf, pos + 16)
            except IndexError:
                break
            if vpos + length > len(self._buf):
                break
            value = self._buf[vpos:vpos + length]
            self._handle(key, value, out)
            pos = vpos + length
        self._buf = self._buf[pos:]
        self._pos += pos
        return out

    def _handle(self, key: bytes, value: bytes,
                out: List[MxfFrame]) -> None:
        if key[:12] == KEY_PREFIX_PARTITION and key[13] in (2, 3, 4):
            self.partitions += 1
            return
        if key[:12] == SET_PREFIX:
            self._metadata_set(key, value)
            return
        if key[:12] == KEY_ESSENCE_PREFIX:
            track_number = struct.unpack(">I", key[12:16])[0]
            item = key[12]
            kind = ("picture" if item in _PICTURE
                    else "sound" if item in _SOUND else "data")
            tr = self.tracks.get(track_number)
            n = self._counts.get(track_number, 0)
            self._counts[track_number] = n + 1
            pts = -1
            if tr and tr.edit_rate[0]:
                pts = n * 1_000_000_000 * tr.edit_rate[1] \
                    // tr.edit_rate[0]
            out.append(MxfFrame(track_number, kind, value, n, pts))

    def _metadata_set(self, key: bytes, value: bytes) -> None:
        # Timeline track sets (key byte 13/14: 01 3b) carry
        # TrackID/TrackNumber/EditRate with SMPTE-static tags
        items = parse_local_set(value)
        if key[13] == 0x01:
            set_type = key[14]
            if set_type in (0x27, 0x28, 0x29, 0x51):
                self.descriptors.append(
                    _parse_picture_descriptor(set_type, items))
                return
            if set_type in (0x42, 0x47, 0x48):
                self.descriptors.append(
                    _parse_sound_descriptor(set_type, items))
                return
        if TAG_TRACK_NUMBER in items and TAG_TRACK_ID in items:
            num = int.from_bytes(items[TAG_TRACK_NUMBER], "big")
            if num == 0:
                return  # material package track
            tr = MxfTrack(
                track_id=int.from_bytes(items[TAG_TRACK_ID], "big"),
                track_number=num)
            if TAG_EDIT_RATE in items and \
                    len(items[TAG_EDIT_RATE]) == 8:
                n, d = struct.unpack(">II", items[TAG_EDIT_RATE])
                tr.edit_rate = (n, d)
            item = (num >> 24) & 0xFF
            tr.kind = ("picture" if item in _PICTURE
                       else "sound" if item in _SOUND else "data")
            self.tracks[num] = tr

    def descriptor_for_track(self, track_number: int):
        """The essence descriptor linked to a track (0x3006
        LinkedTrackID joins the source package's TrackID,
        mxfdemux.c's track<->descriptor resolution)."""
        tr = self.tracks.get(track_number)
        if tr is None:
            return None
        for d in self.descriptors:
            if d.linked_track_id == tr.track_id:
                return d
        # single-essence files may omit the linkage
        want = (MxfPictureDescriptor if tr.kind == "picture"
                else MxfSoundDescriptor)
        single = [d for d in self.descriptors if isinstance(d, want)]
        return single[0] if len(single) == 1 else None

    def track_caps(self, track_number: int) -> Dict[str, object]:
        """Caps-style dict for a track from its descriptor (the
        mxf_metadata_*_descriptor_to_structure analogs +
        set_caps walks, mxfmetadata.c:4545,4946,5176)."""
        tr = self.tracks.get(track_number)
        d = self.descriptor_for_track(track_number)
        if tr is None or d is None:
            return {}
        if isinstance(d, MxfPictureDescriptor):
            caps = {"kind": "video", "codec": d.codec,
                    "width": d.stored_width,
                    "height": d.stored_height,
                    "framerate": tr.edit_rate,
                    "interlaced": d.frame_layout not in (0, 255)}
            if d.aspect_ratio[0] and d.aspect_ratio[1]:
                caps["aspect-ratio"] = d.aspect_ratio
            if d.kind == "cdci" and d.horizontal_subsampling:
                caps["depth"] = d.component_depth or 8
                caps["subsampling"] = (d.horizontal_subsampling,
                                       d.vertical_subsampling or 1)
            if d.kind == "rgba" and d.pixel_layout:
                caps["pixel-layout"] = d.pixel_layout
            return caps
        caps = {"kind": "audio", "codec": d.codec,
                "rate": (d.audio_sampling_rate[0]
                         // max(d.audio_sampling_rate[1], 1)),
                "channels": d.channel_count,
                "bits": d.quantization_bits}
        if d.block_align:
            caps["block-align"] = d.block_align
        return caps


def _u32(v: bytes) -> int:
    return int.from_bytes(v[:4], "big") if len(v) >= 4 else 0


def _rat(v: bytes) -> Tuple[int, int]:
    if len(v) == 8:
        return struct.unpack(">II", v)
    return (0, 1)


def _parse_picture_descriptor(set_type: int, items: Dict[int, bytes]
                              ) -> MxfPictureDescriptor:
    d = MxfPictureDescriptor(
        kind={0x27: "generic", 0x28: "cdci", 0x29: "rgba",
              0x51: "mpeg"}[set_type])
    d.linked_track_id = _u32(items.get(0x3006, b""))
    d.sample_rate = _rat(items.get(0x3001, b""))
    d.essence_container = items.get(0x3004, b"")
    d.picture_essence_coding = items.get(0x3201, b"")
    if 0x3215 in items:
        d.signal_standard = items[0x3215][0]
    if 0x320C in items and items[0x320C]:
        d.frame_layout = items[0x320C][0]
    d.stored_width = _u32(items.get(0x3203, b""))
    d.stored_height = _u32(items.get(0x3202, b""))
    d.display_width = _u32(items.get(0x3209, b"")) or d.stored_width
    d.display_height = _u32(items.get(0x3208, b"")) or d.stored_height
    d.aspect_ratio = _rat(items.get(0x320E, b""))
    if set_type in (0x28, 0x51):   # MPEGVideo extends CDCI
        d.component_depth = _u32(items.get(0x3301, b""))
        d.horizontal_subsampling = _u32(items.get(0x3302, b""))
        d.vertical_subsampling = _u32(items.get(0x3308, b""))
        if 0x3303 in items and items[0x3303]:
            d.color_siting = items[0x3303][0]
        d.black_ref_level = _u32(items.get(0x3304, b""))
        d.white_ref_level = _u32(items.get(0x3305, b""))
        d.color_range = _u32(items.get(0x3306, b""))
    if set_type == 0x29:
        d.pixel_layout = items.get(0x3401, b"")
    return d


def _parse_sound_descriptor(set_type: int, items: Dict[int, bytes]
                            ) -> MxfSoundDescriptor:
    d = MxfSoundDescriptor(
        kind={0x42: "generic", 0x47: "aes3", 0x48: "wave"}[set_type])
    d.linked_track_id = _u32(items.get(0x3006, b""))
    d.sample_rate = _rat(items.get(0x3001, b""))
    d.essence_container = items.get(0x3004, b"")
    d.audio_sampling_rate = _rat(items.get(0x3D03, b""))
    if 0x3D02 in items and items[0x3D02]:
        d.locked = items[0x3D02][0] != 0
    d.channel_count = _u32(items.get(0x3D07, b""))
    d.quantization_bits = _u32(items.get(0x3D01, b""))
    d.sound_essence_compression = items.get(0x3D06, b"")
    if 0x3D0A in items and len(items[0x3D0A]) == 2:
        d.block_align = struct.unpack(">H", items[0x3D0A])[0]
    d.avg_bps = _u32(items.get(0x3D09, b""))
    return d


# ----------------------------------------------------------------------
# OP1a mux (the ffmpeg-interoperable subset of gst/mxf/mxfmux.c)

UL_OP1A = bytes.fromhex("060e2b34040101010d01020101010900")
UL_EC_MPEG_ES = bytes.fromhex("060e2b34040101020d01030102046001")
UL_EC_AES3 = bytes.fromhex("060e2b34040101010d01030102060300")
UL_EC_GENERIC = bytes.fromhex("060e2b34040101030d010301027f0100")
UL_DATADEF_PICTURE = bytes.fromhex("060e2b34040101010103020201000000")
UL_DATADEF_SOUND = bytes.fromhex("060e2b34040101010103020202000000")
UL_DATADEF_TIMECODE = bytes.fromhex("060e2b34040101010103020101000000")
UL_PEC_MPEG2_MPML = bytes.fromhex("060e2b34040101030401020201011100")
# AVC byte-stream frame-wrapped essence container + High-profile coding
# (the ULs ffmpeg's mxfenc writes; SMPTE RP224/ST 381-3)
UL_EC_AVC = bytes.fromhex("060e2b340401010a0d01030102106001")
UL_PEC_AVC_HIGH = bytes.fromhex("060e2b340401010a0401020201311101")
# BWF frame-wrapped sound essence container (SMPTE 382M)
UL_EC_BWF = bytes.fromhex("060e2b34040101010d01030102060100")

KEY_HEADER_PARTITION = bytes.fromhex("060e2b34020501010d01020101020400")
KEY_BODY_PARTITION = bytes.fromhex("060e2b34020501010d01020101030400")
KEY_FOOTER_PARTITION = bytes.fromhex("060e2b34020501010d01020101040400")

TRACKNUM_VIDEO = 0x15010500
TRACKNUM_AUDIO = 0x16010300

# the SMPTE-static local tags this writer emits, for the primer pack
_PRIMER_TAGS = [
    0x3C0A, 0x3B02, 0x3B05, 0x3B07, 0x3B06, 0x3B03, 0x3B09, 0x3B0A,
    0x3B0B, 0x3C09, 0x3C01, 0x3C02, 0x3C04, 0x3C05, 0x3C06, 0x1901,
    0x1902, 0x4401, 0x4405, 0x4404, 0x4403, 0x4701, 0x4801, 0x4804,
    0x4B01, 0x4B02, 0x4803, 0x0201, 0x0202, 0x1001, 0x1201, 0x1101,
    0x1102, 0x1501, 0x1502, 0x1503, 0x3001, 0x3004, 0x3F01, 0x3006,
    0x3203, 0x3202, 0x3209, 0x3208, 0x320C, 0x320E, 0x3201, 0x3301,
    0x3302, 0x3308, 0x3D02, 0x3D03, 0x3D07, 0x3D01, 0x3D0A, 0x3D09,
    0x2701, 0x3F06, 0x3F07,
]
# tag -> defining UL: mxfdemux resolves via its own table; a zero UL in
# the primer is accepted by ffmpeg (it keys on the tag values)
_UL_ZERO = bytes(16)


def _item(tag: int, value: bytes) -> bytes:
    return struct.pack(">HH", tag, len(value)) + value


def _set(kind: int, items: List[bytes]) -> bytes:
    body = b"".join(items)
    key = SET_PREFIX + bytes([0x01, 0x01, kind, 0x00])
    return key + ber_encode(len(body), long_form=4) + body


def _rational(n: int, d: int) -> bytes:
    return struct.pack(">II", n, d)


def _batch(uls: List[bytes]) -> bytes:
    return struct.pack(">II", len(uls), 16 if uls else 0) \
        + b"".join(uls)


class MxfMux:
    """OP1a writer: one video (MPEG-ES wrapped) and/or audio (AES3/PCM)
    track, closed+complete partitions, the ffmpeg-shaped metadata graph
    (the set/UL layout ffmpeg's own mxfenc emits — the lingua franca
    every MXF reader accepts)."""

    KAG = 512

    def __init__(self, edit_rate=(25, 1), width: int = 0,
                 height: int = 0, audio_rate: int = 48000,
                 channels: int = 2, bits: int = 16,
                 video_codec: str = "mpeg2",
                 audio_desc: str = "aes3"):
        self.edit_rate = edit_rate
        self.width = width
        self.height = height
        self.audio_rate = audio_rate
        self.channels = channels
        self.bits = bits
        self.has_video = width > 0
        self.has_audio = channels > 0
        # "mpeg2" -> MPEGVideo descriptor (set 0x51, MPEG-ES container);
        # "h264" -> CDCI descriptor (set 0x28) with the AVC coding +
        # byte-stream container ULs
        if video_codec not in ("mpeg2", "h264"):
            raise ValueError(f"video_codec {video_codec!r}")
        if audio_desc not in ("aes3", "wave"):
            raise ValueError(f"audio_desc {audio_desc!r}")
        self.video_codec = video_codec
        self.audio_desc = audio_desc
        self._uuid_n = 0
        self._frames: List[Tuple[int, bytes]] = []  # (tracknum, data)
        self.duration = 0

    def _uuid(self) -> bytes:
        self._uuid_n += 1
        return b"\x74\x70\x75\x4d\x58\x46\x00\x00" \
            + self._uuid_n.to_bytes(8, "big")

    @staticmethod
    def _umid(uuid: bytes) -> bytes:
        return bytes.fromhex("060a2b340101010501010d4313000000") + uuid

    def add_video(self, data: bytes) -> None:
        self._frames.append((TRACKNUM_VIDEO, data))
        self.duration = max(
            self.duration,
            sum(1 for t, _ in self._frames if t == TRACKNUM_VIDEO))

    def add_audio(self, data: bytes) -> None:
        self._frames.append((TRACKNUM_AUDIO, data))
        if not self.has_video:
            self.duration = max(
                self.duration,
                sum(1 for t, _ in self._frames if t == TRACKNUM_AUDIO))

    # -- low-level writers ---------------------------------------------------

    def _klv(self, key: bytes, value: bytes) -> bytes:
        return key + ber_encode(len(value), long_form=4) + value

    def _fill_to(self, blob: bytearray, boundary: int) -> None:
        """KLV fill item up to the next KAG boundary (the fill KLV
        itself is 16-byte key + 5-byte BER long form + value)."""
        need = (-len(blob)) % boundary
        if need and need < 21:
            need += boundary
        if need:
            blob += KEY_FILL + ber_encode(need - 21, long_form=4) \
                + b"\x00" * (need - 21)

    @property
    def _video_ec(self) -> bytes:
        return UL_EC_AVC if self.video_codec == "h264" else UL_EC_MPEG_ES

    @property
    def _audio_ec(self) -> bytes:
        return UL_EC_BWF if self.audio_desc == "wave" else UL_EC_AES3

    def _partition_pack(self, key: bytes, this_partition: int,
                        footer: int, header_bytes: int,
                        body_sid: int, body_offset: int = 0) -> bytes:
        ecs = []
        if self.has_video:
            ecs.append(self._video_ec)
        if self.has_audio:
            ecs.append(self._audio_ec)
        v = struct.pack(">HHIQQQ", 1, 3, self.KAG, this_partition, 0,
                        footer)
        v += struct.pack(">QQ", header_bytes, 0)  # header, index bytes
        v += struct.pack(">I", 0)                 # index SID
        v += struct.pack(">QI", body_offset, body_sid)
        v += UL_OP1A
        v += _batch(ecs)
        return self._klv(key, v)

    def _primer(self) -> bytes:
        body = struct.pack(">II", len(_PRIMER_TAGS), 18)
        for tag in _PRIMER_TAGS:
            body += struct.pack(">H", tag) + _UL_ZERO
        return self._klv(KEY_PRIMER, body)

    # -- metadata graph --------------------------------------------------------

    def _metadata(self) -> bytes:
        u = {}
        for name in ("preface", "ident", "storage", "ecd", "mpkg",
                     "spkg", "mdesc", "vdesc", "adesc"):
            u[name] = self._uuid()
        mat_umid = self._umid(self._uuid())
        src_umid = self._umid(self._uuid())
        dur = struct.pack(">q", self.duration)
        er = _rational(*self.edit_rate)

        tracks = []   # (material track uuid, source track uuid) sets
        sets = []

        def track(kind_num, track_id, datadef, components,
                  track_number):
            seq_u = self._uuid()
            tr_u = self._uuid()
            comp_sets = []
            comp_uuids = []
            for comp in components:
                cu = self._uuid()
                comp_uuids.append(cu)
                comp_sets.append(_set(comp[0], [
                    _item(TAG_INSTANCE_UID, cu)] + comp[1]))
            seq = _set(0x0F, [
                _item(TAG_INSTANCE_UID, seq_u),
                _item(0x0201, datadef),
                _item(0x0202, dur),
                _item(0x1001, _batch(comp_uuids)),
            ])
            tr = _set(0x3B, [
                _item(TAG_INSTANCE_UID, tr_u),
                _item(0x4801, struct.pack(">I", track_id)),
                _item(0x4804, struct.pack(">I", track_number)),
                _item(0x4B01, er),
                _item(0x4B02, struct.pack(">q", 0)),
                _item(0x4803, seq_u),
            ])
            sets.extend(comp_sets)
            sets.append(seq)
            sets.append(tr)
            return tr_u

        # material package tracks: timecode + one per essence track
        mat_tracks = []
        mat_tracks.append(track(
            0x14, 1, UL_DATADEF_TIMECODE,
            [(0x14, [_item(0x0201, UL_DATADEF_TIMECODE),
                     _item(0x0202, dur),
                     _item(0x1501, struct.pack(">q", 0)),
                     _item(0x1502, struct.pack(
                         ">H", self.edit_rate[0]
                         // max(1, self.edit_rate[1]))),
                     _item(0x1503, b"\x00")])],
            0))
        src_track_ids = {}
        tid = 2
        for kind, present, datadef in (
                ("video", self.has_video, UL_DATADEF_PICTURE),
                ("audio", self.has_audio, UL_DATADEF_SOUND)):
            if not present:
                continue
            src_track_ids[kind] = tid
            mat_tracks.append(track(
                0x11, tid, datadef,
                [(0x11, [_item(0x0201, datadef),
                         _item(0x0202, dur),
                         _item(0x1201, struct.pack(">q", 0)),
                         _item(0x1101, src_umid),
                         _item(0x1102, struct.pack(">I", tid))])],
                0))
            tid += 1

        # source package tracks (the essence container mapping)
        src_tracks = []
        src_tracks.append(track(
            0x14, 1, UL_DATADEF_TIMECODE,
            [(0x14, [_item(0x0201, UL_DATADEF_TIMECODE),
                     _item(0x0202, dur),
                     _item(0x1501, struct.pack(">q", 0)),
                     _item(0x1502, struct.pack(
                         ">H", self.edit_rate[0]
                         // max(1, self.edit_rate[1]))),
                     _item(0x1503, b"\x00")])],
            0))
        null_umid = bytes(32)
        for kind, tracknum, datadef in (
                ("video", TRACKNUM_VIDEO, UL_DATADEF_PICTURE),
                ("audio", TRACKNUM_AUDIO, UL_DATADEF_SOUND)):
            if kind not in src_track_ids:
                continue
            src_tracks.append(track(
                0x11, src_track_ids[kind], datadef,
                [(0x11, [_item(0x0201, datadef),
                         _item(0x0202, dur),
                         _item(0x1201, struct.pack(">q", 0)),
                         _item(0x1101, null_umid),
                         _item(0x1102, struct.pack(">I", 0))])],
                tracknum))

        # descriptors (full caps fields: stored+display sizes, frame
        # layout, reduced aspect ratio; CDCI subsampling for h264 —
        # mxf_metadata_*_descriptor_from_caps, mxfmetadata.c:5030+)
        import math
        sub_descs = []
        if self.has_video:
            g = math.gcd(self.width, self.height) or 1
            common = [
                _item(TAG_INSTANCE_UID, u["vdesc"]),
                _item(0x3006, struct.pack(
                    ">I", src_track_ids["video"])),
                _item(0x3001, er),
                _item(0x3004, self._video_ec),
                _item(0x3203, struct.pack(">I", self.width)),
                _item(0x3202, struct.pack(">I", self.height)),
                _item(0x3209, struct.pack(">I", self.width)),
                _item(0x3208, struct.pack(">I", self.height)),
                _item(0x320C, b"\x00"),  # full frame (progressive)
                _item(0x320E, _rational(self.width // g,
                                        self.height // g)),
            ]
            if self.video_codec == "h264":
                # CDCI descriptor: 8-bit 4:2:0 + the AVC coding UL
                sets.append(_set(0x28, common + [
                    _item(0x3301, struct.pack(">I", 8)),
                    _item(0x3302, struct.pack(">I", 2)),
                    _item(0x3308, struct.pack(">I", 2)),
                    _item(0x3201, UL_PEC_AVC_HIGH),
                ]))
            else:
                sets.append(_set(0x51, common + [
                    _item(0x3201, UL_PEC_MPEG2_MPML),
                ]))
            sub_descs.append(u["vdesc"])
        if self.has_audio:
            audio_common = [
                _item(TAG_INSTANCE_UID, u["adesc"]),
                _item(0x3006, struct.pack(
                    ">I", src_track_ids["audio"])),
                _item(0x3001, _rational(self.audio_rate, 1)),
                _item(0x3004, self._audio_ec),
                _item(0x3D02, b"\x01"),
                _item(0x3D03, _rational(self.audio_rate, 1)),
                _item(0x3D07, struct.pack(">I", self.channels)),
                _item(0x3D01, struct.pack(">I", self.bits)),
                _item(0x3D0A, struct.pack(
                    ">H", self.channels * self.bits // 8)),
            ]
            if self.audio_desc == "wave":
                sets.append(_set(0x48, audio_common + [
                    _item(0x3D09, struct.pack(
                        ">I", self.audio_rate * self.channels
                        * self.bits // 8)),
                ]))
            else:
                sets.append(_set(0x47, audio_common))
            sub_descs.append(u["adesc"])
        descriptor = sub_descs[0]
        if len(sub_descs) > 1:
            sets.append(_set(0x44, [
                _item(TAG_INSTANCE_UID, u["mdesc"]),
                _item(0x3001, er),
                _item(0x3004, UL_EC_GENERIC),
                _item(0x3F01, _batch(sub_descs)),
            ]))
            descriptor = u["mdesc"]

        packages = [_set(0x36, [
            _item(TAG_INSTANCE_UID, u["mpkg"]),
            _item(0x4401, mat_umid),
            _item(0x4405, bytes(8)),
            _item(0x4404, bytes(8)),
            _item(0x4403, _batch(mat_tracks)),
        ]), _set(0x37, [
            _item(TAG_INSTANCE_UID, u["spkg"]),
            _item(0x4401, src_umid),
            _item(0x4405, bytes(8)),
            _item(0x4404, bytes(8)),
            _item(0x4403, _batch(src_tracks)),
            _item(0x4701, descriptor),
        ])]

        head = [_set(0x2F, [
            _item(TAG_INSTANCE_UID, u["preface"]),
            _item(0x3B02, bytes(8)),
            _item(0x3B05, b"\x01\x03"),
            _item(0x3B07, struct.pack(">I", 1)),
            _item(0x3B06, _batch([u["ident"]])),
            _item(0x3B03, u["storage"]),
            _item(0x3B09, UL_OP1A),
            _item(0x3B0A, _batch(
                ([self._video_ec] if self.has_video else [])
                + ([self._audio_ec] if self.has_audio else []))),
            _item(0x3B0B, struct.pack(">II", 0, 0)),
        ]), _set(0x30, [
            _item(TAG_INSTANCE_UID, u["ident"]),
            _item(0x3C09, self._uuid()),
            _item(0x3C01, "gstbad_tpu".encode("utf-16-be") + b"\x00\x00"),
            _item(0x3C02, "mxfmux".encode("utf-16-be") + b"\x00\x00"),
            _item(0x3C04, "1.0".encode("utf-16-be") + b"\x00\x00"),
            _item(0x3C05, self._uuid()),
            _item(0x3C06, bytes(8)),
        ]), _set(0x18, [
            _item(TAG_INSTANCE_UID, u["storage"]),
            _item(0x1901, _batch([u["mpkg"], u["spkg"]])),
            _item(0x1902, _batch([u["ecd"]])),
        ])]
        tail = [_set(0x23, [
            _item(TAG_INSTANCE_UID, u["ecd"]),
            _item(0x2701, src_umid),
            _item(0x3F07, struct.pack(">I", 1)),  # body SID
            _item(0x3F06, struct.pack(">I", 0)),  # index SID
        ])]
        return b"".join(head + packages + sets + tail)

    # -- assembly --------------------------------------------------------------

    def finish(self) -> bytes:
        """The complete file (header metadata needs the final
        duration, so this writer is file-at-EOS like mxfmux's
        non-streamable path)."""
        meta = self._primer() + self._metadata()
        out = bytearray()
        out += self._partition_pack(KEY_HEADER_PARTITION, 0, 0, 0, 0)
        hdr_start = len(out)
        out += meta
        self._fill_to(out, self.KAG)
        header_bytes = len(out) - hdr_start
        body_start = len(out)
        out += self._partition_pack(KEY_BODY_PARTITION, body_start,
                                    0, 0, 1)
        self._fill_to(out, self.KAG)
        for tracknum, data in self._frames:
            key = KEY_ESSENCE_PREFIX + struct.pack(">I", tracknum)
            out += self._klv(key, data)
        footer_start = len(out)
        out += self._partition_pack(KEY_FOOTER_PARTITION, footer_start,
                                    footer_start, 0, 0)
        # patch footer offset + header byte count into the packs
        final = bytearray(out)
        for off in (0, body_start, footer_start):
            struct.pack_into(">Q", final, off + 16 + 5 + 8 + 16,
                             footer_start)
        struct.pack_into(">Q", final, 0 + 16 + 5 + 8 + 24,
                         header_bytes)
        return bytes(final)
