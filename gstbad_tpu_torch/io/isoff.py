"""ISO BMFF box parsing (gst-libs/gst/isoff/gstisoff.c) — the library
dashdemux and mssdemux share for moof/moov/sidx and the
smooth-streaming tfxd/tfrf UUID boxes.

Transcribed behaviors:
  - box headers: 32-bit size, size==1 -> 64-bit largesize, 'uuid' ->
    16-byte extended type; header_size counts everything up to the
    payload (gstisoff.c:68-108);
  - mfhd must be EXACTLY 8 payload bytes with version 0 / flags 0
    (gstisoff.c:142-162);
  - tfhd/trun optional fields gated by their flags words
    (gstisoff.c:164-263, flag values gstisoff.h:112-143);
  - tfdt/tfxd/tfrf 32/64-bit time fields by version bit
    (gstisoff.c:265-404);
  - traf requires a tfhd, moof requires an mfhd, trak requires
    tkhd+mdia, mdia requires mdhd+hdlr (parse failures return None);
  - the sidx parser is incremental (INIT/HEADER/DATA/FINISHED states)
    with entry pts/offset accumulation in nanoseconds; its flags field
    is read as 24-bit LITTLE-endian — a reference quirk reproduced
    faithfully (gstisoff.c:844);
  - hdlr handler_type is read little-endian so it compares equal to
    the 'soun'/'vide' fourcc bytes in file order (gstisoff.c:593-612).

Errors: parse functions return None / raise IsoffError (a ValueError)
on malformed input, never IndexError/struct.error.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

GST_SECOND = 1_000_000_000
CLOCK_TIME_NONE = (1 << 64) - 1

# smooth-streaming UUIDs (gstisoff.c:45-53)
TFRF_UUID = bytes([0xd4, 0x80, 0x7e, 0xf2, 0xca, 0x39, 0x46, 0x95,
                   0x8e, 0x54, 0x26, 0xcb, 0x9e, 0x46, 0xa7, 0x9f])
TFXD_UUID = bytes([0x6d, 0x1d, 0x9b, 0x05, 0x42, 0xd5, 0x44, 0xe6,
                   0x80, 0xe2, 0x14, 0x1d, 0xaf, 0xf7, 0x57, 0xb2])

# tfhd flags (gstisoff.h:112-118)
TFHD_BASE_DATA_OFFSET_PRESENT = 0x000001
TFHD_SAMPLE_DESCRIPTION_INDEX_PRESENT = 0x000002
TFHD_DEFAULT_SAMPLE_DURATION_PRESENT = 0x000008
TFHD_DEFAULT_SAMPLE_SIZE_PRESENT = 0x000010
TFHD_DEFAULT_SAMPLE_FLAGS_PRESENT = 0x000020
TFHD_DURATION_IS_EMPTY = 0x010000
TFHD_DEFAULT_BASE_IS_MOOF = 0x020000

# trun flags (gstisoff.h:138-143)
TRUN_DATA_OFFSET_PRESENT = 0x000001
TRUN_FIRST_SAMPLE_FLAGS_PRESENT = 0x000004
TRUN_SAMPLE_DURATION_PRESENT = 0x000100
TRUN_SAMPLE_SIZE_PRESENT = 0x000200
TRUN_SAMPLE_FLAGS_PRESENT = 0x000400
TRUN_SAMPLE_COMPOSITION_TIME_OFFSETS_PRESENT = 0x000800


class IsoffError(ValueError):
    pass


class ByteReader:
    """gst_byte_reader analog: bounded big/little-endian reads."""

    def __init__(self, data: bytes, start: int = 0,
                 end: Optional[int] = None):
        self.data = data
        self.pos = start
        self.end = len(data) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def _take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise IsoffError("not enough data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def u16be(self) -> int:
        return struct.unpack(">H", self._take(2))[0]

    def u24be(self) -> int:
        return int.from_bytes(self._take(3), "big")

    def u24le(self) -> int:
        return int.from_bytes(self._take(3), "little")

    def u32be(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def u64be(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def skip(self, n: int) -> None:
        self._take(n)

    def sub(self, n: int) -> "ByteReader":
        if self.remaining() < n:
            raise IsoffError("not enough data for sub reader")
        r = ByteReader(self.data, self.pos, self.pos + n)
        self.pos += n
        return r


def parse_box_header(r: ByteReader
                     ) -> Optional[Tuple[bytes, bytes, int, int]]:
    """(fourcc, extended_type, header_size, size) or None when more
    data is needed (gst_isoff_parse_box_header)."""
    start = r.pos
    if r.remaining() < 8:
        return None
    size = r.u32be()
    fourcc = r._take(4)
    if size == 1:
        if r.remaining() < 8:
            r.pos = start
            return None
        size = r.u64be()
    extended = b""
    if fourcc == b"uuid":
        if r.remaining() < 16:
            r.pos = start
            return None
        extended = r._take(16)
    return fourcc, extended, r.pos - start, size


@dataclasses.dataclass
class MfhdBox:
    sequence_number: int = 0


@dataclasses.dataclass
class TfhdBox:
    version: int = 0
    flags: int = 0
    track_id: int = 0
    base_data_offset: int = 0
    sample_description_index: int = 0
    default_sample_duration: int = 0
    default_sample_size: int = 0
    default_sample_flags: int = 0


@dataclasses.dataclass
class TrunSample:
    sample_duration: int = 0
    sample_size: int = 0
    sample_flags: int = 0
    sample_composition_time_offset: int = 0


@dataclasses.dataclass
class TrunBox:
    version: int = 0
    flags: int = 0
    sample_count: int = 0
    data_offset: int = 0
    first_sample_flags: int = 0
    samples: List[TrunSample] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TfdtBox:
    decode_time: int = CLOCK_TIME_NONE


@dataclasses.dataclass
class TfxdBox:
    version: int = 0
    flags: int = 0
    time: int = 0
    duration: int = 0


@dataclasses.dataclass
class TfrfEntry:
    time: int = 0
    duration: int = 0


@dataclasses.dataclass
class TfrfBox:
    version: int = 0
    flags: int = 0
    entries: List[TfrfEntry] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TrafBox:
    tfhd: TfhdBox = dataclasses.field(default_factory=TfhdBox)
    tfdt: TfdtBox = dataclasses.field(default_factory=TfdtBox)
    trun: List[TrunBox] = dataclasses.field(default_factory=list)
    tfxd: Optional[TfxdBox] = None
    tfrf: Optional[TfrfBox] = None


@dataclasses.dataclass
class MoofBox:
    mfhd: MfhdBox = dataclasses.field(default_factory=MfhdBox)
    traf: List[TrafBox] = dataclasses.field(default_factory=list)


def _parse_mfhd(r: ByteReader) -> Optional[MfhdBox]:
    if r.remaining() != 8:  # exact-size check (gstisoff.c:148)
        return None
    if r.u8() != 0 or r.u24be() != 0:
        return None
    return MfhdBox(sequence_number=r.u32be())


def _parse_tfhd(r: ByteReader) -> Optional[TfhdBox]:
    t = TfhdBox()
    try:
        t.version = r.u8()
        if t.version != 0:
            return None
        t.flags = r.u24be()
        t.track_id = r.u32be()
        if t.flags & TFHD_BASE_DATA_OFFSET_PRESENT:
            t.base_data_offset = r.u64be()
        if t.flags & TFHD_SAMPLE_DESCRIPTION_INDEX_PRESENT:
            t.sample_description_index = r.u32be()
        if t.flags & TFHD_DEFAULT_SAMPLE_DURATION_PRESENT:
            t.default_sample_duration = r.u32be()
        if t.flags & TFHD_DEFAULT_SAMPLE_SIZE_PRESENT:
            t.default_sample_size = r.u32be()
        if t.flags & TFHD_DEFAULT_SAMPLE_FLAGS_PRESENT:
            t.default_sample_flags = r.u32be()
    except IsoffError:
        return None
    return t


def _parse_trun(r: ByteReader) -> Optional[TrunBox]:
    t = TrunBox()
    try:
        t.version = r.u8()
        if t.version not in (0, 1):
            return None
        t.flags = r.u24be()
        t.sample_count = r.u32be()
        if t.flags & TRUN_DATA_OFFSET_PRESENT:
            v = r.u32be()
            t.data_offset = v - (1 << 32) if v & 0x80000000 else v
        if t.flags & TRUN_FIRST_SAMPLE_FLAGS_PRESENT:
            t.first_sample_flags = r.u32be()
        for _ in range(t.sample_count):
            s = TrunSample()
            if t.flags & TRUN_SAMPLE_DURATION_PRESENT:
                s.sample_duration = r.u32be()
            if t.flags & TRUN_SAMPLE_SIZE_PRESENT:
                s.sample_size = r.u32be()
            if t.flags & TRUN_SAMPLE_FLAGS_PRESENT:
                s.sample_flags = r.u32be()
            if t.flags & TRUN_SAMPLE_COMPOSITION_TIME_OFFSETS_PRESENT:
                s.sample_composition_time_offset = r.u32be()
            t.samples.append(s)
    except IsoffError:
        return None
    return t


def _parse_tfdt(r: ByteReader) -> Optional[TfdtBox]:
    try:
        version = r.u8()
        r.skip(3)
        return TfdtBox(decode_time=r.u64be() if version == 1
                       else r.u32be())
    except IsoffError:
        return None


def _parse_tfxd(r: ByteReader) -> Optional[TfxdBox]:
    try:
        t = TfxdBox(version=r.u8(), flags=r.u24be())
        if t.version & 1:
            t.time, t.duration = r.u64be(), r.u64be()
        else:
            t.time, t.duration = r.u32be(), r.u32be()
        return t
    except IsoffError:
        return None


def _parse_tfrf(r: ByteReader) -> Optional[TfrfBox]:
    try:
        t = TfrfBox(version=r.u8(), flags=r.u24be())
        count = r.u8()
        for _ in range(count):
            if t.version & 1:
                t.entries.append(TfrfEntry(r.u64be(), r.u64be()))
            else:
                t.entries.append(TfrfEntry(r.u32be(), r.u32be()))
        return t
    except IsoffError:
        return None


def _parse_traf(r: ByteReader) -> Optional[TrafBox]:
    traf = TrafBox()
    had_tfhd = False
    while r.remaining() > 0:
        hdr = parse_box_header(r)
        if hdr is None:
            return None
        fourcc, extended, header_size, size = hdr
        if r.remaining() < size - header_size:
            return None
        sub = r.sub(size - header_size)
        if fourcc == b"tfhd":
            tfhd = _parse_tfhd(sub)
            if tfhd is None:
                return None
            traf.tfhd = tfhd
            had_tfhd = True
        elif fourcc == b"tfdt":
            tfdt = _parse_tfdt(sub)
            if tfdt is None:
                return None
            traf.tfdt = tfdt
        elif fourcc == b"trun":
            trun = _parse_trun(sub)
            if trun is None:
                return None
            traf.trun.append(trun)
        elif fourcc == b"uuid":
            if extended == TFRF_UUID:
                traf.tfrf = _parse_tfrf(sub)
                if traf.tfrf is None:
                    return None
            elif extended == TFXD_UUID:
                traf.tfxd = _parse_tfxd(sub)
                if traf.tfxd is None:
                    return None
    if not had_tfhd:
        return None
    return traf


def parse_moof(data: bytes) -> Optional[MoofBox]:
    """gst_isoff_moof_box_parse over the moof PAYLOAD (after its box
    header)."""
    r = ByteReader(data)
    moof = MoofBox()
    had_mfhd = False
    while r.remaining() > 0:
        hdr = parse_box_header(r)
        if hdr is None:
            return None
        fourcc, _, header_size, size = hdr
        if r.remaining() < size - header_size:
            return None
        sub = r.sub(size - header_size)
        if fourcc == b"mfhd":
            mfhd = _parse_mfhd(sub)
            if mfhd is None:
                return None
            moof.mfhd = mfhd
            had_mfhd = True
        elif fourcc == b"traf":
            traf = _parse_traf(sub)
            if traf is None:
                return None
            moof.traf.append(traf)
    if not had_mfhd:
        return None
    return moof


# ------------------------------------------------------------------ moov

@dataclasses.dataclass
class MdhdBox:
    timescale: int = 0


@dataclasses.dataclass
class HdlrBox:
    handler_type: bytes = b""


@dataclasses.dataclass
class TkhdBox:
    track_id: int = 0


@dataclasses.dataclass
class MdiaBox:
    mdhd: MdhdBox = dataclasses.field(default_factory=MdhdBox)
    hdlr: HdlrBox = dataclasses.field(default_factory=HdlrBox)


@dataclasses.dataclass
class TrakBox:
    tkhd: TkhdBox = dataclasses.field(default_factory=TkhdBox)
    mdia: MdiaBox = dataclasses.field(default_factory=MdiaBox)


@dataclasses.dataclass
class MoovBox:
    trak: List[TrakBox] = dataclasses.field(default_factory=list)


def _parse_mdhd(r: ByteReader) -> Optional[MdhdBox]:
    try:
        version = r.u8()
        r.skip(3)
        r.skip(16 if version == 1 else 8)
        return MdhdBox(timescale=r.u32be())
    except IsoffError:
        return None


def _parse_hdlr(r: ByteReader) -> Optional[HdlrBox]:
    try:
        r.skip(4)  # version + flags
        r.skip(4)  # pre_defined
        return HdlrBox(handler_type=r._take(4))
    except IsoffError:
        return None


def _parse_tkhd(r: ByteReader) -> Optional[TkhdBox]:
    try:
        version = r.u8()
        r.skip(3)
        r.skip(16 if version == 1 else 8)
        return TkhdBox(track_id=r.u32be())
    except IsoffError:
        return None


def _parse_container(r: ByteReader, handlers) -> bool:
    while r.remaining() > 0:
        hdr = parse_box_header(r)
        if hdr is None:
            return False
        fourcc, _, header_size, size = hdr
        if r.remaining() < size - header_size:
            return False
        sub = r.sub(size - header_size)
        fn = handlers.get(fourcc)
        if fn is not None and not fn(sub):
            return False
    return True


def parse_moov(data: bytes) -> Optional[MoovBox]:
    moov = MoovBox()

    def on_trak(sub):
        trak = TrakBox()
        seen = {"tkhd": False, "mdia": False}

        def on_tkhd(r2):
            t = _parse_tkhd(r2)
            if t is None:
                return False
            trak.tkhd = t
            seen["tkhd"] = True
            return True

        def on_mdia(r2):
            mdia = MdiaBox()
            got = {"mdhd": False, "hdlr": False}

            def on_mdhd(r3):
                m = _parse_mdhd(r3)
                if m is None:
                    return False
                mdia.mdhd = m
                got["mdhd"] = True
                return True

            def on_hdlr(r3):
                h = _parse_hdlr(r3)
                if h is None:
                    return False
                mdia.hdlr = h
                got["hdlr"] = True
                return True

            if not _parse_container(r2, {b"mdhd": on_mdhd,
                                         b"hdlr": on_hdlr}):
                return False
            if not (got["mdhd"] and got["hdlr"]):
                return False
            trak.mdia = mdia
            seen["mdia"] = True
            return True

        if not _parse_container(sub, {b"tkhd": on_tkhd,
                                      b"mdia": on_mdia}):
            return False
        if not (seen["tkhd"] and seen["mdia"]):
            return False
        moov.trak.append(trak)
        return True

    if not _parse_container(ByteReader(data), {b"trak": on_trak}):
        return None
    if not moov.trak:
        return None
    return moov


# ------------------------------------------------------------------ sidx

@dataclasses.dataclass
class SidxEntry:
    ref_type: int = 0
    size: int = 0
    duration: int = 0       # converted to nanoseconds
    starts_with_sap: int = 0
    sap_type: int = 0
    sap_delta_time: int = 0
    offset: int = 0         # cumulative byte offset
    pts: int = 0            # cumulative pts in nanoseconds


class SidxParser:
    """Incremental sidx parser (gst_isoff_sidx_parser_parse,
    gstisoff.c:829-940).  Feed the sidx PAYLOAD bytes; states INIT ->
    HEADER -> DATA -> FINISHED.  NOTE the reference reads the FullBox
    flags as 24-bit little-endian (gstisoff.c:844) — kept."""

    INIT, HEADER, DATA, FINISHED = range(4)

    def __init__(self):
        self.clear()

    def clear(self):
        self.status = self.INIT
        self.version = 0
        self.flags = 0
        self.ref_id = 0
        self.timescale = 0
        self.earliest_pts = 0
        self.first_offset = 0
        self.entries: List[SidxEntry] = []
        self.entries_count = 0
        self._cum_size = 0
        self._cum_pts = 0
        self._buf = b""

    def parse(self, data: bytes) -> int:
        """Returns bytes consumed of `data` (the rest is buffered)."""
        self._buf += data
        r = ByteReader(self._buf)
        if self.status == self.INIT:
            if r.remaining() < 4:
                return len(data)
            self.version = r.u8()
            self.flags = r.u24le()  # reference quirk: little-endian
            self.status = self.HEADER
        if self.status == self.HEADER:
            need = 12 + (8 if self.version == 0 else 16)
            if r.remaining() < need:
                self._buf = self._buf[r.pos:]
                return len(data)
            self.ref_id = r.u32be()
            self.timescale = r.u32be()
            if self.version == 0:
                self.earliest_pts = r.u32be()
                self.first_offset = r.u32be()
            else:
                self.earliest_pts = r.u64be()
                self.first_offset = r.u64be()
            r.skip(2)
            self.entries_count = r.u16be()
            self._cum_pts = (self.earliest_pts * GST_SECOND
                             + self.timescale // 2) // self.timescale \
                if self.timescale else 0
            self.status = self.DATA
        if self.status == self.DATA:
            while len(self.entries) < self.entries_count:
                if r.remaining() < 12:
                    break
                e = SidxEntry()
                e.offset = self._cum_size
                e.pts = self._cum_pts
                aux = r.u32be()
                e.ref_type = aux >> 31
                e.size = aux & 0x7FFFFFFF
                dur = r.u32be()
                aux = r.u32be()
                e.starts_with_sap = aux >> 31
                e.sap_type = (aux >> 28) & 0x7
                e.sap_delta_time = aux & 0xFFFFFFF
                e.duration = (dur * GST_SECOND
                              + self.timescale // 2) // self.timescale \
                    if self.timescale else 0
                self._cum_size += e.size
                self._cum_pts += e.duration
                self.entries.append(e)
            if len(self.entries) == self.entries_count:
                self.status = self.FINISHED
        self._buf = self._buf[r.pos:]
        return len(data)
