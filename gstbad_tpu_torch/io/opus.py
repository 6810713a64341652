"""Opus packet framing (ext/opus/gstopusparse.c, gstopusheader.c).

Two layers:
  - a from-spec RFC 6716 §3 packet parser (packet_parse): TOC codes
    0-3, CBR/VBR frame-size decoding, padding chains, the 1275-byte
    frame cap and the 120 ms packet cap — the same validation
    opus_packet_parse applies;
  - a ctypes binding to the REAL libopus (packet_parse_libopus) used
    as the oracle in tests and preferred at runtime when the library
    loads (the reference element calls opus_packet_parse directly,
    gstopusparse.c:176-178).

Also here:
  - packet_duration_opus: the ogg/opus TOC duration table the element
    stamps buffers with (gstopusparse.c:268-326) — NOTE the reference
    table (copied from gstoggstream.c) maps all four CELT bandwidths
    as "CELT NB" comments but the values are what matter;
  - OpusHead ID-header build/parse/validation
    (gst_opus_header_is_id_header rules, gstopusheader.c:36-86;
    the header made per gst_codec_utils_opus_create_header);
  - caps derivation from the header
    (gst_codec_utils_opus_create_caps_from_header semantics).

A copy of the JAX package's io/opus.py, with one correction: a failed
load of libopus is remembered.  The JAX module looks the library up
again on every call (find_library runs ldconfig and the compiler), and
opusparse asks once a packet and once a skipped byte: where libopus is
missing that took minutes for a few hundred packets.  Otherwise only
its imports differ.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

GST_SECOND = 1_000_000_000
MAX_PAYLOAD_BYTES = 1500     # gstopusparse.c:53
MAX_FRAME_BYTES = 1275       # RFC 6716 §3.4
MAX_PACKET_SAMPLES = 5760    # 120 ms @ 48 kHz


class OpusError(ValueError):
    pass


# ------------------------------------------------------------ durations

# gstopusparse.c:271-280 (microseconds per frame, indexed by config)
_DURATIONS_US = [
    10000, 20000, 40000, 60000,  # Silk NB
    10000, 20000, 40000, 60000,  # Silk MB
    10000, 20000, 40000, 60000,  # Silk WB
    10000, 20000,                # Hybrid SWB
    10000, 20000,                # Hybrid FB
    2500, 5000, 10000, 20000,    # CELT NB
    2500, 5000, 10000, 20000,    # CELT WB
    2500, 5000, 10000, 20000,    # CELT SWB
    2500, 5000, 10000, 20000,    # CELT FB
]


def packet_duration_opus(data: bytes) -> int:
    """packet_duration_opus (gstopusparse.c:268-326): nanoseconds, 0
    for invalid/over-120ms packets."""
    if len(data) < 1:
        return 0
    toc = data[0]
    frame_duration = _DURATIONS_US[toc >> 3] * 1000
    code = toc & 3
    if code == 0:
        nframes = 1
    elif code in (1, 2):
        nframes = 2
    else:
        if len(data) < 2:
            return 0
        nframes = data[1] & 63
    duration = nframes * frame_duration
    if duration > 120 * 1_000_000:
        return 0
    return duration


def samples_per_frame(toc: int, fs: int = 48000) -> int:
    """opus_packet_get_samples_per_frame."""
    if toc & 0x80:
        return (fs << ((toc >> 3) & 0x3)) // 400
    if (toc & 0x60) == 0x60:
        return fs // 50 if toc & 0x08 else fs // 100
    size = (toc >> 3) & 0x3
    if size == 3:
        return fs * 60 // 1000
    return (fs << size) // 100


# ------------------------------------------------------- packet parsing

def _get_size(data: bytes, pos: int) -> Tuple[int, int]:
    """RFC 6716 frame-length coding: returns (size, bytes_used)."""
    if pos >= len(data):
        raise OpusError("truncated size")
    b = data[pos]
    if b < 252:
        return b, 1
    if pos + 1 >= len(data):
        raise OpusError("truncated size")
    return b + data[pos + 1] * 4, 2


def packet_parse(data: bytes
                 ) -> Tuple[int, List[bytes], int]:
    """From-spec opus_packet_parse: (toc, frames, payload_offset).
    Raises OpusError exactly where libopus returns a negative code."""
    if len(data) < 1:
        raise OpusError("empty packet")
    toc = data[0]
    code = toc & 3
    pos = 1
    frame_sizes: List[int] = []
    pad = 0
    if code == 0:
        count = 1
        frame_sizes = [len(data) - 1]
    elif code == 1:
        count = 2
        if (len(data) - 1) & 1:
            raise OpusError("code 1 packet with odd payload")
        frame_sizes = [(len(data) - 1) // 2] * 2
    elif code == 2:
        count = 2
        size, used = _get_size(data, pos)
        pos += used
        if size > len(data) - pos:
            raise OpusError("code 2 first frame too large")
        frame_sizes = [size, len(data) - pos - size]
    else:
        if len(data) < 2:
            raise OpusError("code 3 packet too short")
        ch = data[1]
        count = ch & 63
        if count <= 0:
            raise OpusError("code 3 packet with zero frames")
        if count * samples_per_frame(toc) > MAX_PACKET_SAMPLES:
            raise OpusError("packet exceeds 120 ms")
        pos = 2
        if ch & 64:  # padding
            while True:
                if pos >= len(data):
                    raise OpusError("truncated padding")
                p = data[pos]
                pos += 1
                if p == 255:
                    pad += 254
                else:
                    pad += p
                    break
        if ch & 128:  # VBR
            for _ in range(count - 1):
                size, used = _get_size(data, pos)
                pos += used
                frame_sizes.append(size)
            rest = len(data) - pos - pad - sum(frame_sizes)
            if rest < 0:
                raise OpusError("VBR frames overflow packet")
            frame_sizes.append(rest)
        else:  # CBR
            rest = len(data) - pos - pad
            if rest % count:
                raise OpusError("CBR payload not divisible")
            frame_sizes = [rest // count] * count
    if code != 3 and count * samples_per_frame(toc) \
            > MAX_PACKET_SAMPLES:
        raise OpusError("packet exceeds 120 ms")
    # like libopus, payload_offset is where the FIRST frame begins
    # (after TOC, counts and size fields); trailing padding is not
    # part of the framed payload
    payload_offset = pos
    frames = []
    for size in frame_sizes:
        if size < 0 or size > MAX_FRAME_BYTES:
            raise OpusError("bad frame size")
        if pos + size > len(data):
            raise OpusError("frame overflows packet")
        frames.append(data[pos:pos + size])
        pos += size
    if pos + pad > len(data):
        raise OpusError("padding overflows packet")
    return toc, frames, payload_offset


# --------------------------------------------------- libopus (oracle)

_LIBOPUS = None
_LIBOPUS_ERROR = None      # the OSError of the one failed load, kept


def _load_libopus():
    global _LIBOPUS, _LIBOPUS_ERROR
    if _LIBOPUS is not None:
        return _LIBOPUS
    if _LIBOPUS_ERROR is not None:
        raise _LIBOPUS_ERROR
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        _LIBOPUS_ERROR = e
        raise
    lib.opus_packet_parse.restype = ctypes.c_int
    lib.opus_packet_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int)]
    _LIBOPUS = lib
    return lib


def libopus_available() -> bool:
    try:
        _load_libopus()
        return True
    except OSError:
        return False


def packet_parse_libopus(data: bytes
                         ) -> Tuple[int, List[bytes], int]:
    """The REAL opus_packet_parse (returns like packet_parse; raises
    OpusError on negative return)."""
    lib = _load_libopus()
    toc = ctypes.c_ubyte()
    frames = (ctypes.c_void_p * 48)()
    sizes = (ctypes.c_int16 * 48)()
    payload_offset = ctypes.c_int()
    buf = ctypes.create_string_buffer(bytes(data), len(data))
    n = lib.opus_packet_parse(
        ctypes.cast(buf, ctypes.c_char_p), len(data), ctypes.byref(toc),
        ctypes.cast(frames, ctypes.POINTER(ctypes.c_char_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_int16)),
        ctypes.byref(payload_offset))
    if n < 0:
        raise OpusError(f"opus_packet_parse: {n}")
    out = []
    for i in range(n):
        out.append(ctypes.string_at(frames[i], sizes[i])
                   if sizes[i] else b"")
    return toc.value, out, payload_offset.value


# --------------------------------------------------------------- header

@dataclasses.dataclass
class OpusHead:
    version: int = 1
    channels: int = 2
    pre_skip: int = 0
    sample_rate: int = 48000
    output_gain: int = 0
    channel_mapping_family: int = 0
    n_streams: int = 1
    n_stereo_streams: int = 1
    channel_mapping: Tuple[int, ...] = (0, 1)


def is_id_header(data: bytes) -> bool:
    """gst_opus_header_is_id_header (gstopusheader.c:36-86): magic,
    version < 0x0f, non-zero channels, family-0 capped at 2 channels,
    multistream stream-count sanity."""
    if len(data) < 19 or data[:8] != b"OpusHead":
        return False
    version = data[8]
    if version >= 0x0F:
        return False
    channels = data[9]
    if channels == 0:
        return False
    family = data[18]
    if family == 0:
        if channels > 2:
            return False
    else:
        if len(data) < 21 + channels:
            return False
        n_streams = data[19]
        n_stereo = data[20]
        if n_streams == 0 or n_stereo > n_streams \
                or n_streams + n_stereo > 255:
            return False
    return True


def is_comment_header(data: bytes) -> bool:
    return data[:8] == b"OpusTags"


def build_id_header(sample_rate: int = 48000, channels: int = 2,
                    channel_mapping_family: int = 0,
                    n_streams: int = 1, n_stereo_streams: int = 1,
                    channel_mapping: Tuple[int, ...] = (0, 1),
                    pre_skip: int = 0, gain: int = 0) -> bytes:
    """gst_codec_utils_opus_create_header layout: magic, version 1,
    channels, pre-skip LE16, input rate LE32, gain LE16, family
    (+ stream counts and mapping table for family != 0)."""
    out = b"OpusHead" + bytes([1, channels]) \
        + struct.pack("<HIh", pre_skip, sample_rate, gain) \
        + bytes([channel_mapping_family])
    if channel_mapping_family != 0:
        out += bytes([n_streams, n_stereo_streams])
        out += bytes(channel_mapping[:channels])
    return out


def parse_id_header(data: bytes) -> OpusHead:
    if not is_id_header(data):
        raise OpusError("not a valid OpusHead")
    h = OpusHead()
    h.version = data[8]
    h.channels = data[9]
    h.pre_skip, h.sample_rate, h.output_gain = \
        struct.unpack_from("<HIh", data, 10)
    h.channel_mapping_family = data[18]
    if h.channel_mapping_family == 0:
        h.n_streams = 1
        h.n_stereo_streams = h.channels - 1
        h.channel_mapping = tuple(range(h.channels))
    else:
        h.n_streams = data[19]
        h.n_stereo_streams = data[20]
        h.channel_mapping = tuple(data[21:21 + h.channels])
    return h


def caps_from_header(header: bytes) -> Dict:
    """gst_codec_utils_opus_create_caps_from_header semantics; the
    rate field is always 48000 with the original rate in the header."""
    h = parse_id_header(header)
    caps = {
        "media": "audio/x-opus",
        "framed": True,
        "rate": 48000,
        "channels": h.channels,
        "channel-mapping-family": h.channel_mapping_family,
        "stream-count": h.n_streams,
        "coupled-count": h.n_stereo_streams,
        "streamheader": [header],
    }
    if h.channel_mapping_family != 0:
        caps["channel-mapping"] = list(h.channel_mapping)
    return caps
