"""typefind + decodebin analog — byte-sniffing the container/codec
formats this framework can decode, and building the matching source
element.

The reference leans on GStreamer core's typefind + decodebin3 (its
uridecodebin/transcodebin/playbin fronts, e.g. gst/transcode/
gsttranscodebin.c); the -bad tree itself only registers per-plugin
typefinders.  Here `find_type` mirrors the classic magic checks
(gsttypefindfunctions.c patterns) for every format the framework has
a real decoder for, and `make_source` is the decodebin step: type ->
configured host-source element."""

from __future__ import annotations

from typing import List, Optional, Tuple


def find_type(data: bytes) -> Optional[str]:
    """Sniff the media type of a byte stream (first bytes suffice)."""
    if len(data) < 12:
        return None
    if data[:9] == b"YUV4MPEG2":
        return "video/x-yuv4mpeg"
    if data[:4] == b"DKIF":
        fourcc = data[8:12]
        return {b"AV01": "video/x-av1-ivf",
                b"VP80": "video/x-vp8-ivf",
                b"VP90": "video/x-vp9-ivf"}.get(fourcc, "video/x-ivf")
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "image/webp"
    if data[:8] == bytes.fromhex("0000000c6a502020"):
        return "image/jp2"
    if data[:4] == bytes.fromhex("ff4fff51"):
        return "image/x-j2c"
    if data[:4] in (b"\x00\x00\x00\x01",) or data[:3] == b"\x00\x00\x01":
        # annex-B: H.265 when the first NAL is VPS/SPS/PPS/IDR
        off = 4 if data[:4] == b"\x00\x00\x00\x01" else 3
        nal_type = (data[off] >> 1) & 0x3F
        if nal_type in (32, 33, 34, 19, 20, 21):
            return "video/x-h265"
    if data[:11] == bytes.fromhex("060e2b34020501010d0102"):
        # MXF partition pack prefix
        return "application/mxf"
    if data[:16] == bytes.fromhex("3026b2758e66cf11a6d900aa0062ce6c"):
        # ASF header object GUID
        return "video/x-ms-asf"
    if data[:4] == b"\x00\x00\x01\xba":
        # MPEG program stream pack header
        return "video/mpeg-sys"
    if (len(data) >= 189 and data[0] == 0x47 and data[188] == 0x47
            and data[376:377] in (b"\x47", b"")):
        # MPEG-TS: sync bytes at 188 spacing
        return "video/mpegts"
    if data[:4] == b"\x76\x2f\x31\x01":
        # OpenEXR magic (gstopenexrdec.cpp:243 validates the same word)
        return "image/x-exr"
    if data[0:1] == b"\x80" and data[1:9] == b"kate\x00\x00\x00\x00":
        # Kate ID header (ext/kate typefind; tests/check/elements/kate.c
        # test_kate_typefind expects application/x-kate)
        return "application/x-kate"
    if data[:4] == b"Vgm ":
        return "audio/x-vgm"
    if data[:4] == b"NESM":
        return "audio/x-nsf"
    if data[:27] == b"SNES-SPC700 Sound File Data":
        return "audio/x-spc"
    if data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC"):
        return "audio/x-aiff"
    if data[:4] == b"MThd":
        return "audio/midi"
    if data[:2] in (b"P4", b"P5", b"P6") and data[2:3] in b" \t\n\r#":
        return "image/pnm"
    if data[:3] == b"BZh" and data[3:4].isdigit():
        return "application/x-bzip"
    if data[:3] == b"\xff\xd8\xff":
        return "image/jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "image/png"
    if len(data) > 1084 and data[1080:1084] in (
            b"M.K.", b"M!K!", b"4CHN", b"6CHN", b"8CHN", b"FLT4",
            b"FLT8"):
        return "audio/x-mod"
    # tracker formats with leading magics (libopenmpt handles all)
    if data[:4] == b"IMPM":
        return "audio/x-it"
    if data[:17] == b"Extended Module: ":
        return "audio/x-xm"
    if len(data) > 48 and data[44:48] == b"SCRM":
        return "audio/x-s3m"
    if data[:8] == b"OpusHead":
        return "audio/x-opus"
    if len(data) >= 12 and data[4:8] == b"ftyp":
        return "video/quicktime"  # ISO BMFF (mp4/mov family)
    if data[:8] == b"\x00\x00\x00\x18moof" or data[4:8] == b"moof" \
            or data[4:8] == b"styp":
        return "video/iso-fragmented"
    if data[:7] == b"#EXTM3U":
        return "application/x-hls"
    head = data[:512].lstrip(b"\xef\xbb\xbf \t\r\n")
    if head.startswith(b"<?xml") or head.startswith(b"<"):
        body = data[:2048]
        if b"<MPD" in body:
            return "application/dash+xml"
        if b"<SmoothStreamingMedia" in body:
            return "application/vnd.ms-sstr+xml"
        if b"<tt" in body and b"ttml" in body.replace(b"ttaf1", b"ttml"):
            return "application/ttml+xml"
    if len(data) >= 40 and data[3] == 0xC5 \
            and data[4:8] == b"\x04\x00\x00\x00" \
            and data[20:24] == b"\x0c\x00\x00\x00":
        # VC-1 Annex-L sequence layer (the vc1parse detection pattern)
        return "video/x-wmv"
    return None


# media type -> (element name, feed style)
_DECODERS = {
    "image/x-exr": ("openexrdec", "single"),
    "image/webp": ("webpdec", "single"),
    "image/jp2": ("openjpegdec", "single"),
    "image/x-j2c": ("openjpegdec", "single"),
    "video/x-h265": ("libde265dec", "single"),
    "video/x-av1-ivf": ("av1dec", "ivf"),
    "audio/x-vgm": ("gmedec", "single"),
    "audio/x-nsf": ("gmedec", "single"),
    "audio/x-spc": ("gmedec", "single"),
    "audio/x-mod": ("openmptdec", "single"),
    "audio/x-it": ("openmptdec", "single"),
    "audio/x-xm": ("openmptdec", "single"),
    "audio/x-s3m": ("openmptdec", "single"),
}


def decodable_types() -> List[str]:
    return sorted(_DECODERS) + ["video/x-yuv4mpeg", "audio/x-aiff"]


def make_source(data: bytes, path: Optional[str] = None,
                **props) -> Tuple[str, object]:
    """decodebin3 analog: sniff `data` and return (media_type,
    configured source Element) ready for a Pipeline.  y4m/aiff route
    through their file sources (need `path`)."""
    import gstbad_tpu_torch as gt
    mtype = find_type(data)
    if mtype is None:
        raise ValueError("typefind: unrecognized stream")
    if mtype == "video/x-yuv4mpeg":
        if path is None:
            raise ValueError("y4m source needs a file path")
        return mtype, gt.make("y4mfilesrc", location=path, **props)
    if mtype == "audio/x-aiff":
        if path is None:
            raise ValueError("aiff source needs a file path")
        return mtype, gt.make("aifffilesrc", location=path, **props)
    entry = _DECODERS.get(mtype)
    if entry is None:
        raise ValueError(f"typefind: no decoder for {mtype} "
                         "(parse-only format)")
    name, feed = entry
    el = gt.make(name, **props)
    if feed == "ivf":
        from gstbad_tpu_torch.io.ivf import IvfParse
        parser = IvfParse()
        for _pts, payload in parser.push(data):
            el.push_packet(payload)
    else:
        el.push_packet(data)
    return mtype, el
