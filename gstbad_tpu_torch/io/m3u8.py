"""HLS m3u8 playlist parser (ext/hls/m3u8.c).

Master + media playlists with the reference's semantics, pinned by the
upstream unit suite (tests/check/elements/hlsdemux_m3u8.c):

  - master playlists: EXT-X-STREAM-INF variants (PROGRAM-ID, BANDWIDTH,
    CODECS, RESOLUTION) sorted ascending by bandwidth with the
    default variant = first in DOCUMENT order; entries whose URI line
    is missing are dropped; a media playlist wraps into a single
    "simple" variant;
  - media playlists: EXTINF double durations, TARGETDURATION,
    MEDIA-SEQUENCE numbering, ENDLIST -> is_live, EXT-X-BYTERANGE
    (explicit offset or accumulated from the previous range of the
    same URI), EXT-X-KEY (METHOD NONE/AES-128, quoted URI, optional
    0x IV else the media sequence as a 16-byte big-endian IV),
    EXT-X-MAP init files shared by the following segments,
    EXT-X-DISCONTINUITY;
  - relative URI resolution against the playlist URI (query strings
    preserved verbatim - the url_with_slash_query_param case);
  - live updates: gst_m3u8_update keeps counting sequence numbers
    across sliding-window reloads and rejects invalid data;
  - duration (CLOCK_TIME_NONE for live), target duration, seek range
    (live excludes the last 3 target durations), variant-for-bitrate
    selection (highest bandwidth <= bitrate, lowest as floor).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

GST_SECOND = 1_000_000_000
CLOCK_TIME_NONE = -1


@dataclass
class InitFile:
    uri: str
    offset: int = 0
    size: int = -1


@dataclass
class MediaFile:
    uri: str
    duration: int = 0          # ns
    title: Optional[str] = None
    sequence: int = 0
    offset: int = 0
    size: int = -1
    key: Optional[str] = None
    iv: Optional[bytes] = None
    discont: bool = False
    init_file: Optional[InitFile] = None


def _resolve(base_uri: str, uri: str) -> str:
    if "://" in uri:
        return uri
    if uri.startswith("/"):
        m = re.match(r"^([a-z]+://[^/]+)", base_uri)
        return (m.group(1) + uri) if m else uri
    return base_uri.rsplit("/", 1)[0] + "/" + uri


def _parse_attributes(s: str) -> Dict[str, str]:
    """ATTR=value,ATTR="quoted,value" lists."""
    out = {}
    pos = 0
    n = len(s)
    while pos < n:
        eq = s.find("=", pos)
        if eq < 0:
            break
        key = s[pos:eq].strip().strip(",")
        pos = eq + 1
        if pos < n and s[pos] == '"':
            end = s.find('"', pos + 1)
            out[key] = s[pos + 1:end]
            pos = end + 1
        else:
            end = s.find(",", pos)
            if end < 0:
                end = n
            out[key] = s[pos:end].strip()
            pos = end
        while pos < n and s[pos] in ", ":
            pos += 1
    return out


class M3u8:
    """A media playlist (GstM3U8)."""

    def __init__(self, uri: str):
        self.uri = uri
        self.version = 0
        self.targetduration = CLOCK_TIME_NONE
        self.sequence = 0
        self.endlist = False
        self.files: List[MediaFile] = []
        self._highest_sequence = -1

    # -- parsing -----------------------------------------------------------

    def _parse(self, data: str) -> bool:
        lines = [ln.strip() for ln in data.replace("\r\n", "\n")
                 .split("\n")]
        if not lines or not lines[0].startswith("#EXTM3U"):
            return False
        files: List[MediaFile] = []
        duration = 0
        title = None
        offset = 0
        size = -1
        have_range = False
        key = None
        iv = None
        discont = False
        init_file: Optional[InitFile] = None
        mediasequence = 0
        have_mediasequence = False
        endlist = False
        targetduration = CLOCK_TIME_NONE
        version = 0
        last_offsets: Dict[str, int] = {}
        for ln in lines[1:]:
            if not ln:
                continue
            if not ln.startswith("#"):
                uri = _resolve(self.uri, ln)
                mf = MediaFile(uri=uri, duration=duration, title=title,
                               sequence=mediasequence, discont=discont,
                               key=key, init_file=init_file)
                if key is not None and iv is None:
                    mf.iv = mediasequence.to_bytes(16, "big")
                elif key is not None:
                    mf.iv = iv
                if have_range:
                    if offset < 0:  # accumulate from previous range
                        offset = last_offsets.get(uri, 0)
                    mf.offset = offset
                    mf.size = size
                    last_offsets[uri] = offset + size
                files.append(mf)
                mediasequence += 1
                duration = 0
                title = None
                discont = False
                have_range = False
                offset = 0
                size = -1
                continue
            if ln.startswith("#EXT-X-ENDLIST"):
                endlist = True
            elif ln.startswith("#EXT-X-VERSION:"):
                version = int(ln.split(":", 1)[1])
            elif ln.startswith("#EXT-X-TARGETDURATION:"):
                targetduration = int(
                    float(ln.split(":", 1)[1])) * GST_SECOND
            elif ln.startswith("#EXT-X-MEDIA-SEQUENCE:"):
                mediasequence = int(ln.split(":", 1)[1])
                have_mediasequence = True
            elif ln.startswith("#EXTINF:"):
                body = ln.split(":", 1)[1]
                dur, _, t = body.partition(",")
                duration = int(round(float(dur) * GST_SECOND))
                title = t if t else None
            elif ln.startswith("#EXT-X-BYTERANGE:"):
                body = ln.split(":", 1)[1]
                if "@" in body:
                    sz, off = body.split("@")
                    offset = int(off)
                else:
                    sz = body
                    offset = -1  # accumulate
                size = int(sz)
                have_range = True
            elif ln.startswith("#EXT-X-KEY:"):
                attrs = _parse_attributes(ln.split(":", 1)[1])
                method = attrs.get("METHOD", "NONE")
                if method == "NONE":
                    key = None
                    iv = None
                else:
                    key = _resolve(self.uri, attrs.get("URI", ""))
                    iv = None
                    if "IV" in attrs:
                        hexiv = attrs["IV"]
                        if hexiv.lower().startswith("0x"):
                            hexiv = hexiv[2:]
                        iv = bytes.fromhex(hexiv.zfill(32))
            elif ln.startswith("#EXT-X-MAP:"):
                attrs = _parse_attributes(ln.split(":", 1)[1])
                init_file = InitFile(
                    uri=_resolve(self.uri, attrs.get("URI", "")))
                if "BYTERANGE" in attrs:
                    sz, _, off = attrs["BYTERANGE"].partition("@")
                    init_file.size = int(sz)
                    init_file.offset = int(off) if off else 0
            elif ln.startswith("#EXT-X-DISCONTINUITY"):
                discont = True
        self.version = version
        self.targetduration = targetduration
        self.endlist = endlist
        self.files = files
        if files:
            self.sequence = files[0].sequence
        return True

    # -- queries (m3u8.c) ----------------------------------------------------

    def is_live(self) -> bool:
        return not self.endlist

    def get_duration(self) -> int:
        if self.is_live():
            return CLOCK_TIME_NONE
        return sum(f.duration for f in self.files)

    def get_target_duration(self) -> int:
        return self.targetduration

    def get_seek_range(self) -> Optional[Tuple[int, int]]:
        """(start, stop); live playlists hold back the last 3 target
        durations (gst_m3u8_get_seek_range)."""
        if not self.files:
            return None
        total = sum(f.duration for f in self.files)
        if self.is_live():
            hold = sum(f.duration for f in self.files[-3:])
            total -= hold
            if total < 0:
                total = 0
        return 0, total

    def find_file_by_sequence(self, seq: int) -> Optional[MediaFile]:
        for f in self.files:
            if f.sequence == seq:
                return f
        return None

    def update(self, data: str) -> bool:
        """gst_m3u8_update: re-parse; sequence numbering continues
        across sliding-window reloads (rotated live playlists keep
        counting instead of reusing MEDIA-SEQUENCE blindly)."""
        old_files = {f.uri: f.sequence for f in self.files}
        old_highest = max((f.sequence for f in self.files), default=-1)
        saved = (self.files, self.sequence)
        if not self._parse(data):
            self.files, self.sequence = saved
            return False
        # keep sequence continuity: known URIs keep their sequence
        if old_files:
            known = [f for f in self.files if f.uri in old_files]
            if known:
                for f in self.files:
                    if f.uri in old_files:
                        delta = old_files[f.uri] - f.sequence
                        if delta:
                            for g in self.files:
                                g.sequence += delta
                        break
                self.sequence = self.files[0].sequence
        return True


@dataclass
class VariantStream:
    uri: str
    bandwidth: int = 0
    program_id: int = 0
    codecs: Optional[str] = None
    width: int = 0
    height: int = 0
    m3u8: Optional[M3u8] = None


class MasterPlaylist:
    """GstHLSMasterPlaylist."""

    def __init__(self):
        self.variants: List[VariantStream] = []
        self.default_variant: Optional[VariantStream] = None
        self.version = 0
        self.is_simple = False

    @classmethod
    def from_data(cls, data: str,
                  uri: str) -> Optional["MasterPlaylist"]:
        lines = [ln.strip() for ln in data.replace("\r\n", "\n")
                 .split("\n")]
        if not lines or not lines[0].startswith("#EXTM3U"):
            return None
        master = cls()
        if "#EXT-X-STREAM-INF" not in data:
            # media playlist: wrap as one simple variant
            m = M3u8(uri)
            if not m._parse(data):
                return None
            v = VariantStream(uri=uri, m3u8=m)
            master.variants = [v]
            master.default_variant = v
            master.is_simple = True
            return master
        pending: Optional[VariantStream] = None
        doc_order: List[VariantStream] = []
        for ln in lines[1:]:
            if not ln:
                continue
            if ln.startswith("#EXT-X-VERSION:"):
                master.version = int(ln.split(":", 1)[1])
            elif ln.startswith("#EXT-X-STREAM-INF:"):
                attrs = _parse_attributes(ln.split(":", 1)[1])
                pending = VariantStream(uri="")
                pending.bandwidth = int(attrs.get("BANDWIDTH", 0))
                pending.program_id = int(attrs.get("PROGRAM-ID", 0))
                pending.codecs = attrs.get("CODECS")
                if "RESOLUTION" in attrs:
                    w, _, h = attrs["RESOLUTION"].partition("x")
                    pending.width = int(w)
                    pending.height = int(h)
            elif not ln.startswith("#"):
                if pending is not None:
                    pending.uri = _resolve(uri, ln)
                    pending.m3u8 = M3u8(pending.uri)
                    doc_order.append(pending)
                    pending = None
        master.variants = sorted(doc_order,
                                 key=lambda v: v.bandwidth)
        master.default_variant = doc_order[0] if doc_order else None
        return master

    def get_variant_for_bitrate(self, bitrate: int) -> \
            Optional[VariantStream]:
        """Highest bandwidth <= bitrate, lowest as the floor
        (gst_hls_master_playlist_get_variant_for_bitrate)."""
        if not self.variants:
            return None
        best = None
        for v in self.variants:  # ascending
            if v.bandwidth <= bitrate:
                best = v
        return best or self.variants[0]


def load_master(data: str, uri: str) -> Optional[MasterPlaylist]:
    """gst_hls_master_playlist_new_from_data: media playlists inside a
    simple master also get their files parsed."""
    return MasterPlaylist.from_data(data, uri)
