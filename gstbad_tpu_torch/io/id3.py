"""ID3v1 / ID3v2 tag rendering (gst/id3tag/id3tag.c, gstid3mux.c).

The id3mux element prepends an ID3v2 tag and appends an ID3v1 footer.
Transcribed layout: v2 header with syncsafe size rounded UP to 1024
(id3tag.c:186-210), 10-byte frame headers (v2.3 u32be size, v2.4
syncsafe), text-frame encodings (v2.4 always UTF-8=3; v2.3 Latin-1=0 for
pure-ASCII else UTF-16LE+BOM=1, id3tag.c:330-348), TRCK/TPOS as
"number/count" strings, TYER 4-digit year for v2.3 vs TDRC for v2.4
(id3tag.c:927-929), COMM frames with "Comment" description and "XXX"
fallback language.  The ID3v1 footer is the fixed 128-byte "TAG" record
with Latin-1 ('?' fallback) fields, genre byte 255 when unmatched and a
plausible-year gate (id3tag.c:1266-1420).

Tags are a plain dict: title, artist, album, album-artist, composer,
copyright, genre, encoded-by, publisher, musical-key, comment,
track-number, track-count, album-volume-number, album-volume-count,
date (year int), bpm.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ENC_LATIN1 = 0
ENC_UTF16_BOM = 1
ENC_UTF8 = 3

TEXT_FRAMES = [
    ("artist", "TPE1"), ("album-artist", "TPE2"), ("title", "TIT2"),
    ("album", "TALB"), ("copyright", "TCOP"), ("composer", "TCOM"),
    ("genre", "TCON"), ("encoded-by", "TENC"), ("publisher", "TPUB"),
    ("interpreted-by", "TPE4"), ("musical-key", "TKEY"),
]

# ID3v1 genre list (the gst_tag_id3_genre table prefix; index = byte)
ID3V1_GENRES = [
    "Blues", "Classic Rock", "Country", "Dance", "Disco", "Funk",
    "Grunge", "Hip-Hop", "Jazz", "Metal", "New Age", "Oldies", "Other",
    "Pop", "R&B", "Rap", "Reggae", "Rock", "Techno", "Industrial",
    "Alternative", "Ska", "Death Metal", "Pranks", "Soundtrack",
    "Euro-Techno", "Ambient", "Trip-Hop", "Vocal", "Jazz+Funk", "Fusion",
    "Trance", "Classical", "Instrumental", "Acid", "House", "Game",
    "Sound Clip", "Gospel", "Noise", "Alternative Rock", "Bass", "Soul",
    "Punk", "Space", "Meditative", "Instrumental Pop",
    "Instrumental Rock", "Ethnic", "Gothic", "Darkwave",
    "Techno-Industrial", "Electronic", "Pop-Folk", "Eurodance", "Dream",
    "Southern Rock", "Comedy", "Cult", "Gangsta", "Top 40",
    "Christian Rap", "Pop/Funk", "Jungle", "Native American", "Cabaret",
    "New Wave", "Psychedelic", "Rave", "Showtunes", "Trailer", "Lo-Fi",
    "Tribal", "Acid Punk", "Acid Jazz", "Polka", "Retro", "Musical",
    "Rock & Roll", "Hard Rock",
]


def _syncsafe(v: int) -> bytes:
    return bytes([(v >> 21) & 0x7F, (v >> 14) & 0x7F,
                  (v >> 7) & 0x7F, v & 0x7F])


def _encoding_for(version: int, s: str) -> int:
    if version == 4:
        return ENC_UTF8
    return ENC_LATIN1 if all(32 <= ord(c) < 127 for c in s) \
        else ENC_UTF16_BOM


def _enc_string(encoding: int, s: str, terminate: bool) -> bytes:
    if encoding == ENC_UTF16_BOM:
        out = b"\xff\xfe" + s.encode("utf-16-le")
        return out + (b"\x00\x00" if terminate else b"")
    data = s.encode("latin-1" if encoding == ENC_LATIN1 else "utf-8")
    return data + (b"\x00" if terminate else b"")


def _frame(version: int, frame_id: str, payload: bytes) -> bytes:
    size = (len(payload).to_bytes(4, "big") if version == 3
            else _syncsafe(len(payload)))
    return frame_id.encode("ascii") + size + b"\x00\x00" + payload


def _text_frame(version: int, frame_id: str, s: str) -> bytes:
    enc = _encoding_for(version, s)
    return _frame(version, frame_id,
                  bytes([enc]) + _enc_string(enc, s, False))


def render_id3v2(tags: Dict, version: int = 3) -> bytes:
    """id3_mux_render_v2_tag: the full tag block, zero-padded to the next
    1024 boundary (id3tag.c:209 GST_ROUND_UP_1024)."""
    if version not in (3, 4):
        raise ValueError("id3: only v2.3 / v2.4 are supported")
    frames: List[bytes] = []
    for key, fid in TEXT_FRAMES:
        if key in tags:
            frames.append(_text_frame(version, fid, str(tags[key])))
    for num_key, cnt_key, fid in (
            ("track-number", "track-count", "TRCK"),
            ("album-volume-number", "album-volume-count", "TPOS")):
        if num_key in tags:
            s = str(int(tags[num_key]))
            if cnt_key in tags:
                s += f"/{int(tags[cnt_key])}"
            frames.append(_text_frame(version, fid, s))
        elif cnt_key in tags:
            frames.append(_text_frame(version, fid,
                                      f"0/{int(tags[cnt_key])}"))
    if "date" in tags:
        year = int(tags["date"])
        if version == 3:
            frames.append(_text_frame(version, "TYER", f"{year:04d}"))
        else:
            frames.append(_text_frame(version, "TDRC", f"{year:04d}"))
    if "bpm" in tags:
        frames.append(_text_frame(version, "TBPM",
                                  str(int(float(tags["bpm"]) + 0.5))))
    if "comment" in tags:
        desc, val = "Comment", str(tags["comment"])
        enc = max(_encoding_for(version, desc), _encoding_for(version, val))
        payload = (bytes([enc]) + b"XXX"
                   + _enc_string(enc, desc, True)
                   + _enc_string(enc, val, False))
        frames.append(_frame(version, "COMM", payload))

    body = b"".join(frames)
    total = (10 + len(body) + 1023) & ~1023
    header = b"ID3" + bytes([version, 0, 0]) + _syncsafe(total - 10)
    return header + body + b"\x00" * (total - 10 - len(body))


def render_id3v1(tags: Dict) -> bytes:
    """id3_mux_render_v1_tag (id3tag.c:1385-1420): 128-byte footer, or
    b"" when no supported tag is present."""
    data = bytearray(128)
    data[0:3] = b"TAG"
    data[127] = 255
    wrote = False

    def put(key: str, off: int, maxlen: int):
        nonlocal wrote
        if key not in tags:
            return
        latin1 = str(tags[key]).encode("latin-1", errors="replace")
        if latin1:
            data[off:off + min(len(latin1), maxlen)] = \
                latin1[:maxlen]
            wrote = True

    put("title", 3, 30)
    put("artist", 33, 30)
    put("album", 63, 30)
    if "date" in tags:
        year = int(tags["date"])
        if 500 < year < 2100:
            data[93:97] = f"{year:04d}".encode("ascii")
            wrote = True
    put("comment", 97, 28)
    if "track-number" in tags and int(tags["track-number"]) <= 127:
        data[126] = int(tags["track-number"])
        wrote = True
    if "genre" in tags and str(tags["genre"]) in ID3V1_GENRES:
        idx = ID3V1_GENRES.index(str(tags["genre"]))
        if idx <= 127:
            data[127] = idx
            wrote = True
    return bytes(data) if wrote else b""


def mux_stream(payload: bytes, tags: Dict, write_v1: bool = True,
               write_v2: bool = True, v2_version: int = 3) -> bytes:
    """id3mux: ID3v2 header + stream + ID3v1 footer
    (gstid3mux.c:28-30)."""
    out = b""
    if write_v2:
        out += render_id3v2(tags, v2_version)
    out += payload
    if write_v1:
        out += render_id3v1(tags)
    return out
