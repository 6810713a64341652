"""Subtitle encoders (gst/subenc/): srtenc + webvttenc, byte-domain.

srtenc (gstsrtenc.c:82-131): per text buffer emits
  "<counter>\\n<HH:MM:SS,mmm> --> <HH:MM:SS,mmm>\\n<text>\\n\\n"
with counter starting at 1 (gstsrtenc.c:161), default duration 1 s when
the buffer carries none, and controllable timestamp/duration offsets.
webvttenc (gstwebvttenc.c:81-135): a "WEBVTT\\n\\n" stream header, no
stanza counter, and '.' as the milliseconds separator.
"""

from __future__ import annotations

NSEC = 1_000_000_000
MSEC = 1_000_000


def _ts(t_ns: int, sep: str) -> str:
    h, t_ns = divmod(t_ns, 3600 * NSEC)
    m, t_ns = divmod(t_ns, 60 * NSEC)
    s, t_ns = divmod(t_ns, NSEC)
    ms = t_ns // MSEC
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


class SrtEnc:
    SEP = ","
    HEADER = ""

    def __init__(self, timestamp_offset_ns: int = 0,
                 duration_offset_ns: int = 0):
        self.timestamp = timestamp_offset_ns
        self.duration = duration_offset_ns
        self.counter = 1
        self._started = False

    def encode(self, text: str, pts_ns: int,
               duration_ns: int = -1) -> bytes:
        ts = pts_ns + self.timestamp
        if duration_ns >= 0:
            dur = duration_ns + self.duration
        elif self.duration > 0:
            dur = self.duration
        else:
            dur = NSEC
        parts = []
        if not self._started and self.HEADER:
            parts.append(self.HEADER)
        self._started = True
        if self.SEP == ",":  # srt stanza counter (gstsrtenc.c:105)
            parts.append(f"{self.counter}\n")
            self.counter += 1
        parts.append(f"{_ts(ts, self.SEP)} --> {_ts(ts + dur, self.SEP)}\n")
        parts.append(text)
        parts.append("\n\n")
        return "".join(parts).encode()


class WebvttEnc(SrtEnc):
    SEP = "."
    HEADER = "WEBVTT\n\n"


def _parse_ts(text: str) -> int:
    """'HH:MM:SS,mmm' or 'HH:MM:SS.mmm' -> ns."""
    hms, _, ms = text.replace(".", ",").partition(",")
    h, m, s = hms.split(":")
    return ((int(h) * 3600 + int(m) * 60 + int(s)) * NSEC
            + int(ms or 0) * MSEC)


def parse_srt(text) -> list:
    """Decode SRT (or WebVTT) stanzas — the playbin `suburi` subparse
    path consumed by gst_play_set_subtitle_uri (gstplay.c set_suburi;
    the subtitle decode itself lives in -base's subparse, so this is a
    from-spec inverse of SrtEnc above).  Returns
    [{'start': ns, 'end': ns, 'text': str}], tolerant of missing
    counters, WEBVTT headers and CRLF."""
    if isinstance(text, bytes):
        text = text.decode("utf-8-sig", errors="replace")
    cues = []
    for stanza in text.replace("\r\n", "\n").split("\n\n"):
        lines = [ln for ln in stanza.split("\n") if ln.strip()]
        if not lines:
            continue
        if lines[0].strip().upper().startswith("WEBVTT"):
            lines = lines[1:]
            if not lines:
                continue
        if "-->" not in lines[0] and len(lines) > 1 and "-->" in lines[1]:
            lines = lines[1:]             # drop the stanza counter
        if "-->" not in lines[0]:
            continue
        start_s, _, end_s = lines[0].partition("-->")
        try:
            start = _parse_ts(start_s.strip().split(" ")[0])
            end = _parse_ts(end_s.strip().split(" ")[0])
        except (ValueError, IndexError):
            continue
        cues.append({"start": start, "end": end,
                     "text": "\n".join(lines[1:])})
    if not cues:
        raise ValueError("no SRT/WebVTT cues found")
    return cues
