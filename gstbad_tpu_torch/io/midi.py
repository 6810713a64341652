"""Standard MIDI File parsing (gst/midi/midiparse.c).

MThd/MTrk chunk walk, variable-length deltas, running status, meta/sysex
handling and the reference's play scheduler transcribed: all tracks
advance on a shared pulse clock; event time is the ABSOLUTE pulse scaled
by the tempo current at that moment (`next_pulse * 1000 * tempo /
division`, midiparse.c:1141-1143 — a mid-song tempo meta rescales the
whole position, NOT an integrated timeline; kept faithfully), with
10 ms 0xF9 tick events between real events (midiparse.c:1147-1160).

The downstream synth (fluiddec/wildmidi) is an external-library wrapper
in the reference too; here the parse result is the event timeline.
A copy of the JAX package's io/midi.py: only its imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

DEFAULT_TEMPO = 500000      # us per quarter note = 120 BPM


@dataclass
class MidiEvent:
    time_ns: int
    pulse: int
    track: int
    event: int               # status byte (0xF9 = the 10 ms tick)
    data: bytes


class _Track:
    def __init__(self, data: bytes, idx: int):
        self.data = data
        self.idx = idx
        self.offset = 0
        self.pulse = 0
        self.running_status = 0xFF
        self.eot = False


def _varlen(data: bytes, pos: int):
    value = 0
    for i in range(4):
        if pos + i >= len(data):
            raise ValueError("midi: truncated varlen")
        b = data[pos + i]
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i + 1
    raise ValueError("midi: varlen too long")


def parse_midi(path_or_bytes, emit_ticks: bool = False
               ) -> List[MidiEvent]:
    """Parse an SMF file and run the reference scheduler, returning the
    timed event list."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()

    pos = 0
    division = None
    tracks: List[_Track] = []
    while pos + 8 <= len(raw):
        tag = raw[pos:pos + 4]
        size = int.from_bytes(raw[pos + 4:pos + 8], "big")
        body = raw[pos + 8:pos + 8 + size]
        pos += 8 + size
        if tag == b"MThd":
            fmt = int.from_bytes(body[0:2], "big")
            ntracks = int.from_bytes(body[2:4], "big")
            division = int.from_bytes(body[4:6], "big")
            if fmt not in (0, 1):
                raise ValueError(f"midi: unsupported format {fmt}")
            if ntracks > 1 and fmt == 0:
                raise ValueError("midi: multiple tracks in format 0")
            if division & 0x8000:
                raise ValueError("midi: SMPTE division unsupported "
                                 "(midiparse.c:484-485)")
        elif tag == b"MTrk":
            tracks.append(_Track(body, len(tracks)))
    if division is None or not tracks:
        raise ValueError("midi: no MThd/MTrk chunks")

    for t in tracks:
        _advance(t)              # read first delta

    tempo = DEFAULT_TEMPO
    pulse = 0
    events: List[MidiEvent] = []
    tick = 0
    position = 0

    def time_of(p: int) -> int:
        return p * 1000 * tempo // division

    while True:
        next_pulse = None
        for t in tracks:
            while not t.eot and t.pulse == pulse:
                tempo = _handle_event(t, events, tempo, time_of(pulse),
                                      pulse)
            if not t.eot and (next_pulse is None or t.pulse < next_pulse):
                next_pulse = t.pulse
        if next_pulse is None:
            break
        next_position = time_of(next_pulse)
        if emit_ticks:
            while True:
                tick += 1
                position = tick * 10_000_000
                if position >= next_position:
                    tick -= 1
                    break
                events.append(MidiEvent(position, pulse, -1, 0xF9, b""))
        pulse = next_pulse
        position = next_position
    return events


def _advance(track: _Track) -> None:
    """update_track_position (midiparse.c:697-729)."""
    if track.offset >= len(track.data):
        track.eot = True
        return
    delta, used = _varlen(track.data, track.offset)
    track.offset += used
    track.pulse += delta


def _handle_event(track: _Track, events: List[MidiEvent], tempo: int,
                  time_ns: int, pulse: int) -> int:
    """handle_next_event (midiparse.c:731-809); returns the (possibly
    updated) tempo."""
    data = track.data
    status = data[track.offset]
    if status & 0x80:
        event = status
    else:
        event = track.running_status     # running status
        if not event & 0x80:
            raise ValueError("midi: invalid running status")

    if event & 0xF0 == 0xF0:
        if event == 0xFF:                # meta
            mtype = data[track.offset + 1]
            length, used = _varlen(data, track.offset + 2)
            body = data[track.offset + 2 + used:
                        track.offset + 2 + used + length]
            track.offset += 2 + used + length
            if mtype == 0x2F:            # end of track
                track.eot = True
                return tempo
            if mtype == 0x51 and length == 3:
                uspqn = int.from_bytes(body, "big")
                tempo = uspqn if uspqn else DEFAULT_TEMPO
            events.append(MidiEvent(time_ns, pulse, track.idx, 0xFF,
                                    bytes([mtype]) + body))
        elif event in (0xF0, 0xF7):      # sysex
            length, used = _varlen(data, track.offset + 1)
            body = data[track.offset + 1 + used:
                        track.offset + 1 + used + length]
            track.offset += 1 + used + length
            events.append(MidiEvent(time_ns, pulse, track.idx, event,
                                    body))
        else:
            raise ValueError(f"midi: unhandled event 0x{event:02x}")
        if not track.eot:
            _advance(track)
        return tempo

    length = 1 if event & 0xF0 in (0xC0, 0xD0) else 2
    if status & 0x80:
        payload = data[track.offset + 1:track.offset + 1 + length]
        track.offset += length + 1
    else:                                # running status: no status byte
        payload = data[track.offset:track.offset + length]
        track.offset += length
    events.append(MidiEvent(time_ns, pulse, track.idx, event, payload))
    if event < 0xF8:
        track.running_status = event
    _advance(track)
    return tempo
