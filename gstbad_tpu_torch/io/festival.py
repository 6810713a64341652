"""Festival speech-server client — exact transcription of the
reference's wire protocol (gst/festival/gstfestival.c).

The element is a CLIENT of a festival TTS server (localhost:1314 by
default, gstfestival.h:71-73).  Protocol, transcribed call-for-call:

- on open: `(Parameter.set 'Audio_Required_Rate 16000)` then a
  response read (gstfestival.c:285-291);
- per text buffer: `(tts_textall "<text>" "<text-mode>")` with `"`
  and `\\` escaped by a backslash (gstfestival.c:293-305), text-mode
  default "fundamental";
- responses: 3-byte acks in a loop until "OK\\n" — "WV\\n" precedes a
  waveform transported with Festival's key-stuffing ("ft_StUfF_key"
  terminates; a literal 11-char prefix "ft_StUfF_ke" arrives stuffed
  as "ft_StUfF_keX", the X dropped — socket_receive_file_to_buff,
  gstfestival.c:400-446), "LP\\n" precedes an s-expression (read with
  the same unstuffing), "ER\\n" is a server error
  (read_response, gstfestival.c:211-258).

A copy of the JAX package's io/festival.py: only its imports differ.
"""

from __future__ import annotations

import socket
from typing import List, Optional, Tuple

DEFAULT_HOST = "localhost"        # FESTIVAL_DEFAULT_SERVER_HOST
DEFAULT_PORT = 1314               # FESTIVAL_DEFAULT_SERVER_PORT
DEFAULT_TEXT_MODE = "fundamental"  # FESTIVAL_DEFAULT_TEXT_MODE

_STUFF_KEY = b"ft_StUfF_key"


class FestivalError(RuntimeError):
    pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            break
        out += chunk
    return out


def receive_stuffed(sock: socket.socket) -> bytes:
    """socket_receive_file_to_buff: read until the stuff key, undoing
    the 'ft_StUfF_keX' -> 'ft_StUfF_ke' literal-prefix stuffing."""
    key = _STUFF_KEY
    out = bytearray()
    k = 0
    while k < len(key):
        c = sock.recv(1)
        if not c:
            break                     # eof before end of file
        if key[k:k + 1] == c:
            k += 1
        elif c == b"X" and k == len(key) - 1:
            # looked like the key but wasn't: emit the matched prefix,
            # omit the stuffed X
            out += key[:k]
            k = 0
        else:
            out += key[:k]
            k = 0
            out += c
    return bytes(out)


class FestivalClient:
    """One server connection (the element's FT_Info analog)."""

    def __init__(self, host: str = DEFAULT_HOST,
                 port: int = DEFAULT_PORT,
                 text_mode: str = DEFAULT_TEXT_MODE,
                 timeout: float = 10.0):
        self.text_mode = text_mode
        try:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
        except OSError as e:
            raise FestivalError(
                f"could not talk to festival server at {host}:{port} "
                f"(no server running or wrong host/port?): {e}")
        # gstfestival.c:285: issued once per talk in the reference;
        # once per connection is equivalent on a persistent socket
        self._send("(Parameter.set 'Audio_Required_Rate 16000)\n")
        self.read_response()

    def _send(self, text: str) -> None:
        self._sock.sendall(text.encode("utf-8"))

    def talk(self, text: str) -> List[bytes]:
        """tts_textall + response read -> the waveform buffers the
        server returned (each pushed as one buffer downstream by the
        reference)."""
        escaped = []
        for ch in text:
            if ch == "\0":
                break                  # the reference stops at NUL
            if ch in ('"', "\\"):
                escaped.append("\\")
            escaped.append(ch)
        self._send(f'(tts_textall "{"".join(escaped)}" '
                   f'"{self.text_mode}")\n')
        return self.read_response()

    def read_response(self) -> List[bytes]:
        """The read_response loop: collect WV waveforms until OK."""
        waves: List[bytes] = []
        while True:
            ack = _read_exact(self._sock, 3)
            if len(ack) < 3:
                raise FestivalError("festival server closed early")
            if ack == b"WV\n":
                waves.append(receive_stuffed(self._sock))
            elif ack == b"LP\n":
                receive_stuffed(self._sock)     # s-expr, logged+freed
            elif ack == b"ER\n":
                raise FestivalError(
                    "Festival speech server returned an error "
                    "(make sure you have voices/languages installed)")
            elif ack == b"OK\n":
                return waves

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def parse_wav(data: bytes) -> Tuple[int, int, "object"]:
    """Minimal RIFF/WAVE reader for the server's S16 output ->
    (rate, channels, int16 ndarray [S, C])."""
    import numpy as np
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("festival: not a RIFF/WAVE stream")
    pos = 12
    rate = channels = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            channels = int.from_bytes(body[2:4], "little")
            rate = int.from_bytes(body[4:8], "little")
        elif cid == b"data":
            pcm = np.frombuffer(body[:size - (size % 2)], "<i2")
        pos += 8 + size + (size & 1)
    if rate is None or pcm is None:
        raise ValueError("festival: WAV missing fmt/data chunks")
    return rate, channels, pcm.reshape(-1, channels)
