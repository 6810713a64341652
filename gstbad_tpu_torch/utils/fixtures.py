"""Seeded inputs for the host engines' checks, built in memory: a VGM
stream for gmedec, a ProTracker MOD for openmptdec, Opus packets of each
TOC code for opusparse, and a festival server that speaks the wire
protocol of gst/festival over localhost TCP.

    from gstbad_tpu_torch.utils import fixtures
    with fixtures.FestivalServer() as srv:
        el = gtt.make("festival", host="127.0.0.1", port=srv.port)

make_vgm and make_mod are copies of the JAX package's test fixtures
(tests/test_moduledec.py), so that chip_smoke.py, which runs without the
tests, makes the same files."""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, List, Optional

import numpy as np


def make_vgm(seconds: int = 1) -> bytes:
    """Minimal VGM 1.50 stream: one SN76489 tone + volume, N frames
    of 735-sample waits, end."""
    n_waits = 60 * seconds
    cmds = bytes([0x50, 0x8E, 0x50, 0x0D, 0x50, 0x90])
    cmds += bytes([0x62]) * n_waits + bytes([0x66])
    hdr = bytearray(0x40)
    hdr[0:4] = b"Vgm "
    struct.pack_into("<I", hdr, 0x04, 0x40 + len(cmds) - 4)
    struct.pack_into("<I", hdr, 0x08, 0x00000150)
    struct.pack_into("<I", hdr, 0x0C, 3579545)
    struct.pack_into("<I", hdr, 0x18, 735 * n_waits)
    struct.pack_into("<I", hdr, 0x24, 60)
    struct.pack_into("<H", hdr, 0x28, 0x0009)
    hdr[0x2A] = 16
    struct.pack_into("<I", hdr, 0x34, 0x0C)
    return bytes(hdr) + cmds


def make_mod(title: bytes = b"TESTSONG") -> bytes:
    """Minimal ProTracker M.K. module: 1 pattern, one C-2 note on a
    32-word sine sample."""
    hdr = bytearray()
    hdr += title.ljust(20, b"\0")
    for s in range(31):
        name = f"sample{s}".encode().ljust(22, b"\0")
        if s == 0:
            length, vol, rep, replen = 32, 64, 0, 16
        else:
            length, vol, rep, replen = 0, 0, 0, 1
        hdr += name + struct.pack(">H", length) + bytes([0, vol]) \
            + struct.pack(">HH", rep, replen)
    hdr += bytes([1, 127]) + bytes([0]) + bytes(127)
    hdr += b"M.K."
    pat = bytearray(1024)
    period, sample = 428, 1
    pat[0] = (sample & 0xF0) | (period >> 8)
    pat[1] = period & 0xFF
    pat[2] = (sample & 0x0F) << 4
    smp = ((np.sin(np.arange(64) * 2 * np.pi / 16) * 100)
           .astype(np.int8)).tobytes()
    return bytes(hdr) + bytes(pat) + smp


# ------------------------------------------------------------------ opus

def _size_bytes(n: int) -> bytes:
    """RFC 6716 3.2.1 frame length: one byte below 252, else two."""
    if n < 252:
        return bytes([n])
    rem = n - 252
    return bytes([252 + (rem & 3), rem >> 2])


def opus_packets(n: int, seed: int = 0) -> List[bytes]:
    """n seeded Opus packets that cycle through the four TOC codes
    (RFC 6716 3.2): one frame, two equal frames, two frames of different
    sizes, and code 3's CBR and VBR frame counts with padding; the TOC
    configurations span SILK, hybrid and CELT, mono and stereo."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cfg = int(rng.integers(0, 32))
        toc = cfg << 3 | int(rng.integers(0, 2)) << 2
        code = i % 4

        def frame(k=None):
            k = int(rng.integers(1, 300)) if k is None else k
            return rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        if code == 0:
            pkt = bytes([toc]) + frame()
        elif code == 1:
            k = int(rng.integers(1, 300))
            pkt = bytes([toc | 1]) + frame(k) + frame(k)
        elif code == 2:
            f1 = frame()
            pkt = bytes([toc | 2]) + _size_bytes(len(f1)) + f1 + frame()
        else:
            # at most 120 ms of audio in the packet
            per_ms = {0: 10, 1: 20, 2: 40, 3: 60}[cfg & 3] if cfg < 12 \
                else ({0: 10, 1: 20}[cfg & 1] if cfg < 16
                      else {0: 2.5, 1: 5, 2: 10, 3: 20}[cfg & 3])
            count = int(rng.integers(1, int(120 // per_ms) + 1))
            vbr = bool(rng.integers(0, 2))
            padding = int(rng.integers(0, 300))
            # the packet within test-vector framing's 1500 bytes
            most = max(2, (1100 - padding) // count)
            frames = ([frame(int(rng.integers(1, most)))
                       for _ in range(count)] if vbr
                      else [frame(int(rng.integers(1, most)))] * count)
            pkt = bytes([toc | 3, count | (0x80 if vbr else 0)
                         | (0x40 if padding else 0)])
            p = padding
            while padding and p >= 255:
                pkt += bytes([255])
                p -= 254
            if padding:
                pkt += bytes([p])
            if vbr:
                pkt += b"".join(_size_bytes(len(f)) for f in frames[:-1])
            pkt += b"".join(frames) + b"\x00" * padding
        out.append(pkt)
    return out


def opus_test_vectors(packets: List[bytes]) -> bytes:
    """The libopus test-vector framing opusparse also reads: each packet
    after its length and a final range, both u32 big-endian."""
    return b"".join(struct.pack(">II", len(p), 0) + p for p in packets)


# -------------------------------------------------------------- festival

_STUFF_KEY = b"ft_StUfF_key"


def wav_bytes(samples: np.ndarray, rate: int) -> bytes:
    """A RIFF/WAVE file of S16 mono samples."""
    pcm = np.asarray(samples, "<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2,
                                    2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def spoken(text: str, rate: int = 16000) -> bytes:
    """The waveform FestivalServer answers `text` with: a tone a
    character, its pitch from the character's code, 2 ms each (a few
    kilobytes a check: the client reads a waveform a byte a call, as
    socket_receive_file_to_buff does)."""
    t = np.arange(rate * 2 // 1000)
    tones = [(np.sin(2 * np.pi * (200 + 3 * (ord(c) % 200)) * t / rate)
              * 9000).astype(np.int16) for c in text] or [t[:0]]
    return wav_bytes(np.concatenate(tones), rate)


class FestivalServer:
    """A festival server on 127.0.0.1 (an ephemeral port): it answers
    `(Parameter.set ...)` with an LP s-expression and OK, and each
    `(tts_textall "<text>" "<mode>")` with WV, the key-stuffed waveform
    of `voice(text)` (spoken by default), and OK, or with ER where
    `voice` gives None, as festival does without a voice for the text
    (gstfestival.c's read_response and socket_receive_file_to_buff, the
    server's side).
    Each connection is served on a thread of its own until the client
    closes it; the commands received are kept in `commands`."""

    def __init__(self, voice: Optional[Callable[[str], bytes]] = None):
        self.voice = voice or spoken
        self.commands: List[str] = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(target=self._serve, daemon=True)
        self._accept.start()

    @staticmethod
    def _stuff(data: bytes) -> bytes:
        return data.replace(_STUFF_KEY[:-1], _STUFF_KEY[:-1] + b"X") \
            + _STUFF_KEY

    @staticmethod
    def _unescape(s: str) -> str:
        out, esc = [], False
        for ch in s:
            if esc or ch != "\\":
                out.append(ch)
                esc = False
            else:
                esc = True
        return "".join(out)

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return                  # closed
            th = threading.Thread(target=self._talk, args=(conn,),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _talk(self, conn: socket.socket) -> None:
        with conn, conn.makefile("rb") as f:
            for line in f:
                cmd = line.decode("utf-8").strip()
                with self._lock:
                    self.commands.append(cmd)
                if cmd.startswith("(Parameter.set"):
                    conn.sendall(b"LP\n" + self._stuff(b"nil\n") + b"OK\n")
                elif cmd.startswith('(tts_textall "'):
                    body = cmd[len('(tts_textall "'):]
                    text = self._unescape(body[:body.rindex('" "')])
                    wav = self.voice(text)
                    conn.sendall(b"ER\n" if wav is None else
                                 b"WV\n" + self._stuff(wav) + b"OK\n")
                else:
                    conn.sendall(b"ER\n")

    def close(self) -> None:
        try:
            self._srv.shutdown(socket.SHUT_RDWR)   # wakes the accept
        except OSError:
            pass
        self._srv.close()
        self._accept.join(timeout=10)
        for th in self._threads:
            th.join(timeout=10)

    def __enter__(self) -> "FestivalServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
