"""libgme (Game Music Emu) ctypes binding — the REAL library the
reference's ext/gme wraps (gstgme.c).

The reference's call walk, followed exactly by the element
(elements/audio/moduledec.py gmedec): gme_open_data(data, size, &p,
32000) (gstgme.c:396), gme_track_info for the tag/duration walk —
duration = play_length + 8000 ms when looping, fade at play_length
(gstgme.c:440-459) — gme_start_track(0), gme_set_fade, then
gme_play(p, 1600 * 2, buf) per buffer (NUM_SAMPLES, gstgme.c:325-334)
until gme_track_ended.

A copy of the JAX package's io/gme.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, byref, c_char_p, c_int, c_short, c_void_p
from typing import Optional

import numpy as np


class _Info(ctypes.Structure):
    # gme.h gme_info_t: 16 ints (length, intro_length, loop_length,
    # play_length + reserved), then 16 const char* (system, game,
    # song, author, copyright, comment, dumper + reserved)
    _fields_ = [("ints", c_int * 16), ("strs", c_char_p * 16)]


_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libgme.so.0")
    except OSError:
        return None
    lib.gme_open_data.restype = c_char_p
    lib.gme_open_data.argtypes = [c_void_p, ctypes.c_long,
                                  POINTER(c_void_p), c_int]
    lib.gme_track_count.argtypes = [c_void_p]
    lib.gme_start_track.restype = c_char_p
    lib.gme_start_track.argtypes = [c_void_p, c_int]
    lib.gme_play.restype = c_char_p
    lib.gme_play.argtypes = [c_void_p, c_int, POINTER(c_short)]
    lib.gme_track_ended.argtypes = [c_void_p]
    lib.gme_set_fade.argtypes = [c_void_p, c_int]
    lib.gme_track_info.restype = c_char_p
    lib.gme_track_info.argtypes = [c_void_p, POINTER(POINTER(_Info)),
                                   c_int]
    lib.gme_seek_samples.restype = c_char_p
    lib.gme_seek_samples.argtypes = [c_void_p, c_int]
    lib.gme_free_info.argtypes = [POINTER(_Info)]
    lib.gme_delete.argtypes = [c_void_p]
    try:
        lib.gme_enable_accuracy.argtypes = [c_void_p, c_int]
    except AttributeError:
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class GmePlayer:
    """One opened game-music emulator (track 0 started like the
    reference)."""

    def __init__(self, data: bytes, rate: int = 32000,
                 track: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgme not available")
        self._lib = lib
        self._p = c_void_p()
        err = lib.gme_open_data(data, len(data), byref(self._p), rate)
        if err:
            raise ValueError(f"gme_open_data: {err.decode()}")
        self.track_count = lib.gme_track_count(self._p)
        info_p = POINTER(_Info)()
        err = lib.gme_track_info(self._p, byref(info_p), track)
        self.info = {}
        self.play_length_ms = 150000
        self.loop_length_ms = -1
        if not err and info_p:
            ints = list(info_p.contents.ints)
            self.play_length_ms = ints[3]
            self.loop_length_ms = ints[2]
            names = ("system", "game", "song", "author", "copyright",
                     "comment", "dumper")
            for i, name in enumerate(names):
                s = info_p.contents.strs[i]
                if s:
                    self.info[name] = s.decode("utf-8", "replace")
            lib.gme_free_info(info_p)
        if hasattr(lib, "gme_enable_accuracy"):
            lib.gme_enable_accuracy(self._p, 1)
        err = lib.gme_start_track(self._p, track)
        if err:
            raise ValueError(f"gme_start_track: {err.decode()}")
        # the reference's fade walk (gstgme.c:440-459)
        if self.loop_length_ms > 0:
            lib.gme_set_fade(self._p, self.play_length_ms)

    @property
    def duration_ms(self) -> int:
        return self.play_length_ms \
            + (8000 if self.loop_length_ms > 0 else 0)

    def seek_frames(self, frame: int) -> None:
        """Seek to an output frame position (gme counts interleaved
        shorts, so a stereo frame = 2 gme samples)."""
        err = self._lib.gme_seek_samples(self._p, frame * 2)
        if err:
            raise RuntimeError(f"gme_seek_samples: {err.decode()}")

    def play(self, n_frames: int) -> Optional[np.ndarray]:
        """-> [n_frames, 2] int16 stereo, or None when the track
        ended."""
        if self._lib.gme_track_ended(self._p):
            return None
        buf = (c_short * (n_frames * 2))()
        err = self._lib.gme_play(self._p, n_frames * 2, buf)
        if err:
            raise RuntimeError(f"gme_play: {err.decode()}")
        return np.ctypeslib.as_array(buf).reshape(n_frames, 2).copy()

    def __del__(self):
        p = getattr(self, "_p", None)
        if p:
            self._lib.gme_delete(p)
            self._p = None
