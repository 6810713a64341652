"""libgsm ctypes binding — the REAL GSM 06.10 codec library the
reference's ext/gsm wraps (gstgsmenc.c / gstgsmdec.c).

160 S16 samples <-> one 33-byte GSM frame at 8000 Hz mono
(gstgsmenc.c:143-186, gstgsmdec.c:56).  WAV49 (audio/ms-gsm) mode
flips GSM_OPT_WAV49 like gstgsmdec.c:156-170 — there 2 frames pack
into 65 bytes.

A copy of the JAX package's io/gsmcodec.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import POINTER, byref, c_int, c_int16, c_uint8, c_void_p

import numpy as np

GSM_OPT_WAV49 = 6          # gsm.h private option id
FRAME_SAMPLES = 160
FRAME_BYTES = 33

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libgsm.so.1")
    except OSError:
        return None
    lib.gsm_create.restype = c_void_p
    lib.gsm_destroy.argtypes = [c_void_p]
    lib.gsm_encode.argtypes = [c_void_p, POINTER(c_int16),
                               POINTER(c_uint8)]
    lib.gsm_decode.restype = c_int
    lib.gsm_decode.argtypes = [c_void_p, POINTER(c_uint8),
                               POINTER(c_int16)]
    lib.gsm_option.argtypes = [c_void_p, c_int, POINTER(c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class GsmCodec:
    """One gsm handle (stateful across frames, like the reference's
    per-element state)."""

    def __init__(self, wav49: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgsm not available")
        self._lib = lib
        self._h = lib.gsm_create()
        if not self._h:
            raise RuntimeError("gsm_create failed")
        if wav49:
            v = c_int(1)
            lib.gsm_option(self._h, GSM_OPT_WAV49, byref(v))

    def encode_frame(self, samples: np.ndarray) -> bytes:
        """[160] int16 -> 33 bytes."""
        s = np.ascontiguousarray(samples, np.int16)
        if s.shape != (FRAME_SAMPLES,):
            raise ValueError("gsm: need exactly 160 samples")
        out = (c_uint8 * FRAME_BYTES)()
        self._lib.gsm_encode(self._h,
                             s.ctypes.data_as(POINTER(c_int16)), out)
        return bytes(out)

    def decode_frame(self, frame: bytes) -> np.ndarray:
        """33 bytes -> [160] int16."""
        if len(frame) != FRAME_BYTES:
            raise ValueError("gsm: need exactly 33 bytes")
        buf = (c_uint8 * FRAME_BYTES)(*frame)
        out = (c_int16 * FRAME_SAMPLES)()
        if self._lib.gsm_decode(self._h, buf, out) != 0:
            raise ValueError("gsm_decode: bad frame")
        return np.ctypeslib.as_array(out).copy()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.gsm_destroy(h)
            self._h = None
