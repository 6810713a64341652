"""libchromaprint ctypes binding (ext/chromaprint/gstchromaprint.c).

The reference element IS a thin wrapper around exactly these calls
(gstchromaprint.c: chromaprint_new(CHROMAPRINT_ALGORITHM_DEFAULT) ->
start(rate, channels) -> feed(S16 interleaved) -> finish ->
get_fingerprint); this environment ships libchromaprint.so.1, so the
host boundary binds it directly — fingerprints are Acoustid-compatible,
the same bytes the reference element produces.  The device chroma
engine (elements/audio/fingerprint.py) remains as the in-graph
`engine=native` path and the fallback when the library is absent.

A copy of the JAX package's io/chromaprint.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

ALGORITHM_DEFAULT = 1     # CHROMAPRINT_ALGORITHM_TEST2 (the lib default)

_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    name = ctypes.util.find_library("chromaprint")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.chromaprint_new.restype = ctypes.c_void_p
        lib.chromaprint_new.argtypes = [ctypes.c_int]
        lib.chromaprint_start.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.chromaprint_feed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
        lib.chromaprint_finish.argtypes = [ctypes.c_void_p]
        lib.chromaprint_get_fingerprint.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
        lib.chromaprint_dealloc.argtypes = [ctypes.c_void_p]
        lib.chromaprint_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None


def fingerprint(s16: np.ndarray, rate: int,
                algorithm: int = ALGORITHM_DEFAULT) -> str:
    """Acoustid fingerprint of [N, C] int16 interleaved samples."""
    lib = load()
    if lib is None:
        raise RuntimeError("libchromaprint not available")
    s16 = np.ascontiguousarray(s16, np.int16)
    if s16.ndim == 1:
        s16 = s16[:, None]
    n, c = s16.shape
    ctx = lib.chromaprint_new(algorithm)
    if not ctx:
        raise RuntimeError("chromaprint_new failed")
    try:
        if not lib.chromaprint_start(ctx, int(rate), int(c)):
            raise RuntimeError("chromaprint_start failed")
        flat = s16.reshape(-1)
        ptr = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
        if not lib.chromaprint_feed(ctx, ptr, flat.size):
            raise RuntimeError("chromaprint_feed failed")
        if not lib.chromaprint_finish(ctx):
            raise RuntimeError("chromaprint_finish failed")
        out = ctypes.c_char_p()
        if not lib.chromaprint_get_fingerprint(ctx, ctypes.byref(out)):
            raise RuntimeError("chromaprint_get_fingerprint failed")
        try:
            return out.value.decode("ascii")
        finally:
            lib.chromaprint_dealloc(out)
    finally:
        lib.chromaprint_free(ctx)
