"""libopenmpt ctypes binding — the REAL library the reference's
ext/openmpt wraps (gstopenmptdec.c).

Follows the reference's sequence: openmpt_module_create_from_memory2
(gstopenmptdec.c:529), subsong scan before select_subsong (:562-616),
openmpt_module_set_render_param for master-gain / stereo-separation /
filter-length / volume-ramping (:641-650), then the interleaved
stereo/quad read calls per output buffer.

A copy of the JAX package's io/openmpt.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, byref, c_char_p, c_double, c_float,
                    c_int, c_int16, c_size_t, c_void_p)
from typing import Dict, Optional

import numpy as np

# openmpt_module_render_param
RENDER_MASTERGAIN_MILLIBEL = 1
RENDER_STEREOSEPARATION_PERCENT = 2
RENDER_INTERPOLATIONFILTER_LENGTH = 3
RENDER_VOLUMERAMPING_STRENGTH = 4

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libopenmpt.so.0")
    except OSError:
        return None
    lib.openmpt_module_create_from_memory2.restype = c_void_p
    lib.openmpt_module_create_from_memory2.argtypes = [
        c_void_p, c_size_t, c_void_p, c_void_p, c_void_p, c_void_p,
        POINTER(c_int), POINTER(c_char_p), c_void_p]
    lib.openmpt_module_destroy.argtypes = [c_void_p]
    lib.openmpt_module_set_render_param.argtypes = [c_void_p, c_int,
                                                    ctypes.c_int32]
    lib.openmpt_module_set_repeat_count.argtypes = [c_void_p,
                                                    ctypes.c_int32]
    lib.openmpt_module_get_num_subsongs.restype = ctypes.c_int32
    lib.openmpt_module_get_num_subsongs.argtypes = [c_void_p]
    lib.openmpt_module_select_subsong.argtypes = [c_void_p,
                                                  ctypes.c_int32]
    lib.openmpt_module_get_duration_seconds.restype = c_double
    lib.openmpt_module_get_duration_seconds.argtypes = [c_void_p]
    lib.openmpt_module_set_position_seconds.restype = c_double
    lib.openmpt_module_set_position_seconds.argtypes = [c_void_p,
                                                        c_double]
    lib.openmpt_module_get_metadata.restype = c_void_p  # must free
    lib.openmpt_module_get_metadata.argtypes = [c_void_p, c_char_p]
    lib.openmpt_free_string.argtypes = [c_void_p]
    lib.openmpt_module_read_interleaved_float_stereo.restype = c_size_t
    lib.openmpt_module_read_interleaved_float_stereo.argtypes = [
        c_void_p, ctypes.c_int32, c_size_t, POINTER(c_float)]
    lib.openmpt_module_read_interleaved_stereo.restype = c_size_t
    lib.openmpt_module_read_interleaved_stereo.argtypes = [
        c_void_p, ctypes.c_int32, c_size_t, POINTER(c_int16)]
    lib.openmpt_module_read_float_mono.restype = c_size_t
    lib.openmpt_module_read_float_mono.argtypes = [
        c_void_p, ctypes.c_int32, c_size_t, POINTER(c_float)]
    lib.openmpt_module_read_mono.restype = c_size_t
    lib.openmpt_module_read_mono.argtypes = [
        c_void_p, ctypes.c_int32, c_size_t, POINTER(c_int16)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class Module:
    """One loaded module (tracker) file."""

    def __init__(self, data: bytes):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopenmpt not available")
        self._lib = lib
        err = c_int(0)
        msg = c_char_p()
        self._m = lib.openmpt_module_create_from_memory2(
            data, len(data), None, None, None, None, byref(err),
            byref(msg), None)
        if not self._m:
            text = msg.value.decode() if msg.value else f"error {err.value}"
            raise ValueError(f"openmpt: {text}")

    def set_render_param(self, param: int, value: int) -> None:
        self._lib.openmpt_module_set_render_param(self._m, param,
                                                  value)

    def set_repeat_count(self, n: int) -> None:
        self._lib.openmpt_module_set_repeat_count(self._m, n)

    @property
    def num_subsongs(self) -> int:
        return self._lib.openmpt_module_get_num_subsongs(self._m)

    def select_subsong(self, idx: int) -> None:
        self._lib.openmpt_module_select_subsong(self._m, idx)

    @property
    def duration_seconds(self) -> float:
        return self._lib.openmpt_module_get_duration_seconds(self._m)

    def set_position_seconds(self, seconds: float) -> float:
        return self._lib.openmpt_module_set_position_seconds(
            self._m, seconds)

    def metadata(self, key: str) -> Optional[str]:
        p = self._lib.openmpt_module_get_metadata(self._m,
                                                  key.encode())
        if not p:
            return None
        try:
            return ctypes.string_at(p).decode("utf-8", "replace") \
                or None
        finally:
            self._lib.openmpt_free_string(p)

    def tags(self) -> Dict[str, str]:
        out = {}
        for key in ("title", "artist", "tracker", "type",
                    "type_long", "message"):
            v = self.metadata(key)
            if v:
                out[key] = v
        return out

    def read(self, rate: int, n_frames: int, channels: int = 2,
             fmt: str = "F32") -> np.ndarray:
        """-> [frames_read, channels] F32 or S16 interleaved PCM;
        frames_read < n_frames at song end (0 = done)."""
        lib = self._lib
        if channels == 2 and fmt == "F32":
            buf = (c_float * (n_frames * 2))()
            got = lib.openmpt_module_read_interleaved_float_stereo(
                self._m, rate, n_frames, buf)
            arr = np.ctypeslib.as_array(buf).reshape(n_frames, 2)
        elif channels == 2:
            buf = (c_int16 * (n_frames * 2))()
            got = lib.openmpt_module_read_interleaved_stereo(
                self._m, rate, n_frames, buf)
            arr = np.ctypeslib.as_array(buf).reshape(n_frames, 2)
        elif fmt == "F32":
            buf = (c_float * n_frames)()
            got = lib.openmpt_module_read_float_mono(
                self._m, rate, n_frames, buf)
            arr = np.ctypeslib.as_array(buf).reshape(n_frames, 1)
        else:
            buf = (c_int16 * n_frames)()
            got = lib.openmpt_module_read_mono(
                self._m, rate, n_frames, buf)
            arr = np.ctypeslib.as_array(buf).reshape(n_frames, 1)
        return arr[:got].copy()

    def __del__(self):
        m = getattr(self, "_m", None)
        if m:
            self._lib.openmpt_module_destroy(m)
            self._m = None
