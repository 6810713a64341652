"""frei0r plugin host (gst/frei0r/gstfrei0r.c:471-598 register_plugin
+ the f0r ABI of gst/frei0r/frei0r.h) — the io/ladspa.py pattern
applied to video-effect plugins.

dlopens f0r shared objects, validates them the way the reference does
(required symbols, frei0r_version <= 1, color model <= PACKED32,
param types <= STRING, trial construct at 640x480 —
gstfrei0r.c:489-560), and marshals the five parameter types:
BOOL/DOUBLE as double, COLOR as three floats, POSITION as two
doubles, STRING as char** (frei0r.h:395-430).

Since no system frei0r plugins ship in this environment, the in-repo
fixture plugins (csrc/frei0r_plugins.c: a filter, a source, a
mixer2 and a string-param filter) are built on demand — exactly the
csrc/ladspa_plugins.c approach the LADSPA host uses.
A copy of the JAX package's io/frei0r.py: the fixtures are the port's own
copy, gstbad_tpu_torch/csrc/frei0r_plugins.c, built at first use into
gstbad_tpu_torch/_build/ (io/_native_build.py); the rest differs only in
its imports.
"""

from __future__ import annotations

import ctypes
import os
from ctypes import (POINTER, Structure, byref, c_char_p, c_double,
                    c_float, c_int, c_uint32, c_void_p)
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from gstbad_tpu_torch.io import _native_build

PLUGIN_TYPE_FILTER = 0
PLUGIN_TYPE_SOURCE = 1
PLUGIN_TYPE_MIXER2 = 2
PLUGIN_TYPE_MIXER3 = 3

COLOR_MODEL_BGRA8888 = 0
COLOR_MODEL_RGBA8888 = 1
COLOR_MODEL_PACKED32 = 2

PARAM_BOOL = 0
PARAM_DOUBLE = 1
PARAM_COLOR = 2
PARAM_POSITION = 3
PARAM_STRING = 4


class _PluginInfo(Structure):
    _fields_ = [("name", c_char_p), ("author", c_char_p),
                ("plugin_type", c_int), ("color_model", c_int),
                ("frei0r_version", c_int), ("major_version", c_int),
                ("minor_version", c_int), ("num_params", c_int),
                ("explanation", c_char_p)]


class _ParamInfo(Structure):
    _fields_ = [("name", c_char_p), ("type", c_int),
                ("explanation", c_char_p)]


class _Color(Structure):
    _fields_ = [("r", c_float), ("g", c_float), ("b", c_float)]


class _Position(Structure):
    _fields_ = [("x", c_double), ("y", c_double)]


@dataclass
class ParamInfo:
    name: str
    type: int
    explanation: str


@dataclass
class PluginInfo:
    name: str
    author: str
    plugin_type: int
    color_model: int
    frei0r_version: int
    num_params: int
    explanation: str


class Frei0rError(RuntimeError):
    pass


class Frei0rInstance:
    """One constructed effect instance (f0r_construct)."""

    def __init__(self, plugin: "Frei0rPlugin", width: int, height: int):
        if width % 8 or height % 8 or not (8 <= width <= 2048) \
                or not (8 <= height <= 2048):
            # frei0r.h: resolutions are multiples of 8 in [8, 2048]
            raise Frei0rError(
                f"frei0r needs 8-aligned dims in [8,2048], "
                f"got {width}x{height}")
        self.plugin = plugin
        self.width = width
        self.height = height
        self._handle = plugin._lib.f0r_construct(width, height)
        if not self._handle:
            raise Frei0rError(f"f0r_construct failed for {plugin.name}")

    def close(self) -> None:
        if self._handle:
            self.plugin._lib.f0r_destruct(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------ param marshal
    # (gstfrei0r.c:290-466 gst_frei0r_get/set_property)

    def set_param(self, index: int, value) -> None:
        p = self.plugin.params[index]
        lib = self.plugin._lib
        if p.type in (PARAM_BOOL, PARAM_DOUBLE):
            v = c_double(float(value))
            lib.f0r_set_param_value(self._handle, byref(v), index)
        elif p.type == PARAM_COLOR:
            r, g, b = value
            v = _Color(r, g, b)
            lib.f0r_set_param_value(self._handle, byref(v), index)
        elif p.type == PARAM_POSITION:
            x, y = value
            v = _Position(x, y)
            lib.f0r_set_param_value(self._handle, byref(v), index)
        elif p.type == PARAM_STRING:
            s = c_char_p(str(value).encode("utf-8"))
            lib.f0r_set_param_value(self._handle, byref(s), index)
        else:
            raise Frei0rError(f"unsupported param type {p.type}")

    def get_param(self, index: int):
        p = self.plugin.params[index]
        lib = self.plugin._lib
        if p.type == PARAM_BOOL:
            v = c_double()
            lib.f0r_get_param_value(self._handle, byref(v), index)
            return v.value >= 0.5
        if p.type == PARAM_DOUBLE:
            v = c_double()
            lib.f0r_get_param_value(self._handle, byref(v), index)
            return v.value
        if p.type == PARAM_COLOR:
            v = _Color()
            lib.f0r_get_param_value(self._handle, byref(v), index)
            return (v.r, v.g, v.b)
        if p.type == PARAM_POSITION:
            v = _Position()
            lib.f0r_get_param_value(self._handle, byref(v), index)
            return (v.x, v.y)
        if p.type == PARAM_STRING:
            v = c_char_p()
            lib.f0r_get_param_value(self._handle, byref(v), index)
            return (v.value or b"").decode("utf-8")
        raise Frei0rError(f"unsupported param type {p.type}")

    # ------------------------------------------------------ update

    def _check(self, frame: np.ndarray) -> np.ndarray:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != (self.height, self.width, 4):
            raise Frei0rError(
                f"expected ({self.height},{self.width},4) u8, "
                f"got {frame.shape}")
        return frame

    def update(self, time: float,
               inframe: Optional[np.ndarray]) -> np.ndarray:
        """f0r_update (filters and sources; input None for sources)."""
        lib = self.plugin._lib
        out = np.empty((self.height, self.width, 4), np.uint8)
        if inframe is None:
            inptr = None
        else:
            inframe = self._check(inframe)
            inptr = inframe.ctypes.data_as(POINTER(c_uint32))
        lib.f0r_update(self._handle, c_double(time), inptr,
                       out.ctypes.data_as(POINTER(c_uint32)))
        return out

    def update2(self, time: float, in1: np.ndarray,
                in2: Optional[np.ndarray],
                in3: Optional[np.ndarray] = None) -> np.ndarray:
        """f0r_update2 (mixers)."""
        lib = self.plugin._lib
        out = np.empty((self.height, self.width, 4), np.uint8)

        def ptr(f):
            if f is None:
                return None
            return self._check(f).ctypes.data_as(POINTER(c_uint32))

        lib.f0r_update2(self._handle, c_double(time), ptr(in1),
                        ptr(in2), ptr(in3),
                        out.ctypes.data_as(POINTER(c_uint32)))
        return out


class Frei0rPlugin:
    """One loaded f0r shared object (one plugin per .so by spec)."""

    def __init__(self, path: str):
        self.path = path
        lib = ctypes.CDLL(path)
        # required symbols (gstfrei0r.c:489-507)
        for sym in ("f0r_init", "f0r_deinit", "f0r_construct",
                    "f0r_destruct", "f0r_get_plugin_info",
                    "f0r_get_param_info", "f0r_set_param_value",
                    "f0r_get_param_value"):
            if not hasattr(lib, sym):
                raise Frei0rError(f"{path}: missing {sym}")
        self.has_update = hasattr(lib, "f0r_update")
        self.has_update2 = hasattr(lib, "f0r_update2")
        if not (self.has_update or self.has_update2):
            raise Frei0rError(f"{path}: no f0r_update/f0r_update2")
        lib.f0r_construct.restype = c_void_p
        lib.f0r_construct.argtypes = [c_uint32, c_uint32]
        lib.f0r_destruct.argtypes = [c_void_p]
        lib.f0r_set_param_value.argtypes = [c_void_p, c_void_p, c_int]
        lib.f0r_get_param_value.argtypes = [c_void_p, c_void_p, c_int]
        if self.has_update:
            lib.f0r_update.argtypes = [c_void_p, c_double,
                                       POINTER(c_uint32),
                                       POINTER(c_uint32)]
        if self.has_update2:
            lib.f0r_update2.argtypes = [c_void_p, c_double,
                                        POINTER(c_uint32),
                                        POINTER(c_uint32),
                                        POINTER(c_uint32),
                                        POINTER(c_uint32)]
        if not lib.f0r_init():
            raise Frei0rError(f"{path}: f0r_init failed")
        info = _PluginInfo()
        lib.f0r_get_plugin_info(byref(info))
        # validation per gstfrei0r.c:525-541
        if info.frei0r_version > 1:
            raise Frei0rError(
                f"{path}: unsupported frei0r version "
                f"{info.frei0r_version}")
        if info.color_model > COLOR_MODEL_PACKED32:
            raise Frei0rError(
                f"{path}: unsupported color model {info.color_model}")
        self.info = PluginInfo(
            name=(info.name or b"").decode("utf-8"),
            author=(info.author or b"").decode("utf-8"),
            plugin_type=info.plugin_type,
            color_model=info.color_model,
            frei0r_version=info.frei0r_version,
            num_params=info.num_params,
            explanation=(info.explanation or b"").decode("utf-8"))
        self.params: List[ParamInfo] = []
        for i in range(info.num_params):
            pi = _ParamInfo()
            lib.f0r_get_param_info(byref(pi), i)
            if pi.type > PARAM_STRING:
                raise Frei0rError(
                    f"{path}: unsupported param type {pi.type}")
            self.params.append(ParamInfo(
                name=(pi.name or b"").decode("utf-8"), type=pi.type,
                explanation=(pi.explanation or b"").decode("utf-8")))
        self._lib = lib
        # trial construct (gstfrei0r.c:552-559) + default values
        trial = Frei0rInstance(self, 640, 480)
        self.defaults = [trial.get_param(i)
                         for i in range(len(self.params))]
        trial.close()

    @property
    def name(self) -> str:
        return self.info.name

    def instantiate(self, width: int, height: int) -> Frei0rInstance:
        return Frei0rInstance(self, width, height)


def scan(paths: Optional[List[str]] = None) -> List[Frei0rPlugin]:
    """Scan FREI0R_PATH-style directories for .so plugins
    (gstfrei0r.c:660-709: FREI0R_PATH env, else the system frei0r-1
    dirs)."""
    if paths is None:
        env = os.environ.get("FREI0R_PATH")
        if env:
            paths = env.split(":")
        else:
            paths = [os.path.expanduser("~/.frei0r-1/lib"),
                     "/usr/local/lib/frei0r-1", "/usr/lib/frei0r-1",
                     "/usr/local/lib64/frei0r-1", "/usr/lib64/frei0r-1"]
    plugins: List[Frei0rPlugin] = []
    seen = set()
    for d in paths:
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".so"):
                continue
            try:
                p = Frei0rPlugin(os.path.join(d, fn))
            except (Frei0rError, OSError):
                continue
            if p.name in seen:   # duplicate plugin names skipped
                continue
            seen.add(p.name)
            plugins.append(p)
    return plugins


_FIXTURES = ("BRIGHTNESS", "GRADIENT", "BLEND", "LABELER")


def build_fixture_plugins() -> str:
    """Compile csrc/frei0r_plugins.c into one .so per fixture
    (frei0r mandates one plugin per shared object) in a content-hash
    build dir; returns the directory, fit for FREI0R_PATH."""
    directory = _native_build.build_dir("frei0r", ["frei0r_plugins.c"])
    for name in _FIXTURES:
        _native_build.gcc_shared(
            os.path.join(directory, f"fix{name.lower()}.so"),
            "frei0r_plugins.c", f"-DF0R_FIXTURE_{name}")
    return directory
