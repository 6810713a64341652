"""LADSPA plugin host (ext/ladspa/gstladspa.c + gstladspautils.c).

The reference dlopens every library on LADSPA_PATH, walks
ladspa_descriptor(i), classifies each plugin by audio port counts
(source / sink / filter) and builds GObject properties from the
control-port range hints.  This module does the same over ctypes:

  - scan(path): discover plugins; element type names follow the
    reference scheme "ladspa[src|sink]-<soname>-<label>" lowercased
    and canonicalized to [a-z0-9-+] (gstladspa.c:213-233);
  - control-port property specs replicate
    gst_ladspa_object_class_get_param_spec (gstladspautils.c:344-452):
    TOGGLED -> bool(False); bounds from the hints else +/-FLT_MAX;
    SAMPLE_RATE hints scale bounds by 44100; INTEGER clamps to int32
    and yields an int property; defaults from the DEFAULT_* table
    incl. the logarithmic LOW/MIDDLE/HIGH interpolation; lower>upper
    silently swapped; duplicate property names get "-<n>" suffixes;
  - Plugin instances: instantiate/connect/activate/run with
    de-interleave in, interleave out (gstladspautils.c:73-166).

The LADSPA struct/constant declarations are written from the public
LADSPA 1.1 specification.
A copy of the JAX package's io/ladspa.py: the fixture is the port's own
copy, gstbad_tpu_torch/csrc/ladspa_plugins.c, built at first use into
gstbad_tpu_torch/_build/ (io/_native_build.py); the rest differs only in
its imports.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from gstbad_tpu_torch.io import _native_build

# port descriptors
PORT_INPUT = 0x1
PORT_OUTPUT = 0x2
PORT_CONTROL = 0x4
PORT_AUDIO = 0x8

# hints
HINT_BOUNDED_BELOW = 0x001
HINT_BOUNDED_ABOVE = 0x002
HINT_TOGGLED = 0x004
HINT_SAMPLE_RATE = 0x008
HINT_LOGARITHMIC = 0x010
HINT_INTEGER = 0x020
HINT_DEFAULT_MASK = 0x3C0
HINT_DEFAULT_MINIMUM = 0x040
HINT_DEFAULT_LOW = 0x080
HINT_DEFAULT_MIDDLE = 0x0C0
HINT_DEFAULT_HIGH = 0x100
HINT_DEFAULT_MAXIMUM = 0x140
HINT_DEFAULT_0 = 0x200
HINT_DEFAULT_1 = 0x240
HINT_DEFAULT_100 = 0x280
HINT_DEFAULT_440 = 0x2C0

FLT_MAX = 3.402823466e38
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


class LadspaError(ValueError):
    pass


class _PortRangeHint(ctypes.Structure):
    _fields_ = [("HintDescriptor", ctypes.c_int),
                ("LowerBound", ctypes.c_float),
                ("UpperBound", ctypes.c_float)]


class _Descriptor(ctypes.Structure):
    pass


_HANDLE = ctypes.c_void_p
_Descriptor._fields_ = [
    ("UniqueID", ctypes.c_ulong),
    ("Label", ctypes.c_char_p),
    ("Properties", ctypes.c_int),
    ("Name", ctypes.c_char_p),
    ("Maker", ctypes.c_char_p),
    ("Copyright", ctypes.c_char_p),
    ("PortCount", ctypes.c_ulong),
    ("PortDescriptors", ctypes.POINTER(ctypes.c_int)),
    ("PortNames", ctypes.POINTER(ctypes.c_char_p)),
    ("PortRangeHints", ctypes.POINTER(_PortRangeHint)),
    ("ImplementationData", ctypes.c_void_p),
    ("instantiate", ctypes.CFUNCTYPE(_HANDLE,
                                     ctypes.POINTER(_Descriptor),
                                     ctypes.c_ulong)),
    ("connect_port", ctypes.CFUNCTYPE(None, _HANDLE, ctypes.c_ulong,
                                      ctypes.POINTER(ctypes.c_float))),
    ("activate", ctypes.CFUNCTYPE(None, _HANDLE)),
    ("run", ctypes.CFUNCTYPE(None, _HANDLE, ctypes.c_ulong)),
    ("run_adding", ctypes.CFUNCTYPE(None, _HANDLE, ctypes.c_ulong)),
    ("set_run_adding_gain", ctypes.CFUNCTYPE(None, _HANDLE,
                                             ctypes.c_float)),
    ("deactivate", ctypes.CFUNCTYPE(None, _HANDLE)),
    ("cleanup", ctypes.CFUNCTYPE(None, _HANDLE)),
]


@dataclasses.dataclass
class PropertySpec:
    name: str
    nick: str            # the raw port name (the pspec blurb)
    type: type           # bool | int | float
    default: object
    minimum: object = None
    maximum: object = None
    writable: bool = True
    port_index: int = 0


def _canon_name(name: str) -> str:
    """g_strcanon to [A-Za-z0-9-+] then lowercase
    (gstladspa.c:231-233)."""
    return re.sub(r"[^A-Za-z0-9\-+]", "-", name).lower()


def _prop_base_name(port_name: str) -> str:
    """gstladspautils.c:332-341: lowercase, non-alnum -> '-'."""
    out = []
    for ch in port_name.lower():
        out.append(ch if (ch.isalnum() and ch.isascii()) else "-")
    return "".join(out)


def _param_spec(desc, portnum: int, taken: set,
                writable: bool) -> PropertySpec:
    """gst_ladspa_object_class_get_param_spec
    (gstladspautils.c:344-452)."""
    name = _prop_base_name(desc.PortNames[portnum].decode())
    if name in taken:
        n = 1
        while f"{name}-{n}" in taken:
            n += 1
        name = f"{name}-{n}"
    taken.add(name)
    hint = desc.PortRangeHints[portnum]
    hd = hint.HintDescriptor
    nick = desc.PortNames[portnum].decode()
    if hd & HINT_TOGGLED:
        return PropertySpec(name, nick, bool, False,
                            writable=writable, port_index=portnum)
    lower = hint.LowerBound if hd & HINT_BOUNDED_BELOW else -FLT_MAX
    upper = hint.UpperBound if hd & HINT_BOUNDED_ABOVE else FLT_MAX
    if hd & HINT_SAMPLE_RATE:
        # "FIXME: how to handle this correctly?" — the reference
        # scales by a fixed 44100 (gstladspautils.c:377-383)
        if hd & HINT_BOUNDED_BELOW:
            lower *= 44100
        if hd & HINT_BOUNDED_ABOVE:
            upper *= 44100
    if hd & HINT_INTEGER:
        lower = min(max(lower, INT32_MIN), INT32_MAX)
        upper = min(max(upper, INT32_MIN), INT32_MAX)
    # default: lower bound, then the DEFAULT_* table
    def_ = lower
    d = hd & HINT_DEFAULT_MASK
    if d == HINT_DEFAULT_0:
        def_ = 0
    elif d == HINT_DEFAULT_1:
        def_ = 1
    elif d == HINT_DEFAULT_100:
        def_ = 100
    elif d == HINT_DEFAULT_440:
        def_ = 440
    elif d == HINT_DEFAULT_MINIMUM:
        def_ = lower
    elif d == HINT_DEFAULT_MAXIMUM:
        def_ = upper
    elif d in (HINT_DEFAULT_LOW, HINT_DEFAULT_MIDDLE,
               HINT_DEFAULT_HIGH):
        w = {HINT_DEFAULT_LOW: 0.75, HINT_DEFAULT_MIDDLE: 0.5,
             HINT_DEFAULT_HIGH: 0.25}[d]
        if hd & HINT_LOGARITHMIC:
            def_ = math.exp(w * math.log(lower)
                            + (1 - w) * math.log(upper))
        else:
            def_ = w * lower + (1 - w) * upper
    if lower > upper:
        lower, upper = upper, lower  # silently swap
    def_ = min(max(def_, lower), upper)
    if hd & HINT_INTEGER:
        return PropertySpec(name, nick, int, int(def_), int(lower),
                            int(upper), writable, portnum)
    return PropertySpec(name, nick, float, float(def_), float(lower),
                        float(upper), writable, portnum)


class LadspaPlugin:
    """One discovered LADSPA plugin type."""

    def __init__(self, library: ctypes.CDLL, filename: str,
                 index: int, desc):
        self._lib = library          # keep the dlopen alive
        self.filename = filename
        self.index = index
        self.desc = desc
        self.unique_id = desc.UniqueID
        self.label = desc.Label.decode()
        self.name = desc.Name.decode()
        self.maker = desc.Maker.decode()
        self.audio_in: List[int] = []
        self.audio_out: List[int] = []
        self.control_in: List[int] = []
        self.control_out: List[int] = []
        for i in range(desc.PortCount):
            p = desc.PortDescriptors[i]
            if p & PORT_AUDIO:
                (self.audio_in if p & PORT_INPUT
                 else self.audio_out).append(i)
            elif p & PORT_CONTROL:
                (self.control_in if p & PORT_INPUT
                 else self.control_out).append(i)
        taken: set = set()
        self.in_props = [_param_spec(desc, i, taken, True)
                         for i in self.control_in]
        self.out_props = [_param_spec(desc, i, taken, False)
                          for i in self.control_out]
        entry = os.path.splitext(os.path.basename(filename))[0]
        if entry.startswith("lib"):
            entry = entry[3:]
        if not self.audio_in:
            prefix = "ladspasrc"
        elif not self.audio_out:
            prefix = "ladspasink"
        else:
            prefix = "ladspa"
        self.element_name = _canon_name(
            f"{prefix}-{entry}-{self.label}")

    def instantiate(self, rate: int) -> "LadspaInstance":
        return LadspaInstance(self, rate)


class LadspaInstance:
    def __init__(self, plugin: LadspaPlugin, rate: int):
        self.plugin = plugin
        desc = plugin.desc
        self.handle = desc.instantiate(ctypes.byref(desc), rate)
        if not self.handle:
            raise LadspaError(
                f"could not instantiate {plugin.label}")
        self.rate = rate
        self.activated = False
        n_in = len(plugin.control_in)
        n_out = len(plugin.control_out)
        self._ctl_in = (ctypes.c_float * max(n_in, 1))()
        self._ctl_out = (ctypes.c_float * max(n_out, 1))()
        for i, port in enumerate(plugin.control_in):
            self._ctl_in[i] = plugin.in_props[i].default
            desc.connect_port(
                self.handle, port,
                ctypes.cast(ctypes.byref(self._ctl_in, i * 4),
                            ctypes.POINTER(ctypes.c_float)))
        for i, port in enumerate(plugin.control_out):
            desc.connect_port(
                self.handle, port,
                ctypes.cast(ctypes.byref(self._ctl_out, i * 4),
                            ctypes.POINTER(ctypes.c_float)))

    # control values by property name
    def set_control(self, name: str, value) -> None:
        for i, spec in enumerate(self.plugin.in_props):
            if spec.name == name:
                self._ctl_in[i] = (1.0 if value else 0.0) \
                    if spec.type is bool else float(value)
                return
        raise LadspaError(f"no writable control '{name}'")

    def get_control(self, name: str):
        for i, spec in enumerate(self.plugin.in_props):
            if spec.name == name:
                v = self._ctl_in[i]
                break
        else:
            for i, spec in enumerate(self.plugin.out_props):
                if spec.name == name:
                    v = self._ctl_out[i]
                    break
            else:
                raise LadspaError(f"no control '{name}'")
        if spec.type is bool:
            return v > 0.5
        if spec.type is int:
            return int(min(max(v, INT32_MIN), INT32_MAX))
        return v

    def activate(self) -> None:
        if not self.activated and self.plugin.desc.activate:
            self.plugin.desc.activate(self.handle)
        self.activated = True

    def deactivate(self) -> None:
        if self.activated and self.plugin.desc.deactivate:
            self.plugin.desc.deactivate(self.handle)
        self.activated = False

    def run(self, samples: int,
            audio_in: Optional[np.ndarray] = None) -> np.ndarray:
        """One processing block: interleaved float32 [samples, n_in]
        in, interleaved [samples, n_out] out
        (gst_ladspa_transform, gstladspautils.c:140-166)."""
        plugin = self.plugin
        desc = plugin.desc
        if not self.activated:
            self.activate()
        n_in = len(plugin.audio_in)
        n_out = len(plugin.audio_out)
        if n_in:
            audio_in = np.ascontiguousarray(audio_in, np.float32)
            if audio_in.ndim == 1:
                audio_in = audio_in[:, None]
            if audio_in.shape != (samples, n_in):
                raise LadspaError(
                    f"expected [{samples}, {n_in}] input")
            deinter = np.ascontiguousarray(audio_in.T)
        else:
            deinter = np.zeros((0, samples), np.float32)
        out = np.zeros((n_out, samples), np.float32)
        for i, port in enumerate(plugin.audio_in):
            desc.connect_port(self.handle, port,
                              deinter[i].ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_float)))
        for i, port in enumerate(plugin.audio_out):
            desc.connect_port(self.handle, port,
                              out[i].ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_float)))
        desc.run(self.handle, samples)
        return np.ascontiguousarray(out.T)

    def close(self) -> None:
        if self.handle:
            self.deactivate()
            if self.plugin.desc.cleanup:
                self.plugin.desc.cleanup(self.handle)
            self.handle = None


def scan_file(filename: str) -> List[LadspaPlugin]:
    """ladspa_describe_plugin (gstladspa.c:201-260): walk
    ladspa_descriptor(i); control-only plugins are skipped."""
    try:
        lib = ctypes.CDLL(filename)
    except OSError as e:
        raise LadspaError(f"cannot dlopen {filename}: {e}") from e
    try:
        fn = lib.ladspa_descriptor
    except AttributeError as e:
        raise LadspaError(
            f"{filename} has no ladspa_descriptor") from e
    fn.restype = ctypes.POINTER(_Descriptor)
    fn.argtypes = [ctypes.c_ulong]
    out = []
    i = 0
    while True:
        ptr = fn(i)
        if not ptr:
            break
        plugin = LadspaPlugin(lib, filename, i, ptr.contents)
        if plugin.audio_in or plugin.audio_out:
            out.append(plugin)
        i += 1
    return out


def scan(path: Optional[str] = None) -> List[LadspaPlugin]:
    """Scan a search path (defaults to $LADSPA_PATH, like the
    reference's gst_plugin_get_cache_data path walk)."""
    if path is None:
        path = os.environ.get("LADSPA_PATH", "")
    plugins: List[LadspaPlugin] = []
    for directory in path.split(os.pathsep):
        if not directory or not os.path.isdir(directory):
            continue
        for entry in sorted(os.listdir(directory)):
            if not entry.endswith(".so"):
                continue
            try:
                plugins += scan_file(os.path.join(directory, entry))
            except LadspaError:
                continue
    return plugins


# ------------------------------------------------- native test plugins

def build_test_plugins() -> str:
    """Compile csrc/ladspa_plugins.c (the in-repo LADSPA fixture
    library — this environment ships no system plugins) into a
    content-hash-named build directory and return that directory, fit
    for LADSPA_PATH.  The .so keeps a stable basename so element
    names stay stable."""
    directory = _native_build.build_dir("ladspa", ["ladspa_plugins.c"])
    _native_build.gcc_shared(os.path.join(directory, "libgstbadtest.so"),
                             "ladspa_plugins.c")
    return directory
