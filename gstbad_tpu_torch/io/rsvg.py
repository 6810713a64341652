"""(A copy of gstbad_tpu/io/rsvg.py, numpy only.)

librsvg + cairo ctypes binding (ext/rsvg/gstrsvgoverlay.c,
gstrsvgdec.c).

The reference plugin IS a thin wrapper around exactly these calls:
rsvg_handle_new_from_data -> rsvg_handle_get_dimensions ->
cairo_translate/cairo_scale -> rsvg_handle_render_cairo onto a
CAIRO_FORMAT_ARGB32 surface wrapping the BGRA video frame
(gstrsvgoverlay.c:361-431, gstrsvgdec.c:156-246).  This environment
ships librsvg-2.so.2 + libcairo.so.2, so the host boundary binds them
directly: SVG rasterization happens ONCE on the host (per property /
document change), and the per-frame OVER composite runs on device as
pixman's exact fixed-point formula (ops side) — unlike the reference,
which re-renders the SVG into every frame on the CPU.

ARGB32 on little-endian is premultiplied B,G,R,A in memory — the same
byte order as this framework's BGRA video plane, so surfaces map
directly onto frame arrays (the reference composites premultiplied
cairo output onto *straight*-alpha video the same way; quirk kept).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

CAIRO_FORMAT_ARGB32 = 0

_libs = None
_tried = False


class _GError(ctypes.Structure):
    _fields_ = [("domain", ctypes.c_uint32), ("code", ctypes.c_int),
                ("message", ctypes.c_char_p)]


class _RsvgDimensionData(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("em", ctypes.c_double), ("ex", ctypes.c_double)]


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        rsvg = ctypes.CDLL("librsvg-2.so.2")
        cairo = ctypes.CDLL("libcairo.so.2")
        gobject = ctypes.CDLL("libgobject-2.0.so.0")
    except OSError:
        return None

    rsvg.rsvg_handle_new_from_data.restype = ctypes.c_void_p
    rsvg.rsvg_handle_new_from_data.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(_GError))]
    rsvg.rsvg_handle_get_dimensions.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_RsvgDimensionData)]
    rsvg.rsvg_handle_render_cairo.restype = ctypes.c_int
    rsvg.rsvg_handle_render_cairo.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p]

    cairo.cairo_image_surface_create.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create.argtypes = [ctypes.c_int,
                                                 ctypes.c_int,
                                                 ctypes.c_int]
    cairo.cairo_image_surface_create_for_data.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create_for_data.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    cairo.cairo_create.restype = ctypes.c_void_p
    cairo.cairo_create.argtypes = [ctypes.c_void_p]
    cairo.cairo_translate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double]
    cairo.cairo_scale.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                  ctypes.c_double]
    cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(
        ctypes.c_ubyte)
    cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_stride.restype = ctypes.c_int
    cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
    cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_status.restype = ctypes.c_int
    cairo.cairo_surface_status.argtypes = [ctypes.c_void_p]

    gobject.g_object_unref.argtypes = [ctypes.c_void_p]

    _libs = (rsvg, cairo, gobject)
    return _libs


def available() -> bool:
    return _load() is not None


class Svg:
    """A parsed SVG document (rsvg_handle) + its natural dimensions."""

    def __init__(self, data: bytes):
        libs = _load()
        if libs is None:
            raise RuntimeError("librsvg/cairo not available")
        self._rsvg, self._cairo, self._gobject = libs
        err = ctypes.POINTER(_GError)()
        self._handle = self._rsvg.rsvg_handle_new_from_data(
            bytes(data), len(data), ctypes.byref(err))
        if not self._handle:
            msg = err.contents.message.decode() if err else "unknown"
            raise ValueError(f"rsvg: failed to parse SVG: {msg}")
        dim = _RsvgDimensionData()
        self._rsvg.rsvg_handle_get_dimensions(self._handle,
                                              ctypes.byref(dim))
        self.width = int(dim.width)
        self.height = int(dim.height)

    @classmethod
    def from_file(cls, path: str) -> "Svg":
        with open(path, "rb") as f:
            return cls(f.read())

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._gobject.g_object_unref(handle)
            self._handle = None

    def render(self, width: int, height: int, tx: float = 0.0,
               ty: float = 0.0, sx: float = 1.0, sy: float = 1.0,
               onto: Optional[np.ndarray] = None) -> np.ndarray:
        """Render through the reference's exact cairo walk
        (translate(tx,ty) -> scale(sx,sy) -> render_cairo) into an
        ARGB32 surface of (width, height).

        Returns [height, width, 4] uint8 in ARGB32 little-endian
        memory order (B,G,R,A premultiplied) — the same layout as the
        framework's BGRA video plane.  With `onto` (same-shape u8
        array), the surface starts as a copy of it and the composite
        is cairo's own — the byte-exact oracle for the device OVER."""
        cairo = self._cairo
        if onto is not None:
            buf = np.ascontiguousarray(onto, np.uint8).copy()
            assert buf.shape == (height, width, 4)
            surface = cairo.cairo_image_surface_create_for_data(
                buf.ctypes.data_as(ctypes.c_void_p),
                CAIRO_FORMAT_ARGB32, width, height, width * 4)
        else:
            buf = None
            surface = cairo.cairo_image_surface_create(
                CAIRO_FORMAT_ARGB32, width, height)
        if not surface or cairo.cairo_surface_status(surface):
            raise RuntimeError("rsvg: cairo surface creation failed")
        cr = cairo.cairo_create(surface)
        try:
            if tx or ty:
                cairo.cairo_translate(cr, float(tx), float(ty))
            if sx != 1.0 or sy != 1.0:
                cairo.cairo_scale(cr, float(sx), float(sy))
            self._rsvg.rsvg_handle_render_cairo(self._handle, cr)
            cairo.cairo_surface_flush(surface)
            if buf is not None:
                return buf
            data = cairo.cairo_image_surface_get_data(surface)
            stride = cairo.cairo_image_surface_get_stride(surface)
            raw = np.ctypeslib.as_array(
                data, shape=(height, stride))[:, :width * 4]
            return raw.reshape(height, width, 4).copy()
        finally:
            cairo.cairo_destroy(cr)
            cairo.cairo_surface_destroy(surface)


def looks_like_svg(data: bytes) -> bool:
    """The rsvgdec sniff: SVG documents carry an <svg root tag."""
    head = bytes(data[:1024]).lstrip()
    return head.startswith(b"<") and b"<svg" in bytes(data[:4096])


def composite_over_u8(frame: np.ndarray, overlay: np.ndarray
                      ) -> np.ndarray:
    """pixman's exact OVER on u8 premultiplied ARGB32 arrays —
    out = O + UN8_MUL(F, 255 - O_a), UN8_MUL(a,b) = (t=a*b+0x80;
    (t+(t>>8))>>8).  numpy mirror of the device composite for tests."""
    o = overlay.astype(np.int32)
    f = frame.astype(np.int32)
    ia = 255 - o[..., 3:4]
    t = f * ia + 0x80
    return (o + ((t + (t >> 8)) >> 8)).astype(np.uint8)
