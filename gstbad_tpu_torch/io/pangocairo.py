"""(A copy of gstbad_tpu/io/pangocairo.py, numpy only.)

pango + pangocairo ctypes binding (the text stack
ext/ttml/gstttmlrender.c renders through).

The reference keeps ONE PangoLayout created from the default cairo
font map's context (gstttmlrender.c:238-243,353-367) and drives it
with pango markup strings; this module exposes exactly that surface:
set_markup / set_width / get_pixel_extents / get_baseline /
index_to_pos / xy_to_index / pango_cairo_show_layout onto an ARGB32
cairo surface.  All rasterization is host-side setup work — the
per-frame compositing of the rendered overlays runs on device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

PANGO_SCALE = 1024

_libs = None
_tried = False


class Rect(ctypes.Structure):          # PangoRectangle
    _fields_ = [("x", ctypes.c_int), ("y", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int)]


def pango_pixels(u: int) -> int:
    """PANGO_PIXELS: round pango units to pixels."""
    return (u + PANGO_SCALE // 2) >> 10


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    try:
        pango = ctypes.CDLL("libpango-1.0.so.0")
        pangocairo = ctypes.CDLL("libpangocairo-1.0.so.0")
        cairo = ctypes.CDLL("libcairo.so.2")
        gobject = ctypes.CDLL("libgobject-2.0.so.0")
    except OSError:
        return None

    pangocairo.pango_cairo_font_map_get_default.restype = ctypes.c_void_p
    pangocairo.pango_cairo_show_layout.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]
    pango.pango_font_map_create_context.restype = ctypes.c_void_p
    pango.pango_font_map_create_context.argtypes = [ctypes.c_void_p]
    pango.pango_layout_new.restype = ctypes.c_void_p
    pango.pango_layout_new.argtypes = [ctypes.c_void_p]
    pango.pango_layout_set_markup.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p,
                                              ctypes.c_int]
    pango.pango_layout_set_width.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int]
    pango.pango_layout_get_pixel_extents.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(Rect), ctypes.POINTER(Rect)]
    pango.pango_layout_get_baseline.restype = ctypes.c_int
    pango.pango_layout_get_baseline.argtypes = [ctypes.c_void_p]
    pango.pango_layout_index_to_pos.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(Rect)]
    pango.pango_layout_xy_to_index.restype = ctypes.c_int
    pango.pango_layout_xy_to_index.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    pango.pango_layout_get_text.restype = ctypes.c_char_p
    pango.pango_layout_get_text.argtypes = [ctypes.c_void_p]

    pango.pango_layout_set_alignment.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
    pango.pango_font_description_from_string.restype = ctypes.c_void_p
    pango.pango_font_description_from_string.argtypes = [
        ctypes.c_char_p]
    pango.pango_font_description_free.argtypes = [ctypes.c_void_p]
    pango.pango_font_description_get_size.restype = ctypes.c_int
    pango.pango_font_description_get_size.argtypes = [ctypes.c_void_p]
    pango.pango_layout_set_font_description.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p]
    pangocairo.pango_cairo_layout_path.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_void_p]

    cairo.cairo_image_surface_create.restype = ctypes.c_void_p
    cairo.cairo_image_surface_create.argtypes = [ctypes.c_int,
                                                 ctypes.c_int,
                                                 ctypes.c_int]
    cairo.cairo_set_operator.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cairo.cairo_paint.argtypes = [ctypes.c_void_p]
    cairo.cairo_save.argtypes = [ctypes.c_void_p]
    cairo.cairo_restore.argtypes = [ctypes.c_void_p]
    cairo.cairo_set_source_rgba.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double]
    cairo.cairo_set_source_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double]
    cairo.cairo_set_line_width.argtypes = [ctypes.c_void_p,
                                           ctypes.c_double]
    cairo.cairo_stroke.argtypes = [ctypes.c_void_p]
    cairo.cairo_set_source_surface.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_double]
    cairo.cairo_translate.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double]
    cairo.cairo_create.restype = ctypes.c_void_p
    cairo.cairo_create.argtypes = [ctypes.c_void_p]
    cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
    cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(
        ctypes.c_ubyte)
    cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    cairo.cairo_image_surface_get_stride.restype = ctypes.c_int
    cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]

    gobject.g_object_unref.argtypes = [ctypes.c_void_p]

    _libs = (pango, pangocairo, cairo, gobject)
    return _libs


def available() -> bool:
    return _load() is not None


class Layout:
    """The reference's persistent PangoLayout
    (gstttmlrender.c:353-367)."""

    def __init__(self):
        libs = _load()
        if libs is None:
            raise RuntimeError("pango/pangocairo not available")
        self._pango, self._pangocairo, self._cairo, self._gobject = libs
        fontmap = self._pangocairo.pango_cairo_font_map_get_default()
        self._context = self._pango.pango_font_map_create_context(
            fontmap)
        self._layout = self._pango.pango_layout_new(self._context)

    def __del__(self):
        gobject = getattr(self, "_gobject", None)
        if gobject is None:
            return
        if getattr(self, "_layout", None):
            gobject.g_object_unref(self._layout)
            self._layout = None
        if getattr(self, "_context", None):
            gobject.g_object_unref(self._context)
            self._context = None

    def set_markup(self, markup: str) -> None:
        data = markup.encode()
        self._pango.pango_layout_set_markup(self._layout, data,
                                            len(data))

    def set_width(self, width_pango_units: int) -> None:
        self._pango.pango_layout_set_width(self._layout,
                                           int(width_pango_units))

    def pixel_extents(self) -> Tuple[Rect, Rect]:
        ink, logical = Rect(), Rect()
        self._pango.pango_layout_get_pixel_extents(
            self._layout, ctypes.byref(ink), ctypes.byref(logical))
        return ink, logical

    def baseline_pixels(self) -> int:
        return pango_pixels(
            self._pango.pango_layout_get_baseline(self._layout))

    def index_to_pos(self, index: int) -> Rect:
        r = Rect()
        self._pango.pango_layout_index_to_pos(self._layout, int(index),
                                              ctypes.byref(r))
        return r

    def xy_to_index(self, x: int, y: int) -> Tuple[bool, int, int]:
        """(inside, index, trailing) — x/y in pango units."""
        idx = ctypes.c_int()
        trailing = ctypes.c_int()
        inside = self._pango.pango_layout_xy_to_index(
            self._layout, int(x), int(y), ctypes.byref(idx),
            ctypes.byref(trailing))
        return bool(inside), idx.value, trailing.value

    def text(self) -> str:
        return self._pango.pango_layout_get_text(self._layout).decode()

    def show(self, width: int, height: int) -> np.ndarray:
        """pango_cairo_show_layout into a fresh transparent ARGB32
        surface -> [height, width, 4] u8 premultiplied B,G,R,A."""
        cairo = self._cairo
        width = max(int(width), 1)
        height = max(int(height), 1)
        surface = cairo.cairo_image_surface_create(0, width, height)
        cr = cairo.cairo_create(surface)
        try:
            self._pangocairo.pango_cairo_show_layout(cr, self._layout)
            cairo.cairo_surface_flush(surface)
            data = cairo.cairo_image_surface_get_data(surface)
            stride = cairo.cairo_image_surface_get_stride(surface)
            raw = np.ctypeslib.as_array(
                data, shape=(height, stride))[:, :width * 4]
            return raw.reshape(height, width, 4).copy()
        finally:
            cairo.cairo_destroy(cr)
            cairo.cairo_surface_destroy(surface)


    def set_alignment(self, align: int) -> None:
        """0 left, 1 center, 2 right (PangoAlignment)."""
        self._pango.pango_layout_set_alignment(self._layout, int(align))

    def set_font_description(self, desc: str) -> Optional[int]:
        """pango_font_description_from_string + set; returns the
        description's size in pango units (None on parse failure)."""
        d = self._pango.pango_font_description_from_string(
            desc.encode())
        if not d:
            return None
        try:
            size = self._pango.pango_font_description_get_size(d)
            self._pango.pango_layout_set_font_description(self._layout,
                                                          d)
            return int(size)
        finally:
            self._pango.pango_font_description_free(d)

    def render_cc_window(self, shadow_offset: float,
                         outline_offset: float) -> np.ndarray:
        """gst_cea708dec_render_pangocairo (gstcea708decoder.c:416-483)
        over the current layout: A8 shadow (translate by shadow_offset,
        50% black) + black layout-path outline stroke, white text on
        ARGB32, shadow composited DEST_OVER -> [h, w, 4] u8 premul
        B,G,R,A."""
        cairo = self._cairo
        ink, logical = self.pixel_extents()
        width = max(1, logical.width + int(shadow_offset))
        height = max(1, logical.height + logical.y + int(shadow_offset))

        surf_shadow = cairo.cairo_image_surface_create(2, width, height)
        shadow = cairo.cairo_create(surf_shadow)
        cairo.cairo_set_operator(shadow, 0)            # CLEAR
        cairo.cairo_paint(shadow)
        cairo.cairo_set_operator(shadow, 2)            # OVER
        cairo.cairo_save(shadow)
        cairo.cairo_set_source_rgba(shadow, 0.0, 0.0, 0.0, 0.5)
        cairo.cairo_translate(shadow, float(shadow_offset),
                              float(shadow_offset))
        self._pangocairo.pango_cairo_show_layout(shadow, self._layout)
        cairo.cairo_restore(shadow)
        cairo.cairo_save(shadow)
        cairo.cairo_set_source_rgb(shadow, 0.0, 0.0, 0.0)
        cairo.cairo_set_line_width(shadow, float(outline_offset))
        self._pangocairo.pango_cairo_layout_path(shadow, self._layout)
        cairo.cairo_stroke(shadow)
        cairo.cairo_restore(shadow)
        cairo.cairo_destroy(shadow)

        surf = cairo.cairo_image_surface_create(0, width, height)
        crt = cairo.cairo_create(surf)
        try:
            cairo.cairo_set_operator(crt, 0)           # CLEAR
            cairo.cairo_paint(crt)
            cairo.cairo_set_operator(crt, 2)           # OVER
            cairo.cairo_set_source_rgb(crt, 1.0, 1.0, 1.0)
            cairo.cairo_save(crt)
            self._pangocairo.pango_cairo_show_layout(crt, self._layout)
            cairo.cairo_restore(crt)
            cairo.cairo_set_operator(crt, 6)           # DEST_OVER
            cairo.cairo_set_source_surface(crt, surf_shadow, 0.0, 0.0)
            cairo.cairo_paint(crt)
            cairo.cairo_surface_flush(surf)
            data = cairo.cairo_image_surface_get_data(surf)
            stride = cairo.cairo_image_surface_get_stride(surf)
            raw = np.ctypeslib.as_array(
                data, shape=(height, stride))[:, :width * 4]
            return raw.reshape(height, width, 4).copy()
        finally:
            cairo.cairo_destroy(crt)
            cairo.cairo_surface_destroy(surf)
            cairo.cairo_surface_destroy(surf_shadow)


_shared: Optional[Layout] = None


def shared_layout() -> Layout:
    global _shared
    if _shared is None:
        _shared = Layout()
    return _shared
