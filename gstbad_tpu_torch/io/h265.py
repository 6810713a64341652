"""libx265 (encode) + libde265 (decode) ctypes bindings — the REAL
libraries the reference's ext/x265 (gstx265enc.c) and ext/libde265
(libde265-dec.c) wrap.

x265: the ABI-stable plain-C surface — x265_param_alloc +
x265_param_default_preset(preset, tune) + x265_param_parse for every
setting (the same option strings gstx265enc.c builds), encoder_open
(build-suffixed symbol, probed), per-frame x265_picture with I420
plane pointers.  Only the documented fixed-offset prefix of
x265_picture is poked; the struct itself is allocated by
x265_picture_alloc so trailing fields stay library-owned.

de265: push annex-B bytes, de265_decode until images drain,
I420 planes copied out (libde265-dec.c caps: I420 only).

A copy of the JAX package's io/h265.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, Structure, byref, c_char_p, c_int,
                    c_int64, c_uint8, c_uint32, c_void_p)
from typing import List, Optional, Tuple

import numpy as np


class _Nal(Structure):
    _fields_ = [("type", c_uint32), ("sizeBytes", c_uint32),
                ("payload", POINTER(c_uint8))]


class _PicturePrefix(Structure):
    # x265.h x265_picture leading fields (stable across 2.x/3.x)
    _fields_ = [("pts", c_int64), ("dts", c_int64),
                ("userData", c_void_p), ("planes", c_void_p * 3),
                ("stride", c_int * 3), ("bitDepth", c_int),
                ("sliceType", c_int), ("poc", c_int),
                ("colorSpace", c_int), ("forceqp", c_int)]


_x265 = None
_x265_open = None
_de265 = None
_tried = False


def _load():
    global _x265, _x265_open, _de265, _tried
    if _tried:
        return _x265, _de265
    _tried = True
    try:
        x = ctypes.CDLL("libx265.so.199")
        d = ctypes.CDLL("libde265.so.0")
    except OSError:
        return None, None
    # encoder_open is build-suffixed; probe the known builds
    opener = None
    for build in (199, 209, 215, 212, 207, 205, 200, 198, 192):
        opener = getattr(x, f"x265_encoder_open_{build}", None)
        if opener is not None:
            break
    if opener is None:
        return None, None
    x.x265_param_alloc.restype = c_void_p
    x.x265_param_free.argtypes = [c_void_p]
    x.x265_param_default_preset.argtypes = [c_void_p, c_char_p,
                                            c_char_p]
    x.x265_param_parse.argtypes = [c_void_p, c_char_p, c_char_p]
    x.x265_param_apply_profile.argtypes = [c_void_p, c_char_p]
    opener.restype = c_void_p
    opener.argtypes = [c_void_p]
    x.x265_picture_alloc.restype = POINTER(_PicturePrefix)
    x.x265_picture_init.argtypes = [c_void_p,
                                    POINTER(_PicturePrefix)]
    x.x265_picture_free.argtypes = [POINTER(_PicturePrefix)]
    x.x265_encoder_encode.restype = c_int
    x.x265_encoder_encode.argtypes = [
        c_void_p, POINTER(POINTER(_Nal)), POINTER(c_uint32),
        POINTER(_PicturePrefix), POINTER(_PicturePrefix)]
    x.x265_encoder_close.argtypes = [c_void_p]
    d.de265_new_decoder.restype = c_void_p
    d.de265_free_decoder.argtypes = [c_void_p]
    d.de265_push_data.argtypes = [c_void_p, c_void_p, c_int, c_int64,
                                  c_void_p]
    d.de265_flush_data.argtypes = [c_void_p]
    d.de265_decode.argtypes = [c_void_p, POINTER(c_int)]
    d.de265_get_next_picture.restype = c_void_p
    d.de265_get_next_picture.argtypes = [c_void_p]
    d.de265_release_next_picture.argtypes = [c_void_p]
    d.de265_get_image_width.argtypes = [c_void_p, c_int]
    d.de265_get_image_height.argtypes = [c_void_p, c_int]
    d.de265_get_image_plane.restype = POINTER(c_uint8)
    d.de265_get_image_plane.argtypes = [c_void_p, c_int,
                                        POINTER(c_int)]
    _x265, _de265 = x, d
    globals()["_x265_open"] = opener
    return _x265, _de265


def available() -> bool:
    x, d = _load()
    return x is not None and d is not None


class H265Encoder:
    """x265 encoder following gstx265enc.c's param walk."""

    def __init__(self, width: int, height: int, fps: str = "30/1",
                 speed_preset: str = "medium", tune: str = "ssim",
                 bitrate_kbps: int = 2048, qp: int = -1,
                 key_int_max: int = 0, option_string: str = "",
                 lossless: bool = False, log_level: str = "none"):
        x, _d = _load()
        if x is None:
            raise RuntimeError("libx265/libde265 not available")
        self._x = x
        self._param = x.x265_param_alloc()
        tune_b = tune.encode() if tune else None
        if x.x265_param_default_preset(self._param,
                                       speed_preset.encode(),
                                       tune_b) != 0:
            raise ValueError("x265: bad speed-preset/tune")

        def parse(name, value):
            if x.x265_param_parse(self._param, name.encode(),
                                  value.encode()) != 0:
                raise ValueError(f"x265_param_parse {name}={value}")

        parse("input-res", f"{width}x{height}")
        parse("fps", fps)
        parse("input-csp", "i420")
        parse("annexb", "1")
        parse("repeat-headers", "1")   # in-band VPS/SPS/PPS
        parse("log-level", log_level)  # PROP_LOG_LEVEL_DEFAULT none
        if lossless:
            parse("lossless", "1")
        elif qp >= 0:
            parse("qp", str(qp))       # qp wins over bitrate
        else:
            parse("bitrate", str(bitrate_kbps))
        if key_int_max > 0:
            parse("keyint", str(key_int_max))
        for opt in option_string.split(":"):
            if not opt:
                continue
            k, _, v = opt.partition("=")
            parse(k, v if v else "1")
        self._enc = _x265_open(self._param)
        if not self._enc:
            raise RuntimeError("x265_encoder_open failed")
        self._pic = x.x265_picture_alloc()
        x.x265_picture_init(self._param, self._pic)
        self._w, self._h = width, height

    def _collect(self, nals, count) -> bytes:
        out = b""
        for i in range(count):
            n = nals[i]
            out += ctypes.string_at(n.payload, n.sizeBytes)
        return out

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
               pts: int = 0) -> bytes:
        """One I420 frame -> annex-B bytes (may be empty while the
        encoder builds its lookahead)."""
        y = np.ascontiguousarray(y, np.uint8)
        u = np.ascontiguousarray(u, np.uint8)
        v = np.ascontiguousarray(v, np.uint8)
        pic = self._pic.contents
        pic.pts = pts
        pic.bitDepth = 8
        pic.colorSpace = 1             # X265_CSP_I420
        pic.planes[0] = y.ctypes.data_as(c_void_p)
        pic.planes[1] = u.ctypes.data_as(c_void_p)
        pic.planes[2] = v.ctypes.data_as(c_void_p)
        pic.stride[0] = y.shape[1]
        pic.stride[1] = u.shape[1]
        pic.stride[2] = v.shape[1]
        nals = POINTER(_Nal)()
        num = c_uint32(0)
        ret = self._x.x265_encoder_encode(self._enc, byref(nals),
                                          byref(num), self._pic, None)
        if ret < 0:
            raise RuntimeError("x265_encoder_encode failed")
        return self._collect(nals, num.value) if ret > 0 else b""

    def flush(self) -> List[bytes]:
        """Drain the lookahead at EOS."""
        out = []
        while True:
            nals = POINTER(_Nal)()
            num = c_uint32(0)
            ret = self._x.x265_encoder_encode(
                self._enc, byref(nals), byref(num), None, None)
            if ret <= 0:
                break
            out.append(self._collect(nals, num.value))
        return out

    def __del__(self):
        x = getattr(self, "_x", None)
        if x is None:
            return
        if getattr(self, "_pic", None):
            x.x265_picture_free(self._pic)
            self._pic = None
        if getattr(self, "_enc", None):
            x.x265_encoder_close(self._enc)
            self._enc = None
        if getattr(self, "_param", None):
            x.x265_param_free(self._param)
            self._param = None


class H265Decoder:
    """libde265 annex-B decoder -> I420 plane dicts."""

    def __init__(self):
        _x, d = _load()
        if d is None:
            raise RuntimeError("libde265 not available")
        self._d = d
        self._ctx = d.de265_new_decoder()
        if not self._ctx:
            raise RuntimeError("de265_new_decoder failed")

    def push(self, data: bytes, pts: int = 0) -> None:
        if self._d.de265_push_data(self._ctx, data, len(data), pts,
                                   None) != 0:
            raise RuntimeError("de265_push_data failed")

    def flush(self) -> None:
        self._d.de265_flush_data(self._ctx)

    def _grab(self) -> Optional[dict]:
        img = self._d.de265_get_next_picture(self._ctx)
        if not img:
            return None
        planes = {}
        for ch, name in ((0, "y"), (1, "u"), (2, "v")):
            w = self._d.de265_get_image_width(img, ch)
            h = self._d.de265_get_image_height(img, ch)
            stride = c_int(0)
            p = self._d.de265_get_image_plane(img, ch, byref(stride))
            flat = np.ctypeslib.as_array(p, shape=(h * stride.value,))
            planes[name] = flat.reshape(h, stride.value)[:, :w].copy()
        self._d.de265_release_next_picture(self._ctx)
        return planes

    def decode(self) -> List[dict]:
        """Run the decoder until it stalls; -> list of I420 frames
        ({'y','u','v'} uint8 planes) in output order."""
        out = []
        while True:
            img = self._grab()
            if img is not None:
                out.append(img)
                continue
            more = c_int(1)
            err = self._d.de265_decode(self._ctx, byref(more))
            img = self._grab()
            if img is not None:
                out.append(img)
            if not more.value:
                break
            if err != 0 and err != 1020:   # DE265_ERROR_WAITING_FOR_INPUT_DATA
                if img is None:
                    break
        return out

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._d.de265_free_decoder(ctx)
            self._ctx = None
