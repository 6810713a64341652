"""libaom ctypes binding — the REAL AV1 codec library the
reference's ext/aom wraps (gstav1enc.c / gstav1dec.c).

ABI handling: aom_codec_enc_init_ver / dec_init_ver versions are
probed (init fails cleanly with AOM_CODEC_ABI_MISMATCH on a wrong
guess); the aom_codec_enc_cfg prefix layout is verified against
aom_codec_enc_config_default's documented defaults (g_w=320,
g_h=240, g_bit_depth=8) and aom_image offsets against aom_img_alloc's
own plane geometry — a layout mismatch raises instead of corrupting.

Control ids used (aomcx.h, stable libvpx-heritage numbering):
AOME_SET_CPUUSED=13 (the reference's cpu-used property,
gstav1enc.c); every aom_codec_control return code is checked so a
wrong id fails loudly.

A copy of the JAX package's io/av1.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, Structure, byref, c_char_p, c_int,
                    c_int64, c_size_t, c_uint, c_ulong, c_void_p)
from typing import List, Optional

import numpy as np

AOM_IMG_FMT_I420 = 0x102
AOM_USAGE_GOOD_QUALITY = 0
AOM_USAGE_REALTIME = 1
AOME_SET_CPUUSED = 13

# aom_rational
class _Rational(Structure):
    _fields_ = [("num", c_int), ("den", c_int)]


class _FixedBuf(Structure):
    _fields_ = [("buf", c_void_p), ("sz", c_size_t)]


class _EncCfgPrefix(Structure):
    # aom_encoder.h aom_codec_enc_cfg leading fields (3.x)
    _fields_ = [("g_usage", c_uint), ("g_threads", c_uint),
                ("g_profile", c_uint), ("g_w", c_uint),
                ("g_h", c_uint), ("g_limit", c_uint),
                ("g_forced_max_frame_width", c_uint),
                ("g_forced_max_frame_height", c_uint),
                ("g_bit_depth", c_int), ("g_input_bit_depth", c_uint),
                ("g_timebase", _Rational),
                ("g_error_resilient", c_uint), ("g_pass", c_int),
                ("g_lag_in_frames", c_uint),
                ("rc_dropframe_thresh", c_uint),
                ("rc_resize_mode", c_uint),
                ("rc_resize_denominator", c_uint),
                ("rc_resize_kf_denominator", c_uint),
                ("rc_superres_mode", c_int),
                ("rc_superres_denominator", c_uint),
                ("rc_superres_kf_denominator", c_uint),
                ("rc_superres_qthresh", c_int),
                ("rc_superres_kf_qthresh", c_int),
                ("rc_end_usage", c_int),
                ("rc_twopass_stats_in", _FixedBuf),
                ("rc_firstpass_mb_stats_in", _FixedBuf),
                ("rc_target_bitrate", c_uint),
                ("rc_min_quantizer", c_uint),
                ("rc_max_quantizer", c_uint),
                ("rc_undershoot_pct", c_uint),
                ("rc_overshoot_pct", c_uint),
                ("rc_buf_sz", c_uint),
                ("rc_buf_initial_sz", c_uint),
                ("rc_buf_optimal_sz", c_uint),
                ("rc_2pass_vbr_bias_pct", c_uint),
                ("rc_2pass_vbr_minsection_pct", c_uint),
                ("rc_2pass_vbr_maxsection_pct", c_uint),
                ("fwd_kf_enabled", c_int),
                ("kf_mode", c_int),
                ("kf_min_dist", c_uint),
                ("kf_max_dist", c_uint),
                ("sframe_dist", c_uint),
                ("sframe_mode", c_uint),
                ("large_scale_tile", c_uint),
                ("monochrome", c_uint),
                ("full_still_picture_hdr", c_uint),
                ("save_as_annexb", c_uint),
                ("tile_width_count", c_int),
                ("tile_height_count", c_int),
                ("tile_widths", c_int * 64),
                ("tile_heights", c_int * 64)]


class _ImagePrefix(Structure):
    # aom_image.h aom_image leading fields (3.x)
    _fields_ = [("fmt", c_int), ("cp", c_int), ("tc", c_int),
                ("mc", c_int), ("monochrome", c_int), ("csp", c_int),
                ("range", c_int), ("w", c_uint), ("h", c_uint),
                ("bit_depth", c_uint), ("d_w", c_uint),
                ("d_h", c_uint), ("r_w", c_uint), ("r_h", c_uint),
                ("x_chroma_shift", c_uint), ("y_chroma_shift", c_uint),
                ("planes", POINTER(ctypes.c_uint8) * 3),
                ("stride", c_int * 3), ("bps", c_int)]


class _CxPktPrefix(Structure):
    _fields_ = [("kind", c_int), ("buf", c_void_p),
                ("sz", c_size_t), ("pts", c_int64),
                ("duration", c_ulong), ("flags", c_uint),
                ("partition_id", c_int)]


_CFG_BYTES = 16384
_CTX_BYTES = 256

_lib = None
_tried = False
_enc_abi: Optional[int] = None
_dec_abi: Optional[int] = None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libaom.so.3")
    except OSError:
        return None
    lib.aom_codec_av1_cx.restype = c_void_p
    lib.aom_codec_av1_dx.restype = c_void_p
    lib.aom_codec_enc_config_default.argtypes = [c_void_p, c_void_p,
                                                 c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [c_void_p, c_void_p,
                                           c_void_p, c_int64, c_int]
    lib.aom_codec_dec_init_ver.argtypes = [c_void_p, c_void_p,
                                           c_void_p, c_int64, c_int]
    lib.aom_codec_destroy.argtypes = [c_void_p]
    lib.aom_codec_encode.argtypes = [c_void_p, c_void_p, c_int64,
                                     c_ulong, c_int64]
    lib.aom_codec_get_cx_data.restype = POINTER(_CxPktPrefix)
    lib.aom_codec_get_cx_data.argtypes = [c_void_p,
                                          POINTER(c_void_p)]
    lib.aom_codec_decode.argtypes = [c_void_p, c_char_p, c_size_t,
                                     c_void_p]
    lib.aom_codec_get_frame.restype = POINTER(_ImagePrefix)
    lib.aom_codec_get_frame.argtypes = [c_void_p, POINTER(c_void_p)]
    lib.aom_img_alloc.restype = POINTER(_ImagePrefix)
    lib.aom_img_alloc.argtypes = [c_void_p, c_int, c_uint, c_uint,
                                  c_uint]
    lib.aom_img_free.argtypes = [POINTER(_ImagePrefix)]
    lib.aom_codec_error.restype = c_char_p
    lib.aom_codec_error.argtypes = [c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _probe_enc_abi(lib) -> int:
    global _enc_abi
    if _enc_abi is not None:
        return _enc_abi
    iface = lib.aom_codec_av1_cx()
    cfg = ctypes.create_string_buffer(_CFG_BYTES)
    if lib.aom_codec_enc_config_default(iface, cfg, 0) != 0:
        raise RuntimeError("aom enc_config_default failed")
    for ver in range(8, 48):
        ctx = ctypes.create_string_buffer(_CTX_BYTES)
        if lib.aom_codec_enc_init_ver(ctx, iface, cfg, 0, ver) == 0:
            lib.aom_codec_destroy(ctx)
            _enc_abi = ver
            return ver
    raise RuntimeError("aom encoder ABI probe failed")


def _probe_dec_abi(lib) -> int:
    global _dec_abi
    if _dec_abi is not None:
        return _dec_abi
    iface = lib.aom_codec_av1_dx()
    for ver in range(6, 48):
        ctx = ctypes.create_string_buffer(_CTX_BYTES)
        if lib.aom_codec_dec_init_ver(ctx, iface, None, 0, ver) == 0:
            lib.aom_codec_destroy(ctx)
            _dec_abi = ver
            return ver
    raise RuntimeError("aom decoder ABI probe failed")


class AV1Encoder:
    """Per-frame OBU (temporal-unit) encoder, gstav1enc.c shape."""

    def __init__(self, width: int, height: int,
                 target_bitrate_kbps: int = 256, cpu_used: int = 8,
                 usage: int = AOM_USAGE_REALTIME,
                 timebase=(1, 30), threads: int = 1,
                 lag_in_frames: int = 0, cfg_fields: dict = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("libaom not available")
        self._lib = lib
        ver = _probe_enc_abi(lib)
        iface = lib.aom_codec_av1_cx()
        self._cfg_buf = ctypes.create_string_buffer(_CFG_BYTES)
        if lib.aom_codec_enc_config_default(iface, self._cfg_buf,
                                            usage) != 0:
            raise RuntimeError("aom enc_config_default failed")
        cfg = ctypes.cast(self._cfg_buf,
                          POINTER(_EncCfgPrefix)).contents
        # layout sanity: config_default's documented defaults at the
        # start AND the far end of the transcribed prefix
        if (cfg.g_w, cfg.g_h) != (320, 240) or cfg.g_bit_depth != 8 \
                or cfg.rc_max_quantizer != 63 \
                or cfg.kf_max_dist != 9999 \
                or cfg.sframe_dist != 0 \
                or cfg.sframe_mode not in (1, 2) \
                or cfg.tile_width_count != 0 \
                or cfg.tile_height_count != 0:
            # The tail checks (sframe_*/tile_*_count) guard the ten fields
            # appended after kf_max_dist: an aom ABI that inserts or
            # reorders fields there would otherwise silently write
            # tile_widths/heights at wrong offsets.
            raise RuntimeError("aom_codec_enc_cfg layout mismatch")
        cfg.g_w = width
        cfg.g_h = height
        cfg.g_threads = threads
        cfg.g_timebase.num, cfg.g_timebase.den = timebase
        cfg.g_lag_in_frames = lag_in_frames
        cfg.rc_target_bitrate = target_bitrate_kbps
        for name, value in (cfg_fields or {}).items():
            if not hasattr(cfg, name):
                raise ValueError(f"aom cfg field {name!r} unknown")
            setattr(cfg, name, value)
        self._ctx = ctypes.create_string_buffer(_CTX_BYTES)
        if lib.aom_codec_enc_init_ver(self._ctx, iface, self._cfg_buf,
                                      0, ver) != 0:
            raise RuntimeError("aom enc init failed")
        if lib.aom_codec_control(self._ctx, AOME_SET_CPUUSED,
                                 cpu_used) != 0:
            raise RuntimeError("aom control CPUUSED rejected "
                               "(id mismatch?)")
        self._img = lib.aom_img_alloc(None, AOM_IMG_FMT_I420, width,
                                      height, 16)
        if not self._img:
            raise RuntimeError("aom_img_alloc failed")
        im = self._img.contents
        # image layout sanity against the allocator's own geometry
        if im.d_w != width or im.d_h != height \
                or im.stride[0] < width:
            raise RuntimeError("aom_image layout mismatch")
        self._w, self._h = width, height
        self._pts = 0

    def _drain(self) -> bytes:
        out = b""
        it = c_void_p(None)
        while True:
            pkt = self._lib.aom_codec_get_cx_data(self._ctx,
                                                  byref(it))
            if not pkt:
                break
            p = pkt.contents
            if p.kind == 0:            # AOM_CODEC_CX_FRAME_PKT
                out += ctypes.string_at(p.buf, p.sz)
        return out

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
               ) -> bytes:
        im = self._img.contents
        for ch, plane in enumerate((y, u, v)):
            plane = np.ascontiguousarray(plane, np.uint8)
            h, w = plane.shape
            stride = im.stride[ch]
            dst = np.ctypeslib.as_array(im.planes[ch],
                                        shape=(h * stride,))
            dst.reshape(h, stride)[:, :w] = plane
        if self._lib.aom_codec_encode(self._ctx, self._img,
                                      self._pts, 1, 0) != 0:
            raise RuntimeError("aom_codec_encode failed")
        self._pts += 1
        return self._drain()

    def flush(self) -> List[bytes]:
        out = []
        for _ in range(64):
            if self._lib.aom_codec_encode(self._ctx, None, self._pts,
                                          1, 0) != 0:
                break
            data = self._drain()
            if not data:
                break
            out.append(data)
        return out

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_img", None):
            lib.aom_img_free(self._img)
            self._img = None
        if getattr(self, "_ctx", None):
            lib.aom_codec_destroy(self._ctx)
            self._ctx = None


class AV1Decoder:
    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libaom not available")
        self._lib = lib
        ver = _probe_dec_abi(lib)
        iface = lib.aom_codec_av1_dx()
        self._ctx = ctypes.create_string_buffer(_CTX_BYTES)
        if lib.aom_codec_dec_init_ver(self._ctx, iface, None, 0,
                                      ver) != 0:
            raise RuntimeError("aom dec init failed")

    def decode(self, data: bytes) -> List[dict]:
        """One temporal unit in -> zero or more I420 frames out."""
        if self._lib.aom_codec_decode(self._ctx, data, len(data),
                                      None) != 0:
            err = self._lib.aom_codec_error(self._ctx)
            raise RuntimeError(f"aom_codec_decode: "
                               f"{err.decode() if err else '?'}")
        out = []
        it = c_void_p(None)
        while True:
            img = self._lib.aom_codec_get_frame(self._ctx, byref(it))
            if not img:
                break
            im = img.contents
            planes = {}
            for ch, name in ((0, "y"), (1, "u"), (2, "v")):
                w = im.d_w if ch == 0 \
                    else (im.d_w + (1 << im.x_chroma_shift) - 1) \
                    >> im.x_chroma_shift
                h = im.d_h if ch == 0 \
                    else (im.d_h + (1 << im.y_chroma_shift) - 1) \
                    >> im.y_chroma_shift
                stride = im.stride[ch]
                flat = np.ctypeslib.as_array(im.planes[ch],
                                             shape=(h * stride,))
                planes[name] = flat.reshape(h, stride)[:, :w].copy()
            out.append(planes)
        return out

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx is not None and getattr(self, "_lib", None):
            self._lib.aom_codec_destroy(ctx)
            self._ctx = None
