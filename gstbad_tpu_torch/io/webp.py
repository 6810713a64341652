"""libwebp ctypes binding — the REAL library the reference's
ext/webp wraps (gstwebpdec.c / gstwebpenc.c).

The binding follows the reference's exact call sequences:

- encode: WebPConfigPreset(preset, quality) + config.lossless +
  config.method = speed + WebPValidateConfig, WebPPictureInit with
  use_argb for RGB inputs (WebPPictureImportRGB/RGBA,
  gstwebpenc.c:277-291) or WEBP_YUV420 plane pointers for I420/YV12
  (gstwebpenc.c:269-276), WebPMemoryWriter output
  (gstwebpenc.c:238-241, 293-306).
- decode: WebPInitDecoderConfig + WebPGetFeatures, output colorspace
  MODE_ARGB when the bitstream has alpha else MODE_RGB
  (gstwebpdec.c:389-396), decoder options bypass_filtering /
  no_fancy_upsampling / use_threads (gstwebpdec.c:463-467).

Struct layouts are the public webp/decode.h + webp/encode.h ABI; the
ABI version passed to the *Internal entry points is probed at load
time from a candidate list (no dev headers in this environment — the
Init call fails cleanly on a mismatch, so probing is safe).

A copy of the JAX package's io/webp.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, Structure, Union, byref, c_float, c_int,
                    c_size_t, c_uint8, c_uint32, c_void_p)
from typing import Optional, Tuple

import numpy as np

# WebPCSPMode
MODE_RGB, MODE_RGBA, MODE_BGR, MODE_BGRA, MODE_ARGB = 0, 1, 2, 3, 4

# WebPPreset (gstwebpenc.c DEFAULT_PRESET = WEBP_PRESET_PHOTO)
PRESET_DEFAULT, PRESET_PICTURE, PRESET_PHOTO = 0, 1, 2
PRESET_DRAWING, PRESET_ICON, PRESET_TEXT = 3, 4, 5
PRESETS = {"default": 0, "picture": 1, "photo": 2,
           "drawing": 3, "icon": 4, "text": 5}

_DEC_ABIS = (0x0209, 0x0208, 0x0107)
_ENC_ABIS = (0x020F, 0x020E, 0x0209, 0x0202)


class BitstreamFeatures(Structure):
    _fields_ = [("width", c_int), ("height", c_int),
                ("has_alpha", c_int), ("has_animation", c_int),
                ("format", c_int), ("pad", c_uint32 * 5)]


class _RGBABuffer(Structure):
    _fields_ = [("rgba", POINTER(c_uint8)), ("stride", c_int),
                ("size", c_size_t)]


class _YUVABuffer(Structure):
    _fields_ = [("y", POINTER(c_uint8)), ("u", POINTER(c_uint8)),
                ("v", POINTER(c_uint8)), ("a", POINTER(c_uint8)),
                ("y_stride", c_int), ("u_stride", c_int),
                ("v_stride", c_int), ("a_stride", c_int),
                ("y_size", c_size_t), ("u_size", c_size_t),
                ("v_size", c_size_t), ("a_size", c_size_t)]


class _BufUnion(Union):
    _fields_ = [("RGBA", _RGBABuffer), ("YUVA", _YUVABuffer)]


class DecBuffer(Structure):
    _fields_ = [("colorspace", c_int), ("width", c_int),
                ("height", c_int), ("is_external_memory", c_int),
                ("u", _BufUnion), ("pad", c_uint32 * 4),
                ("private_memory", POINTER(c_uint8))]


class DecoderOptions(Structure):
    _fields_ = [("bypass_filtering", c_int),
                ("no_fancy_upsampling", c_int),
                ("use_cropping", c_int), ("crop_left", c_int),
                ("crop_top", c_int), ("crop_width", c_int),
                ("crop_height", c_int), ("use_scaling", c_int),
                ("scaled_width", c_int), ("scaled_height", c_int),
                ("use_threads", c_int), ("dithering_strength", c_int),
                ("flip", c_int), ("alpha_dithering_strength", c_int),
                ("pad", c_uint32 * 5)]


class DecoderConfig(Structure):
    _fields_ = [("input", BitstreamFeatures), ("output", DecBuffer),
                ("options", DecoderOptions)]


class Config(Structure):
    # webp/encode.h WebPConfig (1.2 layout) + a safety pad so an
    # unexpectedly larger library struct cannot overflow
    _fields_ = [("lossless", c_int), ("quality", c_float),
                ("method", c_int), ("image_hint", c_int),
                ("target_size", c_int), ("target_PSNR", c_float),
                ("segments", c_int), ("sns_strength", c_int),
                ("filter_strength", c_int), ("filter_sharpness", c_int),
                ("filter_type", c_int), ("autofilter", c_int),
                ("alpha_compression", c_int), ("alpha_filtering", c_int),
                ("alpha_quality", c_int), ("pass_", c_int),
                ("show_compressed", c_int), ("preprocessing", c_int),
                ("partitions", c_int), ("partition_limit", c_int),
                ("emulate_jpeg_size", c_int), ("thread_level", c_int),
                ("low_memory", c_int), ("near_lossless", c_int),
                ("exact", c_int), ("use_delta_palette", c_int),
                ("use_sharp_yuv", c_int), ("qmin", c_int),
                ("qmax", c_int), ("safety_pad", c_int * 16)]


class Picture(Structure):
    _fields_ = [("use_argb", c_int), ("colorspace", c_int),
                ("width", c_int), ("height", c_int),
                ("y", POINTER(c_uint8)), ("u", POINTER(c_uint8)),
                ("v", POINTER(c_uint8)), ("y_stride", c_int),
                ("uv_stride", c_int), ("a", POINTER(c_uint8)),
                ("a_stride", c_int), ("pad1", c_uint32 * 2),
                ("argb", POINTER(c_uint32)), ("argb_stride", c_int),
                ("pad2", c_uint32 * 3),
                ("writer", c_void_p), ("custom_ptr", c_void_p),
                ("extra_info_type", c_int),
                ("extra_info", POINTER(c_uint8)),
                ("stats", c_void_p), ("error_code", c_int),
                ("progress_hook", c_void_p), ("user_data", c_void_p),
                ("pad3", c_uint32 * 3), ("pad4", POINTER(c_uint8)),
                ("pad5", POINTER(c_uint8)), ("pad6", c_uint32 * 8),
                ("memory_", c_void_p), ("memory_argb_", c_void_p),
                ("pad7", c_void_p * 2)]


class MemoryWriter(Structure):
    _fields_ = [("mem", POINTER(c_uint8)), ("size", c_size_t),
                ("max_size", c_size_t), ("pad", c_uint32 * 1)]


_lib = None
_tried = False
_dec_abi: Optional[int] = None
_enc_abi: Optional[int] = None


def _load():
    global _lib, _tried, _dec_abi, _enc_abi
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL("libwebp.so.7")
    except OSError:
        return None
    lib.WebPInitDecoderConfigInternal.argtypes = [
        POINTER(DecoderConfig), c_int]
    lib.WebPGetFeaturesInternal.argtypes = [
        ctypes.c_char_p, c_size_t, POINTER(BitstreamFeatures), c_int]
    lib.WebPDecode.argtypes = [ctypes.c_char_p, c_size_t,
                               POINTER(DecoderConfig)]
    lib.WebPFreeDecBuffer.argtypes = [POINTER(DecBuffer)]
    lib.WebPConfigInitInternal.argtypes = [POINTER(Config), c_int,
                                           c_float, c_int]
    lib.WebPValidateConfig.argtypes = [POINTER(Config)]
    lib.WebPPictureInitInternal.argtypes = [POINTER(Picture), c_int]
    lib.WebPPictureImportRGB.argtypes = [POINTER(Picture),
                                         ctypes.c_char_p, c_int]
    lib.WebPPictureImportRGBA.argtypes = [POINTER(Picture),
                                          ctypes.c_char_p, c_int]
    lib.WebPMemoryWriterInit.argtypes = [POINTER(MemoryWriter)]
    lib.WebPMemoryWriterClear.argtypes = [POINTER(MemoryWriter)]
    lib.WebPEncode.argtypes = [POINTER(Config), POINTER(Picture)]
    lib.WebPPictureFree.argtypes = [POINTER(Picture)]
    # probe the ABI versions this build accepts
    for abi in _DEC_ABIS:
        cfg = DecoderConfig()
        if lib.WebPInitDecoderConfigInternal(byref(cfg), abi):
            _dec_abi = abi
            break
    for abi in _ENC_ABIS:
        cfg = Config()
        if lib.WebPConfigInitInternal(byref(cfg), PRESET_DEFAULT,
                                      c_float(75.0), abi):
            _enc_abi = abi
            break
    if _dec_abi is None or _enc_abi is None:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def features(data: bytes) -> Optional[Tuple[int, int, bool]]:
    """-> (width, height, has_alpha), or None if not a WebP stream."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libwebp not available")
    f = BitstreamFeatures()
    if lib.WebPGetFeaturesInternal(data, len(data), byref(f),
                                   _dec_abi) != 0:
        return None
    return f.width, f.height, bool(f.has_alpha)


def decode(data: bytes, mode: int = MODE_ARGB,
           bypass_filtering: bool = False,
           no_fancy_upsampling: bool = False,
           use_threads: bool = False) -> np.ndarray:
    """WebP bitstream -> [H, W, C] u8 (C = 4 for ARGB/RGBA modes, 3
    for RGB/BGR), via the advanced decoder API so the reference's
    option properties take real effect."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libwebp not available")
    cfg = DecoderConfig()
    if not lib.WebPInitDecoderConfigInternal(byref(cfg), _dec_abi):
        raise RuntimeError("WebPInitDecoderConfig failed")
    if lib.WebPGetFeaturesInternal(data, len(data), byref(cfg.input),
                                   _dec_abi) != 0:
        raise ValueError("not a WebP bitstream")
    cfg.options.bypass_filtering = int(bypass_filtering)
    cfg.options.no_fancy_upsampling = int(no_fancy_upsampling)
    cfg.options.use_threads = int(use_threads)
    cfg.output.colorspace = mode
    status = lib.WebPDecode(data, len(data), byref(cfg))
    if status != 0:
        raise RuntimeError(f"WebPDecode failed (VP8 status {status})")
    try:
        ch = 4 if mode in (MODE_RGBA, MODE_BGRA, MODE_ARGB) else 3
        h, w = cfg.output.height, cfg.output.width
        stride = cfg.output.u.RGBA.stride
        size = cfg.output.u.RGBA.size
        flat = np.ctypeslib.as_array(cfg.output.u.RGBA.rgba,
                                     shape=(size,))
        rows = flat.reshape(h, stride)[:, :w * ch]
        return rows.reshape(h, w, ch).copy()
    finally:
        lib.WebPFreeDecBuffer(byref(cfg.output))


def encode(img: np.ndarray, quality: float = 90.0, speed: int = 4,
           preset: int = PRESET_PHOTO, lossless: bool = False,
           yuv: Optional[tuple] = None) -> bytes:
    """[H, W, 3|4] u8 RGB/RGBA (or yuv=(y, u, v) I420 planes, img
    ignored) -> WebP bytes, via the reference's exact config walk."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libwebp not available")
    cfg = Config()
    if not lib.WebPConfigInitInternal(byref(cfg), preset,
                                      c_float(float(quality)),
                                      _enc_abi):
        raise RuntimeError("WebPConfigPreset failed")
    cfg.lossless = int(lossless)
    cfg.method = int(speed)
    if not lib.WebPValidateConfig(byref(cfg)):
        raise RuntimeError("WebPValidateConfig failed")
    pic = Picture()
    if not lib.WebPPictureInitInternal(byref(pic), _enc_abi):
        raise RuntimeError("WebPPictureInit failed")
    wr = MemoryWriter()
    lib.WebPMemoryWriterInit(byref(wr))
    try:
        if yuv is not None:
            y, u, v = (np.ascontiguousarray(p, np.uint8) for p in yuv)
            pic.use_argb = 0
            pic.colorspace = 0                    # WEBP_YUV420
            pic.height, pic.width = y.shape
            pic.y = y.ctypes.data_as(POINTER(c_uint8))
            pic.u = u.ctypes.data_as(POINTER(c_uint8))
            pic.v = v.ctypes.data_as(POINTER(c_uint8))
            pic.y_stride = y.shape[1]
            pic.uv_stride = u.shape[1]
        else:
            img = np.ascontiguousarray(img, np.uint8)
            h, w, ch = img.shape
            pic.use_argb = 1
            pic.width, pic.height = w, h
            importer = lib.WebPPictureImportRGBA if ch == 4 \
                else lib.WebPPictureImportRGB
            if not importer(byref(pic), img.tobytes(), w * ch):
                raise RuntimeError("WebPPictureImport failed")
        pic.writer = ctypes.cast(lib.WebPMemoryWrite, c_void_p)
        pic.custom_ptr = ctypes.cast(byref(wr), c_void_p)
        if not lib.WebPEncode(byref(cfg), byref(pic)):
            raise RuntimeError(
                f"WebPEncode failed (error {pic.error_code})")
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPMemoryWriterClear(byref(wr))
        lib.WebPPictureFree(byref(pic))
