"""EXIF serialization (gst/jpegformat/gstjifmux.c over gst-libs'
gstexiftag.c semantics) + a libexif read-back oracle.

build_exif(tags) renders the "Exif\\0\\0" APP1 payload: a little-endian
TIFF with IFD0 (description/make/model/orientation/resolution/software/
datetime/artist/copyright), the EXIF sub-IFD (exposure time, fnumber,
exposure program, ISO, datetime-original, APEX shutter/aperture,
exposure bias, metering mode, flash, focal length, maker note, file
source, exposure mode, white balance, digital zoom, scene type, gain
control, contrast/saturation/sharpness) and the GPS sub-IFD
(lat/lon with hemisphere refs as degree/minute/second rationals,
altitude with sea-level ref, image direction, movement speed in km/h).

The tag dictionary uses the reference's GStreamer tag names
(capturing-shutter-speed as an (n, d) tuple, image-orientation strings
like "rotate-90", capturing-flash-fired bool, geo-location-* floats).

read_exif(blob) binds the SYSTEM libexif (the library the upstream
jifmux unit test verifies with) and returns {(ifd, tag): value string}
via exif_entry_get_value.

A copy of the JAX package's io/exif.py: only its imports differ.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
import struct
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

TYPE_BYTE = 1
TYPE_ASCII = 2
TYPE_SHORT = 3
TYPE_LONG = 4
TYPE_RATIONAL = 5
TYPE_UNDEFINED = 7
TYPE_SRATIONAL = 10

# libexif ExifIfd enum (exif-ifd.h): 0, 1, EXIF, GPS, INTEROPERABILITY
IFD0 = 0
IFD_EXIF = 2
IFD_GPS = 3

# gstexiftag.c orientation strings <-> EXIF values
ORIENTATIONS = {
    "rotate-0": 1, "flip-rotate-0": 2, "rotate-180": 3,
    "flip-rotate-180": 4, "flip-rotate-270": 5, "rotate-90": 6,
    "flip-rotate-90": 7, "rotate-270": 8,
}
METERING_MODES = {"unknown": 0, "average": 1,
                  "center-weighted-average": 2, "spot": 3,
                  "multi-spot": 4, "pattern": 5, "partial": 6}
EXPOSURE_PROGRAMS = {"undefined": 0, "manual": 1, "normal": 2,
                     "aperture-priority": 3, "shutter-priority": 4,
                     "creative": 5, "action": 6, "portrait": 7,
                     "landscape": 8}
SCENE_TYPES = {"standard": 0, "landscape": 1, "portrait": 2,
               "night-scene": 3}
GAIN_LEVELS = {"none": 0, "low-gain-up": 1, "high-gain-up": 2,
               "low-gain-down": 3, "high-gain-down": 4}
LEVELS = {"normal": 0, "soft": 1, "hard": 2}  # contrast/sharpness
SATURATIONS = {"normal": 0, "low-saturation": 1, "high-saturation": 2}
WHITE_BALANCES = {"auto": 0, "manual": 1}
EXPOSURE_MODES = {"auto-exposure": 0, "manual-exposure": 1,
                  "auto-bracket": 2}
FLASH_MODES = {"auto": 0x18, "always": 0x08, "never": 0x10}


def _rat(v, max_den=1000000) -> Tuple[int, int]:
    f = Fraction(v).limit_denominator(max_den)
    return f.numerator, f.denominator


def _deg_min_sec(value: float) -> List[Tuple[int, int]]:
    value = abs(value)
    deg = int(value)
    rem = (value - deg) * 60
    minutes = int(rem)
    seconds = (rem - minutes) * 60
    return [(deg, 1), (minutes, 1), _rat(seconds, 100000)]


class _Ifd:
    def __init__(self):
        self.entries: List[Tuple[int, int, int, bytes]] = []

    def add(self, tag: int, typ: int, value) -> None:
        if typ == TYPE_ASCII:
            data = value.encode() + b"\x00"
            count = len(data)
        elif typ == TYPE_SHORT:
            vals = value if isinstance(value, list) else [value]
            data = b"".join(struct.pack("<H", v) for v in vals)
            count = len(vals)
        elif typ == TYPE_LONG:
            data = struct.pack("<I", value)
            count = 1
        elif typ in (TYPE_RATIONAL, TYPE_SRATIONAL):
            vals = value if isinstance(value, list) else [value]
            code = "<ii" if typ == TYPE_SRATIONAL else "<II"
            data = b"".join(struct.pack(code, n, d) for n, d in vals)
            count = len(vals)
        elif typ in (TYPE_BYTE, TYPE_UNDEFINED):
            data = bytes(value)
            count = len(data)
        else:
            raise ValueError(f"unsupported exif type {typ}")
        self.entries.append((tag, typ, count, data))

    def serialize(self, offset: int, next_ifd: int = 0
                  ) -> Tuple[bytes, int]:
        """(bytes, end_offset); offset = where this IFD starts within
        the TIFF."""
        self.entries.sort(key=lambda e: e[0])
        n = len(self.entries)
        data_off = offset + 2 + 12 * n + 4
        head = struct.pack("<H", n)
        tail = b""
        for tag, typ, count, data in self.entries:
            head += struct.pack("<HHI", tag, typ, count)
            if len(data) <= 4:
                head += data + b"\x00" * (4 - len(data))
            else:
                head += struct.pack("<I", data_off + len(tail))
                tail += data
                if len(tail) & 1:
                    tail += b"\x00"
        head += struct.pack("<I", next_ifd)
        return head + tail, data_off + len(tail)


def build_exif(tags: Dict) -> bytes:
    """tags (GStreamer tag names) -> 'Exif\\0\\0' + TIFF payload."""
    ifd0 = _Ifd()
    exif = _Ifd()
    gps = _Ifd()

    def ascii0(tag, key):
        if key in tags:
            ifd0.add(tag, TYPE_ASCII, str(tags[key]))

    ascii0(0x010E, "description")
    ascii0(0x010F, "device-manufacturer")
    ascii0(0x0110, "device-model")
    if "image-orientation" in tags:
        ifd0.add(0x0112, TYPE_SHORT,
                 ORIENTATIONS[tags["image-orientation"]])
    if "image-horizontal-ppi" in tags:
        ifd0.add(0x011A, TYPE_RATIONAL, _rat(tags["image-horizontal-ppi"]))
    if "image-vertical-ppi" in tags:
        ifd0.add(0x011B, TYPE_RATIONAL, _rat(tags["image-vertical-ppi"]))
    if "image-horizontal-ppi" in tags or "image-vertical-ppi" in tags:
        ifd0.add(0x0128, TYPE_SHORT, 2)  # inches
    ascii0(0x0131, "application-name")
    if "datetime" in tags:
        ifd0.add(0x0132, TYPE_ASCII, tags["datetime"])
    ascii0(0x013B, "artist")
    ascii0(0x8298, "copyright")

    if "capturing-shutter-speed" in tags:
        n, d = tags["capturing-shutter-speed"]
        exif.add(0x829A, TYPE_RATIONAL, (n, d))
        # APEX Tv = log2(1/t) (gstexiftag.c shutter speed writer)
        apex = -math.log2(n / d)
        exif.add(0x9201, TYPE_SRATIONAL, _rat(apex, 100000))
    if "capturing-focal-ratio" in tags:
        f = tags["capturing-focal-ratio"]
        exif.add(0x829D, TYPE_RATIONAL, _rat(f, 100000))
        exif.add(0x9202, TYPE_RATIONAL, _rat(2 * math.log2(f), 100000))
    if "capturing-exposure-program" in tags:
        exif.add(0x8822, TYPE_SHORT,
                 EXPOSURE_PROGRAMS[tags["capturing-exposure-program"]])
    if "capturing-iso-speed" in tags:
        exif.add(0x8827, TYPE_SHORT, tags["capturing-iso-speed"])
    if "datetime" in tags:
        exif.add(0x9003, TYPE_ASCII, tags["datetime"])
    if "capturing-exposure-compensation" in tags:
        exif.add(0x9204, TYPE_SRATIONAL,
                 _rat(tags["capturing-exposure-compensation"], 100000))
    if "capturing-metering-mode" in tags:
        exif.add(0x9207, TYPE_SHORT,
                 METERING_MODES[tags["capturing-metering-mode"]])
    if "capturing-flash-fired" in tags:
        flash = 1 if tags["capturing-flash-fired"] else 0
        flash |= FLASH_MODES.get(tags.get("capturing-flash-mode", ""),
                                 0)
        exif.add(0x9209, TYPE_SHORT, flash)
    if "capturing-focal-length" in tags:
        exif.add(0x920A, TYPE_RATIONAL,
                 _rat(tags["capturing-focal-length"], 100000))
    if "application-data" in tags:
        exif.add(0x927C, TYPE_UNDEFINED, tags["application-data"])
    if tags.get("capturing-source") == "dsc":
        exif.add(0xA300, TYPE_UNDEFINED, b"\x03")
    if "capturing-exposure-mode" in tags:
        exif.add(0xA402, TYPE_SHORT,
                 EXPOSURE_MODES[tags["capturing-exposure-mode"]])
    if "capturing-white-balance" in tags:
        exif.add(0xA403, TYPE_SHORT,
                 WHITE_BALANCES[tags["capturing-white-balance"]])
    if "capturing-digital-zoom-ratio" in tags:
        exif.add(0xA404, TYPE_RATIONAL,
                 _rat(tags["capturing-digital-zoom-ratio"], 100000))
    if "capturing-scene-capture-type" in tags:
        exif.add(0xA406, TYPE_SHORT,
                 SCENE_TYPES[tags["capturing-scene-capture-type"]])
    if "capturing-gain-adjustment" in tags:
        exif.add(0xA407, TYPE_SHORT,
                 GAIN_LEVELS[tags["capturing-gain-adjustment"]])
    if "capturing-contrast" in tags:
        exif.add(0xA408, TYPE_SHORT, LEVELS[tags["capturing-contrast"]])
    if "capturing-saturation" in tags:
        exif.add(0xA409, TYPE_SHORT,
                 SATURATIONS[tags["capturing-saturation"]])
    if "capturing-sharpness" in tags:
        exif.add(0xA40A, TYPE_SHORT, LEVELS[tags["capturing-sharpness"]])

    if "geo-location-latitude" in tags:
        lat = tags["geo-location-latitude"]
        gps.add(1, TYPE_ASCII, "N" if lat >= 0 else "S")
        gps.add(2, TYPE_RATIONAL, _deg_min_sec(lat))
    if "geo-location-longitude" in tags:
        lon = tags["geo-location-longitude"]
        gps.add(3, TYPE_ASCII, "E" if lon >= 0 else "W")
        gps.add(4, TYPE_RATIONAL, _deg_min_sec(lon))
    if "geo-location-elevation" in tags:
        ele = tags["geo-location-elevation"]
        gps.add(5, TYPE_BYTE, b"\x00" if ele >= 0 else b"\x01")
        gps.add(6, TYPE_RATIONAL, _rat(abs(ele), 100000))
    if "geo-location-capture-direction" in tags:
        gps.add(16, TYPE_ASCII, "T")
        gps.add(17, TYPE_RATIONAL,
                _rat(tags["geo-location-capture-direction"], 100000))
    if "geo-location-movement-direction" in tags:
        gps.add(14, TYPE_ASCII, "T")
        gps.add(15, TYPE_RATIONAL,
                _rat(tags["geo-location-movement-direction"], 100000))
    if "geo-location-movement-speed" in tags:
        gps.add(12, TYPE_ASCII, "K")  # km/h (gstexiftag.c speed writer)
        gps.add(13, TYPE_RATIONAL,
                _rat(tags["geo-location-movement-speed"] * 3.6, 100000))

    # layout: header(8) + IFD0 + EXIF IFD + GPS IFD
    have_exif = bool(exif.entries)
    have_gps = bool(gps.entries)
    # reserve the pointer entries so IFD0's size is final
    if have_exif:
        ifd0.add(0x8769, TYPE_LONG, 0)
    if have_gps:
        ifd0.add(0x8825, TYPE_LONG, 0)
    n0 = len(ifd0.entries)
    ifd0_blob, end0 = ifd0.serialize(8)
    exif_off = end0
    if have_exif:
        exif_blob, end1 = exif.serialize(exif_off)
    else:
        exif_blob, end1 = b"", exif_off
    gps_off = end1
    if have_gps:
        gps_blob, _ = gps.serialize(gps_off)
    else:
        gps_blob = b""
    # patch pointer values into IFD0
    ifd0.entries = [(t, ty, c, d) for t, ty, c, d in ifd0.entries
                    if t not in (0x8769, 0x8825)]
    if have_exif:
        ifd0.add(0x8769, TYPE_LONG, exif_off)
    if have_gps:
        ifd0.add(0x8825, TYPE_LONG, gps_off)
    ifd0_blob, _ = ifd0.serialize(8)
    tiff = b"II" + struct.pack("<HI", 42, 8) + ifd0_blob + exif_blob \
        + gps_blob
    return b"Exif\x00\x00" + tiff


# ----------------------------------------------------------------------
# libexif read-back oracle

_LIBEXIF = None


def _load_libexif():
    global _LIBEXIF
    if _LIBEXIF is not None:
        return _LIBEXIF
    name = ctypes.util.find_library("exif") or "libexif.so.12"
    lib = ctypes.CDLL(name)
    lib.exif_data_new_from_data.restype = ctypes.c_void_p
    lib.exif_data_new_from_data.argtypes = [ctypes.c_char_p,
                                            ctypes.c_uint]
    lib.exif_content_get_entry.restype = ctypes.c_void_p
    lib.exif_content_get_entry.argtypes = [ctypes.c_void_p,
                                           ctypes.c_int]
    lib.exif_entry_get_value.restype = ctypes.c_char_p
    lib.exif_entry_get_value.argtypes = [ctypes.c_void_p,
                                         ctypes.c_char_p,
                                         ctypes.c_uint]
    lib.exif_data_unref.argtypes = [ctypes.c_void_p]
    _LIBEXIF = lib
    return lib


def libexif_available() -> bool:
    try:
        _load_libexif()
        return True
    except OSError:
        return False


class _ExifData(ctypes.Structure):
    _fields_ = [("ifd", ctypes.c_void_p * 5),
                ("data", ctypes.c_void_p),
                ("size", ctypes.c_uint)]


class _ExifEntry(ctypes.Structure):
    # exif-entry.h struct _ExifEntry
    _fields_ = [("tag", ctypes.c_int),
                ("format", ctypes.c_int),
                ("components", ctypes.c_ulong),
                ("data", ctypes.POINTER(ctypes.c_ubyte)),
                ("size", ctypes.c_uint)]


def _decode_entry(entry_ptr: int, little_endian: bool):
    e = _ExifEntry.from_address(entry_ptr)
    raw = bytes(ctypes.cast(e.data,
                            ctypes.POINTER(ctypes.c_ubyte * e.size))
                .contents)
    bo = "<" if little_endian else ">"
    n = e.components
    if e.format == TYPE_ASCII:
        return raw.split(b"\x00")[0].decode("utf-8", "replace")
    if e.format == TYPE_SHORT:
        vals = struct.unpack(f"{bo}{n}H", raw[:2 * n])
        return vals[0] if n == 1 else list(vals)
    if e.format == TYPE_LONG:
        vals = struct.unpack(f"{bo}{n}I", raw[:4 * n])
        return vals[0] if n == 1 else list(vals)
    if e.format in (TYPE_RATIONAL, TYPE_SRATIONAL):
        code = "i" if e.format == TYPE_SRATIONAL else "I"
        vals = struct.unpack(f"{bo}{2 * n}{code}", raw[:8 * n])
        pairs = [(vals[2 * i], vals[2 * i + 1]) for i in range(n)]
        return pairs[0] if n == 1 else pairs
    return raw  # BYTE / UNDEFINED


def read_exif_raw(blob: bytes, tags: List[Tuple[int, int]]
                  ) -> Dict[Tuple[int, int], object]:
    """Like read_exif but decodes entry->data raw components (strings,
    shorts, (num, den) rationals) with exif_get_* semantics — the way
    the upstream jifmux test's compare_* callbacks read values."""
    lib = _load_libexif()
    lib.exif_data_get_byte_order.restype = ctypes.c_int
    lib.exif_data_get_byte_order.argtypes = [ctypes.c_void_p]
    ed = lib.exif_data_new_from_data(blob, len(blob))
    if not ed:
        raise ValueError("libexif rejected the blob")
    try:
        # ExifByteOrder: 0 = MOTOROLA (BE), 1 = INTEL (LE)
        le = lib.exif_data_get_byte_order(ed) == 1
        st = _ExifData.from_address(ed)
        out: Dict[Tuple[int, int], object] = {}
        for ifd, tag in tags:
            content = st.ifd[ifd]
            if not content:
                continue
            entry = lib.exif_content_get_entry(content, tag)
            if entry:
                out[(ifd, tag)] = _decode_entry(entry, le)
        return out
    finally:
        lib.exif_data_unref(ed)


def read_exif(blob: bytes, tags: List[Tuple[int, int]]
              ) -> Dict[Tuple[int, int], str]:
    """Parse an EXIF blob with the REAL libexif and return
    {(ifd, tag): rendered value} for the requested (ifd, tag) pairs —
    the same verification path as the upstream jifmux test."""
    lib = _load_libexif()
    ed = lib.exif_data_new_from_data(blob, len(blob))
    if not ed:
        raise ValueError("libexif rejected the blob")
    try:
        st = _ExifData.from_address(ed)
        out = {}
        buf = ctypes.create_string_buffer(256)
        for ifd, tag in tags:
            content = st.ifd[ifd]
            if not content:
                continue
            entry = lib.exif_content_get_entry(content, tag)
            if not entry:
                continue
            val = lib.exif_entry_get_value(entry, buf, 256)
            if val is not None:
                out[(ifd, tag)] = val.decode("utf-8", "replace")
        return out
    finally:
        lib.exif_data_unref(ed)
