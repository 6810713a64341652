"""(A copy of gstbad_tpu/io/dvbsub.py, numpy only.)

DVB subtitle bitstream decoding (gst/dvbsuboverlay/dvb-sub.c).

ETSI EN 300 743 segment stream -> palettized region bitmaps + AYUV CLUTs.
The reference's parser (itself ported from ffmpeg's dvbsubdec) is
transcribed here: page/region/CLUT/object/display-definition segments, the
2/4/8-bit pixel-data run-length strings with their inter-depth map tables,
and the default CLUTs from the spec (dvb-sub.c:293-361).

Quirks kept: CLUT entries with y == 0 are forced fully transparent
(dvb-sub.c:618-619, alpha byte 0xff before the 255-alpha store); region
dimension changes force a bgcolor fill (dvb-sub.c:474-482); page segments
rebuild the display list in reverse arrival order (entries are prepended,
dvb-sub.c:424-425); the object parser renders the SAME field data once per
display the object appears in (dvb-sub.c:1110-1128); a zero-length bottom
field reuses the top field data (dvb-sub.c:1121-1124).

Out-of-scope: coding_method 1 ("string of characters", unimplemented in
the reference too, dvb-sub.c:1130-1131).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

SEGMENT_PAGE = 0x10
SEGMENT_REGION = 0x11
SEGMENT_CLUT = 0x12
SEGMENT_OBJECT = 0x13
SEGMENT_DISPLAY_DEF = 0x14
SEGMENT_END_OF_DISPLAY_SET = 0x80
SYNC_BYTE = 0x0F


def _rgb_to_y(r: int, g: int, b: int) -> int:
    return min(max(((19595 * r) >> 16) + ((38470 * g) >> 16)
                   + ((7471 * b) >> 16), 0), 255)


def _rgb_to_u(r: int, g: int, b: int) -> int:
    return min(max(-((11059 * r) >> 16) - ((21709 * g) >> 16)
                   + ((32768 * b) >> 16) + 128, 0), 255)


def _rgb_to_v(r: int, g: int, b: int) -> int:
    return min(max(((32768 * r) >> 16) - ((27439 * g) >> 16)
                   - ((5329 * b) >> 16) + 128, 0), 255)


def _ayuv(y: int, u: int, v: int, a: int) -> int:
    return (a << 24) | (y << 16) | (u << 8) | v


def _rgba_to_ayuv(r: int, g: int, b: int, a: int) -> int:
    return _ayuv(_rgb_to_y(r, g, b), _rgb_to_u(r, g, b), _rgb_to_v(r, g, b),
                 a)


def _default_cluts():
    """The spec default CLUTs (dvb-sub.c:293-361)."""
    clut4 = np.zeros(4, np.uint32)
    clut4[0] = _rgba_to_ayuv(0, 0, 0, 0)
    clut4[1] = _rgba_to_ayuv(255, 255, 255, 255)
    clut4[2] = _rgba_to_ayuv(0, 0, 0, 255)
    clut4[3] = _rgba_to_ayuv(127, 127, 127, 255)

    clut16 = np.zeros(16, np.uint32)
    clut16[0] = _rgba_to_ayuv(0, 0, 0, 0)
    for i in range(1, 16):
        if i < 8:
            r = 255 if i & 1 else 0
            g = 255 if i & 2 else 0
            b = 255 if i & 4 else 0
        else:
            r = 127 if i & 1 else 0
            g = 127 if i & 2 else 0
            b = 127 if i & 4 else 0
        clut16[i] = _rgba_to_ayuv(r, g, b, 255)

    clut256 = np.zeros(256, np.uint32)
    clut256[0] = _rgba_to_ayuv(0, 0, 0, 0)
    for i in range(1, 256):
        if i < 8:
            r = 255 if i & 1 else 0
            g = 255 if i & 2 else 0
            b = 255 if i & 4 else 0
            a = 63
        else:
            sw = i & 0x88
            if sw == 0x00:
                r = (85 if i & 1 else 0) + (170 if i & 0x10 else 0)
                g = (85 if i & 2 else 0) + (170 if i & 0x20 else 0)
                b = (85 if i & 4 else 0) + (170 if i & 0x40 else 0)
                a = 255
            elif sw == 0x08:
                r = (85 if i & 1 else 0) + (170 if i & 0x10 else 0)
                g = (85 if i & 2 else 0) + (170 if i & 0x20 else 0)
                b = (85 if i & 4 else 0) + (170 if i & 0x40 else 0)
                a = 127
            elif sw == 0x80:
                r = 127 + (43 if i & 1 else 0) + (85 if i & 0x10 else 0)
                g = 127 + (43 if i & 2 else 0) + (85 if i & 0x20 else 0)
                b = 127 + (43 if i & 4 else 0) + (85 if i & 0x40 else 0)
                a = 255
            else:
                r = (43 if i & 1 else 0) + (85 if i & 0x10 else 0)
                g = (43 if i & 2 else 0) + (85 if i & 0x20 else 0)
                b = (43 if i & 4 else 0) + (85 if i & 0x40 else 0)
                a = 255
        clut256[i] = _rgba_to_ayuv(r, g, b, a)
    return clut4, clut16, clut256


DEFAULT_CLUT4, DEFAULT_CLUT16, DEFAULT_CLUT256 = _default_cluts()


class _BitReader:
    """gst_bit_reader semantics; reads past the end return 0 (the
    reference reads 'unchecked' after its loop guard — working with
    default-0 bytes is its own stated fallback, dvb-sub.c:846)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0               # bit position

    def remaining(self) -> int:
        return len(self.data) * 8 - self.pos

    def get(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte_i, bit_i = divmod(self.pos, 8)
            bit = ((self.data[byte_i] >> (7 - bit_i)) & 1
                   if byte_i < len(self.data) else 0)
            v = (v << 1) | bit
            self.pos += 1
        return v


def _read_nbit_string(dest: np.ndarray, dpos: int, dbuf_len: int,
                      src: bytes, non_mod: int,
                      map_table: Optional[List[int]], depth: int) -> int:
    """The three _dvb_sub_read_{2,4,8}bit_string readers
    (dvb-sub.c:635-907), unified: returns (pixels_read, bytes_consumed).
    dest is the region's flat index buffer, dpos the start offset."""
    gb = _BitReader(src)
    stop = False
    pixels = 0
    min_bits = {2: 2, 4: 4, 8: 8}[depth]
    while not stop and gb.remaining() >= min_bits:
        run_length = 0
        clut_index = 0
        if depth == 2:
            bits = gb.get(2)
            if bits:
                run_length, clut_index = 1, bits
            else:
                if gb.get(1) == 1:
                    run_length = gb.get(3) + 3
                    clut_index = gb.get(2)
                elif gb.get(1) == 1:
                    run_length = 1          # 1x pseudo-colour '00'
                else:
                    sw3 = gb.get(2)
                    if sw3 == 0:
                        stop = True
                    elif sw3 == 1:
                        run_length = 2
                    elif sw3 == 2:
                        run_length = gb.get(4) + 12
                        clut_index = gb.get(2)
                    else:
                        run_length = gb.get(8) + 29
                        clut_index = gb.get(2)
        elif depth == 4:
            bits = gb.get(4)
            if bits:
                run_length, clut_index = 1, bits
            else:
                if gb.get(1) == 0:
                    rl = gb.get(3)
                    if rl == 0:
                        stop = True
                    else:
                        run_length = rl + 2
                elif gb.get(1) == 0:
                    run_length = gb.get(2) + 4
                    clut_index = gb.get(4)
                else:
                    sw3 = gb.get(2)
                    if sw3 == 0:
                        run_length = 1
                    elif sw3 == 1:
                        run_length = 2
                    elif sw3 == 2:
                        run_length = gb.get(4) + 9
                        clut_index = gb.get(4)
                    else:
                        run_length = gb.get(8) + 25
                        clut_index = gb.get(4)
        else:
            bits = gb.get(8)
            if bits:
                run_length, clut_index = 1, bits
            elif gb.get(1) == 0:
                run_length = gb.get(7)
                if run_length == 0:
                    stop = True
            else:
                run_length = gb.get(7)
                clut_index = gb.get(8)
        if run_length == 0:
            continue
        run_length = min(run_length, max(dbuf_len, 0))
        dbuf_len -= run_length
        if map_table is not None:
            clut_index = map_table[clut_index]
        if not (non_mod == 1 and clut_index == 1):
            dest[dpos + pixels:dpos + pixels + run_length] = clut_index
        pixels += run_length
    return pixels, (gb.pos + 7) >> 3


@dataclass
class Rect:
    """One region rect of an emitted display set (DVBSubtitleRect)."""
    x: int
    y: int
    w: int
    h: int
    depth: int
    indices: np.ndarray          # [h, w] u8 palette indices
    palette: np.ndarray          # [1 << depth] u32 AYUV


@dataclass
class DisplaySet:
    """One end-of-display-set emission (DVBSubtitles)."""
    pts_ns: int
    page_time_out: int           # seconds
    rects: List[Rect]
    display_width: int = 720
    display_height: int = 576
    window_x: int = 0
    window_y: int = 0


@dataclass
class _Region:
    id: int
    width: int = 0
    height: int = 0
    depth: int = 4
    clut: int = 0
    bgcolor: int = 0
    pbuf: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    display_list: List[dict] = field(default_factory=list)


class DvbSubParser:
    """The DvbSub object: feed() PES payloads, collect DisplaySets."""

    def __init__(self):
        self.regions: Dict[int, _Region] = {}
        self.cluts: Dict[int, dict] = {}
        self.objects: Dict[int, dict] = {}
        self.display_list: List[dict] = []   # newest first (prepended)
        self.page_time_out = 0
        self.display_width = 720
        self.display_height = 576
        self.window_flag = False
        self.window_x = 0
        self.window_y = 0
        self._dds_version = -1

    # -- segment parsers ---------------------------------------------------

    def _parse_page(self, buf: bytes):
        if len(buf) < 1:
            return
        self.page_time_out = buf[0]
        page_state = (buf[1] >> 2) & 3
        if page_state == 2:                 # mode change: reset state
            self.regions.clear()
            self.cluts.clear()
            self.objects.clear()
        self.display_list = []
        pos = 2
        while pos + 6 <= len(buf):
            region_id = buf[pos]
            x = (buf[pos + 2] << 8) | buf[pos + 3]
            y = (buf[pos + 4] << 8) | buf[pos + 5]
            pos += 6
            # prepended => final order is reverse arrival (dvb-sub.c:424)
            self.display_list.insert(
                0, {"region_id": region_id, "x": x, "y": y})

    def _parse_region(self, buf: bytes):
        if len(buf) < 10:
            return
        region_id = buf[0]
        region = self.regions.setdefault(region_id, _Region(region_id))
        fill = (buf[1] >> 3) & 1
        width = (buf[2] << 8) | buf[3]
        height = (buf[4] << 8) | buf[5]
        if width * height != region.pbuf.size:
            region.pbuf = np.zeros(width * height, np.uint8)
            fill = 1                        # dvb-sub.c:481
        region.width, region.height = width, height
        depth = 1 << ((buf[6] >> 2) & 7)
        if depth < 2 or depth > 8:
            depth = 4
        region.depth = depth
        region.clut = buf[7]
        if depth == 8:
            region.bgcolor = buf[8]
            pos = 10
        else:
            if depth == 4:
                region.bgcolor = (buf[9] >> 4) & 15
            else:
                region.bgcolor = (buf[9] >> 2) & 3
            pos = 10
        if fill:
            region.pbuf[:] = region.bgcolor
        # drop this region's object displays (dvb-sub.c:513)
        for d in region.display_list:
            obj = self.objects.get(d["object_id"])
            if obj is not None:
                obj["displays"] = [x for x in obj["displays"] if x is not d]
                if not obj["displays"]:
                    self.objects.pop(d["object_id"], None)
        region.display_list = []
        while pos + 6 <= len(buf):
            object_id = (buf[pos] << 8) | buf[pos + 1]
            obj = self.objects.setdefault(
                object_id, {"id": object_id, "type": 0, "displays": []})
            # the type bits live in the first byte of the x_pos word
            # (dvb-sub.c:530 reads *buf before the masked RU16)
            obj["type"] = buf[pos + 2] >> 6
            disp = {"object_id": object_id, "region_id": region_id,
                    "x": ((buf[pos + 2] << 8) | buf[pos + 3]) & 0xFFF,
                    "y": ((buf[pos + 4] << 8) | buf[pos + 5]) & 0xFFF,
                    "fgcolor": 0, "bgcolor": 0}
            pos += 6
            if obj["type"] in (1, 2) and pos + 2 <= len(buf):
                disp["fgcolor"] = buf[pos]
                disp["bgcolor"] = buf[pos + 1]
                pos += 2
            region.display_list.insert(0, disp)
            obj["displays"].insert(0, disp)

    def _parse_clut(self, buf: bytes):
        if len(buf) < 2:
            return
        clut_id = buf[0]
        clut = self.cluts.get(clut_id)
        if clut is None:
            clut = {"clut4": DEFAULT_CLUT4.copy(),
                    "clut16": DEFAULT_CLUT16.copy(),
                    "clut256": DEFAULT_CLUT256.copy()}
            self.cluts[clut_id] = clut
        pos = 2
        while pos + 4 < len(buf):
            entry_id = buf[pos]
            depth = buf[pos + 1] & 0xE0
            if depth == 0:
                return
            full_range = buf[pos + 1] & 1
            pos += 2
            if full_range:
                y, cr, cb, alpha = buf[pos], buf[pos + 1], buf[pos + 2], \
                    buf[pos + 3]
                pos += 4
            else:
                y = buf[pos] & 0xFC
                cr = (((buf[pos] & 3) << 2) | ((buf[pos + 1] >> 6) & 3)) << 4
                cb = (buf[pos + 1] << 2) & 0xF0
                alpha = (buf[pos + 1] << 6) & 0xC0
                pos += 2
            if y == 0:
                alpha = 0xFF                # forced transparent
            val = _ayuv(y, cb, cr, 255 - alpha)
            if depth & 0x80:
                clut["clut4"][entry_id] = val
            if depth & 0x40:
                clut["clut16"][entry_id] = val
            if depth & 0x20:
                clut["clut256"][entry_id] = val

    def _parse_pixel_block(self, disp: dict, buf: bytes, top_bottom: int,
                           non_mod: int):
        region = self.regions.get(disp["region_id"])
        if region is None:
            return
        map2to4 = [0x0, 0x7, 0x8, 0xF]
        map2to8 = [0x00, 0x77, 0x88, 0xFF]
        map4to8 = [0x11 * i for i in range(16)]
        x_pos, y_pos = disp["x"], disp["y"]
        if (y_pos & 1) != top_bottom:
            y_pos += 1
        pos = 0
        while pos < len(buf):
            filled = y_pos >= region.height
            code = buf[pos]
            pos += 1
            if code in (0x10, 0x11, 0x12):
                if filled:
                    return
                depth = {0x10: 2, 0x11: 4, 0x12: 8}[code]
                if depth > region.depth:
                    return
                if code == 0x10:
                    table = (map2to8 if region.depth == 8
                             else map2to4 if region.depth == 4 else None)
                elif code == 0x11:
                    table = map4to8 if region.depth == 8 else None
                else:
                    table = None
                n, consumed = _read_nbit_string(
                    region.pbuf, y_pos * region.width + x_pos,
                    region.width - x_pos, buf[pos:], non_mod, table, depth)
                x_pos += n
                pos += consumed
            elif code == 0x20:
                map2to4[0] = buf[pos] >> 4
                map2to4[1] = buf[pos] & 0xF
                map2to4[2] = buf[pos + 1] >> 4
                map2to4[3] = buf[pos + 1] & 0xF
                pos += 2
            elif code == 0x21:
                map2to8[:] = list(buf[pos:pos + 4])
                pos += 4
            elif code == 0x22:
                map4to8[:] = list(buf[pos:pos + 16])
                pos += 16
            elif code == 0xF0:
                x_pos = disp["x"]
                y_pos += 2

    def _parse_object(self, buf: bytes):
        object_id = (buf[0] << 8) | buf[1]
        obj = self.objects.get(object_id)
        if obj is None:
            return
        coding_method = (buf[2] >> 2) & 3
        non_mod = (buf[2] >> 1) & 1
        if coding_method != 0:
            return                          # dvb-sub.c:1130 (unsupported)
        top_len = (buf[3] << 8) | buf[4]
        bottom_len = (buf[5] << 8) | buf[6]
        if 7 + top_len + bottom_len > len(buf):
            return
        for disp in obj["displays"]:
            top = buf[7:7 + top_len]
            self._parse_pixel_block(disp, top, 0, non_mod)
            if bottom_len > 0:
                bottom = buf[7 + top_len:7 + top_len + bottom_len]
            else:
                bottom = top                # dvb-sub.c:1121-1124
            self._parse_pixel_block(disp, bottom, 1, non_mod)

    def _parse_display_def(self, buf: bytes):
        if len(buf) < 5:
            return
        info = buf[0]
        dds_version = info >> 4
        width = ((buf[1] << 8) | buf[2]) + 1
        height = ((buf[3] << 8) | buf[4]) + 1
        if (width, height) != (self.display_width, self.display_height):
            self.display_width, self.display_height = width, height
            self._dds_version = -1
        if self._dds_version == dds_version:
            return
        self._dds_version = dds_version
        self.window_flag = bool(info & 0x08)
        if len(buf) >= 13 and self.window_flag:
            self.window_x = (buf[5] << 8) | buf[6]
            self.window_y = (buf[9] << 8) | buf[10]

    def _end_of_display_set(self, pts_ns: int) -> DisplaySet:
        rects = []
        for disp in self.display_list:
            region = self.regions.get(disp["region_id"])
            if region is None:
                continue
            clut = self.cluts.get(region.clut)
            if clut is None:
                clut = {"clut4": DEFAULT_CLUT4, "clut16": DEFAULT_CLUT16,
                        "clut256": DEFAULT_CLUT256}
            table = {2: "clut4", 8: "clut256"}.get(region.depth, "clut16")
            rects.append(Rect(
                x=disp["x"], y=disp["y"], w=region.width, h=region.height,
                depth=region.depth,
                indices=region.pbuf.reshape(region.height, region.width
                                            ).copy(),
                palette=clut[table][:1 << region.depth].copy()))
        return DisplaySet(
            pts_ns=pts_ns, page_time_out=self.page_time_out, rects=rects,
            display_width=self.display_width,
            display_height=self.display_height,
            window_x=self.window_x if self.window_flag else 0,
            window_y=self.window_y if self.window_flag else 0)

    # -- entry point -------------------------------------------------------

    def feed(self, data: bytes, pts_ns: int = 0) -> List[DisplaySet]:
        """dvb_sub_feed_with_pts (dvb-sub.c:1376-1476): 0x20 0x00 then
        sync-byte-framed segments.  Returns the display sets emitted by
        END_OF_DISPLAY_SET segments in this payload."""
        out: List[DisplaySet] = []
        if len(data) <= 3 or data[0] != 0x20 or data[1] != 0x00:
            return out
        pos = 2
        while pos < len(data) and data[pos] == SYNC_BYTE:
            pos += 1
            if len(data) - pos < 5:
                return out
            segment_type = data[pos]
            seg_len = (data[pos + 3] << 8) | data[pos + 4]
            pos += 5
            if len(data) - pos < seg_len:
                return out
            seg = data[pos:pos + seg_len]
            if segment_type == SEGMENT_PAGE:
                self._parse_page(seg)
            elif segment_type == SEGMENT_REGION:
                self._parse_region(seg)
            elif segment_type == SEGMENT_CLUT:
                self._parse_clut(seg)
            elif segment_type == SEGMENT_OBJECT:
                self._parse_object(seg)
            elif segment_type == SEGMENT_DISPLAY_DEF:
                self._parse_display_def(seg)
            elif segment_type == SEGMENT_END_OF_DISPLAY_SET:
                out.append(self._end_of_display_set(pts_ns))
            pos += seg_len
        return out


def _scale_linearly(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """gst_video_blend_scale_linearly semantics (the -base
    video-blend.c path the overlay composition uses, built on
    videoscale's vs_image_scale_linear_RGBA): a 16.16 coordinate
    accumulator with increment ((src-1)<<16)/(dest-1), 8-bit blend
    weights (acc>>8 & 0xff), horizontal resample first, then the
    two-row vertical blend — endpoints land exactly on the source
    corners."""
    sh, sw = img.shape[:2]
    a = img.astype(np.int64)
    xinc = 0 if dw <= 1 else ((sw - 1) << 16) // (dw - 1)
    yinc = 0 if dh <= 1 else ((sh - 1) << 16) // (dh - 1)
    xacc = np.arange(dw, dtype=np.int64) * xinc
    k = xacc >> 16
    fx = (xacc >> 8) & 0xFF
    k1 = np.minimum(k + 1, sw - 1)
    hs = (a[:, k] * (256 - fx)[None, :, None]
          + a[:, k1] * fx[None, :, None]) >> 8          # [sh, dw, 4]
    yacc = np.arange(dh, dtype=np.int64) * yinc
    j = yacc >> 16
    fy = (yacc >> 8) & 0xFF
    j1 = np.minimum(j + 1, sh - 1)
    out = (hs[j] * (256 - fy)[:, None, None]
           + hs[j1] * fy[:, None, None]) >> 8
    return out.astype(np.uint8)


def display_set_to_ayuv(ds: DisplaySet, width: int, height: int
                        ) -> np.ndarray:
    """Render a display set onto a [height, width, 4] AYUV canvas the way
    gst_dvbsub_overlay_subs_to_comp does (gstdvbsuboverlay.c:906-1000):
    palette-expand each rect, then place it at window+position scaled from
    the display definition to the video size.  The rect rescale follows
    the overlay composition's linear blend path (_scale_linearly; the
    r4 nearest-neighbor approximation is closed)."""
    canvas = np.zeros((height, width, 4), np.uint8)
    for rect in ds.rects:
        ayuv = rect.palette[rect.indices]            # [h, w] u32
        img = np.stack([(ayuv >> 24) & 0xFF, (ayuv >> 16) & 0xFF,
                        (ayuv >> 8) & 0xFF, ayuv & 0xFF],
                       axis=-1).astype(np.uint8)
        rx = (ds.window_x + rect.x) * width // ds.display_width
        ry = (ds.window_y + rect.y) * height // ds.display_height
        rw = rect.w * width // ds.display_width
        rh = rect.h * height // ds.display_height
        if rw <= 0 or rh <= 0:
            continue
        if (rh, rw) == img.shape[:2]:
            scaled = img
        else:
            scaled = _scale_linearly(img, rh, rw)
        y0, x0 = max(ry, 0), max(rx, 0)
        y1, x1 = min(ry + rh, height), min(rx + rw, width)
        if y1 <= y0 or x1 <= x0:
            continue
        canvas[y0:y1, x0:x1] = scaled[y0 - ry:y1 - ry, x0 - rx:x1 - rx]
    return canvas
