"""(A copy of gstbad_tpu/io/ttml_pango.py, numpy only.)

The gstttmlrender.c render pipeline over real Pango
(ext/ttml/gstttmlrender.c:1185-2760, transcribed).

This is the reference's ACTUAL text stack: per-element pango markup
(generate_pango_markup, :1389-1422), the px-font-size search
(get_pango_font_size, :1458-1476), ink-rect font metrics measured on
"Áĺľď¿gqy" (:1432-1450), byte-index line ranges with
pango_layout_xy_to_index wrapping at the nearest breakpoint
(get_line_char_ranges, :1570-1676), block splitting + the TTML 7.2.3
whitespace strips (:1781-1930), per-element text/background images
combined and stitched (render_block_elements, :2018-2077;
stitch_images, :2510-2540), lineHeight normal-vs-percentage block
metrics with the most-frequent-descender baseline (:2225-2270), and
the region window walk with displayAlign placement and overflow crop
(render_text_region, :2615-2760).

Host-side: everything here is setup-time rasterization; the element
composites the resulting premultiplied overlay on device.  Images are
premultiplied B,G,R,A u8 (cairo ARGB32 little-endian); image combine
uses pixman's exact OVER (io/rsvg.composite_over_u8) — the same math
cairo's fill performs in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple
from xml.sax.saxutils import escape

import numpy as np

from gstbad_tpu_torch.io import pangocairo as pc
from gstbad_tpu_torch.io.rsvg import composite_over_u8
from gstbad_tpu_torch.io.ttml import Block, Region, SceneOut, StyleSet

PANGO_SCALE = pc.PANGO_SCALE

# gstttmlrender.c:1237-1259 (IMSC1 / HbbTV generic font names)
GENERIC_FONTS = {
    "default": "TiresiasScreenfont,Liberation Mono,Courier New,monospace",
    "monospace": "Letter Gothic,Liberation Mono,Courier New,monospace",
    "sansSerif": "TiresiasScreenfont,sans",
    "serif": "serif",
    "monospaceSansSerif": "Letter Gothic,monospace",
    "monospaceSerif": "Courier New,Liberation Mono,monospace",
    "proportionalSansSerif":
        "TiresiasScreenfont,Arial,Helvetica,Liberation Sans,sans",
    "proportionalSerif": "serif",
}

METRICS_PROBE = "Áĺľď¿gqy"     # gstttmlrender.c:1440


def color_to_string(color) -> str:
    """gstttmlrender.c:1185-1193 (pango >= 1.38 path)."""
    r, g, b, a = color
    return f"#{r:02x}{g:02x}{b:02x}{a:02x}"


def generate_pango_markup(ss: StyleSet, font_height: int,
                          text: str) -> str:
    """gstttmlrender.c:1389-1422 — byte-for-byte the reference span."""
    fgcolor = color_to_string(ss.color)
    font_family = GENERIC_FONTS.get(ss.font_family, ss.font_family)
    font_style = "normal" if ss.font_style == "normal" else "italic"
    font_weight = "normal" if ss.font_weight == "normal" else "bold"
    underline = ("single" if ss.text_decoration == "underline"
                 else "none")
    escaped = escape(text, {'"': "&quot;", "'": "&apos;"})
    return (f'<span fgcolor="{fgcolor}" font="{font_height}px" '
            f'font_family="{font_family}" font_style="{font_style}" '
            f'font_weight="{font_weight}" underline="{underline}" >'
            f"{escaped}</span>")


@dataclass
class RImage:
    """GstTtmlRenderRenderedImage: premul BGRA u8 + placement."""
    img: Optional[np.ndarray]      # [h, w, 4] or None (empty)
    x: int = 0
    y: int = 0

    @property
    def width(self) -> int:
        return 0 if self.img is None else self.img.shape[1]

    @property
    def height(self) -> int:
        return 0 if self.img is None else self.img.shape[0]


def _un8_mul(a: np.ndarray, b: int) -> np.ndarray:
    t = a.astype(np.int32) * int(b) + 0x80
    return ((t + (t >> 8)) >> 8).astype(np.uint8)


def draw_rectangle(width: int, height: int, color) -> RImage:
    """gstttmlrender.c:1196-1226 — premultiplied solid fill."""
    r, g, b, a = color
    px = np.array([_un8_mul(np.asarray(b), a),
                   _un8_mul(np.asarray(g), a),
                   _un8_mul(np.asarray(r), a), a], np.uint8)
    return RImage(np.broadcast_to(
        px, (max(height, 0), max(width, 0), 4)).copy())


def combine(i1: Optional[RImage], i2: Optional[RImage]
            ) -> Optional[RImage]:
    """rendered_image_combine (:2330-2400): union canvas, i1 copied,
    i2 OVER on top."""
    if i1 is None and i2 is None:
        return None
    if i1 is not None and (i2 is None or i2.img is None):
        return RImage(None if i1.img is None else i1.img.copy(),
                      i1.x, i1.y)
    if i2 is not None and (i1 is None or i1.img is None):
        return RImage(None if i2.img is None else i2.img.copy(),
                      i2.x, i2.y)
    x = min(i1.x, i2.x)
    y = min(i1.y, i2.y)
    w = max(i1.x + i1.width, i2.x + i2.width) - x
    h = max(i1.y + i1.height, i2.y + i2.height) - y
    canvas = np.zeros((h, w, 4), np.uint8)
    canvas[i1.y - y:i1.y - y + i1.height,
           i1.x - x:i1.x - x + i1.width] = i1.img
    y2, x2 = i2.y - y, i2.x - x
    region = canvas[y2:y2 + i2.height, x2:x2 + i2.width]
    canvas[y2:y2 + i2.height, x2:x2 + i2.width] = \
        composite_over_u8(region, i2.img)
    return RImage(canvas, x, y)


def crop(image: RImage, x: int, y: int, width: int, height: int
         ) -> Optional[RImage]:
    """rendered_image_crop (:2404-2475)."""
    if (x <= image.x and y <= image.y and width >= image.width
            and height >= image.height):
        return RImage(image.img.copy(), image.x, image.y)
    if (image.x >= x + width or image.x + image.width <= x
            or image.y >= y + height or image.y + image.height <= y):
        return None
    rx = max(image.x, x)
    ry = max(image.y, y)
    rw = min(image.x + image.width - rx, x + width - rx)
    rh = min(image.y + image.height - ry, y + height - ry)
    sub = image.img[ry - image.y:ry - image.y + rh,
                    rx - image.x:rx - image.x + rw]
    return RImage(sub.copy(), rx, ry)


def overlay_images(images: List[RImage]) -> Optional[RImage]:
    ret = None
    for im in images:
        ret = combine(ret, im)
    return ret


def stitch_images(images: List[RImage], block_direction: bool
                  ) -> Optional[RImage]:
    """stitch_images (:2510-2540): contiguous placement walk."""
    cur = 0
    for im in images:
        if block_direction:
            im.y += cur
            cur = im.y + im.height
        else:
            im.x += cur
            cur = im.x + im.width
    return overlay_images(images)


# -- unified blocks -----------------------------------------------------------

@dataclass
class UnifiedElement:
    style: StyleSet
    suppress_whitespace: bool
    pango_font_size: int
    metrics_height: int
    metrics_baseline: int
    text: bytes                    # byte-indexed like the C


@dataclass
class UnifiedBlock:
    style: StyleSet
    elements: List[UnifiedElement] = field(default_factory=list)

    @property
    def joined_text(self) -> bytes:
        return b"".join(ue.text for ue in self.elements)

    def clone(self) -> "UnifiedBlock":
        return UnifiedBlock(self.style, [
            UnifiedElement(ue.style, ue.suppress_whitespace,
                           ue.pango_font_size, ue.metrics_height,
                           ue.metrics_baseline, ue.text)
            for ue in self.elements])


class PangoRenderer:
    """One render context (the reference's GstTtmlRender layout +
    frame dimensions)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.layout = pc.shared_layout()
        self._metrics_cache = {}

    # gstttmlrender.c:1432-1450
    def font_metrics(self, ss: StyleSet, font_size: int
                     ) -> Tuple[int, int]:
        key = (ss.font_family, ss.font_style, ss.font_weight,
               ss.text_decoration, font_size)
        hit = self._metrics_cache.get(key)
        if hit is not None:
            return hit
        markup = generate_pango_markup(ss, font_size, METRICS_PROBE)
        self.layout.set_markup(markup)
        self.layout.set_width(-1)
        ink, _ = self.layout.pixel_extents()
        ret = (ink.height, self.layout.baseline_pixels() - ink.y)
        self._metrics_cache[key] = ret
        return ret

    # gstttmlrender.c:1458-1476
    def pango_font_size(self, ss: StyleSet) -> int:
        desired = math.ceil(ss.font_size * self.height)
        font_size = desired
        rendered = 1 << 30
        while rendered > desired and font_size > 0:
            rendered, _ = self.font_metrics(ss, font_size)
            font_size -= 1
        return font_size + 1

    def unify_block(self, block: Block) -> UnifiedBlock:
        ub = UnifiedBlock(block.style)
        for el in block.elements:
            size = self.pango_font_size(el.style)
            mh, mb = self.font_metrics(el.style, size)
            ub.elements.append(UnifiedElement(
                el.style, el.suppress_whitespace, size, mh, mb,
                el.text.encode()))
        return ub

    # gstttmlrender.c:2225-2270
    def block_metrics(self, ub: UnifiedBlock) -> Tuple[int, int]:
        if ub.style.line_height < 0:      # lineHeight="normal"
            max_h = 0
            descender = 0
            for ue in ub.elements:
                if ue.metrics_height > max_h:
                    max_h = ue.metrics_height
                    descender = ue.metrics_height - ue.metrics_baseline
            line_height = math.ceil(max_h * 1.25)
            baseline_offset = int((max_h + line_height) / 2.0) \
                - descender
        else:
            counts = {}
            for ue in ub.elements:
                d = ue.metrics_height - ue.metrics_baseline
                counts[d] = counts.get(d, 0) \
                    + len(ue.text.decode("utf-8", "replace"))
            descender = 0
            max_count = 0
            for d, c in counts.items():
                if c > max_count:
                    max_count = c
                    descender = d
            font_size = math.ceil(ub.style.font_size * self.height)
            line_height = math.ceil(font_size * ub.style.line_height)
            baseline_offset = int((font_size + line_height) / 2.0) \
                - descender
        return line_height, baseline_offset

    def block_markup(self, ub: UnifiedBlock) -> str:
        return "".join(
            generate_pango_markup(ue.style, ue.pango_font_size,
                                  ue.text.decode("utf-8", "replace"))
            for ue in ub.elements)

    # gstttmlrender.c:1522-1537
    @staticmethod
    def _nearest_breakpoint(joined: bytes, index: int) -> int:
        # walk UTF-8 chars strictly before byte index-1
        pos = index - 1
        while pos > 0:
            pos -= 1
            while pos > 0 and (joined[pos] & 0xC0) == 0x80:
                pos -= 1                  # utf8_find_prev_char
            if joined[pos] in (0x20, 0x09, 0x0D):
                return pos
        return -1

    # gstttmlrender.c:1570-1676
    def line_char_ranges(self, ub: UnifiedBlock, width: int,
                         wrap: bool) -> List[Tuple[int, int]]:
        joined = ub.joined_text
        ranges: List[List[int]] = []
        start = 0
        while start < len(joined):
            c = start
            while c < len(joined) and joined[c] != 0x0A:
                c += 1
            ranges.append([start, c - 1])
            start = c + 1
        if not wrap:
            return [tuple(r) for r in ranges]
        self.layout.set_markup(self.block_markup(ub))
        self.layout.set_width(-1)
        i = 0
        while i < len(ranges):
            within = True
            while within:
                rng = ranges[i]
                rect = self.layout.index_to_pos(rng[0])
                max_line_extent = rect.x + PANGO_SCALE * width
                within, end_index, _trailing = self.layout.xy_to_index(
                    max_line_extent, rect.y)
                if within:
                    end_index = self._nearest_breakpoint(joined,
                                                         end_index)
                    if end_index > rng[0]:
                        ranges.insert(i + 1, [end_index + 1, rng[1]])
                        rng[1] = end_index
                        i += 1
                    else:
                        within = False
            i += 1
        return [tuple(r) for r in ranges]

    # gstttmlrender.c:1683-1707
    @staticmethod
    def _element_index(ub: UnifiedBlock, char_index: int
                       ) -> Tuple[int, int]:
        joined = ub.joined_text
        if char_index < 0 or char_index >= len(joined):
            return -1, 0
        count = 0
        offset = 0
        for i, ue in enumerate(ub.elements):
            if count <= char_index < count + len(ue.text):
                return i, char_index - count
            count += len(ue.text)
        return len(ub.elements), offset

    # gstttmlrender.c:1841-1930
    def split_block(self, ub: UnifiedBlock,
                    ranges: List[Tuple[int, int]]
                    ) -> List[UnifiedBlock]:
        out = []
        for first, last in ranges:
            clone = ub.clone()
            index, last_offset = self._element_index(clone, last)
            if index < 0:
                continue
            del clone.elements[index + 1:]
            index, first_offset = self._element_index(clone, first)
            if index < 0:
                continue
            del clone.elements[:index]
            ue = clone.elements[0]
            if first_offset > 0:
                ue.text = ue.text[first_offset:]
                if len(clone.elements) == 1:
                    last_offset -= first_offset
            ue = clone.elements[-1]
            if last_offset < len(ue.text) - 1:
                ue.text = ue.text[:last_offset + 1]
            if clone.elements:
                out.append(clone)
        return out

    # gstttmlrender.c:1781-1838 (TTML 7.2.3 whitespace at line breaks)
    @staticmethod
    def handle_whitespace(blocks: List[UnifiedBlock]
                          ) -> List[UnifiedBlock]:
        out = []
        for ub in blocks:
            while ub.elements:
                ue = ub.elements[0]
                if not ue.suppress_whitespace:
                    break
                stripped = ue.text.lstrip(b" ")
                if stripped:
                    ue.text = stripped
                    break
                ub.elements.pop(0)
            while ub.elements:
                ue = ub.elements[-1]
                if not ue.suppress_whitespace:
                    break
                stripped = ue.text.rstrip(b" ")
                if stripped:
                    ue.text = stripped
                    break
                ub.elements.pop()
            if ub.elements:
                out.append(ub)
        return out

    # gstttmlrender.c:1937-2014
    def draw_text(self, markup: str, baseline_offset: int) -> RImage:
        self.layout.set_markup(markup)
        self.layout.set_width(-1)
        ink, logical = self.layout.pixel_extents()
        baseline = self.layout.baseline_pixels()
        bx1 = min(logical.x, ink.x)
        bx2 = max(logical.x + logical.width, ink.x + ink.width)
        by1 = min(logical.y, ink.y)
        by2 = max(logical.y + logical.height, ink.y + ink.height)
        full = self.layout.show(bx2 - bx1, by2 - by1)
        # crop: source offset (-bx1, -ink.y) into (bw, ink.height)
        bw, bh = bx2 - bx1, max(ink.height, 1)
        out = np.zeros((bh, bw, 4), np.uint8)
        sy0 = max(ink.y, 0)
        sx0 = max(bx1, 0)
        dy0 = sy0 - ink.y
        dx0 = sx0 - bx1
        h = min(full.shape[0] - sy0, bh - dy0)
        w = min(full.shape[1] - sx0, bw - dx0)
        if h > 0 and w > 0:
            out[dy0:dy0 + h, dx0:dx0 + w] = \
                full[sy0:sy0 + h, sx0:sx0 + w]
        return RImage(out, 0,
                      max(0, baseline_offset - (baseline - ink.y)))

    # gstttmlrender.c:2018-2077
    def render_block_elements(self, ub: UnifiedBlock,
                              line_height: int, baseline_offset: int
                              ) -> Optional[RImage]:
        line_padding = math.ceil(ub.style.line_padding * self.width)
        inline = []
        for i, ue in enumerate(ub.elements):
            markup = generate_pango_markup(
                ue.style, ue.pango_font_size,
                ue.text.decode("utf-8", "replace"))
            text_image = self.draw_text(markup, baseline_offset)
            if not ub.style.fill_line_gap:
                bg_offset = baseline_offset - ue.metrics_baseline
                bg_height = ue.metrics_height
            else:
                bg_offset = 0
                bg_height = line_height
            bg_width = text_image.width
            if line_padding > 0:
                if i == 0:
                    text_image.x += line_padding
                    bg_width += line_padding
                if i == len(ub.elements) - 1:
                    bg_width += line_padding
            bg_image = draw_rectangle(bg_width, bg_height,
                                      ue.style.background_color)
            bg_image.y = bg_offset
            inline.append(combine(bg_image, text_image))
        return stitch_images(inline, block_direction=False)

    # gstttmlrender.c:2085-2122
    @staticmethod
    def align_line_areas(lines: List[RImage], ss: StyleSet) -> None:
        longest = max((ln.width for ln in lines), default=0)
        for ln in lines:
            mra = ss.multi_row_align
            if mra == "auto":
                if ss.text_align == "center":
                    mra = "center"
                elif ss.text_align in ("end", "right"):
                    mra = "end"
            if mra == "center":
                ln.x += int(round((longest - ln.width) / 2.0))
            elif mra == "end":
                ln.x += longest - ln.width

    # gstttmlrender.c:2546-2588
    def render_text_block(self, block: Block, window_width: int
                          ) -> Optional[RImage]:
        ub = self.unify_block(block)
        if not ub.elements:
            return None
        line_height, baseline_offset = self.block_metrics(ub)
        wrap = any(el.style.wrap_option == "on"
                   for el in block.elements)
        line_padding = math.ceil(ub.style.line_padding * self.width)
        ranges = self.line_char_ranges(
            ub, window_width - 2 * line_padding, wrap)
        split = self.split_block(ub, ranges)
        split = self.handle_whitespace(split)
        if not split:
            return None
        lines = []
        for i, line_block in enumerate(split):
            line = self.render_block_elements(line_block, line_height,
                                              baseline_offset)
            if line is None:
                line = RImage(np.zeros((0, 0, 4), np.uint8))
            line.y += i * line_height
            lines.append(line)
        self.align_line_areas(lines, ub.style)
        return overlay_images(lines)

    # gstttmlrender.c:2615-2760
    def render_region(self, region: Region) -> Optional[RImage]:
        rs = region.style
        region_w = int(round(rs.extent_w * self.width)) or self.width
        region_h = int(round(rs.extent_h * self.height)) or self.height
        region_x = int(round(rs.origin_x * self.width))
        region_y = int(round(rs.origin_y * self.height))
        pad_s = int(round(rs.padding_start * self.width))
        pad_e = int(round(rs.padding_end * self.width))
        pad_b = int(round(rs.padding_before * self.height))
        pad_a = int(round(rs.padding_after * self.height))
        window_x = region_x + pad_s
        window_y = region_y + pad_b
        window_w = region_w - (pad_s + pad_e)
        window_h = region_h - (pad_b + pad_a)

        region_image = None
        if rs.background_color[3] != 0:
            region_image = draw_rectangle(region_w, region_h,
                                          rs.background_color)
            region_image.x = region_x
            region_image.y = region_y

        rendered_blocks = []
        for block in region.blocks:
            rb = self.render_text_block(block, window_w)
            if rb is None:
                continue
            if block.style.text_align == "center":
                rb.x += int(round((window_w - rb.width) / 2.0))
            elif block.style.text_align in ("right", "end"):
                rb.x += window_w - rb.width
            block_height = rb.height + 2 * rb.y
            bg = draw_rectangle(window_w, block_height,
                                block.style.background_color)
            rb = combine(bg, rb)
            rb.y = 0
            rendered_blocks.append(rb)

        if rendered_blocks:
            blocks_image = stitch_images(rendered_blocks,
                                         block_direction=True)
            blocks_image.x += window_x
            if rs.display_align == "before":
                blocks_image.y = window_y
            elif rs.display_align == "center":
                blocks_image.y = region_y + int(
                    (region_h + pad_b)
                    - (pad_a + blocks_image.height)) // 2
            else:                       # after
                blocks_image.y = (region_y + region_h) \
                    - (pad_a + blocks_image.height)
            if rs.overflow == "hidden" and (
                    blocks_image.height > window_h
                    or blocks_image.width > window_w):
                blocks_image = crop(blocks_image, window_x, window_y,
                                    window_w, window_h)
            region_image = combine(region_image, blocks_image)
        return region_image


def render_scene(scene: SceneOut, width: int, height: int
                 ) -> np.ndarray:
    """Full-frame premultiplied B,G,R,A overlay of one scene through
    the reference render pipeline."""
    renderer = PangoRenderer(width, height)
    frame = np.zeros((height, width, 4), np.uint8)
    for region in scene.regions:
        ri = renderer.render_region(region)
        if ri is None or ri.img is None or not ri.width:
            continue
        clipped = crop(ri, 0, 0, width, height)
        if clipped is None:
            continue
        y, x = clipped.y, clipped.x
        sub = frame[y:y + clipped.height, x:x + clipped.width]
        frame[y:y + clipped.height, x:x + clipped.width] = \
            composite_over_u8(sub, clipped.img)
    return frame
