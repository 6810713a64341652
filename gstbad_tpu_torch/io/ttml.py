"""(A copy of gstbad_tpu/io/ttml.py, numpy only.)

TTML / EBU-TT-D parser (ext/ttml/ttmlparse.c) — the scene model
behind the ttmlrender element.

Transcribes ttmlparse.c's full pipeline:
- document framing: requires "<?xml" and "</tt>" in the input, consumes
  through the end tag (ttml_parse, ttmlparse.c:1931-1959);
- cellResolution (default 32x15) and xml:space document defaults;
- element parse (style/region/body/div/p/span/br + anonymous text
  spans), begin/end timecodes (hours:minutes:seconds[.fraction] with
  the fraction scaled by 10^(3-digits) to milliseconds,
  ttmlparse.c:279-327);
- whitespace handling per TTML 7.2.3 (LF/TAB become spaces, runs of
  space/CR collapse) unless xml:space="preserve" is inherited;
- content filtering (text only significant inside <p>/<span>),
- leaf timing resolution (nearest timed ancestor; untimed leaves get
  the 24-hour Root Temporal Extent), leaf region resolution;
- region splitting (one tree per <region>, keeping only nodes in or
  above that region... note the reference's condition at
  ttmlparse.c:1424-1430 only region-prunes non-BR nodes: its
  `type == ANON_SPAN || type != BR` is always true for anything but
  BR — transcribed with the same effect);
- referenced-style merge, style inheritance (anon spans/BR merge the
  full parent set; others inherit all but the non-inheriting
  attributes backgroundColor/origin/extent/displayAlign/overflow/
  padding/writingMode/showBackground/unicodeBidi; nested relative
  fontSize multiplies, ttmlparse.c:726-790);
- region time assignment for opaque showBackground="always" regions;
- scene creation at every begin/end transition and inline-element
  joining of equal-styled adjacent anon spans/BRs;
- computed style sets with the reference's defaults and scalings
  (fontSize /100 then /cellres_y, linePadding /cellres_x, origin/
  extent /100 with the >1.0 clamps, padding shorthand orders scaled
  by the region extent, subtitle.c:59-83 defaults).

The renderer counterpart (gstttmlrender.c) lays glyphs out with
Pango/Cairo; render_scene() here implements the same layout geometry
(region origin/extent/padding, block stacking with displayAlign, line
wrapping with linePadding, textAlign, per-element background rects,
fill_line_gap) over the framework's fixed-advance bitmap face —
documented divergence, same family as ceaccoverlay's."""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_CELLRES_X = 32
DEFAULT_CELLRES_Y = 15
NSECONDS_IN_DAY = 24 * 3600 * 10 ** 9
CLOCK_NONE = None

_STYLE_NS = ("http://www.w3.org/ns/ttml#styling",
             "http://www.w3.org/ns/ttml/profile/imsc1#styling",
             "urn:ebu:tt:style")
_XML_NS = "http://www.w3.org/XML/1998/namespace"

(T_STYLE, T_REGION, T_BODY, T_DIV, T_P, T_SPAN, T_ANON, T_BR) = range(8)

_NON_INHERITED = ("backgroundColor", "origin", "extent", "displayAlign",
                  "overflow", "padding", "writingMode", "showBackground",
                  "unicodeBidi")

(WS_NONE, WS_DEFAULT, WS_PRESERVE) = range(3)


@dataclass
class TtmlElement:
    type: int
    id: Optional[str] = None
    whitespace_mode: int = WS_NONE
    styles: Optional[List[str]] = None
    region: Optional[str] = None
    begin: Optional[int] = None
    end: Optional[int] = None
    style_set: Optional[Dict[str, str]] = None
    text: Optional[str] = None


class Node:
    def __init__(self, data: TtmlElement):
        self.data = data
        self.children: List["Node"] = []
        self.parent: Optional["Node"] = None

    def append(self, child: "Node"):
        child.parent = self
        self.children.append(child)

    def walk(self):
        yield self
        for c in list(self.children):
            yield from c.walk()

    def leaves(self):
        if not self.children:
            yield self
        for c in list(self.children):
            if c.children:
                yield from c.leaves()
            else:
                yield c

    def remove(self):
        if self.parent:
            self.parent.children.remove(self)

    def copy(self) -> "Node":
        n = Node(replace(self.data,
                         styles=list(self.data.styles)
                         if self.data.styles else None,
                         style_set=dict(self.data.style_set)
                         if self.data.style_set else None))
        for c in self.children:
            n.append(c.copy())
        return n


def _local(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


def _prop(el: ET.Element, name: str) -> Optional[str]:
    """xmlGetProp analog: match the attribute by local name in any
    namespace (bare name wins)."""
    if name in el.attrib:
        return el.attrib[name]
    for k, v in el.attrib.items():
        if k.startswith("{") and _local(k) == name:
            return v
    return None


def parse_timecode(s: str) -> Optional[int]:
    """hours:minutes:seconds[.fraction] -> ns
    (ttml_parse_timecode, ttmlparse.c:279-327)."""
    parts = s.split(":", 2)
    if len(parts) != 3:
        return None
    hours = int(parts[0] or 0)
    minutes = int(parts[1] or 0)
    ms = 0
    if "." in parts[2]:
        sec_s, frac = parts[2].split(".", 1)
        seconds = int(sec_s or 0)
        n = len(frac)
        ms = int(int(frac or 0) * (10.0 ** (3 - n)))
    else:
        seconds = int(parts[2] or 0)
    return (hours * 3600 + minutes * 60 + seconds) * 10 ** 9 \
        + ms * 10 ** 6


def parse_colorstring(color: Optional[str]
                      ) -> Tuple[int, int, int, int]:
    """#RRGGBB / #RRGGBBAA -> (r, g, b, a); invalid -> all zero."""
    if not color:
        return (0, 0, 0, 0)
    if len(color) in (7, 9) and color[0] == "#":
        try:
            r = int(color[1:3], 16)
            g = int(color[3:5], 16)
            b = int(color[5:7], 16)
            a = int(color[7:9], 16) if len(color) == 9 else 255
            return (r, g, b, a)
        except ValueError:
            return (0, 0, 0, 0)
    return (0, 0, 0, 0)


def _parse_style_set(el: ET.Element) -> Optional[Dict[str, str]]:
    if _prop(el, "id") is None:
        return None
    out = {}
    for k, v in el.attrib.items():
        if k.startswith("{") and k[1:].split("}")[0] in _STYLE_NS:
            out[_local(k)] = v
    return out


_TYPE_BY_NAME = {"style": T_STYLE, "region": T_REGION, "body": T_BODY,
                 "div": T_DIV, "p": T_P, "span": T_SPAN, "br": T_BR}


def _parse_element(el: ET.Element) -> Optional[TtmlElement]:
    name = _local(el.tag)
    if name not in _TYPE_BY_NAME:
        return None
    e = TtmlElement(type=_TYPE_BY_NAME[name])
    e.id = _prop(el, "id")
    styles = _prop(el, "style")
    if styles:
        e.styles = styles.split(" ")
    if e.type in (T_STYLE, T_REGION):
        e.style_set = _parse_style_set(el)
    e.region = _prop(el, "region")
    v = _prop(el, "begin")
    e.begin = parse_timecode(v) if v else None
    v = _prop(el, "end")
    e.end = parse_timecode(v) if v else None
    if e.type == T_BR:
        e.text = "\n"
    v = el.attrib.get(f"{{{_XML_NS}}}space") or el.attrib.get("space")
    if v == "preserve":
        e.whitespace_mode = WS_PRESERVE
    elif v == "default":
        e.whitespace_mode = WS_DEFAULT
    return e


def _anon(text: str) -> TtmlElement:
    return TtmlElement(type=T_ANON, text=text)


def _parse_body(el: ET.Element) -> Optional[Node]:
    e = _parse_element(el)
    if e is None:
        return None
    node = Node(e)
    if el.text:
        node.append(Node(_anon(el.text)))
    for child in el:
        sub = _parse_body(child)
        if sub is not None:
            node.append(sub)
        if child.tail:
            node.append(Node(_anon(child.tail)))
    return node


# -- whitespace / filtering -------------------------------------------------

def _inherit_whitespace(tree: Node, doc_mode: int) -> None:
    for n in tree.walk():
        if n.data.whitespace_mode != WS_NONE:
            continue
        n.data.whitespace_mode = (doc_mode if n.parent is None
                                  else n.parent.data.whitespace_mode)


def _collapse_whitespace(tree: Node) -> None:
    for n in tree.leaves():
        e = n.data
        if not e.text or e.type == T_BR \
                or e.whitespace_mode == WS_PRESERVE:
            continue
        t = e.text.replace("\n", " ").replace("\t", " ")
        t = re.sub("[ \r]+", " ", t)
        e.text = t


def _filter_content(node: Node) -> Optional[Node]:
    for c in list(node.children):
        _filter_content(c)
    parent = node.parent.data if node.parent else None
    if node.data.type == T_ANON and parent is not None \
            and parent.type not in (T_P, T_SPAN):
        node.remove()
        return None
    return node


# -- timing / region resolution ---------------------------------------------

def _apply_time_window(tree: Node, begin: int, end: int) -> None:
    for n in list(tree.walk()):
        e = n.data
        if e.begin is None:
            continue
        if e.begin > end or (e.end is not None and e.end < begin):
            n.remove()
            continue
        e.begin = max(e.begin, begin)
        if e.end is not None:
            e.end = min(e.end, end)


def _resolve_timings(tree: Node) -> None:
    for leaf in tree.leaves():
        e = leaf.data
        if e.begin is not None and e.end is not None:
            continue
        node = leaf
        anc = e
        while node.parent and anc.begin is None:
            node = node.parent
            anc = node.data
        if anc.begin is None:
            e.begin, e.end = 0, NSECONDS_IN_DAY
        else:
            e.begin, e.end = anc.begin, anc.end


def _resolve_regions(tree: Node) -> None:
    for leaf in tree.leaves():
        node = leaf
        while node.parent and node.data.region is None:
            node = node.parent
        if node.data.region:
            leaf.data.region = node.data.region


def _remove_nodes_by_region(node: Node, region: str) -> Optional[Node]:
    for c in list(node.children):
        _remove_nodes_by_region(c, region)
    e = node.data
    # reference quirk: (type == ANON_SPAN || type != BR) is true for
    # every type except BR — BR nodes never get region-pruned
    if e.type != T_BR and e.region is not None and e.region != region:
        node.remove()
        return None
    if e.type not in (T_ANON, T_BR) and not node.children:
        node.remove()
        return None
    return node


def _split_by_region(body: Node, regions: Dict[str, TtmlElement]
                     ) -> List[Node]:
    out = []
    for name, region in regions.items():
        region_node = Node(replace(
            region, style_set=dict(region.style_set or {})))
        body_copy = body.copy()
        body_copy = _remove_nodes_by_region(body_copy, name)
        if body_copy is not None:
            region_node.append(body_copy)
        out.append(region_node)
    return out


# -- styles -----------------------------------------------------------------

def _merge(set1, set2):
    """set2 overrides set1 (full merge)."""
    if set1 is None and set2 is None:
        return None
    out = dict(set1 or {})
    out.update(set2 or {})
    return out


def _inherit(parent, child):
    """Inheritance: child keeps its values; parent's inheritable
    attributes fill in; nested fontSize percentages multiply."""
    out = dict(child or {})
    if not parent:
        return out
    for k, v in parent.items():
        if k == "fontSize" and "fontSize" in out:
            psize = int(re.match(r"\d+", v).group()) \
                if re.match(r"\d+", v) else 100
            csize = int(re.match(r"\d+", out["fontSize"]).group()) \
                if re.match(r"\d+", out["fontSize"]) else 100
            out["fontSize"] = f"{(csize * psize) // 100}%"
            continue
        if k in _NON_INHERITED:
            continue
        out.setdefault(k, v)
    return out


def _resolve_referenced_styles(trees: List[Node],
                               styles: Dict[str, TtmlElement]) -> None:
    for tree in trees:
        for n in tree.walk():
            if not n.data.styles:
                continue
            for sid in n.data.styles:
                style = styles.get(sid)
                if style:
                    n.data.style_set = _merge(n.data.style_set,
                                              style.style_set)


def _inherit_styles(trees: List[Node]) -> None:
    for tree in trees:
        for n in tree.walk():
            if not n.parent:
                continue
            pset = n.parent.data.style_set
            if not pset:
                continue
            if n.data.type in (T_ANON, T_BR):
                n.data.style_set = _merge(pset, n.data.style_set)
                n.data.styles = list(n.parent.data.styles) \
                    if n.parent.data.styles else None
            else:
                n.data.style_set = _inherit(pset, n.data.style_set)


def _assign_region_times(trees: List[Node], doc_begin, doc_duration
                         ) -> None:
    for region_node in trees:
        e = region_node.data
        ss = e.style_set or {}
        always = ss.get("showBackground") != "whenActive"
        color = parse_colorstring(ss.get("backgroundColor")) \
            if "backgroundColor" in ss else (0, 0, 0, 0)
        if always and color[3] != 0:
            e.begin = doc_begin if doc_begin is not None else 0
            e.end = (e.begin + doc_duration) \
                if doc_duration is not None else NSECONDS_IN_DAY


# -- scenes -----------------------------------------------------------------

def _next_transition(trees: List[Node], time) -> Optional[int]:
    best = None
    for tree in trees:
        for n in tree.walk():
            e = n.data
            if e.begin is not None and \
                    (time is None or e.begin > time):
                if best is None or e.begin < best:
                    best = e.begin
            if e.end is not None and time is not None \
                    and e.end > time:
                if best is None or e.end < best:
                    best = e.end
    return best


def _remove_by_time(node: Node, time: int) -> Optional[Node]:
    for c in list(node.children):
        _remove_by_time(c, time)
    e = node.data
    if not node.children and (
            (e.begin is not None and e.begin > time)
            or (e.end is not None and e.end <= time)
            or e.begin is None):
        node.remove()
        return None
    return node


@dataclass
class Scene:
    begin: int
    end: int
    trees: List[Node] = field(default_factory=list)


def _create_scenes(region_trees: List[Node]) -> List[Scene]:
    scenes: List[Scene] = []
    cur: Optional[Scene] = None
    t = None
    while True:
        t = _next_transition(region_trees, t)
        if t is None:
            break
        if cur is not None:
            cur.end = t
            scenes.append(cur)
        active = []
        for tree in region_trees:
            root = _remove_by_time(tree.copy(), t)
            if root is not None:
                active.append(root)
        cur = Scene(begin=t, end=t, trees=active) if active else None
    return scenes


def _styles_match(e1: TtmlElement, e2: TtmlElement) -> bool:
    if (e1.styles is None) != (e2.styles is None):
        return False
    if e1.styles is None:
        return True
    return e1.styles == e2.styles


def _join_inline(tree: Node) -> None:
    for n in list(tree.children):
        _join_inline(n)
    # promote single-child spans
    for n in list(tree.children):
        if n.data.type == T_SPAN and len(n.children) == 1:
            child = n.children[0]
            idx = tree.children.index(n)
            tree.children[idx] = child
            child.parent = tree
    # join adjacent joinable siblings with equal styles
    i = 0
    while i + 1 < len(tree.children):
        e1 = tree.children[i].data
        e2 = tree.children[i + 1].data
        if e1.type in (T_ANON, T_BR) and e2.type in (T_ANON, T_BR) \
                and _styles_match(e1, e2):
            e1.text = (e1.text or "") + (e2.text or "")
            e1.type = T_ANON
            del tree.children[i + 1]
        else:
            i += 1


# -- computed styles --------------------------------------------------------

@dataclass
class StyleSet:
    """GstSubtitleStyleSet with the reference defaults
    (subtitle.c:59-83) + ttml_update_style_set scalings."""
    text_direction: str = "ltr"
    font_family: str = "default"
    font_size: float = 1.0
    line_height: float = -1.0
    text_align: str = "start"
    color: Tuple[int, int, int, int] = (255, 255, 255, 255)
    background_color: Tuple[int, int, int, int] = (0, 0, 0, 0)
    font_style: str = "normal"
    font_weight: str = "normal"
    text_decoration: str = "none"
    unicode_bidi: str = "normal"
    wrap_option: str = "on"
    multi_row_align: str = "auto"
    line_padding: float = 0.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    extent_w: float = 0.0
    extent_h: float = 0.0
    display_align: str = "before"
    padding_start: float = 0.0
    padding_end: float = 0.0
    padding_before: float = 0.0
    padding_after: float = 0.0
    writing_mode: str = "lrtb"
    show_background: str = "always"
    overflow: str = "hidden"
    fill_line_gap: bool = False


def _num(s: str) -> float:
    m = re.search(r"[-+]?\d+(\.\d+)?", s)
    return float(m.group()) if m else 0.0


def update_style_set(ss: StyleSet, tss: Optional[Dict[str, str]],
                     cellres_x: int, cellres_y: int) -> StyleSet:
    """ttml_update_style_set (ttmlparse.c:448-670)."""
    tss = tss or {}
    a = tss.get("textDirection")
    if a:
        ss.text_direction = "rtl" if a == "rtl" else "ltr"
    a = tss.get("fontFamily")
    if a and len(a) <= 128:
        ss.font_family = a
    a = tss.get("fontSize")
    if a:
        ss.font_size = _num(a) / 100.0
    ss.font_size *= 1.0 / cellres_y
    a = tss.get("lineHeight")
    if a:
        ss.line_height = -1 if a == "normal" else _num(a) / 100.0
    a = tss.get("textAlign")
    if a:
        ss.text_align = a if a in ("left", "center", "right", "end") \
            else "start"
    a = tss.get("color")
    if a:
        ss.color = parse_colorstring(a)
    a = tss.get("backgroundColor")
    if a:
        ss.background_color = parse_colorstring(a)
    a = tss.get("fontStyle")
    if a:
        ss.font_style = "italic" if a == "italic" else "normal"
    a = tss.get("fontWeight")
    if a:
        ss.font_weight = "bold" if a == "bold" else "normal"
    a = tss.get("textDecoration")
    if a:
        ss.text_decoration = "underline" if a == "underline" else "none"
    a = tss.get("wrapOption")
    if a:
        ss.wrap_option = "off" if a == "noWrap" else "on"
    a = tss.get("multiRowAlign")
    if a:
        ss.multi_row_align = a if a in ("start", "center", "end") \
            else "auto"
    a = tss.get("linePadding")
    if a:
        ss.line_padding = _num(a) * (1.0 / cellres_x)
    a = tss.get("origin")
    if a:
        nums = re.findall(r"[-+]?\d+(?:\.\d+)?", a)
        if len(nums) >= 2:
            ss.origin_x = float(nums[0]) / 100.0
            ss.origin_y = float(nums[1]) / 100.0
    a = tss.get("extent")
    if a:
        nums = re.findall(r"[-+]?\d+(?:\.\d+)?", a)
        if len(nums) >= 2:
            ss.extent_w = float(nums[0]) / 100.0
            if ss.origin_x + ss.extent_w > 1.0:
                ss.extent_w = 1.0 - ss.origin_x
            ss.extent_h = float(nums[1]) / 100.0
            if ss.origin_y + ss.extent_h > 1.0:
                ss.extent_h = 1.0 - ss.origin_y
    a = tss.get("displayAlign")
    if a:
        ss.display_align = a if a in ("center", "after") else "before"
    a = tss.get("padding")
    if a:
        decs = [d.strip() for d in a.split("%")[:-1]]
        vals = [float(d) / 100.0 for d in decs if d != ""]
        if len(vals) == 1:
            ss.padding_start = ss.padding_end = vals[0]
            ss.padding_before = ss.padding_after = vals[0]
        elif len(vals) == 2:
            ss.padding_before = ss.padding_after = vals[0]
            ss.padding_start = ss.padding_end = vals[1]
        elif len(vals) == 3:
            ss.padding_before = vals[0]
            ss.padding_start = ss.padding_end = vals[1]
            ss.padding_after = vals[2]
        elif len(vals) >= 4:
            ss.padding_before = vals[0]
            ss.padding_end = vals[1]
            ss.padding_after = vals[2]
            ss.padding_start = vals[3]
        # scale from region-relative to display-relative
        ss.padding_before *= ss.extent_h
        ss.padding_after *= ss.extent_h
        ss.padding_end *= ss.extent_w
        ss.padding_start *= ss.extent_w
    a = tss.get("writingMode")
    if a:
        if a.startswith("rl"):
            ss.writing_mode = "rltb"
        elif a in ("tbrl", "tb"):
            ss.writing_mode = "tbrl"
        elif a == "tblr":
            ss.writing_mode = "tblr"
        else:
            ss.writing_mode = "lrtb"
    a = tss.get("showBackground")
    if a:
        ss.show_background = "whenActive" if a == "whenActive" \
            else "always"
    a = tss.get("overflow")
    if a:
        ss.overflow = "visible" if a == "visible" else "hidden"
    if tss.get("fillLineGap") == "true":
        ss.fill_line_gap = True
    return ss


# -- output model -----------------------------------------------------------

@dataclass
class SubElement:
    style: StyleSet
    text: str
    suppress_whitespace: bool


@dataclass
class Block:
    style: StyleSet
    elements: List[SubElement]


@dataclass
class Region:
    style: StyleSet
    blocks: List[Block]


@dataclass
class SceneOut:
    begin: int
    end: int
    regions: List[Region]


def _blend(c1, c2):
    """ttml_blend_colors: c2 wins unless fully transparent."""
    return c1 if c2[3] == 0 else c2


def _build_region(tree: Node, cx: int, cy: int) -> Region:
    region_el = tree.data
    region = Region(update_style_set(StyleSet(), region_el.style_set,
                                     cx, cy), [])
    if not tree.children:
        return region
    body = tree.children[0]
    block_color = parse_colorstring(
        (body.data.style_set or {}).get("backgroundColor"))
    for div in body.children:
        if div.data.type != T_DIV:
            continue
        div_color = parse_colorstring(
            (div.data.style_set or {}).get("backgroundColor"))
        block_color = _blend(block_color, div_color)
        for p in div.children:
            if p.data.type != T_P:
                continue
            p_color = parse_colorstring(
                (p.data.style_set or {}).get("backgroundColor"))
            block_color = _blend(block_color, p_color)
            bstyle = update_style_set(StyleSet(), p.data.style_set,
                                      cx, cy)
            bstyle.background_color = block_color
            block = Block(bstyle, [])

            def add(el: TtmlElement):
                st = update_style_set(StyleSet(), el.style_set, cx, cy)
                block.elements.append(SubElement(
                    st, el.text or "",
                    el.whitespace_mode != WS_PRESERVE))

            for content in p.children:
                e = content.data
                if e.type in (T_BR, T_ANON):
                    add(e)
                elif e.type == T_SPAN:
                    for anon in content.children:
                        if anon.data.type in (T_BR, T_ANON):
                            add(anon.data)
            if block.elements:
                region.blocks.append(block)
    return region


def ttml_parse(input_str: str, begin: Optional[int] = None,
               duration: Optional[int] = None
               ) -> Tuple[List[SceneOut], int]:
    """-> (scenes, consumed bytes); ([], 0) when the <?xml / </tt>
    framing is incomplete (need more data)."""
    start = input_str.find("<?xml")
    end = input_str.find("</tt>")
    if start < 0 or end < 0:
        return [], 0
    consumed = end + len("</tt>")
    doc = input_str[start:consumed]
    try:
        root = ET.fromstring(doc)
    except ET.ParseError:
        return [], 0
    if _local(root.tag) != "tt":
        return [], 0
    cellres = _prop(root, "cellResolution")
    if cellres:
        nums = re.findall(r"\d+", cellres)
        cx, cy = int(nums[0]), int(nums[1])
    else:
        cx, cy = DEFAULT_CELLRES_X, DEFAULT_CELLRES_Y
    doc_ws = WS_PRESERVE if (
        root.attrib.get(f"{{{_XML_NS}}}space") == "preserve"
        or root.attrib.get("space") == "preserve") else WS_DEFAULT

    styles: Dict[str, TtmlElement] = {}
    regions: Dict[str, TtmlElement] = {}
    for child in root:
        if _local(child.tag) == "head":
            for sub in child:
                if _local(sub.tag) == "styling":
                    for s in sub:
                        if _local(s.tag) == "style":
                            e = _parse_element(s)
                            if e:
                                styles[e.id] = e
                elif _local(sub.tag) == "layout":
                    for r in sub:
                        if _local(r.tag) == "region":
                            e = _parse_element(r)
                            if e:
                                regions[e.id] = e
    body_el = next((c for c in root if _local(c.tag) == "body"), None)
    if body_el is None:
        return [], consumed

    body = _parse_body(body_el)
    _inherit_whitespace(body, doc_ws)
    _collapse_whitespace(body)
    _filter_content(body)
    if begin is not None and duration is not None:
        _apply_time_window(body, begin, begin + duration)
    _resolve_timings(body)
    _resolve_regions(body)
    trees = _split_by_region(body, regions)
    _resolve_referenced_styles(trees, styles)
    _inherit_styles(trees)
    _assign_region_times(trees, begin, duration)
    scenes = _create_scenes(trees)
    for scene in scenes:
        for tree in scene.trees:
            _join_inline(tree)
    out = []
    for scene in scenes:
        regions_out = [_build_region(t, cx, cy) for t in scene.trees]
        out.append(SceneOut(scene.begin, scene.end, regions_out))
    return out, consumed


# -- rendering (the gstttmlrender.c geometry; bitmap face) -------------------

def _glyph_atlas():
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "data",
                        "cc_font.npz")
    with np.load(path) as z:
        return z["atlas"] > 0, int(z["first"])


_ATLAS = None


def _glyph(ch: int, h: int, w: int) -> np.ndarray:
    global _ATLAS
    if _ATLAS is None:
        _ATLAS = _glyph_atlas()
    atlas, first = _ATLAS
    idx = ch - first
    if idx < 0 or idx >= atlas.shape[0]:
        idx = 0
    g = atlas[idx]
    ys = (np.arange(h) * g.shape[0]) // h
    xs = (np.arange(w) * g.shape[1]) // w
    return g[np.ix_(ys, xs)]


def render_scene(scene: SceneOut, width: int, height: int
                 ) -> np.ndarray:
    """[height, width, 4] RGBA overlay of one scene (layout geometry
    per gstttmlrender.c over the bitmap face — module doc)."""
    out = np.zeros((height, width, 4), np.uint8)
    for region in scene.regions:
        rs = region.style
        rx = int(rs.origin_x * width)
        ry = int(rs.origin_y * height)
        rw = int(rs.extent_w * width) or width
        rh = int(rs.extent_h * height) or height
        rx2, ry2 = min(rx + rw, width), min(ry + rh, height)
        if rs.background_color[3]:
            out[ry:ry2, rx:rx2] = rs.background_color
        if not region.blocks:
            continue
        pad_s = int(rs.padding_start * width)
        pad_e = int(rs.padding_end * width)
        pad_b = int(rs.padding_before * height)
        pad_a = int(rs.padding_after * height)
        inner_x = rx + pad_s
        inner_w = max(1, (rx2 - pad_e) - inner_x)

        # lay all blocks out into (line) lists first to know the stack
        # height for displayAlign
        rendered_blocks = []
        for block in region.blocks:
            bs = block.style
            font_h = max(4, int(bs.font_size * height))
            char_w = max(2, int(font_h * 14 / 26))
            line_h = font_h if bs.line_height < 0 \
                else int(bs.line_height * font_h)
            lpad = int(bs.line_padding * width)
            maxchars = max(1, (inner_w - 2 * lpad) // char_w)
            # split elements into (char, style) runs and wrap
            lines: List[List[Tuple[str, StyleSet]]] = [[]]
            for el in block.elements:
                for ch in el.text:
                    if ch == "\n":
                        lines.append([])
                    else:
                        lines[-1].append((ch, el.style))
            wrapped: List[List[Tuple[str, StyleSet]]] = []
            for line in lines:
                if bs.wrap_option == "off" or len(line) <= maxchars:
                    wrapped.append(line)
                    continue
                cur = line
                while len(cur) > maxchars:
                    cut = maxchars
                    for k in range(maxchars, 0, -1):
                        if cur[k - 1][0] == " ":
                            cut = k
                            break
                    wrapped.append(cur[:cut])
                    cur = cur[cut:]
                wrapped.append(cur)
            rendered_blocks.append(
                (bs, font_h, char_w, line_h, lpad, wrapped))

        total_h = sum(len(w_) * lh
                      for (_b, _f, _c, lh, _l, w_) in rendered_blocks)
        if rs.display_align == "after":
            y = (ry2 - pad_a) - total_h
        elif rs.display_align == "center":
            y = ry + pad_b + ((ry2 - ry - pad_b - pad_a) - total_h) // 2
        else:
            y = ry + pad_b

        for (bs, font_h, char_w, line_h, lpad, wrapped) in \
                rendered_blocks:
            for li, line in enumerate(wrapped):
                lw = len(line) * char_w + 2 * lpad
                if bs.text_align in ("center",):
                    x = inner_x + (inner_w - lw) // 2
                elif bs.text_align in ("right", "end"):
                    x = inner_x + inner_w - lw
                else:
                    x = inner_x
                gy0 = max(ry, y)
                bg_h = line_h if (bs.fill_line_gap
                                  or li == len(wrapped) - 1) else line_h
                gy1 = min(ry2, y + bg_h)
                if bs.background_color[3] and line:
                    x1 = min(rx2, x + lw)
                    out[gy0:gy1, max(rx, x):x1] = bs.background_color
                cx = x + lpad
                for (ch, st) in line:
                    if st.background_color[3]:
                        out[gy0:min(ry2, y + line_h),
                            max(rx, cx):min(rx2, cx + char_w)] = \
                            st.background_color
                    if 0 <= cx and cx + char_w <= width \
                            and y + font_h <= height and y >= 0:
                        g = _glyph(ord(ch) if ord(ch) < 128 else ord("?"),
                                   font_h, char_w)
                        blk = out[y:y + font_h, cx:cx + char_w]
                        blk[g] = st.color
                        if st.text_decoration == "underline":
                            out[y + font_h - 1, cx:cx + char_w] = st.color
                    cx += char_w
                y += line_h
    return out
