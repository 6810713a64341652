"""teletextdec (ext/teletextdec/gstteletextdec.c): teletext PES
streams to RGBA page renders and text, the torch form of
gstbad_tpu/elements/video/teletext.py.

io/teletext.py (a copy of the JAX package's decoder: the element's
data-unit walk and the zvbi part up to the Level 2.5 colour system)
decodes the buffers pushed with push_packet() at negotiation.  A host
source: each completed page matching `page`/`subpage` is one RGBA frame
(40*12 x 25*10), uploaded a window at a time, and a HOST element: each
valid frame posts a `teletext-page` message with `lines` (the page as
text rows) and `subtitles` (rows 1-23 stripped and joined through
subtitles-template, a lone "\\n" when blank;
gstteletextdec.c:857-897).  font-description is accepted for parity;
the bitmap face renders the glyphs."""

from __future__ import annotations

import fractions

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, require


def _dec2bcd(v: int) -> int:
    out = 0
    shift = 0
    while v:
        out |= (v % 10) << shift
        v //= 10
        shift += 4
    return out


@register
class TeletextDec(Element):
    NAME = "teletextdec"
    KIND = "host-source"
    HOST = True          # host_process posts the text exports
    PROPERTIES = (
        Property("page", int, 100, 100, 999, static=True,
                 doc="page number to display (gstteletextdec.c:199)"),
        Property("subpage", int, -1, -1, 0x99, static=True,
                 doc="sub-page (-1 = all)"),
        Property("subtitles-mode", bool, False, static=True),
        Property("subtitles-template", str, "%s\n", static=True),
        Property("font-description", str, "verdana 12", static=True,
                 doc="accepted for parity; bitmap face renders"),
        Property("framerate", str, "25/1", static=True),
        Property("level", float, 3.5, static=True,
                 doc="presentation level for the RGBA render (the "
                     "reference asks zvbi for VBI_WST_LEVEL_3p5; "
                     "X/28 CLUT redefinitions and X/26 colours land "
                     "at >= 2.5 — io/teletext.py render_cells)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._packets = []
        self._pages = None
        self._pos = 0

    def push_packet(self, data: bytes) -> None:
        self._packets.append(bytes(data))

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _decode_all(self):
        from gstbad_tpu_torch.io import teletext as tt
        dec = tt.TeletextDecoder()
        # page property is decimal; pgno is BCD with the magazine digit
        p = self.props["page"]
        want_pg = (p // 100 << 8) | ((p // 10 % 10) << 4) | (p % 10)
        sub = self.props["subpage"]
        want_sub = _dec2bcd(sub) if sub >= 0 else -1
        out = []
        for pkt in self._packets:
            frames, ok = tt.extract_frames(pkt)
            if not ok:
                continue
            for frame in frames:
                before = len(dec.events)
                for line in frame:
                    dec.feed_line(line)
                for (pg, sb) in dec.events[before:]:
                    if pg != want_pg or (want_sub != -1
                                         and sb != want_sub):
                        continue
                    page = dec.pages[(pg, sb)]
                    rgba = tt.render_page_rgba(
                        page, level=self.props["level"])
                    lines = tt.page_to_text(
                        page, level=self.props["level"])
                    out.append((rgba, lines))
        self._pages = out

    def negotiate(self, in_spec):
        from gstbad_tpu_torch.io.teletext import CELL_W, CELL_H
        require(self._packets,
                "teletextdec: push_packet() teletext buffers first")
        self._decode_all()
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format="RGBA",
                         width=40 * CELL_W, height=25 * CELL_H,
                         framerate=self._fr)

    def _subtitles(self, lines) -> str:
        subs = ""
        for ln in lines[1:24]:
            s = ln.strip()
            if s:
                subs += self.props["subtitles-template"] % s
        return subs if subs else "\n"

    def pull_window(self, window: int):
        if self._pos >= len(self._pages):
            return None
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        last = None
        for _ in range(window):
            if self._pos < len(self._pages):
                rgba, _lines = self._pages[self._pos]
                frames.append(rgba)
                pts.append(self._pos * dur)
                valid.append(True)
                last = rgba
                self._pos += 1
            else:
                frames.append(last)
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
        return upload_frames(self.device, frames, pts, [0] * window, valid)

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad_tpu_torch.core.bus import Message
        if bus is None:
            return
        dur = self.out_spec.frame_duration_ns
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            t = int(np.asarray(np_batch.pts)[i])
            idx = t // dur
            if idx >= len(self._pages):
                continue
            _rgba, lines = self._pages[idx]
            bus.post(Message(self.NAME, "teletext-page", t,
                             {"lines": lines,
                              "subtitles": self._subtitles(lines)}))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        self._pos = pos
