"""ttmlparse + ttmlrender (ext/ttml/): TTML subtitles onto video, the
torch form of gstbad_tpu/elements/video/ttmlrender.py.

io/ttml.py (a copy of the JAX package's ttmlparse.c transcription and
bitmap-face layout) parses the documents pushed with push_ttml(doc,
pts_ns, duration_ns); each scene renders on the host, through pango
(io/ttml_pango.py, premultiplied BGRA) where the library loads, else
the bitmap face (straight RGBA), into a device bank once.  Each frame
takes the first scene active at its pts, and H4 composites it: pixman's
premultiplied OVER for pango's scenes, video-blend's truncating
(D*(256-a) + S*a) >> 8 for the bitmap face's; one launch a window.

ttmlparse is a HOST element: each scene posts a `ttml-scene` message
(begin/end ns and the blocks' texts) after the first window."""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.elements.video.assrender import TimedBank
from gstbad_tpu_torch.elements.video.qroverlay import rgb_chan


@register
class TtmlRender(VideoFilter):
    NAME = "ttmlrender"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3

    PROPERTIES = (
        Property("face", str, "auto", static=True,
                 doc="auto | pango | bitmap — pango is the reference's"
                     " real text stack (io/ttml_pango.py)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []

    def push_ttml(self, doc: str, pts_ns=None, duration_ns=None) -> None:
        self._docs.append((doc, pts_ns, duration_ns))

    def _use_pango(self) -> bool:
        from gstbad_tpu_torch.io import pangocairo
        face = self.props.get("face", "auto")
        if face == "pango" and not pangocairo.available():
            raise RuntimeError("ttmlrender: face=pango but "
                               "pango/pangocairo is not available")
        return face in ("auto", "pango") and pangocairo.available()

    def prepare(self):
        from gstbad_tpu_torch.io import ttml
        spec = self.out_spec
        H, W = spec.height, spec.width
        scenes = []
        for doc, pts, dur in self._docs:
            parsed, consumed = ttml.ttml_parse(doc, pts, dur)
            require(consumed > 0 or not doc.strip(),
                    "ttmlrender: document is not framed by "
                    "<?xml ... </tt>")
            scenes += parsed
        self._pango = self._use_pango()
        if self._pango:
            from gstbad_tpu_torch.io import ttml_pango
            render = lambda sc: ttml_pango.render_scene(sc, W, H)  # noqa: E731
        else:
            render = lambda sc: ttml.render_scene(sc, W, H)  # noqa: E731
        overlays = [np.zeros((H, W, 4), np.uint8)]
        begins, ends = [0], [0]
        for sc in scenes:
            overlays.append(render(sc))
            begins.append(sc.begin)
            ends.append(sc.end)
        self._bank = TimedBank(overlays, begins, ends, self.device)
        # pango's scenes are B, G, R, A; the bitmap face's R, G, B, A
        self._chan = rgb_chan(spec.format,
                              (2, 1, 0) if self._pango else (0, 1, 2))

    def process(self, params, state, batch: FrameBatch):
        if len(self._bank) == 1:
            return state, batch
        mode = "cairo_over" if self._pango else "shr8_rgb_alpha"
        return state, batch.with_data(self._bank.blend(
            batch.data, batch.pts, self._chan, mode))


@register
class TtmlParse(Element):
    """ttmlparse (ext/ttml/gstttmlparse.c): the parser half as its own
    element, a HOST tap: documents pushed with push_ttml() before the run
    post one `ttml-scene` message a scene (begin/end ns and the blocks'
    texts).  ttmlrender covers both halves for composited output."""

    NAME = "ttmlparse"
    HOST = True
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self._docs = []
        self._posted = False

    def push_ttml(self, doc: str, pts_ns=None, duration_ns=None) -> None:
        self._docs.append((doc, pts_ns, duration_ns))

    def negotiate(self, in_spec):
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad_tpu_torch.core.bus import Message
        from gstbad_tpu_torch.io import ttml
        if self._posted or bus is None:
            return
        self._posted = True
        for doc, pts, dur in self._docs:
            scenes, _ = ttml.ttml_parse(doc, pts, dur)
            for sc in scenes:
                texts = ["".join(e.text for e in b.elements)
                         for r in sc.regions for b in r.blocks]
                bus.post(Message(self.NAME, "ttml-scene", sc.begin,
                                 {"begin": sc.begin, "end": sc.end,
                                  "texts": texts}))
