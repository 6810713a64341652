"""assrender (ext/assrender/gstassrender.c): SSA/ASS subtitles onto
video, the torch form of gstbad_tpu/elements/video/assrender.py.

io/ass.py (a copy of the JAX package's track model and its transcription
of the element's blit_bgra_premultiplied) renders premultiplied BGRA
snapshots on the host, one per event-transition interval (animated
events sampled within their range at animation-fps, at most 512
snapshots); they go to the device once, as a bank.  Each frame takes the
first snapshot active at its pts (argmax over the active intervals, on
the device) and H4 composites it with the element's premultiplied OVER,
min(s + (255 - a) * d // 255, 255): one launch a window.  push_script()
and push_chunk() feed the track as in the JAX package.  Packed RGB,
4-byte and 3-byte formats."""

from __future__ import annotations

import re

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.elements.video.qroverlay import rgb_chan
from gstbad_tpu_torch.ops import overlay as ovops

_ANIM_RE = re.compile(r"\\(t[\s(0-9]|move|fade?|k[fo]?\d|K\d)")


class TimedBank:
    """Host-rendered overlays [K, H, W, 4] u8 on the device with their
    [begin, end) intervals, entry 0 the empty overlay: the layer table of
    a window picks, per frame, the first entry active at its pts, as the
    JAX renderers' argmax does, and -1 (no layer) where none is."""

    def __init__(self, overlays, begins, ends, device):
        self.bank = torch.from_numpy(np.stack(overlays)).to(device)
        self.begin = torch.tensor(np.asarray(begins, np.int64),
                                  device=device)
        self.end = torch.tensor(np.asarray(ends, np.int64), device=device)

    def __len__(self):
        return self.bank.shape[0]

    def layers(self, pts):
        active = (pts[:, None] >= self.begin[None, 1:]) \
            & (pts[:, None] < self.end[None, 1:])
        idx = torch.argmax(active.to(torch.int32), 1) + 1
        return torch.where(active.any(1), idx, torch.full_like(idx, -1)).to(
            torch.int32)[:, None]

    def blend(self, frames, pts, order, mode, alpha_chan=None):
        """Blend each frame's entry (alpha byte 3; source bytes `order`
        for the frame's R, G, B) with H4's `mode`."""
        bank = self.bank
        return ovops.overlay_blend(
            frames, bank[..., 3], [(bank[..., c], 0) for c in (0, 1, 2)],
            self.layers(pts), order, mode, alpha_chan)


@register
class AssRender(VideoFilter):
    NAME = "assrender"
    FORMATS = VideoFormat.PACKED_RGB4 + VideoFormat.PACKED_RGB3
    PROPERTIES = (
        Property("enable", bool, True, static=True,
                 doc="enable rendering of subtitles"),
        Property("embeddedfonts", bool, True, static=True,
                 doc="accepted for parity (no font attachments here)"),
        Property("wait-text", bool, False, static=True,
                 doc="accepted for parity (host-push model)"),
        Property("face", str, "auto", static=True,
                 doc="auto | pango | fixed — pango shapes glyphs with"
                     " real fonts (io/ass._pango_span)"),
        Property("animation-fps", float, 10.0, static=True,
                 doc="snapshot rate inside animated events (\\t, \\move,"
                     " \\fad, karaoke); match the video rate for"
                     " frame-exact animation"),
    )

    _SNAPSHOT_CAP = 512

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad_tpu_torch.io.ass import AssTrack
        self._track = AssTrack()

    def push_script(self, text: str) -> None:
        self._track.process_script(text)

    def push_chunk(self, text: str, pts_ns: int,
                   duration_ns: int) -> None:
        self._track.process_chunk(text, pts_ns, duration_ns)

    def prepare(self):
        from gstbad_tpu_torch.io import ass
        spec = self.out_spec
        H, W = spec.height, spec.width
        face = self.props.get("face", "auto")
        if face == "pango" and not ass.pango_available():
            raise ValueError("assrender: face=pango but "
                             "pango/pangocairo is not available")
        self._face = "pango" if (face in ("auto", "pango")
                                 and ass.pango_available()) else "fixed"
        times = {t for ev in self._track.events
                 for t in (ev.start, ev.end)}
        # animated events need samples within the event: \t, \move,
        # \fad/\fade and karaoke all vary with the event clock
        anim_fps = max(0.1, float(self.props.get("animation-fps", 10.0)))
        step = int(1e9 / anim_fps)
        anim_times = set()
        for ev in self._track.events:
            if _ANIM_RE.search(ev.raw_text or ""):
                anim_times.update(range(ev.start, ev.end, step))
        if len(times) + len(anim_times) > self._SNAPSHOT_CAP:
            keep = max(1, self._SNAPSHOT_CAP - len(times))
            ordered = sorted(anim_times)
            stride = max(1, len(ordered) // keep)
            anim_times = set(ordered[::stride][:keep])
        times = sorted(times | anim_times)
        overlays = [np.zeros((H, W, 4), np.uint8)]
        begins, ends = [0], [0]
        for i, t in enumerate(times[:-1]):
            imgs = ass.render_events(self._track, t, W, H,
                                     face=self._face)
            if not imgs:
                continue
            overlays.append(ass.blit_bgra_premultiplied(imgs, W, H))
            begins.append(t)
            ends.append(times[i + 1])
        self._bank = TimedBank(overlays, begins, ends, self.device)
        self._chan = rgb_chan(spec.format, (2, 1, 0))   # BGRA bank

    def process(self, params, state, batch: FrameBatch):
        if not self.props["enable"] or len(self._bank) == 1:
            return state, batch
        return state, batch.with_data(self._bank.blend(
            batch.data, batch.pts, self._chan, "premul_floor"))
