"""Subtitle and graphics overlays: suboverlay, dvbsuboverlay, dvdspu and
dvbsubenc, the torch form of gstbad_tpu/elements/video/overlay.py
(gst/dvdspu/, gst/dvbsuboverlay/, gst/dvbsubenc/).

The subpicture streams decode on the host (io/dvbsub.py, io/spu.py, the
JAX package's byte-level engines, copied); the blends are H4
(ops/overlay.overlay_blend), one launch a window.  dvbsuboverlay and
dvdspu read the window's pts to the host (one small copy a window), and
upload into a device bank only the sets whose [show, hide) meets the
window, each once while it stays in use (ops/overlay.OverlaySlots): a
film's display sets never sit on the card together.  The layer table
keeps the JAX loop's order, so two sets active on one frame blend as
they do there, and the video alpha byte is kept where the JAX package
keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.ops import overlay as ovops

# AYUV and AYUV-layout banks: alpha at byte 0, Y, U, V at 1-3
_AYUV_CHAN = (None, 0, 1, 2)


def ayuv_planes(bank):
    """(alpha view, [Y, U, V] views) of an [K, H, W, 4] AYUV bank."""
    return bank[..., 0], [(bank[..., c], 0) for c in (1, 2, 3)]


def timed_layers(pts, spans, b):
    """The [B, L] int32 layer table of a window: spans is a list of (key,
    show, hide) in the blend order (hide None for open-ended); each frame
    lists the keys whose [show, hide) holds its pts.  -> (table or None
    when nothing is active, keys in order)."""
    rows = [[] for _ in range(b)]
    keys = []
    for key, show, hide in spans:
        act = pts >= show
        if hide is not None:
            act &= pts < hide
        if act.any():
            keys.append(key)
            for f in np.flatnonzero(act):
                rows[f].append(key)
    if not keys:
        return None, keys
    table = np.full((b, max(len(r) for r in rows)), -1, np.int64)
    for f, r in enumerate(rows):
        table[f, :len(r)] = r
    return table, keys


def blend_timed(slots, batch, spans, render, mode):
    """Blend the sets of `spans` (timed_layers) active in the window onto
    an AYUV batch with H4, their overlays placed in `slots` (render(key)
    -> [H, W, 4] AYUV numpy); the batch as it is when none is active."""
    b = batch.batch
    table, keys = timed_layers(batch.pts.cpu().numpy(), spans, b)
    if table is None:
        return batch
    slot = slots.place(keys, render)
    lut = np.full(max(keys) + 2, -1, np.int64)
    for k, s in slot.items():
        lut[k] = s
    layers = torch.from_numpy(lut[table].astype(np.int32)).to(
        batch.data.device)
    alpha, planes = ayuv_planes(slots.bank)
    out = ovops.overlay_blend(batch.data, alpha, planes, layers,
                              _AYUV_CHAN, mode)
    return batch.with_data(out)


@register
class SubOverlay(Element):
    """2-input: [video, overlay] -> video with the overlay alpha-blended
    by (a*s + (255-a)*d + 127) // 255.  video: AYUV or I420; overlay:
    AYUV, or planar A420 with an "a" plane; geometries must match.  On
    I420 luma blends at full resolution and chroma with the alpha of the
    even rows and columns (three launches a window, one a plane)."""

    NAME = "suboverlay"
    N_INPUTS = 2

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "suboverlay: needs (video, overlay) inputs")
        video, overlay = in_spec
        require(video.kind == "video" and overlay.kind == "video",
                "suboverlay: needs video inputs")
        require(video.width == overlay.width
                and video.height == overlay.height,
                "suboverlay: geometry mismatch")
        require(video.format in (VideoFormat.AYUV, VideoFormat.I420),
                f"suboverlay: video format {video.format} unsupported")
        require(overlay.format in (VideoFormat.AYUV, "A420"),
                f"suboverlay: overlay format {overlay.format} unsupported")
        self._video_fmt = video.format
        self._overlay_fmt = overlay.format
        return video

    def process(self, params, state, batches):
        video, overlay = batches
        b = video.batch
        layers = torch.arange(b, dtype=torch.int32,
                              device=video.pts.device)[:, None]
        if self._overlay_fmt == VideoFormat.AYUV:
            alpha, full = ayuv_planes(overlay.data)
            # every other row and column of the overlay's own chroma
            sub = [(v[:, ::2, ::2], 0) for v, _ in full[1:]]
        else:                   # A420: chroma repeated to full size
            od = overlay.data
            alpha = od["a"]
            full = [(od["y"], 0), (od["u"], 1), (od["v"], 1)]
            sub = [(od["u"], 0), (od["v"], 0)]
        if self._video_fmt == VideoFormat.AYUV:
            out = ovops.overlay_blend(video.data, alpha, full, layers,
                                      _AYUV_CHAN, "div255_round")
            return state, video.with_data(out)

        def plane(x, a, src):
            return ovops.overlay_blend(x[..., None], a, [src], layers,
                                       (0,), "div255_round")[..., 0]

        a_sub = alpha[:, ::2, ::2]
        return state, video.with_data({
            "y": plane(video.data["y"], alpha, full[0]),
            "u": plane(video.data["u"], a_sub, sub[0]),
            "v": plane(video.data["v"], a_sub, sub[1])})


@register
class DvbSubOverlay(Element):
    """dvbsuboverlay (gst/dvbsuboverlay/gstdvbsuboverlay.c): DVB subtitle
    PES payloads pushed with push_pes(data, pts_ns) decode on the host
    (io/dvbsub.py); a display set shows from its pts until the next
    set's pts or its page-time-out, whichever is first (time-out 0 is
    1 s, capped by max-page-timeout; gstdvbsuboverlay.c:795-845), a set
    with no rects clears the screen, and the active sets blend by the
    truncating (D*(256-a) + S*a) >> 8 on Y, U and V where a > 0, the
    video alpha kept."""

    NAME = "dvbsuboverlay"
    PROPERTIES = (
        Property("enable", bool, True, static=True),
        Property("max-page-timeout", int, 0, 0, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad_tpu_torch.io.dvbsub import DvbSubParser
        self._parser = DvbSubParser()
        self._sets = []
        self._slots = None

    def push_pes(self, data: bytes, pts_ns: int = 0) -> None:
        self._sets.extend(self._parser.feed(data, pts_ns))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvbsuboverlay: needs AYUV video (use videoconvert)")
        return in_spec

    def _spans(self):
        max_to = self.props["max-page-timeout"]
        out = []
        for i, ds in enumerate(self._sets):
            if not ds.rects:
                continue                      # clear-screen set
            timeout = ds.page_time_out
            if max_to > 0:
                timeout = min(timeout, max_to)
            if timeout == 0:
                timeout = 1                   # gstdvbsuboverlay.c:821-824
            show = ds.pts_ns
            hide = show + timeout * 10 ** 9
            if i + 1 < len(self._sets):       # replaced by the next set
                hide = min(hide, self._sets[i + 1].pts_ns)
            out.append((i, show, hide))
        return out

    def process(self, params, state, batch: FrameBatch):
        from gstbad_tpu_torch.io.dvbsub import display_set_to_ayuv
        if not self.props["enable"] or not self._sets:
            return state, batch
        _, h, w, _ = batch.data.shape
        if self._slots is None:
            self._slots = ovops.OverlaySlots(batch.data.device, (h, w, 4))
        return state, blend_timed(
            self._slots, batch, self._spans(),
            lambda i: display_set_to_ayuv(self._sets[i], w, h),
            "shr8_keep_alpha")


@register
class DvdSpu(Element):
    """dvdspu (gst/dvdspu/gstdvdspu.c + gstspu-vobsub.c): VobSub
    subpicture packets pushed with push_spu(data, pts_ns, clut) decode on
    the host (io/spu.py) and blend while their display window holds, by
    the truncating (inv_a*dst + a*src)/255
    (gstspu-vobsub-render.c:172-190), the video alpha kept."""

    NAME = "dvdspu"

    def __init__(self, **props):
        super().__init__(**props)
        self._pending = []   # (pic, pts_ns, overlay np [h, w, 4] AYUV)
        self._slots = None

    def push_spu(self, data: bytes, pts_ns: int = 0,
                 clut: np.ndarray = None) -> None:
        from gstbad_tpu_torch.io import spu as spuio
        pic = spuio.parse_spu(data)
        overlay = spuio.spu_to_ayuv(pic, clut)
        self._pending.append((pic, pts_ns, overlay))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvdspu: needs AYUV video (use videoconvert)")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        _, h, w, _ = batch.data.shape
        spans = []
        for i, (pic, pts_ns, _ov) in enumerate(self._pending):
            top, left = pic.rect[0], pic.rect[1]
            if min(pic.height, h - top) <= 0 or min(pic.width, w - left) <= 0:
                continue
            hide_ns = pic.hide_ns()
            spans.append((i, pts_ns + pic.show_ns(),
                          pts_ns + hide_ns if hide_ns is not None else None))
        if not spans:
            return state, batch
        if self._slots is None:
            self._slots = ovops.OverlaySlots(batch.data.device, (h, w, 4))

        def render(i):
            pic, _, overlay = self._pending[i]
            top, left = pic.rect[0], pic.rect[1]
            ph, pw = min(pic.height, h - top), min(pic.width, w - left)
            full = np.zeros((h, w, 4), np.uint8)
            full[top:top + ph, left:left + pw] = overlay[:ph, :pw]
            return full

        return state, blend_timed(self._slots, batch, spans, render,
                                  "div255_keep_alpha")


@register
class DvbSubEnc(Element):
    """dvbsubenc (gst/dvbsubenc/gstdvbsubenc.c): AYUV subtitle pictures to
    DVB subtitle PES packets (io/dvbsubenc.py).  A host element: video
    passes through, each valid frame's packet posts as a `dvbsub-pes`
    message (data/x/y/end) with pts shifted by ts-offset, and an
    end-of-page packet posts when a later frame's pts passes the
    previous subtitle's end.  All-transparent frames are skipped."""

    NAME = "dvbsubenc"
    HOST = True
    PROPERTIES = (
        Property("max-colours", int, 16, 1, 256, static=True,
                 doc="DEFAULT_MAX_COLOURS 16 (gstdvbsubenc.c:42)"),
        Property("ts-offset", int, 0, None, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._object_version = 0
        self._current_end_time = None
        self.packets = []        # (pts_ns, bytes) mirror of the posts

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "dvbsubenc: needs AYUV input (use videoconvert)")
        self._dur = in_spec.frame_duration_ns
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _post(self, bus, name: str, pts: int, fields: dict) -> None:
        from gstbad_tpu_torch.core.bus import Message
        self.packets.append((pts, fields["data"]))
        if bus is not None:
            bus.post(Message(self.NAME, name, pts, fields))

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad_tpu_torch.io import dvbsubenc as enc
        off = self.props["ts-offset"]
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            pts = int(np.asarray(np_batch.pts)[i])
            if self._current_end_time is not None \
                    and self._current_end_time < pts:
                pkt = enc.encode_display_set(
                    self._object_version & 0xF, 1, [])
                self._object_version += 1
                self._post(bus, "dvbsub-pes",
                           self._current_end_time + off,
                           {"data": pkt, "x": 0, "y": 0, "end": True})
                self._current_end_time = None
            frame = np.asarray(np_batch.data[i])
            res = enc.encode_frame(frame, self._object_version,
                                   self.props["max-colours"])
            if res is None:
                continue
            pkt, x, y = res
            self._object_version += 1
            self._post(bus, "dvbsub-pes", pts + off,
                       {"data": pkt, "x": x, "y": y, "end": False})
            self._current_end_time = pts + self._dur
