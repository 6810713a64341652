"""interlace (gst/interlace/gstinterlace.c) — progressive -> interlaced /
telecine field weaver with the 11 pulldown patterns.

The reference's chain loop (gstinterlace.c:1292-1448) consumes
n_fields[phase] fields per input frame and emits woven buffers while >= 2
fields are available; the loop runs at most twice per input frame, so the
window has 2 gated output slots per input (4 half-height field slots with
alternate=true).  None of it needs pixels to decide: the plan depends only
on the pattern, `valid` and `pts`.  So a window takes three steps: the
pts and valid vectors come to the host in one copy, the chain loop runs
there over Python ints and builds an index plan, and the output frames are
built on the device by batched gathers and one `where` per plane.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import (FLAG_BOTTOM_FIELD, FLAG_INTERLACED,
                                         FLAG_RFF, FLAG_TFF, FLAG_TOP_FIELD,
                                         FrameBatch, to_device, to_host)
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require

# gstinterlace.c:363-385: name -> (ratio_n, ratio_d, n_fields per phase)
PATTERNS = {
    "1:1": (1, 2, [1]),
    "2:2": (1, 1, [2]),
    "2:3": (5, 4, [2, 3]),
    "2:3:3:2": (5, 4, [2, 3, 3, 2]),
    "2-11:3": (25, 24, [2] * 11 + [3]),
    "3:4-3": (15, 8, [3, 4, 4, 4]),
    "3-7:4": (25, 16, [3] * 7 + [4]),
    "3:3:4": (5, 3, [3, 3, 4]),
    "3:3": (3, 2, [3, 3]),
    "3:2-4": (11, 10, [3, 2, 2, 2, 2]),
    "1:2-4": (9, 10, [1, 2, 2, 2, 2]),
}


def _rows(plane: torch.Tensor) -> torch.Tensor:
    """[H, 1(, 1)] row parity of a [S, H, ...] plane batch."""
    h = plane.shape[1]
    return (torch.arange(h, device=plane.device) % 2).reshape(
        (h,) + (1,) * (plane.ndim - 2))


def _per_slot(v: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (plane.ndim - 1))


@register
class Interlace(VideoFilter):
    NAME = "interlace"
    # the 8-bit subset of the reference's format list
    # (gstinterlace.c:177-200) + GRAY8.  The field machinery is
    # plane-generic: every plane interleaves its own rows, like the
    # reference's per-component copy_field/copy_fields walk
    # (gstinterlace.c:1070-1171).
    FORMATS = (VideoFormat.I420, VideoFormat.YV12, VideoFormat.Y444,
               VideoFormat.Y42B, VideoFormat.Y41B, VideoFormat.NV12,
               VideoFormat.NV21, VideoFormat.YUY2, VideoFormat.UYVY,
               VideoFormat.AYUV, VideoFormat.GRAY8)
    PROPERTIES = (
        Property("top-field-first", bool, False, static=True),
        Property("pattern", str, "2:3", static=True),
        Property("pattern-offset", int, 0, 0, 12, static=True),
        Property("allow-rff", bool, False, static=True),
        # interlace-mode=alternate output: two half-height field buffers per
        # woven frame, sharing PTS, flagged TOP_FIELD/BOTTOM_FIELD
        # (gstinterlace.c:1288-1410 alternate branches)
        Property("alternate", bool, False, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "interlace: needs video")
        require(in_spec.format in self.FORMATS,
                f"interlace: format {in_spec.format} unsupported")
        require(self.props["pattern"] in PATTERNS,
                f"interlace: unknown pattern {self.props['pattern']}")
        rn, rd, fields = PATTERNS[self.props["pattern"]]
        require(self.props["pattern-offset"] < len(fields),
                "interlace: pattern-offset beyond pattern")
        mode = ("mixed" if self.props["pattern"] not in ("1:1", "2:2")
                else "interleaved")
        if self.props["alternate"]:
            sub420 = ((VideoFormat.I420, VideoFormat.YV12)
                      + VideoFormat.SEMIPLANAR_YUV)
            div = 4 if in_spec.format in sub420 else 2
            require(in_spec.height % div == 0,
                    f"interlace: alternate needs height % {div} == 0")
            return in_spec.with_(
                framerate=in_spec.framerate * Fraction(rn, rd),
                interlace_mode="alternate", height=in_spec.height // 2)
        return in_spec.with_(
            framerate=in_spec.framerate * Fraction(rn, rd),
            interlace_mode=mode)

    def prepare(self):
        _, _, fields = PATTERNS[self.props["pattern"]]
        self._table = fields + [0]   # 0-terminated
        self._mixed = self.props["pattern"] not in ("1:1", "2:2")
        out_fr = self.out_spec.framerate
        # field duration in ns = 1e9 * fps_d / (2 * fps_n)
        self._field_ns = int(round(1e9 * out_fr.denominator
                                   / (2 * out_fr.numerator)))

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        fmt = spec.format
        dev = self.device

        def z(*s):
            return torch.zeros(s, dtype=torch.uint8, device=dev)

        if fmt in (VideoFormat.I420, VideoFormat.YV12):
            stored = {"y": z(h, w), "u": z(h // 2, w // 2),
                      "v": z(h // 2, w // 2)}
        elif fmt == VideoFormat.Y444:
            stored = {"y": z(h, w), "u": z(h, w), "v": z(h, w)}
        elif fmt == VideoFormat.Y42B:
            stored = {"y": z(h, w), "u": z(h, w // 2), "v": z(h, w // 2)}
        elif fmt == VideoFormat.Y41B:
            stored = {"y": z(h, w), "u": z(h, w // 4), "v": z(h, w // 4)}
        elif fmt in VideoFormat.SEMIPLANAR_YUV:
            stored = {"y": z(h, w), "uv": z(h // 2, w)}
        elif fmt == VideoFormat.AYUV:
            stored = {"p": z(h, w, 4)}
        elif fmt in VideoFormat.PACKED_YUV422:
            stored = {"p": z(h, 2 * w)}
        else:
            stored = {"p": z(h, w)}

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        return {
            "phase": scalar(self.props["pattern-offset"], torch.int32),
            "field_index": scalar(0 if self.props["top-field-first"] else 1,
                                  torch.int32),
            "stored": stored,
            "stored_fields": scalar(0, torch.int32),
            "timebase": scalar(0, torch.int64),
            "fields_since": scalar(0, torch.int32),
            "started": scalar(False, torch.bool),
        }

    def _plan(self, pts, valid, st):
        """The chain loop on the host over one window.  Returns the slot
        plan {pool index of the incoming frame "cur", of the stored frame
        "sto", field index "fi", "use" stored, "pts", "flags", "valid"},
        the pool index of the new stored frame, and the new scalars.
        Pool index 0 is the carried stored frame, 1 + i input frame i."""
        table = self._table
        offset = self.props["pattern-offset"]
        allow_rff = self.props["allow-rff"]
        alternate = self.props["alternate"]
        field_ns = self._field_ns
        slots = {k: [] for k in ("cur", "sto", "fi", "use", "pts", "flags",
                                 "valid")}

        def slot(cur, sto, fi, use, p, flags, ok):
            for k, v in zip(slots, (cur, sto, fi, use, p, flags, ok)):
                slots[k].append(v)

        stored_ref = 0
        for i in range(len(pts)):
            # timebase reset (gstinterlace.c:1261-1266)
            at_reset = st["stored_fields"] == 0 and st["phase"] == offset
            timebase = int(pts[i]) if at_reset else st["timebase"]
            fields_since = 0 if at_reset else st["fields_since"]
            current = table[st["phase"]]
            phase = st["phase"] + 1
            if table[phase] == 0:
                phase = 0
            stored_fields = st["stored_fields"]
            field_index = st["field_index"]
            num = stored_fields + current
            ok = bool(valid[i])
            for _ in range(2):
                emit = num >= 2
                use = stored_fields > 0
                take3 = (not use) and num >= 3 and allow_rff
                nout = 3 if take3 else 2
                p = timebase + field_ns * fields_since
                if alternate:
                    # field 1 from stored (or current), field 2 always from
                    # the incoming buffer (gstinterlace.c:1306-1341)
                    top_first = field_index == 0
                    f1 = (FLAG_TOP_FIELD if top_first
                          else FLAG_BOTTOM_FIELD) | FLAG_INTERLACED
                    f2 = (FLAG_BOTTOM_FIELD if top_first
                          else FLAG_TOP_FIELD) | FLAG_INTERLACED
                    slot(1 + i, stored_ref, field_index, use, p,
                         f1 if emit else 0, emit and ok)
                    slot(1 + i, stored_ref, field_index ^ 1, False, p,
                         f2 if emit else 0, emit and ok)
                else:
                    # gst_interlace_decorate_buffer
                    flags = FLAG_TFF if field_index == 0 else 0
                    flags |= FLAG_RFF if nout == 3 else 0
                    if self._mixed and use and nout == 2:
                        flags |= FLAG_INTERLACED
                    slot(1 + i, stored_ref, field_index, use, p,
                         flags if emit else 0, emit and ok)
                if emit:
                    current -= 1 if use else nout
                    stored_fields -= 1 if use else 0
                    fields_since += nout
                    field_index ^= nout & 1
                    num -= nout
            # store the leftover field (gstinterlace.c:1436-1447)
            keep = current > 0
            # an invalid slot (window-adapter rate padding) is not a
            # buffer arrival: no state change, no emission
            if ok:
                st = {"phase": phase, "field_index": field_index,
                      "stored_fields": current if keep else 0,
                      "timebase": timebase, "fields_since": fields_since,
                      "started": True}
                stored_ref = 1 + i if keep else stored_ref
        return slots, stored_ref, st

    def process(self, params, state, batch: FrameBatch):
        is_dict = isinstance(batch.data, dict)
        data = batch.data if is_dict else {"p": batch.data}
        dev = batch.pts.device
        names = ("phase", "field_index", "stored_fields", "timebase",
                 "fields_since", "started")
        pts, valid, *scalars = to_host(batch.pts, batch.valid,
                                       *(state[k] for k in names))
        st = {k: v.item() for k, v in zip(names, scalars)}
        plan, stored_ref, st = self._plan(pts, valid, st)

        (cur, sto, fi, use, out_pts, flags, out_valid, phase, field_index,
         stored_fields, timebase, fields_since, started) = to_device(
            dev, *((plan[k], t) for k, t in (
                ("cur", np.int64), ("sto", np.int64), ("fi", np.int32),
                ("use", bool), ("pts", np.int64), ("flags", np.int32),
                ("valid", bool))),
            (st["phase"], np.int32), (st["field_index"], np.int32),
            (st["stored_fields"], np.int32), (st["timebase"], np.int64),
            (st["fields_since"], np.int32), (st["started"], bool))

        pool = {k: torch.cat([state["stored"][k][None], v])
                for k, v in data.items()}
        frames = {}
        for k, v in pool.items():
            if self.props["alternate"]:
                # slot = field rows `fi` of the stored or incoming frame
                src = pool[k][torch.where(use, sto, cur)]
                h2 = v.shape[1] // 2
                even = _per_slot(fi == 0, src)
                frames[k] = torch.where(even, src[:, 0::2][:, :h2],
                                        src[:, 1::2][:, :h2])
            else:
                # weave: rows of parity fi from the stored frame
                incoming = pool[k][cur]
                stored = pool[k][sto]
                sel = (_rows(stored) == _per_slot(fi, stored)) \
                    & _per_slot(use, stored)
                frames[k] = torch.where(sel, stored, incoming)
        new_state = {
            "phase": phase, "field_index": field_index,
            "stored": {k: v[stored_ref].clone() for k, v in pool.items()},
            "stored_fields": stored_fields, "timebase": timebase,
            "fields_since": fields_since, "started": started,
        }
        out = FrameBatch(data=frames if is_dict else frames["p"],
                         pts=out_pts, flags=flags, valid=out_valid)
        return new_state, out
