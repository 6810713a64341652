"""fieldanalysis (gst/fieldanalysis/gstfieldanalysis.c) — telecine/interlace
analyzer.

A 2-frame history, five metric scores per frame pair, and a decision tree
that classifies PROGRESSIVE / INTERLACED / TELECINE_PROGRESSIVE /
TELECINE_MIXED and decorates each buffer with TFF/RFF/ONEFIELD/INTERLACED
flags, emitting one frame per input after the first (the reference pushes
the previous buffer on each chain call).

A window takes three steps.  The five metrics of every frame against its
previous valid frame are computed on the device in one pass (for the
default metrics, the hand-written kernel behind ops.metrics_default).  The
metrics, pts, flags and valid come to the host in one copy, and the
decision tree runs there over float32 scalars.  The emitted frames (each
the previous valid frame) are one batched gather on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import (FLAG_INTERLACED, FLAG_ONEFIELD,
                                         FLAG_RFF, FLAG_TFF, FrameBatch,
                                         to_device, to_host)
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops import fieldanalysis as ops

PROGRESSIVE, INTERLACED, TC_PROGRESSIVE, TC_MIXED = 0, 1, 2, 3

_F32 = np.float32
_STATE = ("prev_flags", "prev_pts", "prev_f", "prev_concl", "prev_holding",
          "have_prev", "first_buffer")
_DTYPES = {"prev_flags": np.int32, "prev_pts": np.int64,
           "prev_f": np.float32, "prev_concl": np.int32,
           "prev_holding": np.int32, "have_prev": bool,
           "first_buffer": bool}


def decide(st, pts, in_flags, in_valid, f, t, b, t_b, b_t, field_thresh,
           frame_thresh):
    """One step of the decision tree (gstfieldanalysis.c, the JAX
    package's scan body) on host scalars: the metrics and thresholds are
    np.float32, so every comparison and `t * 10` rounds as float32 does.
    Returns (new state, out pts, out flags, out valid, conclusion)."""
    cur_p = f <= frame_thresh
    prev_p = st["prev_f"] <= frame_thresh
    TB = t_b <= frame_thresh
    BT = b_t <= frame_thresh
    TM = (t <= field_thresh) or (t * _F32(10) < b)
    BM = (b <= field_thresh) or (b * _F32(10) < t)

    h1 = st["prev_holding"]
    tt = h1 in (-1, 1)
    bb = h1 in (-1, 2)
    h3 = h1 in (3, -1)
    first_buffer = st["first_buffer"]

    repeat = TM or BM
    predA1 = repeat and prev_p
    predA1a = predA1 and TM and BM
    predA2 = repeat and not prev_p
    a2a = predA2 and ((tt and BM) or (bb and TM))
    a2b = (predA2 and not a2a and not cur_p
           and ((tt and BT) or (bb and TB)))
    a2c = (predA2 and not a2a and not a2b and first_buffer
           and (BT or TB))
    a2d = predA2 and not (a2a or a2b or a2c) and h3
    a2e = predA2 and not (a2a or a2b or a2c or a2d)
    predB = not repeat and cur_p
    b2 = predB and not h3 and h1 > 0
    b3 = predB and not h3 and not h1 > 0
    predC1 = not repeat and not cur_p and (TB or BT)
    m1 = (tt and TB) or (bb and BT)
    c1b = predC1 and h1 != 3 and m1
    c1c = (predC1 and h1 != 3 and not m1
           and ((h1 > 0 and h1 != 3) or (tt and BT) or (bb and TB)))
    c1d = predC1 and h1 != 3 and not m1 and not c1c
    predC2 = not repeat and not cur_p and not (TB or BT)
    c2a2 = predC2 and h1 != 0 and not h3
    c2b = predC2 and h1 == 0

    # the next state's conclusion / holding: the last true row wins
    concl = PROGRESSIVE
    for pred, val in ((predA1a, TC_PROGRESSIVE),
                      (predA1 and not predA1a, TC_MIXED),
                      (predA2 and cur_p, TC_PROGRESSIVE),
                      (predA2 and not cur_p, TC_MIXED),
                      (predB, PROGRESSIVE), (predC1, TC_MIXED),
                      (predC2, INTERLACED)):
        if pred:
            concl = val
    a2_holding = 3 if cur_p else (0 if TM and BM else (1 if BM else 2))
    holding = -1
    for pred, val in ((predA1a, 3),
                      (predA1 and not predA1a, 1 if BM else 2),
                      (predA2, a2_holding),
                      (a2b, 2 if tt and BT else 1),
                      (predB, 3), (predC1, -1),
                      (c1b, 1 if TB else 2),   # 1 + !(m & TB)
                      (predC2, 3)):
        if pred:
            holding = val
    if not st["have_prev"]:
        # first frame: conclusion from f only (gstfieldanalysis.c:1470)
        concl = PROGRESSIVE if cur_p else INTERLACED
        holding = -1

    # emission flags for the PREVIOUS frame: 1 set TFF, 0 clear, -1 keep
    tff_sel = -1
    for pred, val in ((a2a, 1 if tt and BM else 0),
                      (a2b, 1 if tt and BT else 0),
                      (a2c, 1 if TB else 0),
                      (b2, 1 if h1 == 1 else 0),
                      (c1c, 1 if h1 == 1 else 0),
                      (c2a2, 1 if h1 == 1 else 0)):
        if pred:
            tff_sel = val
    onefield = a2a or a2b or a2c or b2 or c1c or c2a2
    drop = predA1a or a2e or b3 or c1d or c2b
    e_concl = TC_MIXED if a2c else st["prev_concl"]
    tff = ((st["prev_flags"] & FLAG_TFF) != 0 if tff_sel == -1
           else tff_sel == 1)
    out_flags = ((FLAG_TFF if tff else 0)
                 | (FLAG_ONEFIELD if onefield else 0)
                 | (FLAG_RFF if drop else 0)
                 | (FLAG_INTERLACED if e_concl in (INTERLACED, TC_MIXED)
                    else 0))
    out_pts = st["prev_pts"]
    # an invalid slot (window-adapter rate padding) is not a buffer
    # arrival: no emission, no history update
    out_valid = st["have_prev"] and in_valid
    if in_valid:
        st = {"prev_flags": in_flags, "prev_pts": pts, "prev_f": f,
              "prev_concl": concl, "prev_holding": holding,
              "have_prev": True,
              "first_buffer": False if st["have_prev"] else first_buffer}
    return st, out_pts, out_flags, out_valid, e_concl


@register
class FieldAnalysis(VideoFilter):
    """Defaults per gstfieldanalysis.c:74-84 (SSD field metric, 5-tap frame
    metric)."""

    NAME = "fieldanalysis"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)
    PROPERTIES = (
        Property("field-metric", str, "ssd", static=True),
        Property("frame-metric", str, "5-tap", static=True),
        Property("noise-floor", int, 16),
        Property("field-threshold", float, 0.08),
        Property("frame-threshold", float, 0.002),
        Property("spatial-threshold", int, 9, static=True),
        Property("block-width", int, 16, static=True),
        Property("block-height", int, 16, static=True),
        Property("block-threshold", int, 80, static=True),
        Property("ignored-lines", int, 2, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "fieldanalysis: needs video")
        require(in_spec.format in self.FORMATS,
                f"fieldanalysis: format {in_spec.format} unsupported")
        require(in_spec.height % 2 == 0, "fieldanalysis: needs even height")
        return in_spec

    def _same_field(self, f0, p0, f1, p1, nf):
        metric = self.props["field-metric"]
        if metric == "sad":
            return ops.same_parity_sad(f0, p0, f1, p1, nf)
        if metric == "3-tap":
            return ops.same_parity_3_tap(f0, p0, f1, p1, nf)
        return ops.same_parity_ssd(f0, p0, f1, p1, nf)

    def _same_frame(self, f0, p0, f1, nf):
        if self.props["frame-metric"] == "windowed-comb":
            return ops.windowed_comb(
                f0, p0, f1, self.props["spatial-threshold"],
                self.props["block-width"], self.props["block-height"],
                self.props["block-threshold"], self.props["ignored-lines"],
                self.in_spec.interlace_mode == "interleaved")
        return ops.opposite_parity_5_tap(f0, p0, f1, nf)

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        dev = self.device
        zero = {"y": torch.zeros((h, w), dtype=torch.uint8, device=dev)}
        if spec.format == VideoFormat.I420:
            for k in ("u", "v"):
                zero[k] = torch.zeros((h // 2, w // 2), dtype=torch.uint8,
                                      device=dev)
        init = {"prev_flags": 0, "prev_pts": 0, "prev_f": 0.0,
                "prev_concl": PROGRESSIVE, "prev_holding": -1,
                "have_prev": False, "first_buffer": True}
        return {"prev": zero, **dict(zip(_STATE, to_device(
            dev, *((init[k], _DTYPES[k]) for k in _STATE))))}

    def _metrics(self, pool_y, cur_idx, prev_idx, nf):
        if (self.props["field-metric"] == "ssd"
                and self.props["frame-metric"] == "5-tap"):
            return ops.metrics_default(pool_y, cur_idx, prev_idx, nf)
        y = pool_y[cur_idx.long()]
        prev = pool_y[prev_idx.long()]
        return (self._same_frame(y, 0, y, nf),
                self._same_field(y, 0, prev, 0, nf),
                self._same_field(y, 1, prev, 1, nf),
                self._same_frame(y, 0, prev, nf),
                self._same_frame(y, 1, prev, nf))

    def process(self, params, state, batch: FrameBatch):
        is_dict = isinstance(batch.data, dict)
        data = batch.data if is_dict else {"y": batch.data}
        dev = batch.pts.device
        b_sz = batch.batch

        # the previous valid frame of slot i (invalid window-adapter
        # padding slots are not buffer arrivals), planned on the device;
        # pool index 0 is the carried frame
        pos = torch.arange(b_sz, device=dev)
        vpos = torch.where(batch.valid, pos, -1)
        prev_idx = torch.cat([vpos.new_full((1,), -1),
                              torch.cummax(vpos, 0).values[:-1]]) + 1
        final_idx = (vpos.max() + 1).reshape(1)
        pool = {k: torch.cat([state["prev"][k][None], v])
                for k, v in data.items()}
        metrics = self._metrics(pool["y"], (pos + 1).to(torch.int32),
                                prev_idx.to(torch.int32),
                                params["noise-floor"])

        host = to_host(batch.pts, batch.flags, batch.valid,
                       torch.stack(metrics), params["field-threshold"],
                       params["frame-threshold"],
                       *(state[k] for k in _STATE))
        pts, in_flags, valid, scores, field_thresh, frame_thresh = host[:6]
        # prev_f stays an np.float32 scalar, the rest become Python values
        st = {k: (v[()] if k == "prev_f" else v.item())
              for k, v in zip(_STATE, host[6:])}
        field_thresh = _F32(field_thresh)
        frame_thresh = _F32(frame_thresh)
        out_pts = np.zeros(b_sz, np.int64)
        out_flags = np.zeros(b_sz, np.int32)
        out_valid = np.zeros(b_sz, bool)
        concl = np.zeros(b_sz, np.int32)
        for i in range(b_sz):
            f, t, b, t_b, b_t = scores[:, i]
            st, out_pts[i], out_flags[i], out_valid[i], concl[i] = decide(
                st, int(pts[i]), int(in_flags[i]), bool(valid[i]), f, t, b,
                t_b, b_t, field_thresh, frame_thresh)

        out_pts_t, out_flags_t, out_valid_t, *carried = to_device(
            dev, out_pts, out_flags, out_valid,
            *((st[k], _DTYPES[k]) for k in _STATE))
        new_state = {
            # the last valid frame of the window (or the carried one when
            # the window had no arrivals)
            "prev": {k: v.index_select(0, final_idx)[0]
                     for k, v in pool.items()},
            **dict(zip(_STATE, carried))}
        # the emitted frame of slot i is its previous valid frame
        frames = {k: v[prev_idx] for k, v in pool.items()}
        out = FrameBatch(data=frames if is_dict else frames["y"],
                         pts=out_pts_t, flags=out_flags_t, valid=out_valid_t)
        scores_t = torch.from_numpy(scores)
        msgs = {"fieldanalysis": {
            "_emit": torch.from_numpy(out_valid),
            "_pts": torch.from_numpy(out_pts),
            "conclusion": torch.from_numpy(concl),
            "f": scores_t[0], "t": scores_t[1], "b": scores_t[2],
            "t_b": scores_t[3], "b_t": scores_t[4],
        }}
        return new_state, out, msgs

    def drain(self, state):
        """EOS flush (gst_field_analysis_flush_one,
        gstfieldanalysis.c:692-722): emit the held frame."""
        have_prev, holding, concl, prev_pts = (
            v.item() for v in to_host(state["have_prev"],
                                      state["prev_holding"],
                                      state["prev_concl"],
                                      state["prev_pts"]))
        if not have_prev:
            return state, None
        if holding in (1, 2):  # 1 + TOP / 1 + BOTTOM: one field needed
            flags = (FLAG_TFF if holding == 1 else 0) | FLAG_ONEFIELD
        else:
            flags = FLAG_RFF if holding == 0 else 0
        if concl in (INTERLACED, TC_MIXED):
            flags |= FLAG_INTERLACED
        dev = state["prev_pts"].device
        frame = {k: v[None] for k, v in state["prev"].items()}
        batch = FrameBatch(
            data=(frame["y"] if self.in_spec.format == VideoFormat.GRAY8
                  else frame),
            pts=torch.tensor([prev_pts], dtype=torch.int64, device=dev),
            flags=torch.tensor([flags], dtype=torch.int32, device=dev),
            valid=torch.ones(1, dtype=torch.bool, device=dev))
        state = {**state, "have_prev": torch.tensor(False, device=dev)}
        return state, batch
