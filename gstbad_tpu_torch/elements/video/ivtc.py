"""ivtc + combdetect (gst/ivtc/) — inverse telecine over a field queue.

The reference keeps a queue of field buffers and per output frame picks
weave vs single-field reconstruction by comb-score thresholds
(gstivtc.c construct_frame).  Fields only ever arrive in order and retire
from the front, so every comb score construct_frame can ask for is the
score of an adjacent pair in arrival order.  A window therefore lays its
fields out as one dense sequence of pool indices (queue leftovers first,
then this window's candidates) and takes three steps:

1. the flags, pts and valid come to the host in one copy, which plans the
   dense sequence; every adjacent pair that can be read is scored on the
   device in one pass (ops.comb_score_pairs, a hand-written kernel on the
   card), and the scores come back in a second copy;
2. the construct/retire loop runs on the host over those ints;
3. the output frames are built on the device: one batched weave for all
   output slots and one batched reconstruct_single for the slots that take
   the single-field branch.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import (FLAG_ONEFIELD, FLAG_RFF, FLAG_TFF,
                                         FrameBatch, to_device, to_host)
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops import comb as comb_ops
from gstbad_tpu_torch.ops import ivtc as ivtc_ops

CAP = 8  # field queue capacity (reference GST_IVTC_MAX_FIELDS = 10)
THRESHOLD = 100
EARLY_NS = 50_000_000   # fields this far behind the output clock retire

WEAVE_NEXT, WEAVE_PREV, SINGLE, NONE = 0, 1, 2, 3


def _emission_plan(seq_par, seq_ts, pair_scores, arrivals, count,
                   current_ts, out_dur):
    """construct_frame (gstivtc.c:565-630) and the early retire
    (gstivtc.c:536-540) over one window, on host ints.  Two output slots
    per input frame; each slot is (kind, j1, j2, pts, valid) with j1, j2
    positions in the dense sequence.  Returns the slots and the final
    (head, count, current_ts)."""
    slots = []
    head = 0
    for arr in arrivals:
        count += int(arr)
        live = seq_ts[head:head + count]
        n_ret = int(np.count_nonzero(live + EARLY_NS < current_ts))
        head += n_ret
        count -= n_ret
        for _ in range(2):
            if count < 4:
                slots.append((NONE, 0, 0, 0, False))
                continue
            forward_ok = bool(seq_ts[head + 1] < current_ts)
            prev_score = pair_scores[head]
            next_score = pair_scores[head + 1]
            use_next_a = forward_ok and next_score < prev_score
            branch_prev = prev_score < THRESHOLD
            branch_next = not branch_prev and next_score < THRESHOLD
            if branch_prev:
                kind = WEAVE_NEXT if use_next_a else WEAVE_PREV
                n_retire = 3 if use_next_a else 2
            elif branch_next:
                kind = WEAVE_NEXT
                n_retire = 3 if forward_ok else 2
            else:
                kind = SINGLE
                n_retire = 2
            j2 = head + 2 if kind == WEAVE_NEXT else head
            slots.append((kind, head + 1, j2, current_ts, True))
            head += n_retire
            count -= n_retire
            current_ts += out_dur
    return slots, head, count, current_ts


@register
class Ivtc(VideoFilter):
    """Inverse telecine.  The reference strips framerate and forces
    progressive in transform_caps (gstivtc.c:160-185); downstream picks the
    rate — here the `output-framerate` property (default 4/5 of the input,
    the 30000/1001 -> 24000/1001 pulldown inverse)."""

    NAME = "ivtc"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)
    PROPERTIES = (Property("output-framerate", str, "", static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "ivtc: needs video")
        require(in_spec.format in self.FORMATS,
                f"ivtc: format {in_spec.format} unsupported")
        fr = self.props["output-framerate"]
        out_fr = (Fraction(fr) if fr
                  else in_spec.framerate * Fraction(4, 5))
        return in_spec.with_(framerate=out_fr,
                             interlace_mode="progressive")

    def init_state(self, batch: int):
        spec = self.in_spec
        h, w = spec.height, spec.width
        dev = self.device
        planes = {"y": torch.zeros((CAP, h, w), dtype=torch.uint8,
                                   device=dev)}
        if spec.format == VideoFormat.I420:
            for k in ("u", "v"):
                planes[k] = torch.zeros((CAP, h // 2, w // 2),
                                        dtype=torch.uint8, device=dev)
        return {
            "q": planes,
            "parity": torch.zeros(CAP, dtype=torch.int32, device=dev),
            "ts": torch.zeros(CAP, dtype=torch.int64, device=dev),
            "head": torch.tensor(0, dtype=torch.int32, device=dev),
            "count": torch.tensor(0, dtype=torch.int32, device=dev),
            "current_ts": torch.tensor(0, dtype=torch.int64, device=dev),
        }

    def process(self, params, state, batch: FrameBatch):
        field_dur = self.in_spec.frame_duration_ns // 2
        out_dur = self.out_spec.frame_duration_ns
        is_dict = isinstance(batch.data, dict)
        data = batch.data if is_dict else {"y": batch.data}
        dev = batch.pts.device
        b = batch.batch

        pts, flags, valid, q_par, q_ts, head, count, current_ts = to_host(
            batch.pts, batch.flags, batch.valid, state["parity"],
            state["ts"], state["head"], state["count"], state["current_ts"])
        head, count, current_ts = int(head), int(count), int(current_ts)

        # ---- the dense field sequence: pool index, parity and ts of the
        # field at each position; position L is the dump of every unused
        # slot.  Pool = the carried ring slots, then this window's frames.
        L = CAP + 3 * b
        slot = np.arange(CAP)
        ring = (head + slot) % CAP
        pos_old = np.where(slot < count, slot, L)
        seq_src = np.zeros(L + 1, np.int64)
        seq_par = np.zeros(L + 1, np.int32)
        seq_ts = np.zeros(L + 1, np.int64)
        seq_src[pos_old] = ring
        seq_par[pos_old] = q_par[ring]
        seq_ts[pos_old] = q_ts[ring]

        p0 = np.where((flags & FLAG_TFF) != 0, 0, 1).astype(np.int32)
        onefield = (flags & FLAG_ONEFIELD) != 0
        rff = (flags & FLAG_RFF) != 0
        cand_par = np.stack([p0, 1 - p0, p0], axis=1).reshape(3 * b)
        # an invalid input slot (window-adapter rate padding) contributes
        # no fields: the reference's chain() never sees such buffers
        cand_valid = (np.stack([np.ones(b, bool), ~onefield, ~onefield & rff],
                               axis=1) & valid[:, None]).reshape(3 * b)
        cand_ts = (pts[:, None] + np.arange(3, dtype=np.int64)[None, :]
                   * field_dur).reshape(3 * b)
        cv = cand_valid.astype(np.int64)
        cpos = np.where(cand_valid, count + np.cumsum(cv) - cv, L)
        seq_src[cpos] = CAP + np.repeat(np.arange(b), 3)
        seq_par[cpos] = cand_par
        seq_ts[cpos] = cand_ts
        arrivals = cand_valid.reshape(b, 3).sum(axis=1)

        # every adjacent pair among the live positions, scored in one pass;
        # the parity select happens on the indices
        live = count + int(cv.sum())
        ids = np.arange(max(live - 1, 0))
        tf = seq_par[ids] == 0
        top = np.where(tf, seq_src[ids], seq_src[ids + 1]).astype(np.int32)
        bot = np.where(tf, seq_src[ids + 1], seq_src[ids]).astype(np.int32)
        pool = {k: torch.cat([state["q"][k], v]) for k, v in data.items()}
        scored = comb_ops.comb_score_pairs(pool["y"],
                                           *to_device(dev, top, bot))
        pair_scores = np.zeros(L, np.int32)
        pair_scores[:len(ids)] = to_host(scored)[0]

        slots, head_abs, count, current_ts = _emission_plan(
            seq_par, seq_ts, pair_scores, arrivals, count, current_ts,
            out_dur)

        # ---- frames: a weave for every slot (an empty slot weaves pool
        # frame 0 with itself), then the single-field slots rebuilt
        kind = np.array([s[0] for s in slots])
        j1 = np.array([s[1] for s in slots])
        j2 = np.array([s[2] for s in slots])
        f1, f2 = seq_src[j1], seq_src[j2]
        first_top = seq_par[j1] == 0
        w_top = np.where(kind == NONE, 0, np.where(first_top, f1, f2))
        w_bot = np.where(kind == NONE, 0, np.where(first_top, f2, f1))
        single = np.nonzero(kind == SINGLE)[0]
        tail = np.clip(head_abs + slot, 0, L)
        (w_top_t, w_bot_t, s_slot, s_src, s_par, tail_src, q_par, q_ts,
         out_pts, out_valid, *scalars) = to_device(
            dev, w_top, w_bot, single, f1[single], seq_par[j1[single]],
            seq_src[tail], seq_par[tail], seq_ts[tail],
            np.array([s[3] for s in slots], np.int64),
            np.array([s[4] for s in slots], bool),
            (0, np.int32), (count, np.int32), (current_ts, np.int64))
        frames = {}
        for k, v in pool.items():
            out = ivtc_ops.weave(v[w_top_t], v[w_bot_t])
            if len(single):
                rebuild = (ivtc_ops.reconstruct_single_luma if k == "y"
                           else ivtc_ops.reconstruct_single_chroma)
                out[s_slot] = rebuild(v[s_src], s_par)
            frames[k] = out

        # the surviving tail of the dense sequence becomes the ring state
        # (head renormalised to 0; slots past count are never read)
        new_state = {"q": {k: v[tail_src] for k, v in pool.items()},
                     "parity": q_par, "ts": q_ts,
                     **dict(zip(("head", "count", "current_ts"), scalars))}
        out = FrameBatch(
            data=frames if is_dict else frames["y"], pts=out_pts,
            flags=torch.zeros(2 * b, dtype=torch.int32, device=dev),
            valid=out_valid)
        return new_state, out


@register
class CombDetect(VideoFilter):
    """combdetect (gstcombdetect.c): paint zebra over combed cells; border
    rows (j<2, j>=h-2) are halved."""

    NAME = "combdetect"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        return torch.tensor(0, dtype=torch.int32, device=self.device)

    def process(self, params, state, batch: FrameBatch):
        is_dict = isinstance(batch.data, dict)
        y = batch.data["y"] if is_dict else batch.data
        b, h, w = y.shape
        dev = y.device
        z = state + 1 + torch.arange(b, dtype=torch.int32, device=dev)
        # one comb chain pass for the window (a kernel on the card)
        mask, _ = comb_ops.comb_mask(y)
        i = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :]
        j = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None]
        stripe = ((i + j + z[:, None, None]) & 0x4) != 0
        zebra = torch.where(stripe, 235, 16).to(torch.uint8)
        out_y = torch.where(mask, zebra, y)
        border = (j < 2) | (j >= h - 2)
        out_y = torch.where(border, y // 2, out_y)
        out = {**batch.data, "y": out_y} if is_dict else out_y
        return state + b, batch.with_data(out)
