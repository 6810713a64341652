"""removesilence (gst/removesilence/) — VAD-gated silence dropper.

A window element whose decisions run on the host.  Per window:

1. on the device: each block's zero-crossing rate (ops.vad_zcr) and its
   power bracket (ops.vad_powers_bracket, a kernel on the card): the
   block's power at its end when run from 0 and from 2^32 - 1;
2. one copy to the host of those [nb] vectors, the pts, valid, the
   carried state and the properties;
3. when some block's bracket is open (its two ends differ), the exact
   serial recurrence over the whole window (ops.vad_powers_serial, a
   kernel on the card) and a second copy.  Blocks shorter than the
   ZCR ring (256 samples) skip the bracket and take the serial powers;
4. on the host: the VAD's hysteresis machine and the per-block silence
   step (gstremovesilence.c:181-250): drop, squash retiming, messages;
5. the new valid, pts and state go back to the device in one queued copy.

Dropping a buffer (GST_BASE_TRANSFORM_FLOW_DROPPED) becomes the window's
validity mask, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch, to_device, to_host
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat
from gstbad_tpu_torch.ops import audio as ops

_PARAMS = ("threshold", "hysteresis", "remove", "squash", "silent",
           "min-buffers", "min-time")
_STATE = (("consec_buffers", np.int64), ("consec_time", np.int64),
          ("silence_detected", np.bool_), ("ts_offset", np.int64))
_VAD = (("count", np.int64), ("power", np.int64), ("state", np.int32),
        ("samples", np.int64))


def silence_steps(frame_types, pts, dur: int, p, st):
    """The per-block silence step of gstremovesilence.c over one window's
    frame types (0 silence, 1 voice), on host ints.  p: the properties,
    st: the carried consec_buffers, consec_time, silence_detected and
    ts_offset (updated in place).  Returns per block (drop, out_pts,
    silence_detected message, silence_finished message, message pts)."""
    nb = len(frame_types)
    drop = np.zeros(nb, bool)
    out_pts = np.zeros(nb, np.int64)
    det = np.zeros(nb, bool)
    fin = np.zeros(nb, bool)
    msg_pts = np.zeros(nb, np.int64)
    no_minimums = p["min-buffers"] == 0 and p["min-time"] == 0
    for i, ft in enumerate(frame_types):
        is_sil = ft == 0
        st["consec_buffers"] = st["consec_buffers"] + 1 if is_sil else 0
        st["consec_time"] = st["consec_time"] + dur if is_sil else 0
        reached = is_sil and (no_minimums or (
            (p["min-buffers"] > 0
             and st["consec_buffers"] >= p["min-buffers"])
            or (p["min-time"] > 0 and st["consec_time"] >= p["min-time"])))
        det[i] = reached and not st["silence_detected"] and not p["silent"]
        fin[i] = (not is_sil and st["silence_detected"]
                  and not p["silent"])
        st["silence_detected"] = (st["silence_detected"] or reached
                                  if is_sil else False)
        drop[i] = p["remove"] and reached
        ts = st["ts_offset"]
        msg_pts[i] = pts[i] - ts
        out_pts[i] = pts[i] - ts if p["squash"] and ts > 0 else pts[i]
        if drop[i] and p["squash"]:
            st["ts_offset"] = ts + dur
    return drop, out_pts, det, fin, msg_pts


@register
class RemoveSilence(AudioFilter):
    """Defaults per gstremovesilence.c:55-62,217-222."""

    NAME = "removesilence"
    FORMATS = (AudioFormat.S16,)
    CHANNELS = (1, 1)
    PROPERTIES = (
        Property("remove", bool, False),
        Property("hysteresis", int, 480, 1, None),
        Property("threshold", int, -60, -70, 70),
        Property("squash", bool, False),
        Property("silent", bool, True),
        Property("minimum-silence-buffers", int, 0, 0, 10000),
        Property("minimum-silence-time", int, 0, 0, None),
    )

    def dynamic_params(self):
        # vad_set_threshold (vad_private.c:105-114)
        power = int(self.props["threshold"] / 10.0)
        values = {
            "threshold": (int((10.0 ** power) * 4294967295), torch.int64),
            "hysteresis": (self.props["hysteresis"], torch.int64),
            "remove": (self.props["remove"], torch.bool),
            "squash": (self.props["squash"], torch.bool),
            "silent": (self.props["silent"], torch.bool),
            "min-buffers": (self.props["minimum-silence-buffers"],
                            torch.int64),
            "min-time": (self.props["minimum-silence-time"], torch.int64),
        }
        return {k: torch.tensor(v, dtype=dt, device=self.device)
                for k, (v, dt) in values.items()}

    def init_state(self, batch: int):
        dev = self.device
        return {
            "vad": ops.vad_init_state(dev),
            "consec_buffers": torch.tensor(0, dtype=torch.int64, device=dev),
            "consec_time": torch.tensor(0, dtype=torch.int64, device=dev),
            "silence_detected": torch.tensor(False, device=dev),
            "ts_offset": torch.tensor(0, dtype=torch.int64, device=dev),
        }

    def process(self, params, state, batch: FrameBatch):
        x = batch.data[..., 0].contiguous()   # [B, S] mono S16
        nb, s = x.shape
        dev = x.device
        dur = int(round(1e9 * s / self.in_spec.rate))
        vad = state["vad"]

        zcr = ops.vad_zcr(vad["ring"], vad["count"], x)
        if s >= ops.VAD_RING:
            ends = ops.vad_powers_bracket(x)
        else:   # a short block's bracket never closes: go serial at once
            ends = (ops.vad_powers_serial(x, vad["power"]),) * 2
        host = to_host(*ends, zcr, batch.pts, batch.valid,
                       *(vad[k] for k, _ in _VAD),
                       *(state[k] for k, _ in _STATE),
                       *(params[k] for k in _PARAMS))
        lo, hi, zcr, pts, valid = host[:5]
        vst = {k: v.item() for (k, _), v in zip(_VAD, host[5:9])}
        st = {k: v.item() for (k, _), v in zip(_STATE, host[9:13])}
        p = {k: v.item() for k, v in zip(_PARAMS, host[13:])}
        powers = lo
        if not np.array_equal(lo, hi):
            (powers,) = to_host(ops.vad_powers_serial(x, vad["power"]))

        raw = (powers > p["threshold"]) & (zcr < 0)
        types, vst["state"], vst["samples"] = ops.vad_hysteresis(
            raw, vst["state"], vst["samples"], s, p["hysteresis"])
        drop, out_pts, det, fin, msg_pts = silence_steps(types, pts, dur, p,
                                                         st)

        # the ring keeps the stream's last 256 samples, sample a at a & 255
        m = nb * s
        tail = min(m, ops.VAD_RING)
        ring_pos = (vst["count"] + m - tail + np.arange(tail)) % ops.VAD_RING
        vst["count"] += m
        vst["power"] = int(powers[-1])
        valid_t, pts_t, pos_t, *carried = to_device(
            dev, valid & ~drop, out_pts, ring_pos,
            *((vst[k], dt) for k, dt in _VAD),
            *((st[k], dt) for k, dt in _STATE))
        ring = vad["ring"].index_copy(0, pos_t, x.reshape(-1)[m - tail:])
        new_state = {
            "vad": {"ring": ring, **dict(zip((k for k, _ in _VAD),
                                             carried[:4]))},
            **dict(zip((k for k, _ in _STATE), carried[4:]))}
        out = batch.replace(valid=valid_t, pts=pts_t)
        msgs = {"removesilence": {
            "_emit": torch.from_numpy(det | fin),
            "_pts": torch.from_numpy(msg_pts),
            "silence_detected": torch.from_numpy(det),
            "silence_finished": torch.from_numpy(fin),
        }}
        return new_state, out, msgs
