"""Gating elements — audiosegmentclip and videosegmentclip
(gst/segmentclip/), avwait (gst/timecode/gstavwait.c) and the `pad`
output picker for avwait's two outputs.  They are the elements that set
FrameBatch.trim: the runner cuts the trimmed samples on the host."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, require

NS = 10 ** 9


def _clip_trims(pts, s_blk: int, rate: int, start, end, passing):
    """(head, tail) samples to cut from blocks of s_blk samples at `pts`
    that pass and span `start` or `end` (end < 0: none), floor-scaled
    like gst_util_uint64_scale, as int32 [B] each."""
    blk_end = pts + s_blk * NS // rate
    zero = torch.zeros_like(pts)
    head = torch.where(passing & (pts < start), (start - pts) * rate // NS,
                       zero)
    tail = torch.where(passing & (end >= 0) & (blk_end > end),
                       s_blk - (end - pts) * rate // NS, zero)
    return (head.clamp(0, s_blk).to(torch.int32),
            tail.clamp(0, s_blk).to(torch.int32))


@register
class AudioSegmentClip(AudioFilter):
    """audiosegmentclip (gst/segmentclip/): drop buffers outside
    [start, stop] ns.  SAMPLE-exact like the reference's
    gst_audio_buffer_clip: boundary blocks spanning start/stop carry
    FrameBatch.trim (floor-scaled sample cuts) with the clipped-buffer
    PTS stamped to the segment start; the runner slices host-side."""

    NAME = "audiosegmentclip"
    FORMATS = AudioFormat.ALL
    PROPERTIES = (
        Property("start", int, 0),
        Property("stop", int, -1),
    )

    def process(self, params, state, batch: FrameBatch):
        start = params["start"].to(torch.int64)
        stop = params["stop"].to(torch.int64)
        s_blk = batch.data.shape[1]
        rate = self.out_spec.rate
        blk_end = batch.pts + s_blk * NS // rate
        inside = (blk_end > start) & ((stop < 0) | (batch.pts < stop))
        head, tail = _clip_trims(batch.pts, s_blk, rate, start, stop, inside)
        pts = torch.where(head > 0, start, batch.pts)
        return state, batch.replace(
            valid=batch.valid & inside, pts=pts,
            trim=torch.stack([head, tail], dim=-1))


@register
class VideoSegmentClip(Element):
    """videosegmentclip (gst/segmentclip/)."""

    NAME = "videosegmentclip"
    PROPERTIES = (
        Property("start", int, 0),
        Property("stop", int, -1),
    )

    def process(self, params, state, batch: FrameBatch):
        start = params["start"].to(torch.int64)
        stop = params["stop"].to(torch.int64)
        inside = (batch.pts >= start) & ((stop < 0) | (batch.pts <= stop))
        return state, batch.replace(valid=batch.valid & inside)


def _parse_tc(s: str):
    """'HH:MM:SS:FF' (or ';' separators, the drop-frame convention)."""
    parts = s.replace(";", ":").split(":")
    if len(parts) != 4:
        raise ValueError(f"timecode {s!r} must be HH:MM:SS:FF")
    return tuple(int(p) for p in parts)


def tc_frames_since_daily_jam(h: int, m: int, s: int, f: int,
                              nominal: int, drop: bool) -> int:
    """gst_video_time_code_frames_since_daily_jam: timecode -> frame count.
    Drop-frame skips `nominal//15` frame numbers each minute except every
    tenth (SMPTE 12M)."""
    if not drop:
        return ((h * 60 + m) * 60 + s) * nominal + f
    dropped = nominal // 15
    total_min = h * 60 + m
    return (((h * 60 + m) * 60 + s) * nominal + f
            - dropped * (total_min - total_min // 10))


@register
class Pad(Element):
    """Output-pad picker for multi-output elements (avwait's vsrc/asrc):
    `avwait name=w ...  w. ! pad index=0 ! ...  w. ! pad index=1 ! ...`."""

    NAME = "pad"
    PROPERTIES = (Property("index", int, 0, static=True),)

    def negotiate(self, in_spec):
        if isinstance(in_spec, (list, tuple)):
            return in_spec[self.props["index"]]
        return in_spec

    def process(self, params, state, batch):
        if isinstance(batch, (list, tuple)):
            return state, batch[self.props["index"]]
        return state, batch


@register
class AvWait(Element):
    """avwait (gst/timecode/gstavwait.c:24-45): drop everything until a
    target timecode / running time is reached, then pass through — audio
    starting with (never before) the video.  Inputs: video alone, or
    [video, audio] (launch fan-in `... ! w.`); with audio the output is a
    2-slot batch list routed through `pad index=` pickers.

    Modes (gstavwait.c:194-201): `timecode` (target-timecode-string against
    the frame timecode derived from PTS x framerate), `running-time`
    (PTS >= target-running-time), `video-first` (video passes immediately,
    audio waits for it).  `recording` acts as the master valve; toggling it
    back on re-arms the wait (gstavwait.c:216-222).  end-timecode-string /
    end-running-time close the gate.  Audio gating is SAMPLE-exact like
    the reference's gst_audio_buffer_clip: a boundary block spanning the
    gate carries FrameBatch.trim (head/tail samples to cut, floor-scaled
    like gst_util_uint64_scale) with the clipped-buffer PTS stamped to
    the gate time; the runner slices the trim away host-side."""

    NAME = "avwait"
    PROPERTIES = (
        Property("mode", str, "timecode", static=True,
                 doc="timecode | running-time | video-first"),
        Property("target-timecode-string", str, "00:00:00:00", static=True),
        Property("target-running-time", int, 0),
        Property("end-timecode-string", str, "", static=True),
        Property("end-running-time", int, -1),
        Property("recording", bool, True),
    )

    def negotiate(self, in_spec):
        specs = in_spec if isinstance(in_spec, (list, tuple)) else [in_spec]
        vspec = specs[0]
        require(vspec.kind == "video", "avwait: first input must be video")
        self._two = len(specs) > 1
        self._arate = specs[1].rate if self._two else 0
        mode = self.props["mode"]
        require(mode in ("timecode", "running-time", "video-first"),
                f"avwait: unknown mode {mode!r}")
        fr = vspec.framerate
        nominal = int(np.ceil(float(fr)))

        def tc_ns(s: str) -> int:
            frames = tc_frames_since_daily_jam(*_parse_tc(s), nominal,
                                               False)
            return frames * NS * fr.denominator // fr.numerator

        self._tc_target = (tc_ns(self.props["target-timecode-string"])
                           if mode == "timecode" else 0)
        end_s = self.props["end-timecode-string"]
        self._tc_end = tc_ns(end_s) if (mode == "timecode" and end_s) else -1
        return list(specs) if self._two else vspec

    def init_state(self, batch: int):
        return {"vstart": torch.tensor(-1, dtype=torch.int64,
                                       device=self.device),
                "was_rec": torch.tensor(True, device=self.device)}

    def process(self, params, state, batch):
        v = batch[0] if self._two else batch
        a = batch[1] if self._two else None
        rec = params["recording"]
        mode = self.props["mode"]

        def i64(x):
            return torch.tensor(x, dtype=torch.int64, device=v.pts.device)

        # re-arm on a recording rising edge (gstavwait.c:216-222)
        vstart = torch.where(rec & ~state["was_rec"], i64(-1),
                             state["vstart"])
        if mode == "running-time":
            tgt = params["target-running-time"].to(torch.int64)
            end = params["end-running-time"].to(torch.int64)
        elif mode == "timecode":
            tgt, end = i64(self._tc_target), i64(self._tc_end)
        else:  # video-first
            tgt = i64(-(2 ** 62))
            end = params["end-running-time"].to(torch.int64)
        vpass = v.valid & rec & (v.pts >= tgt) & ((end < 0) | (v.pts < end))
        first = torch.where(vpass, v.pts, i64(2 ** 62)).min()
        vstart = torch.where(vstart >= 0, vstart,
                             torch.where(vpass.any(), first, i64(-1)))
        opened = (state["vstart"] < 0) & (vstart >= 0)
        new_state = {"vstart": vstart, "was_rec": rec.clone()}
        msgs = {"avwait-status": {
            "running_time": vstart[None],
            "dropping": (~(vstart >= 0))[None],
            "_emit": opened[None],
            "_pts": torch.where(vstart >= 0, vstart, i64(0))[None]}}
        vout = v.replace(valid=vpass)
        if not self._two:
            return new_state, vout, msgs
        # sample-exact audio gate (gst_audio_buffer_clip semantics):
        # boundary blocks spanning the gate pass with head/tail trims
        s_blk = a.data.shape[1]
        a_end = a.pts + s_blk * NS // self._arate
        apass = a.valid & rec & (vstart >= 0) & (a_end > vstart) & \
            ((end < 0) | (a.pts < end))
        head, tail = _clip_trims(a.pts, s_blk, self._arate, vstart, end,
                                 apass)
        a_pts = torch.where(head > 0, vstart, a.pts)
        aout = a.replace(valid=apass, pts=a_pts,
                         trim=torch.stack([head, tail], dim=-1))
        return new_state, [vout, aout], msgs
