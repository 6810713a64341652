"""Smaller reference plugins: accurip, the gating elements
audiosegmentclip and videosegmentclip (gst/segmentclip/) and avwait
(gst/timecode/gstavwait.c) with the `pad` output picker for its two
outputs, speed, timecodestamper, autoconvert, switchbin, the rawparse
elements videoparse and audioparse, and uvch264mjpgdemux.  The gating
elements set FrameBatch.trim: the runner cuts the trimmed samples on the
host."""

from __future__ import annotations

import shlex
from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import make, register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, \
    VideoFormat, require
from gstbad_tpu_torch.golden.audio import speed_resample_indices
from gstbad_tpu_torch.io import uvch264 as _uvch264
from gstbad_tpu_torch.ops.numerics import fma32

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
class AccurateRip(Element):
    """accurip (gst/accurip/gstaccurip.c): AccurateRip v1/v2 CRCs of S16
    stereo audio, accumulated on the host after every window and read at
    EOS through `crc` and `crc_v2`."""

    NAME = "accurip"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self._offset = 1  # AccurateRip sample index is 1-based
        self._crc_v1 = 0
        self._crc_v2 = 0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        x = np.asarray(np_batch.data).reshape(-1, 2).astype(np.uint16)
        values = (x[:, 1].astype(np.uint32) << 16) | x[:, 0]
        idx = np.arange(self._offset, self._offset + len(values),
                        dtype=np.uint64)
        prod = idx * values
        self._crc_v1 = (self._crc_v1
                        + int(prod.sum() & 0xFFFFFFFF)) & 0xFFFFFFFF
        self._crc_v2 = (self._crc_v2
                        + int((prod & 0xFFFFFFFF).sum() & 0xFFFFFFFF)
                        + int((prod >> 32).sum() & 0xFFFFFFFF)) & 0xFFFFFFFF
        self._offset += len(values)

    @property
    def crc(self):
        return self._crc_v1

    @property
    def crc_v2(self):
        return self._crc_v2


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


@register
class Speed(AudioFilter):
    """speed (gst/speed/gstspeed.c:433-511, :580-640): per-buffer linear
    resample walk.  The reference restarts i_float = 0.5*(speed-1) on every
    buffer (no carried phase) and blends the previously SELECTED sample with
    in[ceil(i_float)]; the walk is static per (block size, speed), so the
    gather indices and float32 weights are made once on the host and the
    window's work is two gathers and a weighted sum, rounded as the JAX
    package's compiled window rounds it: one FMA over the second product.
    Output PTS follows the reference's perfect-stream rule: timestamp =
    scale(out_offset, GST_SECOND, rate) accumulated across buffers
    (carried in state)."""

    NAME = "speed"
    FORMATS = (AudioFormat.F32, AudioFormat.S16)
    PROPERTIES = (Property("speed", float, 1.0, 0.1, 40.0, static=True),)

    def prepare(self) -> None:
        self._walks = {}

    def _walk(self, s: int):
        """(prev index, index, 1 - weight, weight) on the device for
        blocks of s samples."""
        if s not in self._walks:
            prev_idx, idx, interp = speed_resample_indices(
                s, self.props["speed"])
            dev = self.device
            self._walks[s] = (
                torch.from_numpy(prev_idx.astype(np.int64)).to(dev),
                torch.from_numpy(idx.astype(np.int64)).to(dev),
                torch.from_numpy(np.float32(1) - interp).to(dev)[None, :,
                                                                 None],
                torch.from_numpy(interp).to(dev)[None, :, None])
        return self._walks[s]

    def init_state(self, batch: int):
        return {"offset": torch.zeros((), dtype=torch.int64,
                                      device=self.device)}

    def process(self, params, state, batch: FrameBatch):
        x = batch.data.to(torch.float32)
        b, s, _ = x.shape
        prev_idx, idx, w0, w1 = self._walk(s)
        y = fma32(x[:, prev_idx], w0, x[:, idx] * w1)
        if self.in_spec.format == AudioFormat.S16:
            y = torch.trunc(y).to(torch.int16)  # C gfloat->gint16 cast
        j = idx.shape[0]
        offs = state["offset"] + torch.arange(
            b, dtype=torch.int64, device=x.device) * j
        pts = offs * NS // self.in_spec.rate
        state = {"offset": state["offset"] + b * j}
        return state, batch.with_data(y).replace(pts=pts)


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


def frames_to_tc(fc, nominal: int, drop: bool):
    """Frame counts (int64 tensor) -> (h, m, s, f) tensors; inverse of
    the above (SMPTE drop-frame re-insertion, cf. gstvideotimecode.c
    add_frames).  torch's // and % on int64 floor, as Python's do."""
    if drop:
        dropped = nominal // 15
        fp10 = nominal * 600 - dropped * 9   # frames per 10 minutes
        fpm = nominal * 60 - dropped         # frames per (dropped) minute
        d = fc // fp10
        m = fc % fp10
        extra = dropped * 9 * d + dropped * ((m - dropped) // fpm).clamp(
            min=0)
        fc = fc + extra
    f = fc % nominal
    total_sec = fc // nominal
    return (total_sec // 3600, (total_sec // 60) % 60, total_sec % 60, f)


@register
class TimecodeStamper(Element):
    """timecodestamper (gst/timecode/gsttimecodestamper.c): attach SMPTE
    timecode per frame, posted as messages (our buffers carry no meta
    list; the message stream is the metadata channel).

    Reference properties covered: source (internal|zero|last-known|
    last-known-or-zero), set (always|keep|never), drop-frame (SMPTE 12M
    drop-frame counting for 1001-denominator rates), post-messages,
    set-internal-timecode (HH:MM:SS:FF), timecode-offset.  The LTC/RTC
    sources and timeout/auto-resync knobs bind to hardware jam-sync
    inputs and the pipeline clock (gsttimecodestamper.c:254-311) — no
    analog exists in the window model; requesting them raises.  Frame
    counts are int64 on the device."""

    NAME = "timecodestamper"
    PROPERTIES = (
        Property("source", str, "internal", static=True),
        Property("set", str, "always", static=True),
        Property("drop-frame", bool, False, static=True),
        Property("post-messages", bool, True, static=True),
        Property("set-internal-timecode", str, "", static=True),
        Property("timecode-offset", int, 0, static=True),
        Property("fps-numerator-override", int, 0, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        if self.props["source"] in ("ltc", "rtc"):
            raise ValueError(
                "timecodestamper: ltc/rtc sources need hardware jam-sync "
                "inputs; use source=internal or zero")

    def negotiate(self, in_spec):
        require(in_spec.kind == "video", "timecodestamper: needs video")
        fr = in_spec.framerate
        self._nominal = int(np.ceil(float(fr)))
        # drop-frame only exists for fractional (1001-denominator) rates
        self._drop = bool(self.props["drop-frame"]) and fr.denominator != 1
        start = self.props["set-internal-timecode"]
        self._start_frames = 0
        if start:
            self._start_frames = tc_frames_since_daily_jam(
                *_parse_tc(start), self._nominal, self._drop)
        return in_spec

    def init_state(self, batch: int):
        return {"count": torch.zeros((), dtype=torch.int64,
                                     device=self.device)}

    def process(self, params, state, batch: FrameBatch):
        b = batch.batch
        fixed = self._start_frames + self.props["timecode-offset"]
        base = (torch.full((), fixed, dtype=torch.int64, device=self.device)
                if self.props["source"] == "zero"
                else state["count"] + fixed)
        fc = (base + torch.arange(b, dtype=torch.int64,
                                  device=self.device)).clamp(min=0)
        h, m, s, f = frames_to_tc(fc, self._nominal, self._drop)
        state = {"count": state["count"] + b}
        if self.props["set"] == "never" or not self.props["post-messages"]:
            return state, batch
        msgs = {"timecode": {"hours": h, "minutes": m, "seconds": s,
                             "frames": f,
                             "drop_frame": torch.full(
                                 (b,), self._drop, device=self.device)}}
        return state, batch, msgs


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


def _make_chain(desc: str):
    """Build a list of elements from `name prop=v [! name ...]` syntax."""
    chain = []
    for seg in desc.split("!"):
        toks = shlex.split(seg.strip())
        if not toks:
            continue
        props = dict(t.split("=", 1) for t in toks[1:])
        chain.append(make(toks[0], **props))
    return chain


class _ChildChain(Element):
    """Shared child-chain hosting for autoconvert/switchbin: the selected
    chain's elements, on this element's device, compose into this node's
    process (a bin whose choice is re-evaluated at every (re)negotiation —
    the caps-change re-selection path of the references runs through the
    Pipeline's rebuild)."""

    def _select(self, in_spec: MediaSpec):
        raise NotImplementedError

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        self._chain = self._select(in_spec)
        spec = in_spec
        for el in self._chain:
            el.device = self.device
            spec = el.set_info(spec)
        return spec

    @property
    def chosen(self):
        return self._chain[0] if len(self._chain) == 1 else self._chain

    def init_state(self, batch: int):
        return [el.init_state(batch) for el in self._chain]

    def dynamic_params(self):
        return [el.dynamic_params() for el in self._chain]

    def process(self, params, state, batch: FrameBatch):
        new_state = list(state)
        messages = {}
        for i, el in enumerate(self._chain):
            out = el.process(params[i], state[i], batch)
            if len(out) == 3:
                new_state[i], batch, msgs = out
                messages.update(msgs)
            else:
                new_state[i], batch = out
        return (new_state, batch, messages) if messages \
            else (new_state, batch)


@register
class AutoConvert(_ChildChain):
    """autoconvert (gst/autoconvert/gstautoconvert.c:23-35): pick the first
    element from `factories` whose negotiation accepts the input spec
    (the reference's caps-on-both-sides check; with forward-only
    negotiation the no-factories default resolves to the passthrough).
    When caps change (a live rebuild renegotiates), the choice is
    re-made — the reference's "may change the selected element" path."""

    NAME = "autoconvert"
    PROPERTIES = (Property("factories", str, "", static=True,
                           doc="comma-separated candidate element names "
                               "(empty = scan the registry)"),)

    def __init__(self, **props):
        if "elements" in props:  # back-compat alias
            props["factories"] = props.pop("elements")
        super().__init__(**props)

    def _select(self, in_spec: MediaSpec):
        factories = [s.strip() for s in
                     self.props["factories"].split(",") if s.strip()]
        if not factories:
            # no factories = "look at all available elements" picking one
            # matching the caps on both sides; with forward-only
            # negotiation the downstream constraint IS the input spec, so
            # the rank-correct pick is the passthrough
            factories = ["identity"]
        errors = []
        for name in factories:
            el = make(name)
            try:
                el.set_info(in_spec)
                return [make(name)]  # fresh instance (set_info is 1-shot)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{name}: {e}")
        raise ValueError(f"{self.NAME}: no candidate accepted {in_spec}: "
                         f"{errors}")


@register
class SwitchBin(_ChildChain):
    """switchbin (gst/switchbin/gstswitchbin.c:26-55): N (caps, element)
    paths; the FIRST path whose caps intersect the input spec is picked,
    ANY is the catch-all.  Flat launch syntax stands in for the reference's
    path0::caps/path0::element child properties:

        switchbin paths="video/x-raw,format=GRAY8 : edgedetect ;
                         ANY : identity"
    """

    NAME = "switchbin"
    PROPERTIES = (Property("paths", str, "ANY : identity", static=True,
                           doc="semicolon-separated `caps : element-chain` "
                               "paths, checked in order"),)

    @staticmethod
    def _caps_match(caps: str, spec: MediaSpec) -> bool:
        caps = caps.strip()
        if caps in ("ANY", "*", ""):
            return True
        media, _, rest = caps.partition(",")
        kind = {"video/x-raw": "video", "audio/x-raw": "audio"}.get(
            media.strip())
        if kind and spec.kind != kind:
            return False
        for cond in filter(None, (c.strip() for c in rest.split(","))):
            k, _, v = cond.partition("=")
            k, v = k.strip(), v.strip()
            have = getattr(spec, k, None)
            if have is None:
                return False
            if str(have) != v and have != type(have)(v):
                return False
        return True

    def _select(self, in_spec: MediaSpec):
        errors = []
        for path in self.props["paths"].split(";"):
            caps, _, chain = path.partition(":")
            if not chain:
                raise ValueError(f"switchbin: path {path!r} needs "
                                 "`caps : element`")
            if self._caps_match(caps, in_spec):
                return _make_chain(chain)
            errors.append(caps.strip())
        raise ValueError(f"{self.NAME}: no path caps matched {in_spec} "
                         f"(tried {errors})")


def _upload_window(device, frames, pts, window: int) -> FrameBatch:
    """A window of `window` frames on `device` in one copy: the n frames
    given, then invalid copies of the last up to the window (a host
    source's short last window)."""
    n = len(frames)
    pad = window - n
    return upload_frames(
        device, frames + [frames[-1]] * pad,
        pts=list(pts) + [int(pts[-1])] * pad,
        flags=np.zeros(window, np.int32),
        valid=[True] * n + [False] * pad)


@register
class VideoParse(Element):
    """videoparse (gst/rawparse/): frame raw bytes into video frames.
    Use via `push_bytes` + appsrc-style pull (host source); a window goes
    to the device as one host buffer in one copy."""

    NAME = "videoparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("format", str, "GRAY8", static=True),
        Property("width", int, 320, static=True),
        Property("height", int, 240, static=True),
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0

    def negotiate(self, in_spec):
        num, _, den = self.props["framerate"].partition("/")
        return MediaSpec(kind="video", format=self.props["format"],
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(int(num), int(den or "1")))

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def _frame_size(self):
        w, h = self.props["width"], self.props["height"]
        fmt = self.props["format"]
        if fmt == VideoFormat.GRAY8:
            return w * h
        if fmt == VideoFormat.I420:
            return w * h * 3 // 2
        return w * h * VideoFormat.n_channels(fmt)

    def pull_window(self, window: int):
        fsz = self._frame_size()
        n = min(len(self._buf) // fsz, window)
        if n == 0:
            return None
        w, h = self.props["width"], self.props["height"]
        fmt = self.props["format"]
        frames = []
        for i in range(n):
            raw = np.frombuffer(self._buf, np.uint8, fsz, i * fsz)
            if fmt == VideoFormat.GRAY8:
                frames.append(raw.reshape(h, w))
            elif fmt == VideoFormat.I420:
                frames.append({
                    "y": raw[:w * h].reshape(h, w),
                    "u": raw[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
                    "v": raw[w * h * 5 // 4:].reshape(h // 2, w // 2)})
            else:
                c = VideoFormat.n_channels(fmt)
                frames.append(raw.reshape(h, w, c))
        dur = self.out_spec.frame_duration_ns
        pts = np.arange(self._n, self._n + n) * dur
        self._n += n
        batch = _upload_window(self.device, frames, pts, window)
        self._buf = self._buf[n * fsz:]
        return batch

    def process(self, params, state, batch):
        return state, batch


@register
class AudioParse(Element):
    """audioparse (gst/rawparse/): frame raw bytes into PCM blocks (a
    window to the device in one copy)."""

    NAME = "audioparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("format", str, AudioFormat.S16, static=True),
        Property("rate", int, 48000, static=True),
        Property("channels", int, 2, static=True),
        Property("samplesperbuffer", int, 1024, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._n = 0

    def negotiate(self, in_spec):
        return MediaSpec(kind="audio", format=self.props["format"],
                         rate=self.props["rate"],
                         channels=self.props["channels"])

    def push_bytes(self, data: bytes) -> None:
        self._buf += data

    def pull_window(self, window: int):
        c = self.props["channels"]
        s = self.props["samplesperbuffer"]
        dt = np.dtype(AudioFormat.dtype(self.props["format"]))
        bsz = s * c * dt.itemsize
        n = min(len(self._buf) // bsz, window)
        if n == 0:
            return None
        raw = np.frombuffer(self._buf, dt, n * s * c).reshape(n, s, c)
        dur = int(1e9 * s / self.props["rate"])
        pts = np.arange(self._n, self._n + n) * dur
        self._n += n
        batch = _upload_window(self.device, list(raw), pts, window)
        self._buf = self._buf[n * bsz:]
        return batch

    def process(self, params, state, batch):
        return state, batch


@register
class UvcH264MjpgDemux(Element):
    """uvch264mjpgdemux (sys/uvch264/gstuvch264_mjpgdemux.c): strips
    the APP4 auxiliary segments out of UVC H.264 camera MJPEG frames,
    reassembling the H264/YUY2/NV12 payloads; timestamps follow the
    header (duration = frame_interval * 100ns, dts = pts - delay).  A
    host byte element: io/uvch264.py walks the bytes."""

    NAME = "uvch264mjpgdemux"
    KIND = "host-source"
    PROPERTIES = ()

    def chain(self, data: bytes, pts_ns: int = -1):
        """-> {"jpeg": bytes, "aux": [{fourcc,width,height,duration,
        pts,dts,data}]}"""
        jpeg, auxes = _uvch264.demux_mjpg(data)
        out = []
        for a in auxes:
            dur = a.frame_interval * 100
            pts = pts_ns
            dts = max(0, pts - a.delay_ms * 1_000_000) \
                if pts >= 0 else -1
            out.append(dict(fourcc=a.fourcc, width=a.width,
                            height=a.height, duration=dur, pts=pts,
                            dts=dts, data=a.data))
        return dict(jpeg=jpeg, aux=out)
