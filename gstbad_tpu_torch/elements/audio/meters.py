"""videoframe-audiolevel and audiolatency (gst/videoframe_audiolevel/,
gst/audiolatency/)."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch, to_device, to_host
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, require
from gstbad_tpu_torch.ops.numerics import true_div


@register
class VideoFrameAudioLevel(AudioFilter):
    """Per-video-frame RMS meter (gstvideoframe-audiolevel.c:26-32).

    With two inputs (video, then audio: the reference's vsink and asink
    pads) the audio samples bin to the video frames by pts, one message
    per video frame, and the video passes through.  With one (audio)
    input, one message per audio block.  rms = sqrt(mean(sample^2)) on
    samples normalized to [-1, 1], in float64."""

    NAME = "videoframe-audiolevel"
    N_INPUTS = 2
    FORMATS = AudioFormat.ALL
    PROPERTIES = (Property("framerate", str, "30/1", static=True),)

    def negotiate(self, in_spec):
        if isinstance(in_spec, list):
            video, audio = in_spec
            require(video.kind == "video" and audio.kind == "audio",
                    "videoframe-audiolevel: needs (video, audio) inputs")
            self._audio_spec = audio
            return video
        self._audio_spec = in_spec
        return in_spec

    def _norm(self, x):
        fmt = self._audio_spec.format
        if fmt == AudioFormat.S16:
            return true_div(x.to(torch.float64), 32768.0)
        if fmt == AudioFormat.S32:
            return true_div(x.to(torch.float64), 2147483648.0)
        return x.to(torch.float64)

    def process(self, params, state, batch):
        if isinstance(batch, list):
            video, audio = batch
            xf = self._norm(audio.data)          # [Ba, S, C]
            _, s, c = xf.shape
            dev = xf.device
            rate = self._audio_spec.rate
            sample_pts = (audio.pts[:, None] + (torch.arange(
                s, dtype=torch.int64, device=dev) * int(round(1e9 / rate))
                )[None, :]).reshape(-1)
            sq = (xf * xf).reshape(-1, c)
            lo = video.pts[:, None]
            hi = lo + self.out_spec.frame_duration_ns
            m = ((sample_pts[None, :] >= lo)
                 & (sample_pts[None, :] < hi)).to(torch.float64)
            counts = torch.clamp(m.sum(dim=1), min=1.0)
            rms = torch.sqrt(m @ sq / counts[:, None])
            return state, video, {"videoframe-audiolevel": {"rms": rms}}
        xf = self._norm(batch.data)
        rms = torch.sqrt(torch.mean(xf * xf, dim=1))
        return state, batch, {"videoframe-audiolevel": {"rms": rms}}


@register
class AudioLatency(AudioFilter):
    """audiolatency (gst/audiolatency/gstaudiolatency.c): tick-probe
    round-trip latency meter.

    The output is a 10 ms 440 Hz tick burst at every whole second of
    stream time; the input is searched for the first |x| > 0.7 sample of
    each frame (buffer_has_wave, :368), whose offset into its second is
    the loop latency.  A ring of the last 5 latencies gives the average,
    posted with the last one as a `latency` message in microseconds
    (:287-310).  The per-frame acceptance walk runs on the host over the
    window's per-frame hits (one copy each way)."""

    NAME = "audiolatency"
    FORMATS = (AudioFormat.F32,)   # the reference's caps are F32
    PROPERTIES = (Property("print-latency", bool, False),)

    TICK_HZ = 440.0
    TICK_NS = 10_000_000   # 10 ms burst

    def init_state(self, batch: int):
        def i64(v, shape=()):
            return torch.full(shape, v, dtype=torch.int64,
                              device=self.device)

        return {"ring": i64(0, (5,)), "idx": i64(0), "count": i64(0),
                "last_bucket": i64(-1)}

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        dev = batch.data.device
        rate = self.in_spec.rate
        offs = (torch.arange(s, dtype=torch.int64, device=dev)
                * 1_000_000_000) // rate
        pos = batch.pts[:, None] + offs[None, :]
        # the output: tick bursts at whole seconds
        frac = torch.remainder(pos, 1_000_000_000)
        in_burst = frac < self.TICK_NS
        t = true_div(frac.to(torch.float32), 1e9)
        arg = (2.0 * np.pi * self.TICK_HZ) * t
        wave = torch.sin(arg.to(torch.float64)).to(torch.float32) * 0.8
        out = torch.where(in_burst, wave, 0.0).to(torch.float32)
        out = out[..., None].expand(b, s, c)
        # the input: the first tick sample of each frame (first channel)
        hits = batch.data[..., 0].abs() > 0.7
        first = torch.argmax(hits.to(torch.int8), dim=1)
        has = hits.any(dim=1)
        hit_pos = pos[torch.arange(b, device=dev), first]
        has_h, pos_h, valid_h, ring, idx, count, last = to_host(
            has, hit_pos, batch.valid, state["ring"], state["idx"],
            state["count"], state["last_bucket"])
        ring = ring.copy()
        idx, count, last = int(idx), int(count), int(last)
        accepted = np.zeros(b, bool)
        lat_us = (pos_h % 1_000_000_000) // 1000
        avg_us = np.zeros(b, np.int64)
        for i in range(b):
            bucket = int(pos_h[i]) // 1_000_000_000
            if has_h[i] and valid_h[i] and bucket > last:
                ring[idx % 5] = lat_us[i]
                idx += 1
                count = min(count + 1, 5)
                last = bucket
                accepted[i] = True
            avg_us[i] = int(ring.sum()) // max(count, 1) if count > 0 else 0
        new_state = dict(zip(("ring", "idx", "count", "last_bucket"),
                             to_device(dev, ring, (idx, np.int64),
                                       (count, np.int64),
                                       (last, np.int64))))
        acc_t, lat_t, avg_t = to_device(dev, accepted, lat_us, avg_us)
        msgs = {"latency": {"_emit": acc_t, "last-latency": lat_t,
                            "average-latency": avg_t}}
        return new_state, batch.with_data(out), msgs
