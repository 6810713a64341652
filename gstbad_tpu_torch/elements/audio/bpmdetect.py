"""bpmdetect (ext/soundtouch/gstbpmdetect.cc, SoundTouch's BPMDetect):
beats-per-minute estimator.

The rectified signal's envelope runs through a first-order lowpass (the
JAX package's associative scan, ops/audio.first_order_iir) and is
decimated to 1 kHz into an 8 s ring carried in state; each window
autocorrelates the ring with one FFT (Wiener-Khinchin) and takes the
strongest lag within 29-200 BPM.  A `bpm` message posts whenever the
estimate moves by 1 BPM or more (the reference's BEATS_PER_MINUTE tag,
gstbpmdetect.cc:255-261).
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec
from gstbad_tpu_torch.ops import audio as ops
from gstbad_tpu_torch.ops.numerics import full_fp32, true_div

MIN_BPM, MAX_BPM = 29.0, 200.0   # SoundTouch's detection range
ENV_RATE = 1000                  # envelope sample rate, Hz
RING_SECONDS = 8


@register
class BpmDetect(AudioFilter):
    NAME = "bpmdetect"
    FORMATS = (AudioFormat.F32, AudioFormat.S16)
    CHANNELS = (1, 64)
    PROPERTIES = (Property("message", bool, True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        spec = super().negotiate(in_spec)
        self._decim = max(1, spec.rate // ENV_RATE)
        self._ring = RING_SECONDS * ENV_RATE
        return spec

    def init_state(self, batch: int):
        dev = self.device
        return {"lp": torch.zeros(1, dtype=torch.float32, device=dev),
                "ring": torch.zeros(self._ring, dtype=torch.float32,
                                    device=dev),
                "fill": torch.zeros((), dtype=torch.int64, device=dev),
                "last_bpm": torch.zeros((), dtype=torch.float32,
                                        device=dev)}

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        dev = batch.data.device
        x = batch.data.reshape(b * s, c).to(torch.float32)
        if self.in_spec.format == AudioFormat.S16:
            x = true_div(x, 32768.0)
        mono = torch.mean(x, dim=1, keepdim=True)
        # the rectified envelope through a ~20 Hz one-pole lowpass
        alpha = float(np.exp(-2.0 * np.pi * 20.0 / self.in_spec.rate))
        env = ops.first_order_iir((1.0 - alpha) * torch.abs(mono), alpha,
                                  state["lp"])
        dec = env[:: self._decim, 0]
        n = dec.shape[0]
        ring = torch.cat([state["ring"], dec])[-self._ring:]
        fill = torch.clamp(state["fill"] + n, max=self._ring)
        # the autocorrelation through one FFT, mean removed
        w = ring - torch.mean(ring)
        with full_fp32():
            spec = torch.fft.rfft(w, n=2 * self._ring)
            ac = torch.fft.irfft(spec * torch.conj(spec))[: self._ring]
        lag_min = int(ENV_RATE * 60.0 / MAX_BPM)
        lag_max = int(ENV_RATE * 60.0 / MIN_BPM)
        lags = torch.arange(self._ring, device=dev)
        band = (lags >= lag_min) & (lags <= lag_max)
        best = torch.argmax(torch.where(band, ac, -torch.inf))
        bpm = torch.full((), 60.0 * ENV_RATE, dtype=torch.float32,
                         device=dev) / best.to(torch.float32)
        ready = fill >= 2 * lag_max  # 2 periods of the slowest tempo
        bpm = torch.where(ready, bpm, 0.0)
        changed = ((bpm - state["last_bpm"]).abs() >= 1.0) & ready
        new_state = {"lp": env[-1], "ring": ring, "fill": fill,
                     "last_bpm": torch.where(changed, bpm,
                                             state["last_bpm"])}
        emit = torch.zeros(b, dtype=torch.bool, device=dev)
        emit[-1] = changed & params["message"]
        return new_state, batch, {"bpm": {"_emit": emit,
                                          "bpm": bpm.expand(b)}}
