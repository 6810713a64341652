"""webrtcdsp and webrtcechoprobe (ext/webrtcdsp/gstwebrtcdsp.cpp,
gstwebrtcechoprobe.cpp): the voice-processing chain on 10 ms frames of S16
audio at 48, 32, 16 or 8 kHz.

As in the JAX package:
- high-pass-filter: a 2nd-order Butterworth at 90 Hz as the associative
  scan over 2x2 affine maps (ops/audio.biquad);
- echo-cancel: the far end arrives as the second graph input
  (`near ! dsp.  far ! webrtcechoprobe ! dsp.  webrtcdsp name=dsp`); a
  partitioned-block frequency-domain NLMS filter (8 partitions, 16 with
  extended-filter) and the coherence suppressor, whose overdrive follows
  echo-suppression-level (ops/audio.aec_cancel);
- noise-suppression: WebRTC's float NS structure over a Hann 50% STFT
  (ops/audio.noise_suppress), attenuation caps 6/10/15/25 dB;
- gain-control: adaptive-digital walks a dB gain toward
  target-level-dbfs within compression-gain-db, fixed-digital applies
  compression-gain-db; limiter clips to full scale;
- voice-detection: a per-block energy VAD at the likelihood's dBFS
  threshold, posting `voice-activity` on transitions
  (gstwebrtcdsp.cpp:445-473).
The block walks of the suppressor, the canceller and the gain are loops
over the window's blocks on the device; the spectra batch over the
window.  FFTs are torch.fft's (the JAX package's are XLA's), so the
output agrees with the JAX package's within a few LSB, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from gstbad_tpu_torch.core.element import AudioFilter, Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.ops import audio as ops
from gstbad_tpu_torch.ops.numerics import f32, full_fp32, true_div

RATES = (48000, 32000, 16000, 8000)  # gstwebrtcdsp.cpp:97
NS_ATTEN_DB = {"low": 6.0, "moderate": 10.0, "high": 15.0,
               "very-high": 25.0}
VAD_THRESH_DB = {"very-low": -70.0, "low": -60.0, "moderate": -50.0,
                 "high": -40.0}
AEC_OVERDRIVE = {"low": 1.0, "moderate": 2.0, "high": 4.0}


@register
class WebrtcEchoProbe(Element):
    """webrtcechoprobe: marks the far-end (playback) branch that feeds
    webrtcdsp's second input; a passthrough."""

    NAME = "webrtcechoprobe"
    PROPERTIES = (Property("probe", str, "webrtcdsp-probe", static=True),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", "webrtcechoprobe: needs audio")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch


def _level_db(frames):
    """20 log10 of the RMS of each frame [F, ...] of int16-scaled
    samples, reduced over the trailing axes."""
    dims = tuple(range(1, frames.ndim))
    rms = torch.sqrt(torch.mean(torch.square(true_div(frames, 32768.0)),
                                dim=dims) + 1e-12)
    return 20.0 * f32(torch.log10, rms) if rms.dtype == torch.float32 \
        else 20.0 * torch.log10(rms)


@register
class WebrtcDsp(AudioFilter):
    NAME = "webrtcdsp"
    FORMATS = (AudioFormat.S16,)
    CHANNELS = (1, 2)
    PROPERTIES = (
        Property("probe", str, "webrtcdsp-probe", static=True),
        Property("high-pass-filter", bool, True, static=True),
        Property("echo-cancel", bool, True, static=True),
        Property("echo-suppression-level", str, "moderate", static=True),
        Property("noise-suppression", bool, True, static=True),
        Property("noise-suppression-level", str, "moderate", static=True),
        Property("gain-control", bool, True, static=True),
        Property("gain-control-mode", str, "adaptive-digital", static=True),
        Property("experimental-agc", bool, False, static=True),
        Property("extended-filter", bool, True, static=True),
        Property("delay-agnostic", bool, False, static=True),
        Property("target-level-dbfs", int, 3, 0, 31),
        Property("compression-gain-db", int, 9, 0, 90),
        Property("startup-min-volume", int, 12, 12, 255, static=True),
        Property("limiter", bool, True),
        Property("voice-detection", bool, False, static=True),
        Property("voice-detection-frame-size-ms", int, 10, 10, 30,
                 static=True),
        Property("voice-detection-likelihood", str, "low", static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        if isinstance(in_spec, list):  # the second input is the echo probe
            require(len(in_spec) == 2, "webrtcdsp: at most 2 inputs "
                    "(near-end + echo probe)")
            near, far = in_spec
            require(far.kind == "audio" and far.rate == near.rate,
                    "webrtcdsp: probe stream must match the near-end rate")
            self._has_probe = True
            in_spec = near
        else:
            self._has_probe = False
        spec = super().negotiate(in_spec)
        require(spec.rate in RATES,
                f"webrtcdsp: rate {spec.rate} not in {RATES}")
        require(self.props["noise-suppression-level"] in NS_ATTEN_DB,
                "webrtcdsp: bad noise-suppression-level")
        require(self.props["echo-suppression-level"] in AEC_OVERDRIVE,
                "webrtcdsp: bad echo-suppression-level")
        require(self.props["voice-detection-likelihood"] in VAD_THRESH_DB,
                "webrtcdsp: bad voice-detection-likelihood")
        self._frame = spec.rate // 100  # 10 ms
        self._hop = self._frame // 2
        self._bins = self._frame // 2 + 1
        self._near_spec = spec
        return spec

    def init_state(self, batch: int):
        c = self._near_spec.channels
        dev = self.device
        gain0 = 0.0
        if (self.props["experimental-agc"]
                and self.props["gain-control-mode"] != "fixed-digital"):
            # the digital form of ExperimentalAgc's startup volume lift
            gain0 = min(float(self.props["compression-gain-db"]),
                        20.0 * math.log10(
                            self.props["startup-min-volume"] / 12.0))

        def z(shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        st = {"hpf": z((2, c)), "stft_tail": z((self._hop, c)),
              "ola_acc": z((self._hop, c)),
              "noise": ops.ns_init(self._bins, c, dev),
              "gain_db": torch.tensor(gain0, dtype=torch.float32,
                                      device=dev),
              "had_voice": torch.zeros((), dtype=torch.bool, device=dev)}
        if self._has_probe and self.props["echo-cancel"]:
            parts = 16 if self.props["extended-filter"] else 8
            st["aec"] = ops.aec_init(self._frame, c, parts, dev)
        return st

    def dynamic_params(self):
        def t(v, dtype):
            return torch.tensor(v, dtype=dtype, device=self.device)

        return {"target-level-dbfs": t(float(
                    self.props["target-level-dbfs"]), torch.float32),
                "compression-gain-db": t(float(
                    self.props["compression-gain-db"]), torch.float32),
                "limiter": t(self.props["limiter"], torch.bool)}

    def process(self, params, state, batch: FrameBatch):
        with full_fp32():
            return self._process(params, state, batch)

    def _process(self, params, state, batch):
        far_batch = None
        if isinstance(batch, list):
            batch, far_batch = batch[0], batch[1]
        b, s, c = batch.data.shape
        n = b * s
        frame = self._frame
        require(n % self._hop == 0,
                f"webrtcdsp: window samples {n} must be a multiple of "
                f"{self._hop} (5 ms)")
        x = batch.data.reshape(n, c).to(torch.float32)

        # 1. the high-pass filter (rumble and DC)
        hpf_state = state["hpf"]
        if self.props["high-pass-filter"]:
            bq_b, bq_a = ops.butter_highpass(90.0, self._near_spec.rate)
            x, hpf_state = ops.biquad(x, bq_b, bq_a, hpf_state)

        # 2. echo cancellation on 10 ms blocks; without a probe the
        # reference warns and skips it
        aec_state = state.get("aec")
        if (self.props["echo-cancel"] and far_batch is not None
                and aec_state is not None and n % frame == 0):
            fd = far_batch.data.reshape(-1, far_batch.data.shape[-1]).to(
                torch.float32)
            if fd.shape[0] < n:   # pad a short probe window
                fd = torch.cat([fd, fd.new_zeros(n - fd.shape[0],
                                                 fd.shape[1])])
            fd = fd[:n]
            far = fd[:, :1].expand(n, c) if fd.shape[1] != c else fd
            od = AEC_OVERDRIVE[self.props["echo-suppression-level"]]
            x, aec_state = ops.aec_cancel(x, far, aec_state, od)

        # 3. noise suppression over the STFT
        frames, stft_tail = ops.stft_frames(x, state["stft_tail"], frame)
        noise = state["noise"]
        if self.props["noise-suppression"]:
            g_min = float(torch.tensor(10.0 ** (
                -NS_ATTEN_DB[self.props["noise-suppression-level"]] / 20.0),
                dtype=torch.float32))
            frames, noise = ops.noise_suppress(frames, noise, g_min)
            y, ola_acc = ops.ola(frames, state["ola_acc"])
        else:
            y, ola_acc = x, state["ola_acc"]

        # 4. gain control on 10 ms frames (none when the window is
        # shorter than one frame)
        gain_db = state["gain_db"]
        if self.props["gain-control"] and n >= frame:
            nf = n // frame
            lvl_db = _level_db(y[: nf * frame].reshape(nf, frame, c))
            if self.props["gain-control-mode"] == "fixed-digital":
                gains = params["compression-gain-db"].expand(nf)
            else:
                gain_db, gains = ops.agc_adaptive(
                    lvl_db, gain_db, params["target-level-dbfs"],
                    params["compression-gain-db"])
            lin = f32(lambda v: torch.pow(10.0, v), true_div(gains, 20.0))
            lin_s = torch.repeat_interleave(lin, frame)
            if lin_s.shape[0] < n:
                lin_s = torch.cat([lin_s, lin[-1].expand(n - lin_s.shape[0])])
            y = y * lin_s[:, None]

        # 5. the limiter and the int16 output
        y = torch.where(params["limiter"], y.clamp(-32768.0, 32767.0), y)
        out = y.clamp(-32768.0, 32767.0).reshape(b, s, c).to(torch.int16)

        new_state = {"hpf": hpf_state, "stft_tail": stft_tail,
                     "ola_acc": ola_acc, "noise": noise, "gain_db": gain_db,
                     "had_voice": state["had_voice"]}
        if aec_state is not None:
            new_state["aec"] = aec_state
        msgs = {}
        if self.props["voice-detection"]:
            vf = (self._near_spec.rate
                  * self.props["voice-detection-frame-size-ms"]) // 1000
            nb = s // vf
            blocks = batch.data[:, :nb * vf].reshape(b * nb, vf, c).to(
                torch.float32)
            db = _level_db(blocks).reshape(b, nb)
            thr = VAD_THRESH_DB[self.props["voice-detection-likelihood"]]
            has_voice = (db > thr).any(dim=1)
            prev = torch.cat([state["had_voice"][None], has_voice[:-1]])
            new_state["had_voice"] = has_voice[-1]
            msgs["voice-activity"] = {"_emit": has_voice != prev,
                                      "stream-has-voice": has_voice}
        return new_state, batch.with_data(out), msgs
