"""spandsp elements (ext/spandsp/): tonegeneratesrc, dtmfdetect, spanplc.

The reference wraps libspandsp; the DSP follows the published algorithms
as the JAX package does:

- tonegeneratesrc (gsttonegeneratesrc.c): a dual-frequency tone with the
  on/off/on2/off2 cadence and the repeat flag; `volume` is attenuation
  in dB below full scale.  The sine is float64 with the JAX package's
  folded argument (numpy's sine on the CPU, torch's on the card).
- dtmfdetect (gstdtmfdetect.c): a Goertzel filterbank over 102-sample
  blocks at 8 kHz as one [102, 16] sin/cos product per block, energy,
  dominance and twist thresholds, and a two-block persistence walk on
  the host before a digit registers; `dtmf-event` messages.
- spanplc (gstspanplc.c): packet loss concealment in the shape of ITU
  G.711 Appendix I: a lost frame (valid False) replays the pitch period
  found by normalized cross-correlation over a 1024-sample history, with
  a linear fade, and the first good frame cross-fades back in; a walk
  over the window's frames, each frame's branch chosen on the host;
  `spanplc-stats` messages.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, to_device, to_host
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.ops.numerics import fma32
from gstbad_tpu_torch.ops.numerics import full_fp32

RATE = 8000

# -- tonegeneratesrc ----------------------------------------------------------


def _sine(arg):
    """float64 sine: numpy's (the C library's, as the JAX package's on the
    CPU) for a CPU tensor, torch's on the card."""
    if arg.device.type == "cpu":
        return torch.from_numpy(np.sin(arg.numpy()))
    return torch.sin(arg)


@register
class ToneGenerateSrc(Element):
    NAME = "tonegeneratesrc"
    KIND = "source"
    PROPERTIES = (
        Property("samplesperbuffer", int, 1024, 1, None, static=True),
        Property("freq", int, 0, 0, 20000, static=True),
        Property("volume", int, 0, 0, 50, static=True,
                 doc="attenuation in dB (0 = full scale)"),
        Property("freq2", int, 0, 0, 20000, static=True),
        Property("volume2", int, 0, 0, 50, static=True),
        Property("on-time", int, 1000, 1, None, static=True,
                 doc="ms on in the first cadence phase"),
        Property("off-time", int, 1000, 0, None, static=True),
        Property("on-time2", int, 0, 0, None, static=True),
        Property("off-time2", int, 0, 0, None, static=True),
        Property("repeat", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        return MediaSpec(kind="audio", format=AudioFormat.S16,
                         rate=RATE, channels=1)

    def init_state(self, window: int):
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def generate(self, params, state, window: int):
        s = self.props["samplesperbuffer"]
        n = state + torch.arange(window * s, dtype=torch.int64,
                                 device=self.device)
        nf = n.to(torch.float64)
        # 2*pi*freq * (n / RATE) as the JAX package's compiled form folds
        # the constants into one factor
        amp1 = 32767.0 * 10.0 ** (-self.props["volume"] / 20.0)
        sig = amp1 * _sine(nf * (2 * np.pi * self.props["freq"] / RATE))
        if self.props["freq2"]:
            amp2 = 32767.0 * 10.0 ** (-self.props["volume2"] / 20.0)
            sig = sig + amp2 * _sine(
                nf * (2 * np.pi * self.props["freq2"] / RATE))
        # the cadence: on, off, on2, off2 (ms), then repeat or silence
        seg = [self.props["on-time"], self.props["off-time"],
               self.props["on-time2"], self.props["off-time2"]]
        bounds = np.cumsum([v * RATE // 1000 for v in seg])
        total = int(bounds[-1])
        pos = torch.remainder(n, total) if self.props["repeat"] else n
        on = (pos < int(bounds[0])) | ((pos >= int(bounds[1]))
                                       & (pos < int(bounds[2])))
        sig = torch.where(on & (pos < total), sig, 0.0)
        out = sig.clamp(-32768, 32767).to(torch.int16).reshape(window, s, 1)
        pts = (torch.div(state, s, rounding_mode="floor")
               + torch.arange(window, dtype=torch.int64, device=self.device)
               ) * s * 10 ** 9 // RATE
        return state + window * s, FrameBatch.make(out, pts=pts)


# -- dtmfdetect ---------------------------------------------------------------

_DTMF_ROWS = (697.0, 770.0, 852.0, 941.0)
_DTMF_COLS = (1209.0, 1336.0, 1477.0, 1633.0)
_BLOCK = 102                      # spandsp dtmf_rx block size
# RFC 2833 event numbers laid out on the 4x4 keypad
_DIGITS = ((1, 2, 3, 12), (4, 5, 6, 13), (7, 8, 9, 14), (10, 0, 11, 15))


def _goertzel_basis():
    n = np.arange(_BLOCK)
    freqs = list(_DTMF_ROWS) + list(_DTMF_COLS)
    cos = np.stack([np.cos(2 * np.pi * f * n / RATE) for f in freqs])
    sin = np.stack([np.sin(2 * np.pi * f * n / RATE) for f in freqs])
    return np.concatenate([cos, sin]).T       # [102, 16]


@register
class DtmfDetect(Element):
    NAME = "dtmfdetect"
    PROPERTIES = ()

    MAX_EVENTS = 8                # digits reported per frame at most

    def negotiate(self, in_spec):
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16
                and in_spec.channels == 1,
                "dtmfdetect: needs S16 mono")
        require(in_spec.rate == RATE,
                "dtmfdetect: needs 8000 Hz (the spandsp DTMF rate)")
        return in_spec

    def prepare(self):
        self._basis = torch.from_numpy(
            _goertzel_basis().astype(np.float32)).to(self.device)
        self._digit_tab = torch.tensor(_DIGITS, dtype=torch.int32,
                                       device=self.device)

    def init_state(self, window: int):
        dev = self.device
        return {"last": torch.full((), -1, dtype=torch.int32, device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev),
                "reported": torch.zeros((), dtype=torch.bool, device=dev)}

    def process(self, params, state, batch: FrameBatch):
        x = batch.data[..., 0].to(torch.float32)   # [B, S]
        b, s = x.shape
        dev = x.device
        nblk = s // _BLOCK
        blocks = x[:, :nblk * _BLOCK].reshape(b, nblk, _BLOCK)
        with full_fp32():
            proj = torch.matmul(blocks, self._basis)   # [B, nblk, 16]
        power = proj[..., :8] ** 2 + proj[..., 8:] ** 2
        rowp, colp = power[..., :4], power[..., 4:]
        re, ri = rowp.max(dim=-1)
        ce, ci = colp.max(dim=-1)
        total = power.sum(dim=-1)
        # absolute energy, dominance, and twist (8 dB forward, 4 reverse)
        floor = (_BLOCK * 0.05 * 32768.0 / 2) ** 2
        hit = ((re + ce > floor) & (re + ce > 0.85 * total)
               & (re < ce * 10 ** 0.8) & (ce < re * 10 ** 0.4))
        digit = torch.where(hit, self._digit_tab[ri, ci], -1)
        # the persistence walk: a digit registers on its second
        # consecutive block, once until the tone stops
        digits, last, count, rep = to_host(digit, state["last"],
                                           state["count"], state["reported"])
        last, count, rep = int(last), int(count), bool(rep)
        events = np.full((b, self.MAX_EVENTS), -1, np.int32)
        for fi in range(b):
            k = 0
            for d in digits[fi].tolist():
                same = d == last
                count = count + 1 if (same and d >= 0) else 0
                emit = d >= 0 and same and count == 1 and not rep
                rep = False if d < 0 else (True if emit else rep)
                last = d
                if emit and k < self.MAX_EVENTS:
                    events[fi, k] = d
                    k += 1
        new_state = dict(zip(("last", "count", "reported"), to_device(
            dev, (last, np.int32), (count, np.int32), (rep, np.bool_))))
        (ev,) = to_device(dev, events)
        msgs = {"dtmf-event": {
            "type": torch.ones((b, self.MAX_EVENTS), dtype=torch.int32,
                               device=dev),
            "number": ev,
            "method": torch.full((b, self.MAX_EVENTS), 2, dtype=torch.int32,
                                 device=dev),
            "_emit": (ev >= 0).any(dim=-1)}}
        return new_state, batch, msgs


# -- spanplc ------------------------------------------------------------------

_HIST = 1024                      # history ring (128 ms at 8 kHz)
_MIN_PITCH = 20                   # 400 Hz
_MAX_PITCH = 200                  # 40 Hz
_ATTEN_MS = 50.0                  # full fade over ~50 ms of fill
_OLA = 32                         # ramp-in cross-fade samples


@register
class SpanPlc(Element):
    NAME = "spanplc"
    PROPERTIES = ()

    def negotiate(self, in_spec):
        require(in_spec.kind == "audio"
                and in_spec.format == AudioFormat.S16
                and in_spec.channels == 1,
                "spanplc: needs S16 mono")
        self._rate = in_spec.rate
        return in_spec

    def init_state(self, window: int):
        dev = self.device

        def i(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        return {"hist": torch.zeros(_HIST, dtype=torch.float32, device=dev),
                "missing": i(False, torch.bool),
                "pitch": i(_MIN_PITCH, torch.int32),
                "offset": i(0, torch.int32), "filled": i(0, torch.int32),
                "num_pushed": i(0, torch.int64), "num_gap": i(0, torch.int64),
                "plc_samples": i(0, torch.int64)}

    def _detect_pitch(self, hist):
        """The lag in [MIN, MAX) whose window best matches the newest
        2 * MIN samples (normalized cross-correlation)."""
        n = 2 * _MIN_PITCH
        probe = hist[-n:]
        lags = torch.arange(_MIN_PITCH, _MAX_PITCH, device=hist.device)
        idx = (_HIST - n) - lags[:, None] + torch.arange(
            n, device=hist.device)[None, :]
        seg = hist[idx]                                  # [lags, n]
        num = torch.sum(seg * probe[None], dim=1)
        den = torch.sqrt(torch.sum(seg * seg, dim=1)
                         * torch.sum(probe * probe)) + 1e-6
        return lags[torch.argmax(num / den)].to(torch.int32)

    def _synth(self, hist, pitch, offset, length):
        idx = torch.remainder(offset + torch.arange(
            length, dtype=torch.int32, device=hist.device), pitch)
        src = hist[-_MAX_PITCH:]
        return src[torch.clamp(_MAX_PITCH - pitch + idx, 0, _MAX_PITCH - 1)
                   .to(torch.int64)]

    def process(self, params, state, batch: FrameBatch):
        x = batch.data[..., 0].to(torch.float32)   # [B, S]
        b, s = x.shape
        dev = x.device
        atten_per = torch.full((), 1000.0 / (_ATTEN_MS * self._rate),
                               dtype=torch.float32, device=dev)
        (valid,) = to_host(batch.valid)
        st = dict(state)
        outs = []
        for fi in range(b):
            samples = x[fi]
            if valid[fi]:
                # ramp-in after concealment: cross-fade the synthetic
                # continuation into the real signal (plc_rx)
                synth = self._synth(st["hist"], st["pitch"], st["offset"],
                                    _OLA)
                w = (torch.arange(_OLA, dtype=torch.float32, device=dev)
                     + 1) / _OLA
                head = samples[:_OLA] * w + synth * (1 - w)
                out = torch.where(st["missing"],
                                  torch.cat([head, samples[_OLA:]]), samples)
                st.update(missing=torch.zeros_like(st["missing"]),
                          offset=torch.zeros_like(st["offset"]),
                          filled=torch.zeros_like(st["filled"]))
            else:
                pitch = torch.where(st["missing"], st["pitch"],
                                    self._detect_pitch(st["hist"]))
                synth = self._synth(st["hist"], pitch, st["offset"], s)
                # no fade for the first 10 ms, then a linear fade to
                # silence over _ATTEN_MS (G.711 A1's shape)
                k = st["filled"] + torch.arange(s, dtype=torch.int32,
                                                device=dev)
                k = torch.clamp(k - self._rate // 100, min=0)
                # 1 - k * atten, contracted as the JAX package's compiled
                # step does it
                kf = k.to(torch.float32)
                gain = torch.clamp(fma32(-kf, atten_per.expand(kf.shape),
                                          torch.ones_like(kf)), 0.0, 1.0)
                out = synth * gain
                st.update(missing=torch.ones_like(st["missing"]),
                          pitch=pitch,
                          offset=torch.remainder(st["offset"] + s, pitch),
                          filled=st["filled"] + s,
                          num_gap=st["num_gap"] + 1,
                          plc_samples=st["plc_samples"] + s)
            st["hist"] = (torch.cat([st["hist"][s:], out]) if s < _HIST
                          else out[-_HIST:])
            st["num_pushed"] = st["num_pushed"] + 1
            outs.append(out)
        out = torch.stack(outs).clamp(-32768, 32767).to(torch.int16)[..., None]
        last = b - 1

        def per_frame(v):
            return v.expand(b)

        msgs = {"spanplc-stats": {
            "num-pushed": per_frame(st["num_pushed"]),
            "num-gap": per_frame(st["num_gap"]),
            "plc-num-samples": per_frame(st["plc_samples"]),
            "plc-duration": per_frame(
                st["plc_samples"] * (10 ** 9 // self._rate)),
            "pitch": per_frame(torch.div(
                torch.full_like(st["pitch"], self._rate),
                torch.clamp(st["pitch"], min=1), rounding_mode="floor")),
            "_emit": torch.arange(b, device=dev) == last}}
        # concealed frames become valid output (the fill-in buffers)
        return st, FrameBatch.make(out, pts=batch.pts, flags=batch.flags,
                                   valid=torch.ones_like(batch.valid)), msgs
