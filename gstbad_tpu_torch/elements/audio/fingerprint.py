"""Audio fingerprinting — chromaprint + ofa element surfaces
(ext/chromaprint/gstchromaprint.c, ext/ofa/gstofa.c).

The reference elements are thin accumulators around external fingerprint
libraries (libchromaprint's chroma/filter/quantize pipeline, libofa).
The element surfaces are reproduced exactly — S16 passthrough, read-only
`fingerprint` string property, `duration` cap (chromaprint: 120 s default,
gstchromaprint.c:98-100; ofa: 135 s, gstofa.c:210), the fingerprint
posted as a tag message when the cap is reached or at EOS
(gstchromaprint.c:144-163) — while the DSP runs on device: mono mixdown,
linear resample to 11025 Hz, Hann STFT (frame 4096, hop 1365 — the
chromaprint framing), 12-bin chroma projection over 28-3520 Hz, and a
Haar-difference quantizer producing one 32-bit sub-fingerprint per frame.
chromaprint (r3): this environment ships libchromaprint.so.1 — the
exact library the reference wraps — so the chromaprint element's
default `engine=auto` binds it at the host boundary
(io/chromaprint.py: new/start/feed/finish/get_fingerprint on the S16
interleaved stream, CHROMAPRINT_ALGORITHM_DEFAULT) and the posted tag
is ACOUSTID-COMPATIBLE, byte-identical to the reference element's.
`engine=native` keeps the device chroma pipeline (deterministic +
perturbation-robust but not Acoustid bit patterns — its classifier
coefficients are not the trained ones); it is also the automatic
fallback when the library is absent.  ofa remains native-only
(libofa is not in this environment) — documented divergence.

A port of the JAX package's elements/audio/fingerprint.py: the chroma
image is computed on the element's device in the JAX order (the gather of
frames, a float32 Hann window, |rfft|^2 through ops/fft.rfft, the product
with the one-hot chroma matrix); the accumulation, the resampler, the
quantizer and the base64 string stay on the host, as there.
"""

from __future__ import annotations

import base64

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require

_TARGET_RATE = 11025
_FRAME = 4096
_HOP = 1365
_FMIN, _FMAX = 28.0, 3520.0


def _chroma_image(mono_11k: np.ndarray, device="cpu") -> np.ndarray:
    """[N] float32 -> [T, 12] chroma rows (the FFT on `device`)."""
    from gstbad_tpu_torch.ops import fft
    from gstbad_tpu_torch.ops.numerics import full_fp32
    n = len(mono_11k)
    t = max((n - _FRAME) // _HOP + 1, 0)
    if t == 0:
        return np.zeros((0, 12), np.float32)
    dev = torch.device(device)
    idx = np.arange(t)[:, None] * _HOP + np.arange(_FRAME)[None, :]
    frames = torch.from_numpy(np.ascontiguousarray(mono_11k, np.float32)
                              ).to(dev)[torch.from_numpy(idx).to(dev)]
    win = torch.from_numpy(np.hanning(_FRAME).astype(np.float32)).to(dev)
    spec = fft.rfft(frames * win[None, :], dim=1).abs() ** 2
    freqs = np.fft.rfftfreq(_FRAME, 1.0 / _TARGET_RATE)
    sel = (freqs >= _FMIN) & (freqs <= _FMAX)
    notes = (12 * np.log2(np.maximum(freqs, 1e-9) / 440.0) + 69.0)
    chroma_idx = np.where(sel, np.round(notes).astype(np.int64) % 12, 0)
    onehot = np.zeros((len(freqs), 12), np.float32)
    onehot[np.arange(len(freqs)), chroma_idx] = sel.astype(np.float32)
    with full_fp32():
        img = (spec @ torch.from_numpy(onehot).to(dev)).cpu().numpy()
    norm = np.linalg.norm(img, axis=1, keepdims=True)
    return (img / np.maximum(norm, 1e-6)).astype(np.float32)


# 16 Haar-like (chroma offset, width, time extent, threshold) classifiers;
# fixed (NOT Acoustid-trained — see module doc)
_CLASSIFIERS = [((i * 5) % 12, 1 + (i % 3), 1 + (i * 7) % 8,
                 0.02 * ((i % 5) - 2)) for i in range(16)]


def _quantize(img: np.ndarray) -> np.ndarray:
    """[T, 12] chroma -> [T'] uint32 sub-fingerprints (window of 16)."""
    t = img.shape[0] - 16
    if t <= 0:
        return np.zeros(0, np.uint32)
    out = np.zeros(t, np.uint32)
    for bit, (off, width, ext, thr) in enumerate(_CLASSIFIERS):
        a = sum(img[:, (off + k) % 12] for k in range(width))
        # Haar difference over the time extent, 2-bit quantizer
        diff = a[ext:t + ext] - a[:t]
        q = ((diff > thr).astype(np.uint32)
             | ((diff > thr + 0.05).astype(np.uint32) << 1))
        out |= q << (2 * bit)
    return out


def _fingerprint_string(sub: np.ndarray) -> str:
    if not len(sub):
        return ""
    return base64.urlsafe_b64encode(sub.astype("<u4").tobytes()).decode()


class _Fingerprinter(Element):
    """Shared S16 passthrough + accumulate + fingerprint-at-EOS/cap."""

    HOST = True
    MAX_SECONDS = 120
    TAG = "fingerprint"

    ENGINE = "native"

    def __init__(self, **props):
        super().__init__(**props)
        self._chunks = []
        self._raw_chunks = []
        self._nsamples = 0
        self._fingerprint = None
        self._posted = False

    def _use_library(self) -> bool:
        from gstbad_tpu_torch.io import chromaprint as cp
        eng = self.props.get("engine", self.ENGINE)
        if eng == "library" and not cp.available():
            raise RuntimeError(f"{self.NAME}: engine=library but "
                               "libchromaprint is not available")
        return eng in ("auto", "library") and cp.available()

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio")
        require(in_spec.format in (AudioFormat.S16, AudioFormat.F32),
                f"{self.NAME}: needs S16/F32")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _max_samples(self):
        cap = self.props.get("duration", self.MAX_SECONDS)
        return cap * self.in_spec.rate

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        if self._posted:
            return
        x = np.asarray(np_batch.data)
        if x.dtype == np.int16:
            raw = x.reshape(-1, x.shape[-1])
            xf = x.astype(np.float32) / 32768.0
        else:
            xf = x
            raw = np.clip(np.asarray(x) * 32768.0, -32768, 32767
                          ).astype(np.int16).reshape(-1, x.shape[-1])
        self._raw_chunks.append(raw)
        mono = xf.reshape(-1, xf.shape[-1]).mean(axis=1
                                                 ).astype(np.float32)
        self._chunks.append(mono)
        self._nsamples += len(mono)
        if self._nsamples >= self._max_samples():
            self._finalize(bus)

    def _finalize(self, bus) -> None:
        if self._posted:
            return
        if self._use_library():
            from gstbad_tpu_torch.io import chromaprint as cp
            raw = (np.concatenate(self._raw_chunks)
                   if self._raw_chunks
                   else np.zeros((0, 1), np.int16))
            self._fingerprint = cp.fingerprint(raw, self.in_spec.rate)
            self._posted = True
            if bus is not None:
                bus.post(Message(self.NAME, "tag", 0,
                                 {self.TAG: self._fingerprint,
                                  "duration": self._nsamples
                                  // max(self.in_spec.rate, 1)}))
            return
        mono = np.concatenate(self._chunks) if self._chunks else \
            np.zeros(0, np.float32)
        rate = self.in_spec.rate
        n_out = int(len(mono) * _TARGET_RATE / rate)
        if n_out:
            pos = np.arange(n_out) * (rate / _TARGET_RATE)
            i0 = np.minimum(pos.astype(np.int64), len(mono) - 1)
            i1 = np.minimum(i0 + 1, len(mono) - 1)
            frac = (pos - i0).astype(np.float32)
            mono = mono[i0] * (1 - frac) + mono[i1] * frac
        sub = _quantize(_chroma_image(mono.astype(np.float32),
                                      self.device))
        self._fingerprint = _fingerprint_string(sub)
        self._posted = True
        if bus is not None:
            bus.post(Message(self.NAME, "tag", 0,
                             {self.TAG: self._fingerprint,
                              "duration": self._nsamples
                              // max(self.in_spec.rate, 1)}))

    def eos(self, bus=None) -> None:
        """EOS hook: compute+post if not yet done (gstofa.c:163-176)."""
        self._finalize(bus)

    @property
    def fingerprint(self):
        return self._fingerprint


@register
class ChromaprintElement(_Fingerprinter):
    """chromaprint (ext/chromaprint/gstchromaprint.c): posts the
    chromaprint-fingerprint tag after `duration` seconds or at EOS."""

    NAME = "chromaprint"
    MAX_SECONDS = 120
    TAG = "chromaprint-fingerprint"
    ENGINE = "auto"
    PROPERTIES = (Property("duration", int, 120, 1, None, static=True),
                  Property("engine", str, "auto", static=True,
                           doc="auto | library | native"))


@register
class OFA(_Fingerprinter):
    """ofa (ext/ofa/gstofa.c): MusicIP fingerprint surface; the reference
    caps accumulation at 135 s (gstofa.c:208-213)."""

    NAME = "ofa"
    MAX_SECONDS = 135
    TAG = "ofa-fingerprint"
    PROPERTIES = ()
