"""Test sources — the videotestsrc analog.

The reference consumes gst-plugins-base's videotestsrc in every launch line
and test; this one generates batched frames directly on the pipeline's
device so benchmarks aren't host-transfer bound.  videotestsrc's noise
pattern and audiotestsrc's white noise (drawn from JAX's PRNG in the JAX
package, which torch cannot reproduce) are not ported yet.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, VideoFormat
from gstbad_tpu_torch.ops.pointops import unpack32

# SMPTE-ish color bars in RGB (white, yellow, cyan, green, magenta, red,
# blue, black at 75%)
_BARS_RGB = np.array([
    [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
    [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0]], np.uint8)


def _rgb_to_yuv_bt601(rgb: np.ndarray) -> np.ndarray:
    r, g, b = [rgb[..., i].astype(np.float64) for i in range(3)]
    y = 16 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    return np.stack([y, u, v], -1).round().clip(0, 255).astype(np.uint8)


@register
class VideoTestSrc(Element):
    """Pattern generator.  Patterns: bars (SMPTE-ish), solid-color, ball
    (moving ball, frame-dependent), gradient, checkers, black, white.
    """

    NAME = "videotestsrc"
    KIND = "source"
    PROPERTIES = (
        Property("pattern", str, "bars", static=True),
        Property("format", str, VideoFormat.BGRx, static=True),
        Property("width", int, 320, 1, None, static=True),
        Property("height", int, 240, 1, None, static=True),
        Property("framerate", str, "30/1", static=True),
        Property("foreground-color", int, 0xFFFFFFFF, static=True),
        Property("seed", int, 0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        num, _, den = self.props["framerate"].partition("/")
        return MediaSpec(kind="video", format=self.props["format"],
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(int(num), int(den or "1")))

    def prepare(self):
        spec = self.out_spec
        h, w = spec.height, spec.width
        fmt = spec.format
        dev = self.device
        self._is_ayuv = fmt == VideoFormat.AYUV
        self._is_gray = fmt == VideoFormat.GRAY8
        pattern = self.props["pattern"]
        # static background in RGB
        if pattern in ("bars", "smpte"):
            idx = (np.arange(w) * 8) // w
            rgb = np.broadcast_to(_BARS_RGB[idx][None, :, :], (h, w, 3))
        elif pattern == "gradient":
            g = np.broadcast_to(
                np.linspace(0, 255, w, dtype=np.float64)[None, :], (h, w))
            rgb = np.stack([g, g, g], -1).astype(np.uint8)
        elif pattern == "checkers":
            yy, xx = np.mgrid[:h, :w]
            c = (((yy // 8) + (xx // 8)) % 2) * 255
            rgb = np.stack([c, c, c], -1).astype(np.uint8)
        elif pattern in ("black", "solid-color", "white", "ball"):
            if pattern == "white":
                color = (255, 255, 255)
            elif pattern == "black":
                color = (0, 0, 0)
            elif pattern == "ball":
                color = (32, 32, 32)
            else:
                fg = self.props["foreground-color"]
                color = ((fg >> 16) & 0xFF, (fg >> 8) & 0xFF, fg & 0xFF)
            rgb = np.broadcast_to(np.array(color, np.uint8)[None, None, :],
                                  (h, w, 3))
        elif pattern == "noise":
            raise ValueError("videotestsrc: pattern=noise is not ported to "
                             "gstbad_tpu_torch yet")
        else:
            raise ValueError(f"unknown pattern {pattern!r}")
        self._bg_rgb = np.ascontiguousarray(rgb)
        packed = self._pack(self._bg_rgb)
        self._bg_word = None
        self._ball_word = None
        if isinstance(packed, dict):
            self._bg = {k: torch.as_tensor(v, device=dev)
                        for k, v in packed.items()}
            return
        self._bg = torch.as_tensor(packed, device=dev)
        if packed.ndim == 3 and packed.shape[-1] == 4:
            # the int32 word image: the whole frame as one word per pixel
            self._bg_word = torch.as_tensor(
                np.ascontiguousarray(packed).view("<i4")[..., 0], device=dev)
            ball = self._pack(self._bg_rgb)
            if self._is_ayuv:
                ball[..., 1] = 235   # luma overlay
            else:
                ball[..., :] = 255   # matches _apply_luma_overlay
            self._ball_word = torch.as_tensor(
                np.ascontiguousarray(ball).view("<i4")[..., 0], device=dev)

    def _pack(self, rgb: np.ndarray):
        """RGB [H,W,3] -> negotiated format layout."""
        fmt = self.out_spec.format
        h, w = rgb.shape[:2]
        if fmt == VideoFormat.GRAY8:
            yuv = _rgb_to_yuv_bt601(rgb)
            return yuv[..., 0]
        if fmt == VideoFormat.AYUV:
            yuv = _rgb_to_yuv_bt601(rgb)
            out = np.empty((h, w, 4), np.uint8)
            out[..., 0] = 255
            out[..., 1:] = yuv
            return out
        if fmt in (VideoFormat.I420, VideoFormat.YV12):
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0],
                    "u": yuv[::2, ::2, 1].copy(),
                    "v": yuv[::2, ::2, 2].copy()}
        if fmt == VideoFormat.Y444:
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0], "u": yuv[..., 1].copy(),
                    "v": yuv[..., 2].copy()}
        if fmt in (VideoFormat.Y42B, VideoFormat.Y41B):
            step = 2 if fmt == VideoFormat.Y42B else 4
            yuv = _rgb_to_yuv_bt601(rgb)
            return {"y": yuv[..., 0], "u": yuv[:, ::step, 1].copy(),
                    "v": yuv[:, ::step, 2].copy()}
        if fmt in VideoFormat.SEMIPLANAR_YUV:
            yuv = _rgb_to_yuv_bt601(rgb)
            u = yuv[::2, ::2, 1]
            v = yuv[::2, ::2, 2]
            first, second = ((u, v) if fmt == VideoFormat.NV12
                             else (v, u))
            uv = np.stack([first, second], axis=-1).reshape(h // 2, w)
            return {"y": yuv[..., 0], "uv": uv.copy()}
        if fmt in VideoFormat.PACKED_YUV422:
            yuv = _rgb_to_yuv_bt601(rgb)
            out = np.empty((h, 2 * w), np.uint8)
            if fmt == VideoFormat.YUY2:
                out[:, 0::2] = yuv[..., 0]
                out[:, 1::4] = yuv[:, ::2, 1]
                out[:, 3::4] = yuv[:, ::2, 2]
            else:
                out[:, 1::2] = yuv[..., 0]
                out[:, 0::4] = yuv[:, ::2, 1]
                out[:, 2::4] = yuv[:, ::2, 2]
            return out
        if fmt in VideoFormat.PACKED_RGB16:
            rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
            r = rgb[..., 0].astype(np.uint16)
            g = rgb[..., 1].astype(np.uint16)
            b = rgb[..., 2].astype(np.uint16)
            return ((r >> (8 - rb)) << rs | (g >> (8 - gb)) << gs
                    | (b >> (8 - bb)) << bs).astype(np.uint16)
        r_off, g_off, b_off, x_off = VideoFormat.rgb_offsets(fmt)
        n = VideoFormat.n_channels(fmt)
        out = np.empty((h, w, n), np.uint8)
        out[..., r_off] = rgb[..., 0]
        out[..., g_off] = rgb[..., 1]
        out[..., b_off] = rgb[..., 2]
        if x_off is not None:
            out[..., x_off] = 255
        return out

    def init_state(self, batch: int):
        # frame counter (int64, as the JAX package's x64 counter)
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def generate(self, params, state, window: int):
        spec = self.out_spec
        h, w = spec.height, spec.width
        dev = self.device
        n = torch.arange(window, dtype=torch.int64, device=dev) + state
        pattern = self.props["pattern"]

        def broadcast(bg):
            if isinstance(bg, dict):
                return {k: v.expand((window,) + v.shape)
                        for k, v in bg.items()}
            return bg.expand((window,) + bg.shape)

        word = None  # int32 word view attached for 4-byte packed formats
        word_base = None  # [1, H, W] base when the word is a broadcast
        if pattern == "ball":
            # moving bright ball on the static background luma; float64
            # geometry as in the JAX package
            t = n.to(torch.float64)
            cx = (w / 2.0) + (w / 3.0) * torch.cos(t * 0.1)
            cy = (h / 2.0) + (h / 3.0) * torch.sin(t * 0.13)
            yy = torch.arange(h, dtype=torch.float64, device=dev)[None, :, None]
            xx = torch.arange(w, dtype=torch.float64, device=dev)[None, None, :]
            r2 = ((xx - cx[:, None, None]) ** 2
                  + (yy - cy[:, None, None]) ** 2)
            radius = max(4.0, min(h, w) / 16.0)
            mask = r2 < radius * radius
            if self._ball_word is not None:
                word = torch.where(mask, self._ball_word[None],
                                   self._bg_word[None])
                data = unpack32(word)
            else:
                data = self._apply_luma_overlay(broadcast(self._bg), mask)
        elif self._bg_word is not None:
            word = self._bg_word.expand(window, h, w)
            word_base = self._bg_word[None]  # [1, H, W] broadcast base
            data = unpack32(word)
        else:
            data = broadcast(self._bg)

        pts = n * spec.frame_duration_ns
        batch = FrameBatch.make(data, pts=pts)
        if word is not None:
            batch = batch.replace(word=word, word_base=word_base)
        return state + window, batch

    def _apply_luma_overlay(self, data, mask):
        fmt = self.out_spec.format
        if isinstance(data, dict):
            return {**data, "y": data["y"].masked_fill(mask, 235)}
        if self._is_ayuv or fmt in VideoFormat.PACKED_YUV422:
            y = VideoFormat.luma_view(fmt, data)
            return VideoFormat.luma_set(fmt, data, y.masked_fill(mask, 235))
        if self._is_gray:
            return data.masked_fill(mask, 235)
        if fmt in VideoFormat.PACKED_RGB16:
            rs, rb, gs, gb, bs, bb = VideoFormat.rgb16_fields(fmt)
            white = ((0xFF >> (8 - rb)) << rs | (0xFF >> (8 - gb)) << gs
                     | (0xFF >> (8 - bb)) << bs)
            # torch has little uint16 arithmetic: select in int32
            return torch.where(mask, white, data.to(torch.int32)
                               ).to(torch.uint16)
        return data.masked_fill(mask[..., None], 255)


_AUDIO_DTYPES = {AudioFormat.S16: torch.int16, AudioFormat.S32: torch.int32,
                 AudioFormat.F32: torch.float32, AudioFormat.F64: torch.float64}


@register
class AudioTestSrc(Element):
    """Sine/square/silence PCM generator, [B, S, C] blocks of S =
    samplesperbuffer samples.  The waveform is float64, as in the JAX
    package, and converted to the sample format at the end."""

    NAME = "audiotestsrc"
    KIND = "source"
    PROPERTIES = (
        Property("wave", str, "sine", static=True),
        Property("freq", float, 440.0, static=True),
        Property("volume", float, 0.8, 0.0, 1.0, static=True),
        Property("format", str, AudioFormat.F32, static=True),
        Property("rate", int, 48000, static=True),
        Property("channels", int, 2, 1, 64, static=True),
        Property("samplesperbuffer", int, 1024, 1, None, static=True),
        Property("seed", int, 0, static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        return MediaSpec(kind="audio", format=self.props["format"],
                         rate=self.props["rate"],
                         channels=self.props["channels"])

    def prepare(self):
        wave = self.props["wave"]
        if wave == "white-noise":
            raise ValueError("audiotestsrc: wave=white-noise is not ported "
                             "to gstbad_tpu_torch yet (ROADMAP queue 1)")
        if wave not in ("sine", "square", "silence"):
            raise ValueError(f"unknown wave {wave!r}")
        if self.out_spec.format not in _AUDIO_DTYPES:
            raise ValueError(f"audiotestsrc: unknown format "
                             f"{self.out_spec.format!r}")

    def init_state(self, batch: int):
        # sample counter (int64, as the JAX package's x64 counter)
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def generate(self, params, state, window: int):
        spec = self.out_spec
        s = self.props["samplesperbuffer"]
        n0 = state
        idx = (n0 + torch.arange(window * s, dtype=torch.int64,
                                 device=self.device)).reshape(window, s)
        wave = self.props["wave"]
        vol = self.props["volume"]
        if wave == "silence":
            x = torch.zeros((window, s), dtype=torch.float64,
                            device=self.device)
        else:
            # 2*pi*freq * (idx / rate) as the JAX package's compiled form
            # evaluates it: XLA folds the two constants into one factor
            arg = idx.to(torch.float64) * (2 * np.pi * self.props["freq"]
                                           / spec.rate)
            if arg.device.type == "cpu":
                # torch's vectorised float64 sine on the CPU is off by one
                # ulp from the C library's on some samples; numpy's, like
                # the JAX package's on the CPU, equals the C library's
                x = torch.from_numpy(np.sin(arg.numpy()))
            else:
                x = torch.sin(arg)
            if wave == "square":
                x = torch.sign(x)
            x = vol * x
        fmt = spec.format
        if fmt == AudioFormat.S16:
            x = (x * 32767.0).clamp(-32768, 32767)
        elif fmt == AudioFormat.S32:
            x = (x * 2147483647.0).clamp(-2147483648, 2147483647)
        # every channel carries the same wave: one converted plane, viewed
        # C times
        data = x.to(_AUDIO_DTYPES[fmt])[..., None].expand(window, s,
                                                         spec.channels)
        dur = int(1e9 * s / spec.rate)
        pts = (n0 // s + torch.arange(window, dtype=torch.int64,
                                      device=self.device)) * dur
        return n0 + window * s, FrameBatch.make(data, pts=pts)
