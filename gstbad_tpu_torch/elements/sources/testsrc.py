"""Test sources — the videotestsrc and audiotestsrc analogs, and
testsrcbin over them.

The reference consumes gst-plugins-base's videotestsrc in every launch line
and test; this one generates batched frames directly on the pipeline's
device so benchmarks aren't host-transfer bound.

videotestsrc's noise pattern and audiotestsrc's white noise come from a
counter-based integer hash keyed by `seed` (the JAX package draws them from
JAX's PRNG, which torch cannot reproduce, so the two agree in distribution
only): frame n's bytes are a function of (seed, n) and sample i's value of
(seed, i), whatever the window, and the hash is int64 torch arithmetic with
every product below 2^63, so the card and the CPU give the same bits.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import make, register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, VideoFormat
from gstbad_tpu_torch.ops.pointops import unpack32

# SMPTE-ish color bars in RGB (white, yellow, cyan, green, magenta, red,
# blue, black at 75%)
_BARS_RGB = np.array([
    [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
    [191, 0, 191], [191, 0, 0], [0, 0, 191], [0, 0, 0]], np.uint8)


_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B       # below 2^27: a 32-bit value times it < 2^59
_VIDEO_STREAM, _AUDIO_STREAM_HI, _AUDIO_STREAM_LO = (0x9E3779B9, 0x85EBCA6B,
                                                     0xC2B2AE35)


def _mix32(x):
    """A bijective 32-bit integer hash (two multiply-xorshift rounds) of
    x in [0, 2^32): a Python int or an int64 tensor."""
    x = (((x >> 16) ^ x) * _HASH_MUL) & _M32
    x = (((x >> 16) ^ x) * _HASH_MUL) & _M32
    return (x >> 16) ^ x


def _counter_key(seed: int, stream: int, counter):
    """The 32-bit key of (seed, stream, counter), counter an int64 tensor
    of frame or sample numbers (any sign, any size)."""
    s = seed & 0xFFFFFFFFFFFFFFFF
    k = _mix32(_mix32((s & _M32) ^ stream) ^ (s >> 32))
    k = _mix32(k ^ (counter & _M32))
    return _mix32(k ^ ((counter >> 32) & _M32))


def noise_frames(seed: int, frames, shape, dtype) -> torch.Tensor:
    """Uniform random frames [B, *shape] of `dtype` (uint8 or uint16) for
    the frame numbers `frames` (int64 [B]): every byte of frame n is a
    function of (seed, n) and its position alone.  One 32-bit hash a word
    of four bytes, its bytes in little-endian order."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = int(np.prod(shape)) * itemsize
    j = torch.arange((nbytes + 3) // 4, dtype=torch.int64,
                     device=frames.device)
    key = _counter_key(seed, _VIDEO_STREAM, frames)[:, None]
    h = _mix32((_mix32(j[None, :] ^ key) + key) & _M32)
    h = h - ((h >> 31) << 32)          # the same bits as an int32 value
    raw = h.to(torch.int32).view(torch.uint8)[:, :nbytes]
    return raw.contiguous().view(dtype).reshape((len(frames),) + tuple(shape))


def noise_uniform(seed: int, idx) -> torch.Tensor:
    """Uniform float64 in [0, 1) on the 2^-53 grid for the sample numbers
    idx (int64 tensor), as numpy forms a double from two 32-bit draws
    (53 = 27 + 26 bits)."""
    a = _mix32(_counter_key(seed, _AUDIO_STREAM_HI, idx))
    b = _mix32(_counter_key(seed, _AUDIO_STREAM_LO, idx))
    return ((a >> 5) * 67108864 + (b >> 6)).to(torch.float64) * 2.0 ** -53


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
        elif pattern in ("black", "solid-color", "white", "ball", "noise"):
            if pattern == "white":
                color = (255, 255, 255)
            elif pattern in ("black", "noise"):
                color = (0, 0, 0)
            elif pattern == "ball":
                color = (32, 32, 32)
            else:
                fg = self.props["foreground-color"]
                color = ((fg >> 16) & 0xFF, (fg >> 8) & 0xFF, fg & 0xFF)
            rgb = np.broadcast_to(np.array(color, np.uint8)[None, None, :],
                                  (h, w, 3))
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
        elif pattern == "noise":
            data = self._noise(n)
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

    def _noise(self, n):
        """Uniform bytes for frames n: the luma plane of a planar format
        (its chroma planes 128), every byte of a packed one (AYUV's alpha
        255).  16-bit formats take 16 random bits a component, where the
        JAX package draws 0-255 into uint8 frames (ROADMAP queue 3)."""
        seed = self.props["seed"]
        if isinstance(self._bg, dict):
            data = {"y": noise_frames(seed, n, self._bg["y"].shape,
                                      torch.uint8)}
            for k, v in self._bg.items():
                if k != "y":
                    data[k] = torch.full((len(n),) + v.shape, 128,
                                         dtype=torch.uint8, device=v.device)
            return data
        data = noise_frames(seed, n, self._bg.shape, self._bg.dtype)
        if self._is_ayuv:
            data[..., 0] = 255
        return data

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
    """Sine/square/silence/white-noise PCM generator, [B, S, C] blocks of
    S = samplesperbuffer samples.  The waveform is float64, as in the JAX
    package, and converted to the sample format at the end.  White noise is
    drawn per absolute sample index, so consecutive windows differ (the JAX
    package repeats one draw every window, ROADMAP queue 3)."""

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
        if wave not in ("sine", "square", "silence", "white-noise"):
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
        elif wave == "white-noise":
            x = vol * (noise_uniform(self.props["seed"], idx) * 2 - 1)
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


# properties a testbin:// stream forwards to its inner source (the JAX
# package's session/testbin.py); anything else in the URI is refused
_VIDEO_PROPS = {"pattern", "format", "width", "height", "framerate",
                "foreground-color", "seed"}
_AUDIO_PROPS = {"wave", "freq", "volume", "format", "rate", "channels",
                "samplesperbuffer", "seed"}


def parse_testbin_uri(uri: str) -> List[Tuple[str, Dict[str, str]]]:
    """'testbin://video,pattern=ball+audio,freq=330' ->
    [('video', {'pattern': 'ball'}), ('audio', {'freq': '330'})]
    (gsttestsrcbin.c:353-415: '+' splits streams, each segment is a
    caps-structure whose fields become child properties)."""
    if not uri.startswith("testbin://"):
        raise ValueError(f"not a testbin URI: {uri!r}")
    location = uri[len("testbin://"):]
    if not location:
        raise ValueError("testbin URI names no streams")
    streams = []
    for segment in location.split("+"):
        parts = [p for p in segment.split(",") if p]
        if not parts:
            continue
        kind = parts[0].strip()
        if kind not in ("audio", "video"):
            raise ValueError(f"testbin: unknown stream type {kind!r} "
                             "(want audio or video)")
        allowed = _VIDEO_PROPS if kind == "video" else _AUDIO_PROPS
        props = {}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in allowed:
                raise ValueError(
                    f"testbin: {kind} stream has no property {k!r} "
                    f"(have {sorted(allowed)})")
            props[k] = v.strip()
        streams.append((kind, props))
    if not streams:
        raise ValueError("testbin URI names no streams")
    return streams


@register
class TestSrcBin(Element):
    """testsrcbin (gst/debugutils/gsttestsrcbin.c): wraps
    audiotestsrc/videotestsrc per a stream spec.  The reference is a bin
    exposing one sometimes-pad per stream and is consumed mainly through
    `playbin uri=testbin://...`; here the factory returns the configured
    inner source directly (the pad-proxy analog), so
    `testsrcbin stream-types=video,pattern=ball ! ...` works inline.  A
    multi-stream spec (`audio+video`) needs one chain per stream and is
    refused here."""

    NAME = "testsrcbin"
    KIND = "source"
    PROPERTIES = (Property("stream-types", str, "video", static=True),)

    def __new__(cls, **props):
        streams = parse_testbin_uri(
            "testbin://" + str(props.get("stream-types", "video")))
        if len(streams) != 1:
            raise ValueError(
                "testsrcbin: one stream per launch-chain instance; "
                f"{len(streams)} streams need one chain each")
        kind, sprops = streams[0]
        return make("videotestsrc" if kind == "video" else "audiotestsrc",
                    **sprops)
