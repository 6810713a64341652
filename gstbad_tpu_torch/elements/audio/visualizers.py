"""audiovisualizers (gst/audiovisualizers/): wavescope, spacescope,
spectrascope and synaescope render audio blocks into BGRx video frames.

As in the JAX package: wavescope and spacescope transcribe the reference's
render loops (gstwavescope.c:214-405, gstspacescope.c:213-400,
gstdrawhelpers.h) with the four styles, the gfloat step interpolation and
truncating casts, and the two-stage float64 resonant filter carried
across buffers (ops/audio.scope_filter, a hand-written CUDA kernel on the
card).  Anti-aliased lines accumulate their taps in float32 and saturate
once (the JAX package's form, not the C's per-dot read-modify-write); the
taps of a pixel add in the JAX package's order, one pass per rank of
the pixel's taps (_ordered_add), so the card, the CPU and the JAX package
give the same bytes.  spectrascope and synaescope transcribe their render
loops (gstspectrascope.c:171-233, gstsynaescope.c:104-311) over the
bit-exact fixed-point gst_fft_s16 (ops/ffts16.py), with integer
accumulation.

The base class's shaders (none, fade and fade-and-move-up/down/left/
right; default fade with 0x000A0A0A) start each frame from the previous
output frame; the canvas carries across windows in state, so the frames
of a window are a walk, one frame after another.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, to_host
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec, require
from gstbad_tpu_torch.golden.ffts16 import SYNAE_SL, synaescope_tables
from gstbad_tpu_torch.ops import audio as ops
from gstbad_tpu_torch.ops.numerics import fma32
from gstbad_tpu_torch.ops import ffts16

_SHADERS = ("none", "fade", "fade-and-move-up", "fade-and-move-down",
            "fade-and-move-left", "fade-and-move-right")
_COLORS = (0x00FF0000, 0x0000FF00, 0x000000FF)
_WHITE = 0x00FFFFFF


def _g32(x):
    """Round float64 values to float32 and back: each step of the C's
    gfloat chains rounds to float32."""
    return x.to(torch.float32).to(torch.float64)


def _gfloat_axpy(base: int, a, scale):
    """trunc(f32(base + f32(a * scale))), as the C computes it in gfloat."""
    prod = _g32(a.to(torch.float64) * float(scale))
    return _g32(prod + float(base)).to(torch.int32)


def _words(img):
    """[H, W, 4] uint8 -> flat int32 words (a view)."""
    return img.reshape(-1, 4).view(torch.int32).reshape(-1)


def _dots(words, x, y, w: int, limit: int, word: int, combine: bool):
    """Set (or OR, with combine) `word` at the pixels (x, y); pixels off
    the frame's flat range are dropped.  Duplicates write the same value,
    so the result does not depend on their order."""
    idx = y * w + x
    ok = (idx >= 0) & (idx < limit)
    flat = torch.cat([words, words.new_zeros(1)])
    idx = torch.where(ok, idx, limit).to(torch.int64)
    val = flat[idx] | word if combine else torch.full_like(idx, word).to(
        torch.int32)
    flat[idx] = val.to(torch.int32)
    return flat[:limit]


def _line_taps(x1, y1, x2, y2, w: int, limit: int, color: int, k_max: int):
    """draw_line_aa's taps for segments [..., N] (the JAX package's
    _lines_aa): (flat pixel index [..., 4 * N * k_max] with `limit` for a
    dropped tap, float32 values [..., 4 * N * k_max, 3]), in the order
    the JAX package scatters them (tap, segment, step)."""
    dx = x2 - x1
    dy = y2 - y1
    j = torch.maximum(dx.abs(), dy.abs())
    k = torch.arange(k_max, dtype=torch.int32, device=x1.device)
    mask = k < j[..., None]
    f = _g32(k.to(torch.float64)
             / torch.clamp(j, min=1)[..., None].to(torch.float64))
    rx = _g32(x1[..., None].to(torch.float64)
              + _g32(dx[..., None].to(torch.float64) * f))
    ry = _g32(y1[..., None].to(torch.float64)
              + _g32(dy[..., None].to(torch.float64) * f))
    x = rx.to(torch.int32)
    y = ry.to(torch.int32)
    fx = (rx - x).to(torch.float32)
    fy = (ry - y).to(torch.float32)
    cb = torch.tensor([(color >> (8 * c)) & 0xFF for c in range(3)],
                      dtype=torch.float32, device=x1.device)
    taps = ((0, 0, ((1.0 - fx) + (1.0 - fy)) / 2.0),
            (1, 0, (fx + (1.0 - fy)) / 2.0),
            (0, 1, ((1.0 - fx) + fy) / 2.0),
            (1, 1, (fx + fy) / 2.0))
    idxs, vals = [], []
    lead = x1.shape[:-1]
    for ox, oy, wgt in taps:
        idx = (y + oy) * w + (x + ox)
        ok = mask & (idx >= 0) & (idx < limit)
        idxs.append(torch.where(ok, idx, limit).reshape(lead + (-1,)))
        vals.append(torch.where(ok, wgt, 0.0).reshape(lead + (-1, 1))
                    * cb)
    return torch.cat(idxs, dim=-1), torch.cat(vals, dim=-2)


def _tap_passes(idx, vals, limit: int):
    """Order a window's line taps for _ordered_add.  idx [B, T] (`limit`
    for a dropped tap) and vals [B, T, 3] in drawing order.  The kept taps
    are sorted by frame and pixel, keeping their drawing order within a
    pixel, and each gets its rank among its pixel's taps; then they are
    grouped by (frame, rank).  Returns (pixels, values) in that order and,
    per frame, the sizes of its rank groups (host ints): the r-th group of
    a frame holds every pixel's r-th tap, each pixel once."""
    b, t = idx.shape
    keep = (idx < limit).reshape(-1).nonzero().squeeze(1)
    frame = torch.div(keep, t, rounding_mode="floor")
    key = frame * limit + idx.reshape(-1)[keep]
    val = vals.reshape(-1, 3)[keep]
    key, order = torch.sort(key, stable=True)
    val = val[order]
    pos = torch.arange(key.numel(), device=key.device)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), dim=0).values
    frame = torch.div(key, limit, rounding_mode="floor")
    group = frame * (t + 1) + rank
    group, order = torch.sort(group, stable=True)
    pix = (key - frame * limit)[order]
    val = val[order]
    ids, counts = torch.unique_consecutive(group, return_counts=True)
    ids, counts = to_host(ids, counts)
    sizes = [[] for _ in range(b)]
    for g, n in zip(ids.tolist(), counts.tolist()):
        sizes[g // (t + 1)].append(n)
    return pix, val, sizes


def _ordered_add(acc, pix, vals, sizes):
    """acc[pix] += vals with each pixel's taps added one by one in drawing
    order (the order of a serial scatter): group r adds every pixel's
    r-th tap, so no group writes a pixel twice."""
    o = 0
    for n in sizes:
        d = pix[o:o + n]
        acc[d] = acc[d] + vals[o:o + n]
        o += n
    return acc


class _Scope(Element):
    """Base: audio [B, S, C] -> video [B, H, W, 4] BGRx at 25 fps."""

    PROPERTIES = (
        Property("width", int, 320, 16, 4096, static=True),
        Property("height", int, 240, 16, 4096, static=True),
        Property("shader", str, "fade", static=True,
                 doc="|".join(_SHADERS)),
        Property("shade-amount", int, 0x000A0A0A, 0, 0xFFFFFFFF,
                 static=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio")
        require(in_spec.format in (AudioFormat.S16, AudioFormat.F32),
                f"{self.NAME}: needs S16/F32")
        require(self.props["shader"] in _SHADERS,
                f"{self.NAME}: unknown shader {self.props['shader']!r}")
        self._audio_spec = in_spec
        return MediaSpec(kind="video", format="BGRx",
                         width=self.props["width"],
                         height=self.props["height"],
                         framerate=Fraction(25, 1))

    def init_state(self, batch: int):
        h, w = self.props["height"], self.props["width"]
        return {"canvas": torch.zeros((h, w, 4), dtype=torch.uint8,
                                      device=self.device)}

    def _s16(self, x):
        if self._audio_spec.format == AudioFormat.S16:
            return x.to(torch.int32)
        return torch.trunc(x.to(torch.float32) * 32768.0).clamp(
            -32768, 32767).to(torch.int32)

    def _shade(self, prev):
        """The shaded canvas the next frame starts from (shader_fade)."""
        shader = self.props["shader"]
        if shader == "none":
            return torch.zeros_like(prev)
        amount = self.props["shade-amount"]
        sub = torch.tensor([(amount >> (8 * i)) & 0xFF for i in range(4)],
                           dtype=torch.int16, device=prev.device)
        faded = torch.clamp(prev.to(torch.int16) - sub, min=0).to(
            torch.uint8)
        out = torch.zeros_like(faded)
        if shader == "fade-and-move-up":
            out[:-1] = faded[1:]
        elif shader == "fade-and-move-down":
            out[1:] = faded[:-1]
        elif shader == "fade-and-move-left":
            out[:, :-1] = faded[:, 1:]
        elif shader == "fade-and-move-right":
            out[:, 1:] = faded[:, :-1]
        else:
            out = faded
        return out

    def _walk(self, state, draw, b: int):
        """The frames of a window one after another: frame i is
        draw(i, shaded frame i - 1) (frame -1 the carried canvas)."""
        prev = state["canvas"]
        imgs = []
        for i in range(b):
            prev = draw(i, self._shade(prev))
            imgs.append(prev)
        state = dict(state)
        state["canvas"] = prev
        return state, torch.stack(imgs)

    def _lines(self, state, segs, b: int):
        """Frames of anti-aliased lines: segs, per frame in drawing order,
        a list of (x1, y1, x2, y2 [B, N], colour, k_max) — all of a
        window's taps are found at once, then each frame adds its taps to
        its shaded canvas in order and saturates."""
        h, w = self.props["height"], self.props["width"]
        limit = h * w
        idxs, vals = [], []
        # the longest segment of each group bounds the steps worth taking
        longest = to_host(torch.stack([
            torch.maximum((x2 - x1).abs(), (y2 - y1).abs()).max()
            for x1, y1, x2, y2, _, _ in segs]))[0]
        for (x1, y1, x2, y2, color, k_max), j in zip(segs, longest):
            k_eff = max(1, min(k_max, int(j)))
            i, v = _line_taps(x1, y1, x2, y2, w, limit, color, k_eff)
            idxs.append(i)
            vals.append(v)
        idx = torch.cat(idxs, dim=-1).to(torch.int64)
        pix, val, sizes = _tap_passes(idx, torch.cat(vals, dim=-2), limit)
        starts = np.cumsum([0] + [sum(z) for z in sizes]).tolist()

        def draw(i, canvas):
            acc = torch.cat([canvas[..., :3].reshape(limit, 3).to(
                torch.float32), canvas.new_zeros((1, 3), dtype=torch.float32)])
            o0, o1 = starts[i], starts[i + 1]
            acc = _ordered_add(acc, pix[o0:o1], val[o0:o1], sizes[i])
            out = torch.clamp(acc[:limit], max=255).to(torch.uint8)
            return torch.cat([out.reshape(h, w, 3), canvas[..., 3:]], dim=-1)

        return self._walk(state, draw, b)

    def _dot_frames(self, state, pts, b: int, combine: bool):
        """Frames of dots: pts, per frame in drawing order, a list of
        (x, y [B, N], word)."""
        h, w = self.props["height"], self.props["width"]

        def draw(i, canvas):
            words = _words(canvas.contiguous())
            for x, y, word in pts:
                words = _dots(words, x[i], y[i], w, h * w, word, combine)
            return words.view(torch.uint8).reshape(h, w, 4)

        return self._walk(state, draw, b)


@register
class WaveScope(_Scope):
    """wavescope (gstwavescope.c): waveform oscilloscope, styles dots,
    lines, color-dots and color-lines (gstwavescope.c:145-151)."""

    NAME = "wavescope"
    PROPERTIES = _Scope.PROPERTIES + (
        Property("style", str, "dots", static=True,
                 doc="dots | lines | color-dots | color-lines"),)

    def init_state(self, batch: int):
        st = super().init_state(batch)
        st["flt"] = torch.zeros(6 * self._audio_spec.channels,
                                dtype=torch.float64, device=self.device)
        return st

    def process(self, params, state, batch: FrameBatch):
        w, h = self.props["width"], self.props["height"]
        style = self.props["style"]
        b, s, c = batch.data.shape
        dev = batch.data.device
        adata = self._s16(batch.data)   # [B, S, C]
        ar = torch.arange(s, dtype=torch.float64, device=dev)
        # the reference reads adata[s] before s += channels in the line
        # styles: sample 0 enters twice, the last sample never
        shift = torch.clamp(torch.arange(s, device=dev) - 1, min=0)
        if style in ("dots", "lines"):
            lines = style == "lines"
            dx = np.float32(w - 1 if lines else w) / np.float32(s)
            dy = np.float32((h - 1 if lines else h) / 65536.0)
            oy = (h - 1) // 2 if lines else h // 2
            xs = _g32(ar * float(dx)).to(torch.int32)
            if lines:
                xs[0] = 0   # the first segment starts at x2 = 0
                y = _gfloat_axpy(oy, adata[:, shift], dy)   # [B, S, C]
                k_max = max(h, -(-w // s) + 1)
                segs = [(xs[:-1].expand(b, s - 1), y[:, :-1, ch],
                         xs[1:].expand(b, s - 1), y[:, 1:, ch], _WHITE,
                         k_max) for ch in range(c)]
                state, imgs = self._lines(state, segs, b)
            else:
                y = _gfloat_axpy(oy, adata, dy)
                state, imgs = self._dot_frames(
                    state, [(xs.expand(b, s), y[..., ch], _WHITE)
                            for ch in range(c)], b, combine=False)
        elif style in ("color-dots", "color-lines"):
            lines = style == "color-lines"
            dx = np.float32(w - 1 if lines else w) / np.float32(s)
            dy = float(np.float32((h - 1 if lines else h) / 65536.0))
            oy = (h - 1) // 2 if lines else h // 2
            h1 = h - 2
            xs = _g32(ar * float(dx)).to(torch.int32)
            a = adata[:, shift] if lines else adata
            flt, taps = ops.scope_filter(state["flt"], a.reshape(b * s, c))
            taps = taps.reshape(b, s, 3, c)

            def ypix(v):
                iv = torch.trunc(float(oy) + v * dy).to(torch.int32)
                return torch.where(iv < 0, h1, torch.clamp(iv, max=h1))

            ys = [ypix(taps[:, :, k, :]) for k in range(3)]   # [B, S, C]
            if lines:
                k_max = max(h, -(-w // s) + 1)
                x1 = xs[:-1].clone()
                x1[0] = 0
                segs = [(x1.expand(b, s - 1), yy[:, :-1, ch],
                         xs[1:].expand(b, s - 1), yy[:, 1:, ch], col, k_max)
                        for ch in range(c) for yy, col in zip(ys, _COLORS)]
                state, imgs = self._lines(state, segs, b)
            else:
                state, imgs = self._dot_frames(
                    state, [(xs.expand(b, s), yy[..., ch], col)
                            for ch in range(c)
                            for yy, col in zip(ys, _COLORS)], b,
                    combine=True)
            state["flt"] = flt
        else:
            raise ValueError(f"wavescope: unknown style {style!r}")
        return state, batch.with_data(imgs)


@register
class SpaceScope(_Scope):
    """spacescope (gstspacescope.c): stereo X-Y scope, styles dots, lines,
    color-dots and color-lines."""

    NAME = "spacescope"
    PROPERTIES = _Scope.PROPERTIES + (
        Property("style", str, "dots", static=True,
                 doc="dots | lines | color-dots | color-lines"),)

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.channels == 2, "spacescope: needs stereo")
        return super().negotiate(in_spec)

    def init_state(self, batch: int):
        st = super().init_state(batch)
        st["flt"] = torch.zeros(12, dtype=torch.float64, device=self.device)
        return st

    def process(self, params, state, batch: FrameBatch):
        w, h = self.props["width"], self.props["height"]
        style = self.props["style"]
        b, s, _ = batch.data.shape
        adata = self._s16(batch.data)   # [B, S, 2]
        if style in ("dots", "lines"):
            lines = style == "lines"
            dx = np.float32(((w - 1) if lines else w) / 65536.0)
            dy = np.float32(((h - 1) if lines else h) / 65536.0)
            ox, oy = ((w - 1) // 2, (h - 1) // 2) if lines else (w // 2,
                                                                 h // 2)
            x = _gfloat_axpy(ox, adata[..., 0], dx)
            y = _gfloat_axpy(oy, adata[..., 1], dy)
            if lines:
                state, imgs = self._lines(
                    state, [(x[:, :-1], y[:, :-1], x[:, 1:], y[:, 1:],
                             _WHITE, max(w, h))], b)
            else:
                state, imgs = self._dot_frames(state, [(x, y, _WHITE)], b,
                                               combine=False)
        elif style in ("color-dots", "color-lines"):
            dx = float(np.float32(w / 65536.0))
            dy = float(np.float32(h / 65536.0))
            ox, oy = w // 2, h // 2
            flt, taps = ops.scope_filter(state["flt"],
                                         adata.reshape(b * s, 2))
            taps = taps.reshape(b, s, 3, 2)

            def clampxy(vx, vy):
                x = torch.trunc(float(ox) + vx * dx).to(torch.int32)
                y = torch.trunc(float(oy) + vy * dy).to(torch.int32)
                return x.clamp(0, w - 2), y.clamp(0, h - 2)

            pts = [clampxy(taps[:, :, k, 0], taps[:, :, k, 1])
                   for k in range(3)]
            if style == "color-lines":
                state, imgs = self._lines(
                    state, [(x[:, :-1], y[:, :-1], x[:, 1:], y[:, 1:], col,
                             max(w, h)) for (x, y), col in zip(pts, _COLORS)],
                    b)
            else:
                state, imgs = self._dot_frames(
                    state, [(x, y, col) for (x, y), col in zip(pts, _COLORS)],
                    b, combine=True)
            state["flt"] = flt
        else:
            raise ValueError(f"spacescope: unknown style {style!r}")
        return state, batch.with_data(imgs)


@register
class SpectraScope(_Scope):
    """spectrascope (gstspectrascope.c:126-233): the draw loop over the
    bit-exact gst_fft_s16 of each frame's first 2 * width samples
    (zero-padded when the block is shorter), Hamming-windowed; the
    mono mixdown keeps the reference's guint accumulator with unsigned
    division (:190-203)."""

    NAME = "spectrascope"

    def process(self, params, state, batch: FrameBatch):
        w, height = self.props["width"], self.props["height"]
        h = height - 1
        nfft = 2 * w
        data = self._s16(batch.data)       # [B, S, C] int32
        b, s, ch = data.shape
        dev = data.device
        if ch == 1:
            mono = data[..., 0]
        else:
            v = torch.sum(data.to(torch.int64), dim=-1) & 0xFFFFFFFF
            lo = torch.div(v, ch, rounding_mode="floor") & 0xFFFF
            mono = torch.where(lo >= 0x8000, lo - 0x10000, lo).to(
                torch.int32)
        if s >= nfft:
            mono = mono[:, :nfft]
        else:
            mono = torch.nn.functional.pad(mono, (0, nfft - s))
        fr_, fi_ = ffts16.fft_s16(ffts16.window_hamming(mono))
        fr = fr_[:, 1:w + 1].to(torch.float32) / 512.0
        fi = fi_[:, 1:w + 1].to(torch.float32) / 512.0
        # gfloat fr*fr + fi*fi, the first product contracted as the JAX
        # package's compiled window does it
        mag2 = fma32(fr, fr, fi * fi)
        y = (h * torch.sqrt(mag2.to(torch.float64))).to(torch.int32)
        y = h - torch.clamp(y, max=h)      # [B, w]
        rows = torch.arange(height, dtype=torch.int32,
                            device=dev)[None, :, None]
        count = ((rows > y[:, None, :]).to(torch.int32)
                 + (rows == h).to(torch.int32))
        white = rows == y[:, None, :]
        wword = torch.tensor([255, 255, 255, 0], dtype=torch.uint8,
                             device=dev)

        def draw(i, canvas):
            bgr = torch.clamp(canvas[..., :3].to(torch.int32)
                              + 0x7F * count[i][..., None], max=255)
            img = torch.cat([bgr.to(torch.uint8), canvas[..., 3:]], dim=-1)
            # the peak pixel: vdata[off] = 0x00FFFFFF overwrites
            return torch.where(white[i][..., None], wword, img)

        state, imgs = self._walk(state, draw, b)
        return state, batch.with_data(imgs)


_SYNAE_MAXI = 20   # the shade decay from 255 reaches 0 in 19 steps


@register
class SynaeScope(_Scope):
    """synaescope (gstsynaescope.c:104-311): the stars render over the
    bit-exact gst_fft_s16 of each channel (no window): per bin the stereo
    sum and difference magnitudes, the clarity, x = r*w/fc and br =
    b*fc*0.01, the colors and shade tables, the star arms with the
    interior and border branches, and the saturating add, accumulated in
    int32.  A silent bin (ll + rr == 0) is skipped (the reference indexes
    with 0.0/0.0 there)."""

    NAME = "synaescope"

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.channels == 2, "synaescope: needs stereo")
        return super().negotiate(in_spec)

    def prepare(self):
        colors, shade = synaescope_tables()
        cb = np.stack([colors & 0xFF, (colors >> 8) & 0xFF,
                       (colors >> 16) & 0xFF], axis=-1)   # B, G, R
        self._colors = torch.from_numpy(cb.astype(np.int32)).to(self.device)
        self._shade_lut = torch.from_numpy(shade.astype(np.int32)).to(
            self.device)

    def _star_acc(self, fl_r, fl_i, fr_r, fr_i, w: int, h: int):
        """The window's saturating-add contributions as int32 flat
        accumulations [B, h*w + w + 2, 3] (adding non-negative colours
        saturates to the same bytes in any order)."""
        sl = SYNAE_SL
        b_ = fl_r.shape[0]
        dev = fl_r.device
        y = torch.arange(h, dtype=torch.int32, device=dev)
        bb = h - y
        frl, fil, frr, fir = (t[:, bb.to(torch.int64)].to(torch.float64)
                              for t in (fl_r, fl_i, fr_r, fr_i))
        ll = (frl + fil) ** 2 + (frr - fir) ** 2
        rr = (frl - fil) ** 2 + (frr + fir) ** 2
        l_ = torch.sqrt(ll)
        r_ = torch.sqrt(rr)
        tot = ll + rr
        live = tot > 0
        safe = torch.where(live, tot, 1.0)
        clarity = (((frl + fil) * (frl - fil) + (frr + fir) * (frr - fir))
                   / safe * 256).to(torch.int32)
        fc = r_ + l_
        x = torch.where(live, r_ * w / torch.where(live, fc, 1.0),
                        0.0).to(torch.int32)
        br = (bb.to(torch.float64) * fc * 0.01).to(torch.int32)
        br1 = torch.clamp((br * (clarity + 128)) >> 8, 0, 255)
        br2 = torch.clamp((br * (128 - clarity)) >> 8, 0, 255)
        off = y * w + x
        interior = (x > sl - 1) & (x < w - sl) & (y > sl - 1) & (y < h - sl)
        size = h * w + w + 2
        acc = torch.zeros((b_, size + 1, 3), dtype=torch.int32, device=dev)
        frame_base = (torch.arange(b_, device=dev) * (size + 1))[:, None]
        flat = acc.view(-1, 3)

        def add(idx, ok, c):
            dest = (torch.where(ok, idx, size) + frame_base).reshape(-1)
            flat.index_add_(0, dest.to(torch.int64), torch.where(
                ok[..., None], c, 0).reshape(-1, 3))

        add(off, live, self._colors[((br1 >> 4) | (br2 & 0xF0)).to(
            torch.int64)])
        s1, s2 = br1, br2
        for i in range(1, _SYNAE_MAXI + 1):
            active = live & ((s1 | s2) != 0)
            c = self._colors[((s1 >> 4) | (s2 & 0xF0)).to(torch.int64)]
            for idx, chk in ((off - i, x - i > 0), (off + i, x + i < w - 1),
                             (off - i * w, y - i > 0),
                             (off + i * w, y + i < h - 1)):
                add(idx, active & (interior | chk), c)
            s1 = self._shade_lut[s1.to(torch.int64)]
            s2 = self._shade_lut[s2.to(torch.int64)]
        return acc[:, :size]

    def process(self, params, state, batch: FrameBatch):
        w, h = self.props["width"], self.props["height"]
        nfft = 2 * h                       # num_freq = height + 1
        data = self._s16(batch.data)       # [B, S, 2]
        b, s, _ = data.shape
        if s >= nfft:
            data = data[:, :nfft]
        else:
            data = torch.nn.functional.pad(data, (0, 0, 0, nfft - s))
        fl_r, fl_i = ffts16.fft_s16(data[..., 0])
        fr_r, fr_i = ffts16.fft_s16(data[..., 1])
        accs = self._star_acc(fl_r, fl_i, fr_r, fr_i, w, h)
        size = h * w + w + 2

        def draw(i, canvas):
            flat = canvas.new_zeros((size, 4), dtype=torch.int32)
            flat[:h * w] = canvas.reshape(h * w, 4).to(torch.int32)
            bgr = torch.clamp(flat[:, :3] + accs[i], max=255)
            out = torch.cat([bgr, flat[:, 3:]], dim=-1)
            return out[:h * w].reshape(h, w, 4).to(torch.uint8)

        state, imgs = self._walk(state, draw, b)
        return state, batch.with_data(imgs)
