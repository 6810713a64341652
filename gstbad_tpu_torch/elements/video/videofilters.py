"""videofilters — scenechange, zebrastripe, videodiff (gst/videofilters/)
plus smooth (gst/smooth/)."""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core import tablefuse
from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch, to_device, to_host
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops import chainfuse, pointops

# the reference zebrastripe/videodiff format breadth
# (gstzebrastripe.c:145-148): every 8-bit YUV layout with a luma component
_LUMA_FORMATS = VideoFormat.YUV_WITH_LUMA + (VideoFormat.GRAY8,)


class _LumaFilter(VideoFilter):
    """Filter that edits the luma component of any 8-bit YUV layout
    (planar/semi-planar dicts, AYUV channel 1, YUY2/UYVY line strides)."""

    FORMATS = _LUMA_FORMATS

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video")
        require(in_spec.format in self.FORMATS,
                f"{self.NAME}: format {in_spec.format} unsupported")
        return in_spec

    def _get_luma(self, data):
        return VideoFormat.luma_view(self.out_spec.format, data)

    def _set_luma(self, data, y):
        return VideoFormat.luma_set(self.out_spec.format, data, y)


def _luma_threshold(threshold: torch.Tensor) -> torch.Tensor:
    """y_threshold = 16 + floor(0.5 + 2.19 * threshold), in float64 as the
    JAX package computes it."""
    return (16 + torch.floor(0.5 + 2.19 * threshold.to(torch.float64))
            ).to(torch.int32)


@register
class ZebraStripe(_LumaFilter):
    """gstzebrastripe.c: diagonal stripes over lumas above
    16 + round(2.19 * threshold%); the stripe phase advances per frame
    (gstzebrastripe.c:145-148,205-253)."""

    NAME = "zebrastripe"
    # "{ I420, Y444, Y42B, Y41B, YUY2, UYVY, AYUV, NV12, NV21, YV12 }"
    # (gstzebrastripe.c:81-82) + GRAY8 as this framework's extension
    FORMATS = _LUMA_FORMATS
    PROPERTIES = (Property("threshold", int, 90, 0, 100, controllable=True),)

    def init_state(self, batch: int):
        # t, the per-frame stripe phase
        return torch.zeros((), dtype=torch.int32, device=self.device)

    def shard_rule(self, params):
        """Positional but per pixel: a mesh shard offsets the stripe phase
        by its first frame and its first row (the stripe is
        (col + row + phase) & 4), and every shard returns the window's
        new state."""
        return "shard", 0

    @staticmethod
    def _offsets(batch: FrameBatch, rows: int):
        """(first frame, first row, window) of a mesh shard's batch whose
        luma holds `rows` rows; (0, 0, its batch) for a whole window."""
        pos = batch.shard
        if pos is None:
            return 0, 0, batch.batch
        return pos.frame0, pos.row0(rows), pos.window

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        b = y.shape[0]
        f0, r0, window = self._offsets(batch, y.shape[1])
        thr = pointops._per_frame(_luma_threshold(params["threshold"]), 3)
        t = state + torch.arange(f0, f0 + b, dtype=torch.int32,
                                 device=y.device)
        out = pointops.zebrastripe(y, thr, t[:, None, None] + r0)
        return state + window, batch.with_data(
            self._set_luma(batch.data, out))

    def table_tail(self, params, state, chain, batch):
        """Table-fusion tail: y' = 16 where stripe & y >= thr
        (gstzebrastripe.c:205-253) on the chain's materialized word.  With
        a pending dilate3 stencil, a linear head, per-run tables and a
        per-window or per-frame threshold, the stencil, the word lookup
        and this select run as ONE kernel (ops/chainfuse.py)."""
        if (self.out_spec.format != VideoFormat.AYUV
                or not chain.single_indexed()):
            return None
        thr = _luma_threshold(params["threshold"])
        b = chain.src_batch.batch
        h, w = chain.src_word.shape[-2:]
        f0, r0, window = self._offsets(chain.src_batch, h)
        tph = state + torch.arange(f0, f0 + b, dtype=torch.int32,
                                   device=thr.device) + r0

        # the kernel recomputes idx from the source words, so an idx plane
        # that an earlier stencil already moved (stencil_applied) rules it out
        ps = chain.pending_stencil
        if (ps is not None and ps[3] == "dilate3"
                and not chain.stencil_applied
                and isinstance(chain.index_fn, tablefuse.LinearIndex)
                and ps[0].ndim == 1 and thr.ndim <= 1
                and all((k == tablefuse.IDX and t.ndim == 1)
                        or (k == tablefuse.CONST and t.ndim == 0)
                        for k, t in chain.bytes_)):
            key_t, _move, sparams, _tag = ps
            chain.pending_stencil = None
            src = (chain.src_word_base if chain.src_word_base is not None
                   else chain.src_word)
            out = chainfuse.dilate_zebra_fused(
                src.contiguous(), chain.rank_table(key_t),
                chain.word_table(), chain.index_fn,
                sparams["erode"], thr, tph, batch=b)
            # keep the output word attached: the word-keeping sink
            # (fakesink) hands it to the runner as is
            return state + window, chain.src_batch.with_data(
                pointops.unpack32(out)).replace(word=out)

        thr = pointops._per_frame(thr, 3)
        stripe = pointops.stripe_mask(h, w, tph[:, None, None])
        word = chain.materialize_word()
        y = pointops.byte_of(word, 1)
        zebra = (word & pointops.i32(0xFFFF00FF)) | (16 << 8)
        out = torch.where(stripe & (y >= thr), zebra, word)
        return state + window, pointops.unpack32(out)


def _previous_valid(y, valid, prev):
    """For each slot of a window, the luma of the last VALID frame before
    it (invalid slots, the window adapter's rate padding, are not buffer
    arrivals), else the carried `prev`; and whether one was found.
    Returns (prevs [B, H, W], found [B], last valid slot or -1)."""
    b = y.shape[0]
    pos = torch.arange(b, dtype=torch.int64, device=y.device)
    vpos = torch.where(valid, pos, -1)
    last_v = torch.cat([vpos.new_full((1,), -1),
                        torch.cummax(vpos, dim=0).values[:-1]])
    found = last_v >= 0
    prevs = torch.where(found[:, None, None], y[last_v.clamp(min=0)],
                        prev[None])
    return prevs, found, vpos.max()


@register
class VideoDiff(_LumaFilter):
    """gstvideodiff.c: highlight luma deltas above threshold=10 vs the
    previous frame; first frame passes through (gstvideodiff.c:128-174).
    The reference never increments its stripe phase t, so t=0."""

    NAME = "videodiff"
    # "{ I420, Y444, Y42B, Y41B }" (gstvideodiff.c:51) + GRAY8 extension
    FORMATS = (VideoFormat.I420, VideoFormat.Y444, VideoFormat.Y42B,
               VideoFormat.Y41B, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        h, w = self.in_spec.height, self.in_spec.width
        return {"prev": torch.zeros((h, w), dtype=torch.uint8,
                                    device=self.device),
                "have_prev": torch.zeros((), dtype=torch.bool,
                                         device=self.device)}

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        prevs, found, last = _previous_valid(y, batch.valid, state["prev"])
        have = found | state["have_prev"]
        diff = pointops.videodiff(y, prevs, 10, 0)
        out = torch.where(have[:, None, None], diff, y)
        any_v = batch.valid.any()
        new_state = {
            "prev": torch.where(any_v, y[last.clamp(min=0)], state["prev"]),
            "have_prev": state["have_prev"] | any_v}
        return new_state, batch.with_data(self._set_luma(batch.data, out))


def _scene_decisions(scores, valid, have_prev, diffs, n_diffs, count):
    """gstscenechange.c's decision tree over one window, on the host: the
    5-score ring, the adaptive threshold 1.8*max - 0.8*min of its first
    four, and the score tests, in float64 as the JAX package's scan
    computes them.  Invalid slots change nothing and post nothing.
    Returns (changes [B] bool, counts [B] int32, have_prev, diffs,
    n_diffs, count)."""
    changes = np.zeros(len(scores), bool)
    counts = np.zeros(len(scores), np.int32)
    diffs = np.array(diffs, np.float64)
    for i, (score, ok) in enumerate(zip(scores, valid)):
        change = False
        if ok and have_prev:
            d = np.concatenate([diffs[1:], [score]])
            n = n_diffs + 1
            smin, smax = d[:4].min(), d[:4].max()
            threshold = np.float64(1.8) * smax - np.float64(0.8) * smin
            with np.errstate(divide="ignore", invalid="ignore"):
                if n <= 4 or score < 5 or score / threshold < 1.0:
                    change = False
                elif score > 30 and score / d[3] > 1.4:
                    change = True
                elif score / threshold > 2.3:
                    change = True
                else:
                    change = bool(score > 50)
            diffs, n_diffs = ((np.zeros(5), 0) if change else (d, n))
        have_prev = have_prev or bool(ok)
        count += int(change)
        changes[i] = change
        counts[i] = count - 1
    return changes, counts, have_prev, diffs, n_diffs, count


@register
class SceneChange(_LumaFilter):
    """gstscenechange.c: SAD of consecutive luma frames, 5-score ring,
    adaptive threshold 1.8*max - 0.8*min + decision tree; posts a
    scenechange message where the reference sends force-key-unit events.
    The scores are taken on the device; the decision tree runs on the host
    (one copy of B scores and the small state per window)."""

    NAME = "scenechange"
    # "{ I420, Y42B, Y41B, Y444 }" (gstscenechange.c:107) + GRAY8 extension
    FORMATS = (VideoFormat.I420, VideoFormat.Y42B, VideoFormat.Y41B,
               VideoFormat.Y444, VideoFormat.GRAY8)

    def init_state(self, batch: int):
        h, w = self.in_spec.height, self.in_spec.width
        dev = self.device
        return {"prev": torch.zeros((h, w), dtype=torch.uint8, device=dev),
                "have_prev": torch.zeros((), dtype=torch.bool, device=dev),
                "diffs": torch.zeros((5,), dtype=torch.float64, device=dev),
                "n_diffs": torch.zeros((), dtype=torch.int32, device=dev),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        prevs, _, last = _previous_valid(y, batch.valid, state["prev"])
        scores, valid, have_prev, diffs, n_diffs, count = to_host(
            pointops.sad(y, prevs), batch.valid, state["have_prev"],
            state["diffs"], state["n_diffs"], state["count"])
        changes, counts, have_prev, diffs, n_diffs, count = \
            _scene_decisions(scores, valid, bool(have_prev), diffs,
                             int(n_diffs), int(count))
        dev = y.device
        changes_t, counts_t, have_t, diffs_t, n_t, count_t = to_device(
            dev, changes, counts, (have_prev, np.bool_), (diffs, np.float64),
            (n_diffs, np.int32), (count, np.int32))
        new_state = {"prev": (y[last.clamp(min=0)] if valid.any()
                              else state["prev"]),
                     "have_prev": have_t, "diffs": diffs_t,
                     "n_diffs": n_t, "count": count_t}
        msgs = {"scenechange": {"_emit": changes_t, "count": counts_t}}
        return new_state, batch, msgs


@register
class Smooth(_LumaFilter):
    """gst/smooth/gstsmooth.c: tolerance-gated window mean on luma.

    Faithful to the reference's pointer arithmetic (as the JAX package's
    golden.videofilters.smooth_y): output row r takes its window from rows
    [r-filtersize, r+filtersize+3) and the last row is passed through.
    """

    NAME = "smooth"
    FORMATS = (VideoFormat.I420, VideoFormat.GRAY8)
    PROPERTIES = (
        Property("active", bool, True),
        Property("tolerance", int, 8, static=True),
        Property("filter-size", int, 3, static=True),
        Property("luma-only", bool, True, static=True),
    )

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        data = self._set_luma(batch.data, self._smooth_plane(y, params))
        if not self.props["luma-only"] and isinstance(batch.data, dict):
            for k in ("u", "v"):  # smooth_filter on planes 1 and 2
                data = {**data,
                        k: self._smooth_plane(batch.data[k], params)}
        return state, batch.with_data(data)

    def _smooth_plane(self, y, params):
        fs = self.props["filter-size"]
        tol = self.props["tolerance"]
        h, w = y.shape[-2:]
        dev = y.device
        src = y.to(torch.int32)
        ssum = torch.zeros_like(src)
        num = torch.zeros_like(src)
        rows = torch.arange(h, device=dev)
        cols = torch.arange(w, device=dev)
        for dy in range(-fs, fs + 3):
            jr = rows + dy
            shifted = src[..., jr.clamp(0, h - 1), :]
            for dx in range(-fs, fs + 1):
                jc = cols + dx
                inb = (((jr >= 0) & (jr < h))[:, None]
                       & ((jc >= 0) & (jc < w))[None, :])
                v = shifted[..., jc.clamp(0, w - 1)]
                within = (src - tol - v) * (src + tol - v) < 0
                m = (inb & within).to(torch.int32)
                ssum += v * m
                num += m
        out = ((src + ssum) // (1 + num)).to(torch.uint8)
        out[..., h - 1, :] = y[..., h - 1, :]  # last row untouched
        return torch.where(params["active"], out, y)
