"""videofilters — zebrastripe (gst/videofilters/).  scenechange, videodiff
and smooth are not ported yet."""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core import tablefuse
from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
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

    def process(self, params, state, batch: FrameBatch):
        y = self._get_luma(batch.data)
        b = y.shape[0]
        thr = pointops._per_frame(_luma_threshold(params["threshold"]), 3)
        t = state + torch.arange(b, dtype=torch.int32, device=y.device)
        out = pointops.zebrastripe(y, thr, t[:, None, None])
        return state + b, batch.with_data(self._set_luma(batch.data, out))

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
        tph = state + torch.arange(b, dtype=torch.int32, device=thr.device)

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
            return state + b, chain.src_batch.with_data(
                pointops.unpack32(out)).replace(word=out)

        thr = pointops._per_frame(thr, 3)
        stripe = pointops.stripe_mask(h, w, tph[:, None, None])
        word = chain.materialize_word()
        y = pointops.byte_of(word, 1)
        zebra = (word & pointops.i32(0xFFFF00FF)) | (16 << 8)
        out = torch.where(stripe & (y >= thr), zebra, word)
        return state + b, pointops.unpack32(out)
