"""compare (gst/debugutils/gstcompare.c) + iqa (ext/iqa/iqa.c).

The reference's compare joins two live pads and iqa aggregates N pads.
Here the reference stream is either the graph's first input (fan-in:
`src ! m.  src2 ! m.  compare name=m`) or attached with `set_reference`;
the scoring math is identical: mem/max/ssim methods, luma-weighted SSIM,
threshold gating, and iqa's multiscale DSSIM (ops/dssim.py).
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.ops import dssim as dssim_ops
from gstbad_tpu_torch.ops import ssim as ssim_ops
from gstbad_tpu_torch.ops.pointops import _apply_matrix, _YCBCR2RGB


def _planes(data, spec):
    """Split a frame batch into component planes [(B, H, W), ...] and
    whether they are YUV."""
    if isinstance(data, dict):
        return [data["y"], data["u"], data["v"]], True
    fmt = spec.format
    if fmt == VideoFormat.GRAY8:
        return [data], True
    if fmt == VideoFormat.AYUV:
        return [data[..., 1], data[..., 2], data[..., 3], data[..., 0]], True
    offs = VideoFormat.rgb_offsets(fmt)
    planes = [data[..., offs[0]], data[..., offs[1]], data[..., offs[2]]]
    if VideoFormat.has_alpha(fmt):
        planes.append(data[..., offs[3]])
    return planes, False


def _weighted_ssim(data, ref, spec):
    """gstcompare.c's SSIM: the component SSIMs, luma-weighted for YUV
    (float64 [B])."""
    planes_a, is_yuv = _planes(data, spec)
    planes_b, _ = _planes(ref, spec)
    weights = ssim_ops.ssim_weights(len(planes_a), is_yuv)
    return sum(w * ssim_ops.ssim_plane(a, b)
               for w, a, b in zip(weights, planes_a, planes_b))


def _frame_dims(x):
    return tuple(range(1, x.ndim))


class _TwoStreamElement(Element):
    """Base for elements comparing a stream against a reference.

    Two ways to feed the reference, matching the reference's 2-pad model:
    - graph fan-in: `videotestsrc ! cmp.  src2. ! cmp.  compare name=cmp ...`
      (first-connected input = reference pad, like iqa's first sink pad)
    - `set_reference(frames)` for harness-style use.
    """

    def __init__(self, **props):
        super().__init__(**props)
        self._reference = None

    def set_reference(self, frames) -> None:
        """Attach the reference stream (the first-sink-pad analog): numpy
        arrays or tensors, a dict of planes for planar formats, moved to
        the element's device."""
        def conv(x):
            return torch.as_tensor(x, device=self.device)

        if isinstance(frames, dict):
            self._reference = {k: conv(v) for k, v in frames.items()}
        else:
            self._reference = conv(frames)

    def negotiate(self, in_spec):
        if isinstance(in_spec, list):
            ref_spec = in_spec[0]
            for spec in in_spec[1:]:
                require(ref_spec.format == spec.format
                        and ref_spec.width == spec.width
                        and ref_spec.height == spec.height,
                        f"{self.NAME}: branch specs differ: "
                        f"{ref_spec} vs {spec}")
            return in_spec[-1]
        return in_spec

    def _split_inputs(self, batch):
        """Returns (reference_data, stream_batch)."""
        if isinstance(batch, list):
            return batch[0].data, batch[-1]
        require(self._reference is not None,
                f"{self.NAME}: set_reference() first or connect two inputs")
        return self._reference, batch


@register
class Compare(_TwoStreamElement):
    """Methods mem/max/ssim (gstcompare.c:57-71); posts per-frame delta
    messages and flags frames under `threshold` (with `upper` semantics:
    upper=true passes when delta >= threshold, gstcompare.c:165-172)."""

    NAME = "compare"
    PROPERTIES = (
        Property("method", str, "mem", static=True),
        Property("threshold", float, 0.0),
        Property("upper", bool, True),
    )

    def process(self, params, state, batch):
        ref, batch = self._split_inputs(batch)
        method = self.props["method"]
        data = batch.data
        pairs = ([(data[k], ref[k]) for k in data] if isinstance(data, dict)
                 else [(data, ref)])
        if method == "mem":
            eq = torch.ones(batch.batch, dtype=torch.bool,
                            device=batch.valid.device)
            for a, b in pairs:
                eq &= (a == b).all(dim=_frame_dims(a)) if a.ndim > 1 \
                    else a == b
            delta = eq.to(torch.float64)
        elif method == "max":
            delta = torch.zeros(batch.batch, dtype=torch.float64,
                                device=batch.valid.device)
            for a, b in pairs:
                d = (a.to(torch.int32) - b.to(torch.int32)).abs()
                delta = torch.maximum(delta, d.amax(dim=_frame_dims(d))
                                      .to(torch.float64))
        elif method == "ssim":
            delta = _weighted_ssim(data, ref, self.out_spec)
        else:
            raise ValueError(f"unknown method {method!r}")
        passed = torch.where(params["upper"], delta >= params["threshold"],
                             delta <= params["threshold"])
        return state, batch, {"delta": {"delta": delta, "passed": passed}}


@register
class Iqa(_TwoStreamElement):
    """iqa (ext/iqa/iqa.c): N-input aggregator — the first input is the
    reference, every other input is scored against it per frame
    (aggregate_frames, iqa.c:336-400); the IQA message carries one dssim
    per pad (iqa.c:48-56,392-399).  Optionally writes the SSIM map into
    the output frame (do_dssim, iqa.c:195-290) and flags frames whose
    dssim exceeds ssim-error-threshold (iqa.c:265-275).

    DSSIM is the multiscale metric (ops/dssim.py); AYUV inputs are matrixed
    to RGB first like the reference's RGBA-only dssim path (iqa.c:248-258).
    The single-scale SSIM oracle is also reported, in the `ssim` field."""

    NAME = "iqa"
    PROPERTIES = (
        Property("do-dssim", bool, True),
        Property("ssim-error-threshold", float, 0.0),
        Property("mode", str, "dssim", static=True),
        Property("output-map", bool, False, static=True),
    )

    def _as_rgb(self, data):
        """u8 RGB view + offsets for the dssim path; AYUV goes through the
        fixed-point YCbCr->RGB matrix, GRAY8/planar luma replicates."""
        fmt = self.out_spec.format
        if VideoFormat.is_rgb(fmt):
            offs = VideoFormat.rgb_offsets(fmt)
            return data, (offs[0], offs[1], offs[2])
        if fmt == VideoFormat.AYUV:
            y, u, v = (data[..., c].to(torch.int64) for c in (1, 2, 3))
            r, g, b = _apply_matrix(_YCBCR2RGB, y, u, v)
            rgb = torch.stack([r.clamp(0, 255), g.clamp(0, 255),
                               b.clamp(0, 255)], dim=-1).to(torch.uint8)
            return rgb, (0, 1, 2)
        plane = data["y"] if isinstance(data, dict) else data
        if plane.ndim == 3:
            return plane[..., None].expand(plane.shape + (3,)), (0, 1, 2)
        return None, None

    def process(self, params, state, batch):
        if isinstance(batch, list):
            ref, streams = batch[0].data, batch[1:]
        else:
            ref, one = self._split_inputs(batch)
            streams = [one]
        thr = params["ssim-error-threshold"]
        # the JAX package reads the property, not its param: no device read
        do_dssim = self.props["do-dssim"]
        fields = {}
        exceeded = None
        ref_rgb, offs = self._as_rgb(ref)
        fmap = None
        for i, sb in enumerate(streams):
            ssim = _weighted_ssim(sb.data, ref, self.out_spec)
            if do_dssim and ref_rgb is not None:
                cmp_rgb, _ = self._as_rgb(sb.data)
                dssim, m = dssim_ops.dssim_rgb(cmp_rgb, ref_rgb, offs)
                if i == 0:
                    fmap = m
            else:
                dssim = (1.0 - ssim) / 2.0
            exc = (thr > 0.0) & (dssim > thr)
            exceeded = exc if exceeded is None else (exceeded | exc)
            if i == 0:  # first compared pad keeps the flat field names
                fields.update({"dssim": dssim, "ssim": ssim})
            fields[f"dssim-pad-{i + 1}"] = dssim
        fields["exceeded"] = exceeded
        out = streams[0]
        if self.props["output-map"] and not isinstance(out.data, dict):
            ch = 1 if self.out_spec.format == VideoFormat.AYUV else 0
            if fmap is not None:
                mp = torch.round(fmap.clamp(0, 1) * 255).clamp(0, 255).to(
                    torch.uint8)
            elif self.out_spec.format == VideoFormat.AYUV:
                mp = ssim_ops.ssim_map(out.data[..., 1], ref[..., 1])
            else:
                mp = None
            if mp is not None:
                data = out.data.clone()
                data[..., ch] = mp
                out = out.with_data(data)
        return state, out, {"IQA": fields}
