"""digitalzoom — center crop + scale back to size
(gst/camerabin2/gstdigitalzoom.c: a GstBin of videocrop ! videoscale !
capsfilter, exposing a `zoom` float).

As in the JAX package (gstbad_tpu/elements/video/digitalzoom.py), the
whole zoom is one separable bilinear resample of the crop window: two
float32 matrix products with interpolation matrices built from the zoom
on the device, so a `zoom` change needs no host work.  The products run in
full float32 (TF32 off, as the JAX package's CPU products are).

A per-frame `zoom` (a control curve) gives each frame its own pair of
matrices, one batched product per axis.  (The JAX package's matrices
broadcast a per-frame zoom against the pixel axis, which raises.)

The crop arithmetic is the reference's exactly
(gstdigitalzoom.c:95-107): w2 = (W - trunc(W/zoom))/2, left forced even.
videoscale itself lives in gst-plugins-base (outside this reference), so
the scaler here is plain bilinear — the videoscale method=bilinear analog.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require
from gstbad_tpu_torch.ops.numerics import full_fp32, true_div


def _interp_matrix(n_in: int, n_out: int, start: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """[*, n_in, n_out] f32 bilinear sampling matrix for the window
    [start, start+length) resampled to n_out pixels (center-aligned);
    start/length are 0-d or per-frame [B] tensors (the leading *)."""
    dev = start.device
    start = start.to(torch.float32)[..., None]
    length = length.to(torch.float32)[..., None]
    x = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
         * true_div(length, n_out) + start - 0.5)
    x = torch.clamp(x, 0.0, n_in - 1.0)
    x0 = torch.floor(x)
    ax = x - x0
    x0i = x0.to(torch.int32)
    x1i = torch.clamp(x0i + 1, max=n_in - 1)
    rows = torch.arange(n_in, dtype=torch.int32, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return (torch.where(rows == x0i[..., None, :], (1.0 - ax)[..., None, :],
                        zero)
            + torch.where(rows == x1i[..., None, :], ax[..., None, :], zero))


def _zoom_plane(img, left, top, cw, ch):
    """img [B,H,W] or [B,H,W,C] f32 -> same shape, window resampled."""
    h, w = img.shape[1], img.shape[2]
    sr = _interp_matrix(h, h, top, ch)     # [(B,) H_in, H_out]
    sc = _interp_matrix(w, w, left, cw)    # [(B,) W_in, W_out]
    per_frame = sr.ndim == 3
    with full_fp32():
        # rows: [B,(C,)H_out,W] = sr^T @ img ; cols: @ sc
        out = torch.einsum("bio,bi...->bo..." if per_frame
                           else "io,bi...->bo...", sr, img)
        if img.ndim == 4:
            return torch.einsum("bhic,bio->bhoc" if per_frame
                                else "bhic,io->bhoc", out, sc)
        return torch.einsum("bhi,bio->bho" if per_frame
                            else "bhi,io->bho", out, sc)


def _crop_box(width, height, zoom):
    """gstdigitalzoom.c:95-107 integer crop; zoom a f32 tensor."""
    zoom = torch.clamp(zoom.to(torch.float32), min=1.0)
    w2 = torch.div(width - (torch.full_like(zoom, width * 1.0) / zoom
                            ).to(torch.int32), 2, rounding_mode="floor")
    h2 = torch.div(height - (torch.full_like(zoom, height * 1.0) / zoom
                             ).to(torch.int32), 2, rounding_mode="floor")
    left = w2 & 0xFFFE  # even left, avoids videoscale slow path
    right = w2
    cw = width - left - right
    ch = height - 2 * h2
    return left, h2, cw, ch


@register
class DigitalZoom(VideoFilter):
    """zoom in [1, inf), default 1 (gstdigitalzoom.c zoom property);
    zooming is centered."""

    NAME = "digitalzoom"
    FORMATS = (VideoFormat.AYUV, VideoFormat.GRAY8, VideoFormat.I420,
               VideoFormat.RGBx, VideoFormat.BGRx, VideoFormat.xRGB,
               VideoFormat.xBGR)
    PROPERTIES = (
        Property("zoom", float, 1.0, 1.0, None, controllable=True),
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", "digitalzoom: needs video")
        require(in_spec.format in self.FORMATS,
                f"digitalzoom: format {in_spec.format} unsupported")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        zoom = params["zoom"]
        spec = self.out_spec

        def do(img, left, top, cw, ch):
            out = _zoom_plane(img.to(torch.float32), left, top, cw, ch)
            return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

        if isinstance(batch.data, dict):  # I420 planes
            w, h = spec.width, spec.height
            left, top, cw, ch = _crop_box(w, h, zoom)

            def half(v):
                return torch.div(v, 2, rounding_mode="floor")

            chroma = (half(left), half(top), half(cw), half(ch))
            out = {"y": do(batch.data["y"], left, top, cw, ch),
                   "u": do(batch.data["u"], *chroma),
                   "v": do(batch.data["v"], *chroma)}
        else:
            h, w = batch.data.shape[1], batch.data.shape[2]
            left, top, cw, ch = _crop_box(w, h, zoom)
            out = do(batch.data, left, top, cw, ch)
        return state, batch.with_data(out)
