"""disparity (ext/opencv/gstdisparity.cpp): two-input stereo
correspondence, the torch form of gstbad_tpu/elements/cv/disparity.py.

Inputs [left, right] RGB; per frame both go to gray, the selected matcher
runs with the reference's hard-coded settings (initialise_sbm,
gstdisparity.cpp:622-653: SBM block 9, 32 disparities, preFilterCap 32,
post-filters off; SGBM minDisp 1, 64 disparities, block 3, P1 200, P2 255,
MODE_HH), and the CV_16S map, min-max normalised to u8, replaces the
RIGHT stream as gray2rgb (gstdisparity.cpp:560-580).  SGBM's path
aggregation is the H3 kernel on the card (ops/stereo.py)."""

from __future__ import annotations

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.ops import cv as cvops
from gstbad_tpu_torch.ops import stereo


@register
class Disparity(Element):
    NAME = "disparity"
    N_INPUTS = 2

    PROPERTIES = (
        Property("method", str, "sgbm", static=True,
                 doc="sbm | sgbm (gstdisparity.cpp:156-157; "
                     "DEFAULT_METHOD = sgbm)"),
    )

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "disparity: needs (left, right) inputs")
        left, right = in_spec
        require(left.kind == "video" and right.kind == "video",
                "disparity: needs video inputs")
        require(left.width == right.width
                and left.height == right.height,
                "disparity: geometry mismatch")
        require(left.format == VideoFormat.RGB
                and right.format == VideoFormat.RGB,
                "disparity: needs RGB inputs (use videoconvert)")
        require(self.props["method"] in ("sbm", "sgbm"),
                f"disparity: unknown method {self.props['method']!r}")
        return right

    def process(self, params, state, batches):
        left, right = batches
        gl = cvops.rgb2gray_u8(left.data)
        gr = cvops.rgb2gray_u8(right.data)
        if self.props["method"] == "sbm":
            disp = stereo.stereo_bm(gl, gr)
        else:
            disp = stereo.stereo_sgm(gl, gr)
        out = cvops.gray2rgb(stereo.normalize_minmax_u8(disp))
        return state, right.with_data(out)
