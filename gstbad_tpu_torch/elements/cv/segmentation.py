"""segmentation (ext/opencv/gstsegmentation.cpp), the torch form of
gstbad_tpu/elements/cv/segmentation.py: per-pixel foreground/background
models over YCrCb, walked frame by frame over the window with the model
arrays as the carried state.  Methods (gstsegmentation.cpp:114-119):
codebook (learning for 30 frames, then every 1/learning-rate frames,
with the 3x3 open/close cleanup), mog and mog2 (ops/segmentation.py).

Output (gstsegmentation.cpp:440-453): test-mode writes the mask into all
four channels; without it the reference's 5-channel cv::merge leaves the
frame untouched, which is reproduced; the non-reference `mask-to-alpha`
writes the mask into alpha."""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat
from gstbad_tpu_torch.golden.segmentation import CB_LEARN_FRAMES
from gstbad_tpu_torch.ops import segmentation as segops


@register
class Segmentation(VideoFilter):
    NAME = "segmentation"
    FORMATS = (VideoFormat.RGBA,)
    PROPERTIES = (
        Property("method", str, "mog2", static=True,
                 doc="codebook | mog | mog2 (default mog2, "
                     "gstsegmentation.cpp:122)"),
        Property("test-mode", bool, False, static=True),
        Property("learning-rate", float, 0.01, 0.0, 1.0,
                 controllable=True),
        Property("mask-to-alpha", bool, False, static=True,
                 doc="non-reference: write the mask into the alpha "
                     "channel instead of reproducing the 5-channel "
                     "merge passthrough quirk"),
    )

    def prepare(self):
        method = self.props["method"]
        if method not in ("codebook", "mog", "mog2"):
            raise ValueError(
                f"segmentation: unknown method {method!r} "
                "(codebook | mog | mog2)")
        # the reference freezes the codebook cadence at caps time
        # (gstsegmentation.cpp:326)
        lr = max(float(self.props["learning-rate"]), 1e-9)
        self._learning_interval = max(int(1.0 / lr), 1)

    def init_state(self, window: int):
        spec = self.out_spec
        h, w = spec.height, spec.width
        new = {"mog2": segops.mog2_new_state, "mog": segops.mog_new_state,
               "codebook": segops.codebook_new_state}[self.props["method"]]
        st = new(h, w, self.device)
        st["framecount"] = torch.zeros((), dtype=torch.int32,
                                       device=self.device)
        return st

    def process(self, params, state, batch: FrameBatch):
        img = batch.data
        b = img.shape[0]
        method = self.props["method"]
        ycc = segops.rgb2ycrcb_u8(img[..., :3])
        lr = torch.as_tensor(params["learning-rate"], dtype=torch.float32,
                             device=img.device)
        alphas = lr.expand(b) if lr.ndim == 0 else lr
        model = {k: v for k, v in state.items() if k != "framecount"}
        fc = state["framecount"]
        masks = []
        if method == "codebook":
            interval = self._learning_interval
            fc0 = int(fc)
            for t in range(b):
                n = fc0 + t + 1                      # gstsegmentation.cpp:361
                learning = n < CB_LEARN_FRAMES
                model = segops.codebook_update(
                    model, ycc[t], learning or n % interval == 0)
                masks.append(torch.zeros(ycc.shape[1:3], dtype=torch.uint8,
                                         device=img.device) if learning
                             else segops.codebook_diff(model, ycc[t]))
            masks = segops.morph_open_close(torch.stack(masks))
        else:
            frame_fn = (segops.mog2_frame if method == "mog2"
                        else segops.mog_frame)
            for t in range(b):
                model, mask = frame_fn(model, ycc[t], alphas[t])
                masks.append(mask)
            masks = torch.stack(masks)
        model["framecount"] = fc + b
        if self.props["test-mode"]:
            out = masks[..., None].expand(*masks.shape, 4).contiguous()
        elif self.props["mask-to-alpha"]:
            out = img.clone()
            out[..., 3] = masks
        else:
            out = img                    # the 5-channel merge quirk
        return model, batch.with_data(out)
