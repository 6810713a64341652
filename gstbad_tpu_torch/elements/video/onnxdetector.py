"""onnxobjectdetector (ext/onnx/gstonnxobjectdetector.cpp) — run an ONNX
object-detection model on video frames.

The reference hands the model file to onnxruntime and reads four output
nodes (detection/box/score/class indices) into bounding-box metas.  Here
io/onnx.py parses the model FILE itself and lowers it to a module on the
pipeline's device, so inference runs in the window step; detections post as
per-frame `object-detector` messages (boxes/scores/classes arrays plus a
count — our buffers carry no meta list).  Properties mirror the
reference: model-file, label-file, score-threshold,
detection/box/score/class-node-index, input-image-format (hwc|chw).
Frames are resized (bilinear, device) to the model's input plane and fed
as raw 0..255 floats like the reference's byte-to-float copy
(gstonnxclient.cpp:271-350).

A port of the JAX package's elements/video/onnxdetector.py: the resize is
ops/resize.resize_linear (jax.image.resize's bilinear with antialias,
within 4 ulp), and the model runs on the window's frames as one batch
(OnnxModule.frames) where the JAX element maps it over the frames one
at a time; the same function, frame by frame.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.core.element import Property, VideoFilter
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require


@register
class OnnxObjectDetector(VideoFilter):
    NAME = "onnxobjectdetector"
    FORMATS = (VideoFormat.RGB,) + VideoFormat.PACKED_RGB4
    PROPERTIES = (
        Property("model-file", str, "", static=True),
        Property("label-file", str, "", static=True),
        Property("score-threshold", float, 0.3, 0.0, 1.0),
        Property("detection-node-index", int, -1, static=True),
        Property("box-node-index", int, -1, static=True),
        Property("score-node-index", int, -1, static=True),
        Property("class-node-index", int, -1, static=True),
        Property("input-image-format", str, "hwc", static=True,
                 doc="hwc | chw"),
    )

    def prepare(self):
        from gstbad_tpu_torch.io import onnx as onnxio
        require(bool(self.props["model-file"]),
                "onnxobjectdetector: model-file is required")
        self._graph = onnxio.load_model(self.props["model-file"])
        self._fn, self._in_names, self._out_names = \
            onnxio.to_torch(self._graph, self.device)
        require(len(self._in_names) == 1,
                f"onnxobjectdetector: model must have ONE input, has "
                f"{self._in_names}")
        shape = dict(self._graph.inputs)[self._in_names[0]]
        require(shape is not None and len(shape) == 4,
                "onnxobjectdetector: model input must be 4-D")
        chw = self.props["input-image-format"] == "chw"
        self._chw = chw
        self._mh = int(shape[2] if chw else shape[1])
        self._mw = int(shape[3] if chw else shape[2])
        self._labels = []
        if self.props["label-file"]:
            with open(self.props["label-file"]) as f:
                self._labels = [ln.strip() for ln in f if ln.strip()]
        self._rgb = (VideoFormat.rgb_offsets(self.out_spec.format)[:3]
                     if self.out_spec.format != VideoFormat.RGB
                     else (0, 1, 2))

    @property
    def labels(self):
        return self._labels

    def process(self, params, state, batch: FrameBatch):
        from gstbad_tpu_torch.ops.resize import resize_linear
        b = batch.batch
        x = torch.stack([batch.data[..., c] for c in self._rgb], 1)
        x = x.to(torch.float32)  # raw 0..255 floats, like the reference
        if (x.shape[2], x.shape[3]) != (self._mh, self._mw):
            x = resize_linear(x, self._mh, self._mw)
        if not self._chw:
            x = x.permute(0, 2, 3, 1)
        # each frame is the model's batch of one
        outs = [o if batched else o.expand((b,) + tuple(o.shape))
                for o, batched in self._fn.frames(x[:, None])]
        idx = {k: self.props[f"{k}-node-index"]
               for k in ("detection", "box", "score", "class")}
        msgs = {}
        thr = params["score-threshold"]
        if idx["score"] >= 0:
            scores = outs[idx["score"]].reshape(b, -1)
            keep = scores > thr
            fields = {"count": keep.sum(dim=1),
                      "scores": torch.where(keep, scores, 0.0)}
            if idx["box"] >= 0:
                boxes = outs[idx["box"]].reshape(b, scores.shape[1], -1)
                fields["boxes"] = torch.where(keep[..., None], boxes, 0.0)
            if idx["class"] >= 0:
                cls = outs[idx["class"]].reshape(b, -1)
                fields["classes"] = torch.where(keep, cls, -1)
            if idx["detection"] >= 0:
                fields["detections"] = outs[idx["detection"]].reshape(b, -1)
            msgs["object-detector"] = fields
        else:
            # no node mapping: post the first output verbatim
            msgs["object-detector"] = {"output":
                                       outs[0].reshape(b, -1)}
        return state, batch, msgs
