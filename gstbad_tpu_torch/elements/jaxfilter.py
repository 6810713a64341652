"""jaxfilter — host an arbitrary tensor function in the pipeline.

The reference's precedent for "a model in the pipeline" is ext/onnx
(onnxobjectdetector running an ONNX session per frame) and the
GstOpencvVideoFilter base; here any function of the window's data slots
into the window step.  The element keeps the JAX package's name,
`jaxfilter`, so that launch strings and the two registries stay the same;
its function takes and returns torch tensors on the pipeline's device.
"""

from __future__ import annotations

from gstbad_tpu_torch.core.element import Element
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register


@register
class TorchFilter(Element):
    """Wrap fn(data) -> data, where data is the window's tensor (or its
    dict of plane tensors) on the pipeline's device (shape/dtype-preserving
    by default), or pass `spec_fn` to transform the negotiated MediaSpec.
    Registered as `jaxfilter`, the JAX package's name, for parity."""

    NAME = "jaxfilter"

    def __init__(self, fn=None, spec_fn=None, **props):
        super().__init__(**props)
        if fn is None:
            raise ValueError("jaxfilter needs fn=<callable on tensors>")
        self._fn = fn
        self._spec_fn = spec_fn

    def negotiate(self, in_spec):
        return self._spec_fn(in_spec) if self._spec_fn else in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch.with_data(self._fn(batch.data))
