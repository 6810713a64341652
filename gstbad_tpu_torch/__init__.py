"""gstbad_tpu_torch — the PyTorch/CUDA port of gstbad_tpu.

A rebuild of GStreamer gst-plugins-bad's media-compute layer in which an
element is a function ``process(params, state, batch) -> (state, batch)``
over batched NHWC uint8 frame tensors on one device, and a pipeline runs a
whole window of frames per step.  The JAX package gstbad_tpu is the
reference this port is tested against; this package imports neither jax
nor gstbad_tpu.

Package layout
  core/      MediaSpec (caps analog), Element protocol, table fusion,
             Pipeline and the gst-launch-style parser, bus messages
  ops/       tensor ops, and the hand-written CUDA kernels (csrc/) with
             their builder (ops/_cuda.py)
  elements/  the ported elements (videotestsrc, coloreffects, chromahold,
             gaudieffects, videoconvert, zebrastripe, the telecine
             elements, bayer, the 16 geometric warps, audiotestsrc and
             config 3's audio chain, fakesink, ...)
  golden/    reference data carried over from the JAX package
  models/    the benchmark pipeline graphs

    import gstbad_tpu_torch as gtt
    p = gtt.parse_launch("videotestsrc ! coloreffects preset=sepia "
                         "! fakesink", device="cuda")
    frames = p.run(n_frames=64, window=16)
"""

__version__ = "0.1.0"

from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, AudioFormat  # noqa: E402
from gstbad_tpu_torch.core.element import Element, Property  # noqa: E402
from gstbad_tpu_torch.core.registry import register, make, element_names  # noqa: E402
from gstbad_tpu_torch.core.pipeline import Pipeline, parse_launch  # noqa: E402

# Importing the element packages registers every element factory.
from gstbad_tpu_torch import elements as _elements  # noqa: E402,F401

__all__ = [
    "MediaSpec", "VideoFormat", "AudioFormat",
    "Element", "Property",
    "register", "make", "element_names",
    "Pipeline", "parse_launch",
]
