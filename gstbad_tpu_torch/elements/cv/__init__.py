"""The opencv element family (ext/opencv): the per-pixel filters, the remap
clients and the detectors."""

from gstbad_tpu_torch.elements.cv import filters  # noqa: F401
from gstbad_tpu_torch.elements.cv import warp  # noqa: F401
from gstbad_tpu_torch.elements.cv import detect  # noqa: F401
