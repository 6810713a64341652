"""The opencv element family (ext/opencv): the per-pixel filters, the remap
clients, the detectors, the Haar cascades, stereo, the background models,
the tracker, GrabCut, and the zbar/zxing scanners."""

from gstbad_tpu_torch.elements.cv import filters  # noqa: F401
from gstbad_tpu_torch.elements.cv import warp  # noqa: F401
from gstbad_tpu_torch.elements.cv import detect  # noqa: F401
from gstbad_tpu_torch.elements.cv import (  # noqa: F401
    barcode, disparity, facedetect, grabcutel, handdetect, segmentation,
    tracker)
