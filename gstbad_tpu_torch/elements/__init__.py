"""Element families; importing this package registers every factory."""

from gstbad_tpu_torch.elements import debugutils  # noqa: F401
from gstbad_tpu_torch.elements.sources import testsrc  # noqa: F401
from gstbad_tpu_torch.elements.video import (  # noqa: F401
    coloreffects, convert, gaudieffects, videofilters)
