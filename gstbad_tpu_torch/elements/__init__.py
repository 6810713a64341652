"""Element families; importing this package registers every factory."""

from gstbad_tpu_torch.elements import debugutils  # noqa: F401
from gstbad_tpu_torch.elements.audio import (  # noqa: F401
    convert as audio_convert, freeverb, mixmatrix, removesilence)
from gstbad_tpu_torch.elements.geometry import geometrictransform  # noqa: F401
from gstbad_tpu_torch.elements.sources import testsrc  # noqa: F401
from gstbad_tpu_torch.elements.video import (  # noqa: F401
    bayer, coloreffects, convert, fieldanalysis, gaudieffects, interlace,
    ivtc, videofilters)
