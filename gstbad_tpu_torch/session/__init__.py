"""Sessions: the transcoder."""

from gstbad_tpu_torch.session.transcoder import Transcoder  # noqa: F401
