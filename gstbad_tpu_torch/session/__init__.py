"""Sessions: Play and Player (the GstPlay/GstPlayer API), Camera (the
camerabin2 analog), the transcoder, testbin:// URIs and the adaptive-
streaming scheduler behind dashdemux, hlsdemux and mssdemux."""

from gstbad_tpu_torch.session.play import (  # noqa: F401
    AudioInfo, MediaInfo, Play, PlayState, StreamInfo, SubtitleInfo,
    VideoInfo)
from gstbad_tpu_torch.session.player import (  # noqa: F401
    DirectDispatcher, Player, QueuedDispatcher, SignalAdapter)
from gstbad_tpu_torch.session.transcoder import Transcoder  # noqa: F401
from gstbad_tpu_torch.session.camera import Camera  # noqa: F401
