"""Element families; importing this package registers every factory."""

from gstbad_tpu_torch.elements import (  # noqa: F401
    adaptivedemux, bridges, debugutils, files, ioelements, jaxfilter, misc,
    mpegts, observability, onvif, pcap, rtp, sdpdemux, videoparsers)
from gstbad_tpu_torch.elements.analysis import compare  # noqa: F401
from gstbad_tpu_torch.elements.audio import (  # noqa: F401
    adpcm, bpmdetect, bs2b, buffersplit, convert as audio_convert, freeverb,
    meters, mixmatrix, pitch, removesilence, spandsp, visualizers,
    webrtcdsp)
from gstbad_tpu_torch.elements import cv  # noqa: F401
from gstbad_tpu_torch.io import ipcpipeline as _ipc_elements  # noqa: F401
from gstbad_tpu_torch.io import shm as _shm_elements  # noqa: F401
from gstbad_tpu_torch.elements.geometry import geometrictransform  # noqa: F401
from gstbad_tpu_torch.elements.sources import testsrc  # noqa: F401
from gstbad_tpu_torch.elements.video import (  # noqa: F401
    assrender, bayer, closedcaption, codecalpha, coloreffects, convert,
    digitalzoom, faceoverlay, fieldanalysis, gaudieffects, interlace, ivtc,
    lcms, overlay, qroverlay, rsvg, teletext, ttmlrender, videofilters,
    videosignal)
