"""Element families; importing this package registers every factory."""

from gstbad_tpu_torch.elements import (  # noqa: F401
    adaptivedemux, asfmux, bridges, debugutils, files, ioelements,
    jaxfilter, jpegformat, kate, misc, mpegts, mxf, observability, onvif,
    pcap, rfbsrc, rtp, sdpdemux, videoparsers)
from gstbad_tpu_torch.elements.analysis import compare  # noqa: F401
from gstbad_tpu_torch.elements.audio import (  # noqa: F401
    adpcm, bpmdetect, bs2b, buffersplit, convert as audio_convert, festival,
    fingerprint, freeverb, gsmcodec, ladspa, lv2, meters, mixmatrix,
    moduledec, opusparse, pitch, removesilence, siren, spandsp, visualizers,
    webrtcdsp)
from gstbad_tpu_torch.elements import cv  # noqa: F401
from gstbad_tpu_torch.io import ipcpipeline as _ipc_elements  # noqa: F401
from gstbad_tpu_torch.io import shm as _shm_elements  # noqa: F401
from gstbad_tpu_torch.elements.geometry import geometrictransform  # noqa: F401
from gstbad_tpu_torch.elements.sources import testsrc  # noqa: F401
from gstbad_tpu_torch.elements.video import (  # noqa: F401
    assrender, av1codec, bayer, closedcaption, codecalpha, coloreffects,
    convert, digitalzoom, faceoverlay, fieldanalysis, frei0r, gaudieffects,
    h265codec, interlace, ivtc, jpeg2000, lcms, onnxdetector, openexr,
    overlay, qroverlay, rsvg, teletext, ttmlrender, videofilters,
    videosignal, vmncdec, webpcodec)
