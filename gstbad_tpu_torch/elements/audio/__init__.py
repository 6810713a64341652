"""Audio elements: BASELINE config 3's chain (audiomixmatrix,
audiochannelmix, freeverb, audioconvert, removesilence) and audio breadth
(bs2b, pitch, webrtcdsp and webrtcechoprobe, bpmdetect, audiobuffersplit,
videoframe-audiolevel, audiolatency, adpcmdec and adpcmenc, spandsp's
tonegeneratesrc, dtmfdetect and spanplc, and the four scopes), the
chromaprint and ofa fingerprinters, and the host engines (sirenenc and
sirendec, gsmenc and gsmdec, opusparse, festival, gmedec and openmptdec),
and the LADSPA and LV2 hosts, whose elements are registered from the
plugins found on a path."""
