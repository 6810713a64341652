"""Audio elements: BASELINE config 3's chain (audiomixmatrix,
audiochannelmix, freeverb, audioconvert, removesilence) and audio breadth
(bs2b, pitch, webrtcdsp and webrtcechoprobe, bpmdetect, audiobuffersplit,
videoframe-audiolevel, audiolatency, adpcmdec and adpcmenc, spandsp's
tonegeneratesrc, dtmfdetect and spanplc, and the four scopes), and the
chromaprint and ofa fingerprinters."""
