"""Audio elements: BASELINE config 3's chain (audiomixmatrix,
audiochannelmix, freeverb, audioconvert, removesilence)."""
