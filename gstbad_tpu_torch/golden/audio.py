"""bs2b's preset table (gstbad_tpu/golden/audio.py BS2B_PRESETS;
gstbs2b.c:85-98): name -> (fcut Hz, feed dB*10)."""

BS2B_PRESETS = {
    "default": (700, 45),
    "cmoy": (700, 60),
    "jmeier": (650, 95),
}
