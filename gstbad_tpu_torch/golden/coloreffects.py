"""coloreffects reference data (gst/coloreffects/gstcoloreffects.c).

A copy of gstbad_tpu/golden/coloreffects.py:LUMA_PRESETS.
"""

# presets whose LUT is routed through BT.709 luma (gstcoloreffects.c:509-541)
LUMA_PRESETS = {"heat": True, "sepia": True, "xray": True,
                "xpro": False, "yellowblue": False}
