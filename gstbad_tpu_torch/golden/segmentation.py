"""The segmentation element's model constants (a copy of the constants of
gstbad_tpu/golden/segmentation.py that gstbad_tpu/ops/segmentation.py
imports).

MOG2: OpenCV modules/video/src/bgfg_gaussmix2.cpp defaults, which
createBackgroundSubtractorMOG2() uses.  Codebook: gstsegmentation.cpp:
375-380, fixed in the reference source.  MOG: opencv_contrib
modules/bgsegm defaults."""

MOG2_K = 5
MOG2_TB = 0.9          # backgroundRatio
MOG2_Tb = 4.0 * 4.0    # varThreshold
MOG2_Tg = 3.0 * 3.0    # varThresholdGen
MOG2_VAR_INIT = 15.0
MOG2_VAR_MIN = 4.0
MOG2_VAR_MAX = 5 * 15.0
MOG2_CT = 0.05
MOG2_TAU = 0.5
MOG2_SHADOW = 127

CB_BOUNDS = (10, 5, 5)
CB_MIN_MOD = (20, 20, 20)
CB_MAX_MOD = (20, 20, 20)
CB_LEARN_FRAMES = 30       # gstsegmentation.cpp:380

MOG_K = 5
MOG_BACKGROUND_RATIO = 0.7
MOG_VAR_THRESHOLD = 2.5 * 2.5
MOG_NOISE_SIGMA = 30 * 0.5
MOG_INITIAL_WEIGHT = 0.05
