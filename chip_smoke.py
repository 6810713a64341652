#!/usr/bin/env python3
"""Smoke run of the gstbad_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code and no result
line):

1. Require a CUDA card; print its name and power limit (nvidia-smi).
2. Build the hand-written kernels from gstbad_tpu_torch/csrc (one nvcc per
   source, all at once, into gstbad_tpu_torch/_build/) and print the build
   time and ptxas report.
3. Hold each kernel bit-exactly against its plain PyTorch version on the
   card, at the main paths' shapes and at a ragged shape: K1 and K2 at
   [64, 1080, 1920] (materialized and broadcast source, both erode
   values), K1 also on frames that mix erode values and thresholds, with
   index weights above 255 (its wide index), and at W 1, 2, 3, 5, 127, 129
   and 333 (rows that are not 16-byte aligned); K4 on a [129, 720, 1280]
   frame pool, K5 on 391 pairs of it, K6
   on [128, 720, 1280], and K5/K6 on the hard cases: woven frames whose
   rows alternate 0 and 255 (every cell an outlier, runs as wide as the
   frame, carries at the 1000 clamp) at W 1, 31, 33, 1281, 3840 and 8192
   and H 4, 5, 6 and 64, K5 with repeated and out-of-pool pairs; K3
   (gaussian blur) at [64, 1080, 1920], materialized and as a broadcast
   [1, 1080, 1920] base, at sigma 1.2, -2.0, 3.2, 8.0 (41 taps) and 20.0
   (101 taps, the largest window), and at sigma 1.2, 8.0 and 20.0 on
   frames one below, at and one above its tiles (H 15-17, 31-33, 63-65;
   W 63-65); K7 (warp
   gather) at [64, 1080, 1920] and [16, 2160, 3840] through the fisheye
   and twirl maps, with the AYUV and the zero background, materialized
   and broadcast; K8 (the VAD power recurrence) in both modes, serial and
   bracket, at [64, 4800] on noise, DC, silence and square-wave rows and
   at [3, 300] and [5, 4801] (the serial plain version runs on a CPU
   copy: one Python step per sample).  K4 also on its hard cases: W 1, 3,
   5, 12, 15, 17, 127, 129, 1280 and 1281 (both load paths) by H 4, 6, 8,
   126, 128, 130, 190, 192 and 194 (either side of its band height and of
   a frame's split into two bands) at noise floors -1, 0, 16, 255, 256 and
   46341, with indices outside the pool, 300 frames, and pools whose base
   is not 8-byte aligned; K8's bracket at n 1, 31, 33, 300, 4801 and
   9600 by nb 1, 64 and 300 on all four kinds of rows, and on rows whose
   base is not 16-byte aligned.  freeverb_scan (the per-sample reverb
   walk below 32 kHz, not a TPU kernel) within 2e-6 of its plain version,
   which runs on a CPU copy: at [4 x 2205, 2] and [4 x 2205] at 22.05
   kHz (the full [64 x 2205, 2] window on freeverb_22k's input), at 8 kHz, 16 kHz and 31999 Hz on blocks of 1 sample, of one
   sample fewer than the shortest ring and of 3000 samples, the state
   carried across the calls, mono and stereo.
4. Drive the port's main paths through parse_launch on the card: the 1080p
   headline graph on bars (broadcast source) and on ball (moving source),
   the headline without zebrastripe (the nine-element prefix, which takes
   the whole-word lookup), at 1280x720 GRAY8 24/1 BASELINE config 5
   (interlace 2:3 ! fieldanalysis ! ivtc) and the combdetect graph, the
   1080p AYUV gaussianblur graph (BASELINE config 2b) on bars and on ball,
   the 4K rgb2bayer ! bayer2rgb ! fisheye ! twirl graph (BASELINE config
   4, window 16), the 1080p fisheye graph, and the audio graphs at 4800
   samples per block, window 64: BASELINE config 3 (audiotestsrc !
   audiomixmatrix ! freeverb ! audioconvert ! removesilence, where the
   VAD's power bracket closes: K8's bracket mode once a window, its serial
   mode never) and vad_square (removesilence on a square wave: both modes
   once a window); and this slice's three: the 1080p I420 transcode
   around gaussianblur (transcode_i420_blur: K3 once a window), the 1080p
   iqa DSSIM fan-in (iqa_dssim_1080p, window 16: K3 once a window) and
   freeverb at 22.05 kHz (freeverb_22k, 64 blocks of 2205 samples:
   freeverb_scan once a window; its counted run and its check against the
   CPU port a window of 16 blocks).  Each path's launch counters are zeroed
   just before and read just after; each of its kernels must have
   launched as planned, and its frames must equal the same graph run by
   the port on the CPU: exactly, but config 3's and freeverb_22k's S16
   samples within 1 LSB (with the share that differs printed), config 3's
   freeverb output within 2e-6, since the card's float32 matrix products
   sum in another order, and iqa's dssim fields within 1e-5 (its ssim
   within 1e-12).  Config 5's SSIM gate (models/benchmarks.config5_fidelity)
   must give the same result on the card as on the CPU.  K3 to K8 and
   freeverb_scan are also held against their plain versions on the very
   inputs the main paths gave them (freeverb_22k's F32 output is that
   check).  Then every (source, target) pair of videoconvert's 26
   formats on a random 64x48 window, card against CPU, exact; and the
   noise sources (videotestsrc pattern=noise at 1920x1080 in AYUV, I420
   and GRAY8, audiotestsrc wave=white-noise): windows of two sizes, a
   second run and the CPU port give the same frames and samples.
   Then the runtime surface (runtime_surface), each path with the counts
   set to 0 just before it and read just after: transcode_y4m_1080p (64
   seeded I420 frames at 1920x1080 written with the port's io/y4m.py, run
   through the port's CLI, transcode_main --device cuda --window 64, with
   videoconvert format=AYUV ! gaussianblur sigma=1.2 ! videoconvert
   format=I420: K3 once; the output file equals the CPU port's transcode
   of the first 16 frames byte for byte; frames/s end to end, and the
   device step's, the upload's and the download's shares of it);
   checkpoint_config5 (config 5 at 1280x720, window 64: 2 windows,
   save_checkpoint, a fresh pipeline, load_checkpoint, 2 windows, equal
   to 4 uninterrupted windows with their bus messages; K4 and K5 once a
   window); edit_headline (the 1080p headline on ball, then
   remove("zebrastripe"): the prefix chain, K2 twice; then
   insert_after("videoconvert", zebrastripe): K1 once; each window equal
   to the graph built fresh with the source at the same frame);
   validate_scenarios (the six tests/validate scenarios on the card
   against their committed flow expectations); then profile_elements,
   the marginal ms of each element of the headline and of
   config2_blur_ball (CUDA events).
   Then the opencv family, digitalzoom, lcms and codecalpha (cv_slice),
   each path with the counts set to 0 just before it and read just after,
   and every count must still be 0 (these paths hold no hand-written
   kernel: no TPU kernel lies on them):
   cv_edges_1080p (ball RGB 1920x1080 ! cvsmooth gaussian 5x5 !
   edgedetect), cv_median_1080p (ball GRAY8 ! cvsmooth median 5 !
   cvequalizehist), undistort_1080p (ball RGB ! cameraundistort of a
   wide-angle lens) and dewarp_1080p (ball RGBA ! dewarp to a 1992x448
   panorama), window 16, and lcms_motion_720p (ball BGRx 1280x720 ! lcms
   to a gamma-2.2 wide-gamut profile written into a temporary directory
   ! videoconvert format=RGB ! motioncells), 2 windows of 64: frames and
   bus messages against the CPU port's (exact; lcms_motion_720p's frames
   within 1 LSB on under 1% of the bytes), the counted run's peak device
   memory and frames/s (median of 5).  Then the
   equality sweep: every new element under its properties (cvsmooth's
   four types and an ROI, cvsobel and cvlaplace at apertures 3, 5 and 7
   masked and not, cvdilate/cverode 1 and 3 iterations, edgedetect 3, 5
   and 7, retinex basic and multiscale, templatematch's six methods,
   cameraundistort at alpha 0, 0.5 and 1 with crop on GRAY8, RGB and
   BGRx, dewarp's three modes by both interpolations, skindetect's two
   methods with and without post-processing, digitalzoom at zoom 1, 1.7
   and 4 and a per-frame ramp on BGRx and I420, lcms's four intents and
   preserve-black, motioncells over two windows, alphacombine and
   codecalphademux) on 4-frame 640x360 windows, card against CPU port:
   exact, but bilateral, retinex, lcms and digitalzoom within 1 LSB on
   under 1% of the bytes, and templatematch's result within 1e-5 of the
   score map's largest (its best location equal unless a near tie on the
   CPU port's map, its rectangle's green byte within 1).
   Then audio breadth (audio_slice, phase 4f): the four per-sample
   walks (adpcm_ima_decode, adpcm_ms_decode and adpcm_ima_encode,
   csrc/adpcm_kernels.cu; scope_filter, csrc/scope_kernels.cu; none a
   TPU kernel, each replacing an XLA lax.scan) bit for bit against their
   plain versions at ragged shapes; then nine paths through parse_launch,
   window 64, fed from seeded numpy through appsrc or push_bytes, each
   with the counts set to 0 just before its counted run and read just
   after (each of its walks once a window, every other count 0), against
   the CPU port on the same inputs, with peak device memory and frames/s
   (median of 5): voip_webrtcdsp_48k (a call's near end and far end
   through webrtcechoprobe into webrtcdsp; S16 within 4 LSB, mean under
   0.5), adpcm_dvi_44k_enc and adpcm_dvi_44k_dec (2041-sample stereo
   blocks into 2048-byte DVI blocks and back), adpcm_ms_44k (seeded MS
   blocks), scopes_720p_{wavescope,spacescope} (color-lines at 1280x720:
   scope_filter), scopes_720p_{spectrascope,synaescope}, exact, and
   headphone_bs2b_pitch_44k (within 1e-3: torch.fft on the card and on
   the CPU through the vocoder's unwrapped phase); each walk also on the
   input its path gave it.  Then a 71-case sweep of all 17 new elements,
   card against CPU port, in every format they accept (exact, but
   webrtcdsp within 4 LSB, pitch within 1e-4, audiolatency's ticks within
   1.2e-7, videoframe-audiolevel's float levels within 1e-12, the tones
   within 1 LSB).
   Then the rest of the OpenCV family (cv_detect_slice, phase 4g): H1
   (haar_cascade) and H2 (tilted_integral), csrc/haar_kernels.cu, and H3
   (sgm_aggregate), csrc/stereo_kernels.cu (none a TPU kernel: they
   replace the JAX package's scan over a face cascade's trees, its
   unrolled hand cascades, its row scan of the rotated table and SGM's
   path scans) against their plain versions at ragged shapes (H2 and H3
   bit for bit; H1's passes everywhere and its scores where a window
   passed, since it stops at a window's first failed stage); then ten
   paths through parse_launch at full width, each with the counts set to
   0 just before its counted run and read just after (H1 once a pyramid
   scale, H2 once a hand scale, H3 8 times a window, every other count
   0), with peak device memory and frames/s (median of 5; the host clock
   around run() for the scanners): faceblur_720p and facedetect_720p
   (seeded texture with the face fixture at four moving places, window
   16, the port's alt2 copy), handdetect_640x480 (window 16),
   disparity_720p (sgbm) and disparity_sbm_720p (a texture and its copy
   shifted by a 2-40 pixel ramp, window 4), segmentation_720p (ball RGBA,
   mog2, test-mode, window 64), cvtracker_720p (ball, mosse, window 64),
   grabcut_480p (ball RGBA with a bbox, window 2), zbar_1080p and
   zxing_1080p (GRAY8 frames with a QR symbol, an EAN-13 and a Code 128,
   window 2); each graph also at DETECT_SMALL (176x168; the scanners at
   1080p) on the card against the CPU port (frames, valid and messages
   equal: the CPU port takes a minute a 720p frame of facedetect); then
   each kernel on the input its path gave it, timed there.
   Then overlay and the text renderers (overlay_slice, phase 4h): H4
   (overlay_blend, csrc/overlay_kernels.cu; not a TPU kernel: it
   replaces the overlay elements' whole-window jnp blends) against its
   plain version at ragged shapes in all six modes (C = 1, 3 and 4, odd
   sizes, 1-3 overlapping layers with gaps, strided and shifted planes);
   then, window 64, appsrc-fed seeded frames through parse_launch at full
   width, each path with the counts set to 0 just before its counted run
   of 2 windows and read just after (H4 once a window where the path
   composites, every other count 0): dvbsub_1080p (AYUV, 8 seeded DVB
   display sets of two regions, 4- and 8-bit CLUTs, 0.8 s apart),
   dvdspu_720x480 (6 seeded VobSub packets), cea708_1080p (ceaccoverlay
   face=fixed, the caption rewritten every 16 frames; face=pango too
   where pango loads), assrender_1080p (BGRx, 16 events in 2 styles),
   ttmlrender_1080p (an IMSC document), qroverlay_1080p and
   debugqroverlay_1080p (BGRx; the bank 8 frames deep: the QR encoder
   takes a quarter second a symbol on the host), rsvgoverlay_1080p
   (BGRA, where librsvg loads), faceoverlay_720p (phase 4g's face
   frames, window 16: H1 once a pyramid scale, the blend in plain ops),
   line21_525 (cccombiner ! line21encoder ! line21decoder ! ccextractor
   on 720x525 I420: no kernel) and ccconverter_cdp (CDP at 29.97 to
   cc_data at 59.94 frames/s, its host walk timed by the host clock);
   each with its peak device memory and frames/s (median of 5), and at
   OVERLAY_SMALL on the card against the CPU port (frames, pts, valid and
   messages equal); then dvbsubenc, ttmlparse, teletextdec and rsvgdec,
   the host elements, card against CPU; then H4 on every launch the
   paths made, timed on dvbsub_1080p's and assrender_1080p's windows.
   Which of pango, librsvg and PIL load is printed first; a path whose
   library is missing is reported there and not run.
   Then what the runtime slice deferred and the small elements of begun
   modules (deferred_slice, phase 4i): H5 (netsim_bucket,
   csrc/netsim_kernels.cu; not a TPU kernel: it replaces netsim's
   lax.scan over a window's token bucket and drop-packets counter)
   against its plain walk on 30 windows of 0-200 frames in six property
   sets, the carry threaded through; then, window 64 at full width, each
   path with the counts set to 0 just before its counted run of 2 windows
   and read just after (H5 once a window on netsim_1080p, every other
   count 0), its peak device memory and frames/s (median of 5; the host
   clock where the host does the work), and the card against the CPU
   port (a window of 16 but netsim's): netsim_1080p (ball 1920x1080 BGRx at
   30/1 through a 1.5 Gb/s bucket of 200 Mb with drop-packets 3, drop 0.02,
   duplicate 0.05 and gamma delays of 20-80 ms at 0.2, no reordering:
   exactly with its probabilities at 0; with them H5's inputs, the doubled
   window's frames and flags equal and its valid within H5's keep, over 2
   windows; the card's gamma, normal and uniform delays by a KS test
   against scipy.stats' draws, p above 1e-3), speed_48k (audiotestsrc F32
   stereo in blocks of 4800 ! speed 1.5), timecode_1080p_2997df
   (timecodestamper drop-frame at 30000/1001), videoparse_1080p (64 seeded
   I420 frames as bytes ! videoconvert BGRx ! checksumsink, the host
   clock), autovideoconvert_1080p (ball I420 ! autovideoconvert !
   videoconvert BGRx ! solarize), each exact (frames, pts, valid, messages,
   checksums), and transcode_gdp_1080p (64 seeded I420 1080p frames through
   the CLI with --profile gdp, the host clock end to end: the .gdp's bytes
   equal the CPU port's and the .gdp back to y4m gives the input's bytes);
   then aesenc -> aesdec, id3mux, pnmenc/pnmdec, aiffparse, aifffilesrc !
   aifffilesink, accurip, uvch264mjpgdemux (on a seeded frame, uvc_mjpeg),
   switchbin, watchdog, clockselect and jaxfilter fn=255 - x, card against
   CPU port; then H5 on the launch its main path made, timed there.
   Then the sessions (session_slice, phase 4j), each path with the counts
   set to 0 just before its counted run and read just after, with its
   peak device memory: play_headline_1080p (Play of the headline on ball
   at 1920x1080 BGRx, window 64, with a colour balance at hue 0.6,
   saturation 0.7 and brightness 0.55: K1 once a window, every other
   count 0; frames/s by the host clock from play() to end-of-stream over
   10 windows, median of 3, and its active pipeline's device step by CUDA
   events), play_vis_48k (Play of a 440 Hz sine in blocks of 4800 at
   volume 0.5 with a wavescope, its style set to color-lines on the
   element Play made: scope_filter once a window (the default style,
   dots, takes no filter); blocks/s by the host clock; scope_filter on
   the input of its second window at window 64, recorded on an
   uncounted run, against its plain version, exact, and timed there)
   and camera_1080p (Camera recording ball AYUV 1920x1080
   at zoom 2 with EV +1, ISO 400, daylight and sepia, previews posted: no
   kernel; viewfinder frames/s by CUDA events around 10 steps); each held
   against the CPU port at a window of 16 over 2 windows: the headline
   seek-accurate to frame 320 and then at rate -1 from frame 31 down to 0
   (frames, pts, flags, valid, the native snapshots and every message
   equal, position-updated, seek-done, video-dimensions-changed and
   state-changed among them), the sine at volume 0.5 and then muted
   (zero samples; volume-changed and mute-changed posted), the camera's
   2-window recording, one MODE_IMAGE capture and a 1-window recording
   in tone normal under the cloudy gains (the written bytes and the image-done,
   video-done and preview-image messages equal); then hlsdemux,
   dashdemux and mssdemux on in-memory manifests with an injected clock
   (host only, untimed: switches, byte ranges, seeks and needs-manifest
   as they should be).
   Then the mesh (mesh_slice, phase 4k), on [cuda:i for i in
   range(count)] repeated up to four logical shards, dp 2 x sp 2: the
   1080p headline (bars, window 64), warp_1080p, config 5 at 1280x720, a
   1080p gaussianblur graph on ball and bs2b at 48 kHz, 2 windows each
   through the sharded step with the counts set to 0 just before and read
   just after (K1 and K3 once a shard a window, with their halo rows; K7,
   K4 and K5 once a window by the gather rule; nothing else), each equal
   field for field (frames, pts, flags, valid, messages) to the unsharded
   card step, the nodes the gather rule ran and the halo exchanges
   printed; K1 and K3 held against their plain versions on the shard
   inputs the mesh gave them ([1, 541, 1920] and [32, 544, 1920]); the
   headline's sharded and unsharded frames/s; then 16 of its 1080p
   frames, downloaded from the card, through appsrc ! shmsink, shmsrc !
   fakesink and ipcpipelinesink, ipcpipelinesrc, both ends in this process
   (the reader on a thread), bytes equal, MB/s by the host clock.
   Then the transport plane (transport_slice, phase 4l):
   rtp_headline_1080p, 32 seeded moving 1920x1080 BGRA frames in 2
   windows of 16 sent over localhost UDP as RFC 4175 datagrams (MTU 1400)
   by a feeder thread, paced while rtpsrc pulls each window, through
   rtpsrc ! videoconvert format=BGRx ! the headline's chain ! zebrastripe
   ! videoconvert format=BGRA ! rtpsink into a receiver process, with the
   counts set to 0 just before the run and read just after (K1 once a
   window, nothing else): every frame back in order with its pts within
   one 90 kHz tick, equal byte for byte to the same graph run by the port
   on the CPU (chip_smoke.py --rtp-reference, a process of its own started
   with the phase), K1 against its plain version on the path's own window
   and timed there, frames/s end to end, the device step, the idle share,
   the datagrams and the host clock inside rtpsrc and rtpsink;
   ts_over_rtp, 10 s of seeded 8 Mb/s H.264 1080p25 and an audio PID
   through mpegtsmux, 7 TS packets a datagram into rtpsrc (MP2T), then
   tsparse, tsdemux, h264parse and mpegtsmux again: every access unit and
   pts back, no continuity error, MB/s; and sdpdemux, the ONVIF pair,
   pcapparse, irtspparse, the PS mux and demux and each of the eleven
   parsers once on the host, each against its round-trip or stream-table
   invariant.
   Then the file formats and the last in-repo device engines
   (file_format_slice, phase 4m): vmnc_headline_1080p, a seeded 64-frame
   1920x1080 VMnc recording (screen_updates: a RAW frame, then COPY,
   HEXTILE and cursor updates) through vmncdec ! the headline's chain !
   zebrastripe in 2 windows of 32, with the counts set to 0 just before
   the run and read just after (K1 once a window, nothing else), every
   frame equal to the CPU port's (a --file-format-reference process of
   its own), K1 against its plain version on the path's window and timed
   there, frames/s end to end, the decoder's host clock, the device step
   and the idle share; onnx_detect_1080p, a seeded detector (onnx_model,
   written by its own protobuf writer) in onnxobjectdetector behind 1080p
   ball frames, 2 windows of 16, its messages against the CPU port's
   (scores, boxes and classes within 1e-4, the keep masks equal but where
   a score lies within 1e-4 of the threshold), no kernel launched,
   frames/s by events; fingerprint_native_44k, chromaprint engine=native
   and ofa on 120 s of seeded 44.1 kHz stereo S16 through appsrc, each
   chroma image within 1e-5 of the CPU port's, the strings equal (or at
   most 0.5% of their 2-bit codes apart); and jpegparse/jifmux, kate, MXF,
   ASF and rfbsrc (against a scripted RFB 3.8 server in a process of its
   own over localhost TCP) once each against their round trips.
   Each phase logs its seconds on a line of its own ("phase 4l: ... s").
5. Time: the median of 5 runs of source frames/s per graph (CUDA events
   around 10 steps of a 64-frame window, 16 at 4K, data kept on the card;
   4 steps where a step takes 50 ms or more),
   a torch.profiler breakdown of each graph's step, the fourteen and
   phase 4j's three device graphs (the active pipelines of
   play_headline_1080p and play_vis_48k, and camera_1080p's) and phase
   4m's onnx_detect_1080p (the earlier slices' paths are timed, their traces
   taken in their own PRs) (device busy
   time, device ops per step, idle share),
   traced in a second process that runs nothing else (chip_smoke.py
   --profile, which the run starts and waits for), and each kernel
   beside its plain version, its bound and, where one PyTorch call computes the same
   function, that call, at the main path's shapes (K4 also by its kernel
   alone, beside its wrapper); K3 also on a
   materialized window at sigma 2.0, 3.2, 8.0 and 20.0, where its taps are
   a runtime count (blur_sigma_ms).  A bound is the larger
   of the bytes over the HBM rate and the instructions over their pipe's
   rate on this card (SMs x 128 FP32 or 64 INT32 lanes x the top SM
   clock), or a dependency chain.  K8's line adds its
   dependency chain: samples walked in order times the cycles of one step
   (measured by a probe kernel that runs the step on registers alone) at
   the card's top SM clock; the audio graphs add their realtime factor.
   freeverb_scan's the same way: the window's samples times the cycles of
   one comb step (gst_freeverb_step_cycles), its plain time the host
   clock's around the CPU walk.  The four audio walks the same way, from
   gst_adpcm_step_cycles and gst_scope_step_cycles; H2 and H3 from
   gst_haar_tilted_step_cycles (a row of the wavefront, barrier included)
   and gst_sgm_step_cycles (a step of a scan line), and H1 from the
   (window, node) evaluations its early exit leaves, which the plain
   version counts, each a few FP32 operations.
   K5 and K6 take their chain bound the same way: the H - 4 rows of a
   column in order, each one dependent step of the row recurrence (the
   clamp of the carried cell, the select and the add; gst_comb_row_cycles
   measures it on registers).  They print their ns per row, and K5/K6 are
   also timed on random 720-row frames 2560, 3840 and 8192 wide.
6. Print the kernel table as one JSON line (K1 and K3 once on a
   broadcast base and once on a materialized window, K1 also on
   rtp_headline_1080p's and vmnc_headline_1080p's windows, each with its
   "mode"), then the result
   line {"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import glob
import importlib.metadata
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
W5, H5 = 1280, 720          # config 5 and combdetect
W4, H4 = 3840, 2160         # config 4
WINDOW = 64
WINDOW4 = 16                # config 4's window (bench.py:330 caps 4K at 16)
HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")
AUDIO_BLOCK = 4800          # config 3's samplesperbuffer, 48 kHz
AUDIO_RATE = 48000
FV_BLOCK, FV_RATE = 2205, 22050   # freeverb_22k: 100 ms blocks at 22.05 kHz
WINDOW_IQA = 16             # iqa_dssim_1080p's window
CONVERT_W, CONVERT_H = 64, 48     # the videoconvert format matrix
# one H100 SXM, from NVIDIA's data sheet: HBM bytes/s.  The instruction
# rates come from the card in main(): an SM issues one FP32 instruction
# (FMUL, FADD or FFMA) on each of its 128 FP32 lanes a clock and one INT32
# instruction on each of its 64 INT32 lanes, at the top SM clock
HBM_BPS = 3.35e12
FP32_LANES, INT32_LANES = 128, 64
# the instructions of K3's two divisions (x pass and y pass) per channel
# and pixel, from cuobjdump -sass of the build: each is one FMUL and four
# FFMA (Markstein's quotient from the reciprocal of the border sum)
K3_DIV_INSTR = 10
# K3's sigmas timed on a materialized window: the cells' 1.2 (centre 4,
# the one centre compiled with a constant tap count) and four whose taps
# are a runtime count (centres 5, 9, 20 and 50)
BLUR_SIGMAS = (1.2, 2.0, 3.2, 8.0, 20.0)
# cycles of the spin kernel that holds the stream while cuda_ms queues its
# calls: 2.5 ms at 1980 MHz, longer than 20 calls of a wrapper take the host
SPIN_CYCLES = 5_000_000
# host seconds of idle time before and after the steps a trace records
PROFILE_PAD_S = 0.02
# a step at least this long (host seconds, warm-up included) is timed as
# the median of 3 runs of 4 steps instead of 5 runs of 10
SLOW_STEP_S = 0.05
# the compiled-C audio chain of BASELINE config 3 on the host CPU
# (BASELINE_C.json audio_chain_realtime_x), the denominator of the
# audio graphs' realtime factor
C_AUDIO_REALTIME_X = 346.63


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls
    after `warmup` calls.  A spin kernel holds the stream while the host
    queues the calls, so that a kernel shorter than its wrapper's host
    time (K8's bracket) runs back to back and is timed on the device."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def blur_sigma_ms(blur, sigmas=BLUR_SIGMAS) -> dict:
    """K3's mean time in ms (cuda_ms) on a materialized [64, 1080, 1920]
    window of random words at each sigma, through `blur`, an ops.blur
    module: this checkout's, or another checkout's, to time two versions
    of the kernel in one call (PERF.md section 6 gives the command)."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    src = torch.randint(-2**31, 2**31 - 1, (WINDOW, H, W), generator=gen,
                        device=dev, dtype=torch.int64).to(torch.int32)
    out = {}
    for sigma in sigmas:
        tables = [torch.from_numpy(t).to(dev)
                  for t in blur.make_blur_tables(sigma, H, W)]
        out[sigma] = cuda_ms(lambda: blur.gaussian_blur_words(src, *tables))
    return out


def bound(nbytes: float, ops: float, ops_per_s: float,
          chain_ms: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over HBM_BPS and the
    instructions over their pipe's rate ops_per_s, or their dependency
    chain (chain_ms: the operations that must run one after another, at
    their latency)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(ops / ops_per_s * 1e3, chain_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


def byte_err(a, b) -> int:
    """Largest difference of any byte of two int32 word tensors (the
    packed-pixel kernels' error per channel)."""
    import torch
    return max_abs_err(a.view(torch.uint8), b.view(torch.uint8))


def main_graphs(gtt, benchmarks):
    """The fourteen graphs of phases 4 and 5: ({key: build(device) ->
    Pipeline}, {key: window})."""
    def launch(desc):
        return lambda device: gtt.parse_launch(desc, device=device)

    runs = {"headline_bars": lambda device: benchmarks.ten_element_graph(
                W, H, device=device),
            "headline_ball": launch(launch_line("ball", HEAD
                                                + " ! zebrastripe")),
            "prefix_bars": launch(launch_line("bars", HEAD)),
            "config5_ivtc": lambda device: benchmarks.config5_ivtc(
                W5, H5, device=device),
            "combdetect_720p": lambda device: benchmarks.combdetect_720p(
                W5, H5, device=device),
            "config2_blur_bars": lambda device: benchmarks.config2_blur(
                W, H, device=device),
            "config2_blur_ball": launch(
                f"videotestsrc pattern=ball width={W} height={H} "
                "format=AYUV ! gaussianblur sigma=1.2 ! fakesink"),
            "config4_warp": lambda device: benchmarks.config4_warp(
                W4, H4, device=device),
            "warp_1080p": lambda device: benchmarks.warp_1080p(
                W, H, device=device),
            "config3_audio": lambda device: benchmarks.config3_audio(
                AUDIO_BLOCK, device=device),
            "vad_square": lambda device: benchmarks.vad_square(
                AUDIO_BLOCK, device=device),
            "transcode_i420_blur": lambda device:
                benchmarks.transcode_i420_blur(W, H, device=device),
            "iqa_dssim_1080p": lambda device: benchmarks.iqa_dssim_1080p(
                W, H, device=device),
            "freeverb_22k": lambda device: benchmarks.freeverb_22k(
                FV_BLOCK, device=device)}
    windows = {key: WINDOW4 if key == "config4_warp" else WINDOW
               for key in runs}
    windows["iqa_dssim_1080p"] = WINDOW_IQA
    return runs, windows


def kernel_counters() -> dict:
    """{kernel: its wrapper}: each wrapper's `launches` counts its
    kernel's launches."""
    from gstbad_tpu_torch.ops import (audio, blur, chainfuse, comb,
                                      fieldanalysis, haar, lut, netsim,
                                      overlay, remap, stereo)
    return {"dilate_zebra_fused": chainfuse.dilate_zebra_fused,
            "apply_word_table": lut.apply_word_table,
            "metrics_default": fieldanalysis.metrics_default,
            "comb_score_pairs": comb.comb_score_pairs,
            "comb_mask": comb.comb_mask,
            "gaussian_blur_words": blur.gaussian_blur_words,
            "warp_words": remap.warp_words,
            "vad_powers_serial": audio.vad_powers_serial,
            "vad_powers_bracket": audio.vad_powers_bracket,
            "freeverb_scan": audio.freeverb_scan,
            "adpcm_ima_decode": audio.adpcm_ima_decode,
            "adpcm_ms_decode": audio.adpcm_ms_decode,
            "adpcm_ima_encode": audio.adpcm_ima_encode,
            "scope_filter": audio.scope_filter,
            "haar_cascade": haar.haar_cascade,
            "tilted_integral": haar.tilted_integral,
            "sgm_aggregate": stereo.sgm_aggregate,
            "overlay_blend": overlay.overlay_blend,
            "netsim_bucket": netsim.netsim_bucket}


def profile_step(p, step_ms: float, key: str, window: int,
                 batch=None) -> None:
    """Device time per step of pipeline `p` from a torch.profiler trace of
    3 steps (20 of a step under 1 ms: a trace of three one-kernel steps
    kept one record; 1 of a step of 50 ms or more, whose tens of
    thousands of device ops take the trace most of a minute): busy ms, device ops launched, the idle share against
    the untraced step time `step_ms`, and the kernels that take the most
    time.  batch: the input window of a graph fed by host sources (the same
    one every step), else None.  The hand-written kernels' records (csrc/
    holds them in anonymous namespaces) are checked against their
    launch counters: a trace that lost some is reported, and the busy
    time counts each lost launch at the mean of the kept ones."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    counters = kernel_counters()

    steps = 20 if step_ms < 1.0 else (3 if step_ms < 50.0 else 1)
    step = p.compile(window)
    params, states = p.params(), p.init_states(window)
    for _ in range(2 if step_ms < 50.0 else 1):   # warm-up steps
        states, _, _ = step(params, states, batch)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    # idle time at both ends of the capture window: without it a trace
    # now and then lacks the device records of its first kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(steps):
            states, _, _ = step(params, states, batch)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev_events:
        log(f"profile {key}: device time not measured (the profiler saw no "
            "device events)")
        return
    by_name = {}
    for e in dev_events:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1000.0
    busy = sum(t for _, t in by_name.values()) / steps
    n = len(dev_events) / steps
    launched = sum(c.launches for c in counters.values())
    ours = [t for name, t in by_name.items()
            if name.split("(anonymous namespace)::")[0] in ("", "void ")]
    kept = sum(c for c, _ in ours)
    lost = ""
    if kept < launched:
        if not kept:
            log(f"profile {key}: device time not measured (the trace kept "
                f"none of {launched} hand-written kernel launches)")
            return
        busy += (launched - kept) * sum(t for _, t in ours) / kept / steps
        n += (launched - kept) / steps
        lost = (f" (the trace kept {kept} of {launched} hand-written kernel "
                "launches; the lost ones counted at the kept ones' mean)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"profile {key}: device busy {busy:.3f} ms/step of {step_ms:.3f} ms "
        f"untraced (idle share {1 - busy / step_ms:.3f}), {n:.2f} device "
        f"ops/step over {steps} steps{lost}; top: " + "; ".join(
            f"{name[:48]} x{c // steps} {t / steps:.3f} ms"
            for name, (c, t) in top))


def profile_graphs(step_ms: dict) -> None:
    """Phase 5's traces, taken by profile_step in a process of their own
    (`chip_smoke.py --profile`, profile_main) that runs nothing else:
    torch.profiler lost device records when it traced these graphs after
    every earlier phase had run in the same process.  step_ms: {key:
    (untraced step ms, window)}."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--profile", json.dumps(step_ms)], cwd=ROOT,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"the profile process exited with {proc.returncode}")
    log(f"profiles: {len(step_ms)} graphs in a process of their own, "
        f"{time.perf_counter() - t0:.1f} s")


def profile_main(spec: str) -> int:
    """`chip_smoke.py --profile SPEC`, SPEC a JSON {key: [untraced step
    ms, window]}: profile_step of each graph named there, one of the
    fourteen, one of phase 4j's or onnx_detect_1080p (phase 4m; source
    graphs: no host feed)."""
    sys.path.insert(0, ROOT)
    import gstbad_tpu_torch as gtt
    from gstbad_tpu_torch.models import benchmarks

    import tempfile
    builds = dict(main_graphs(gtt, benchmarks)[0])
    builds.update(session_graphs())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        model = os.path.join(tmp, "model.onnx")
        with open(model, "wb") as f:
            f.write(onnx_model())
        builds["onnx_detect_1080p"] = lambda d: gtt.parse_launch(
            ONNX_DETECT.format(w=W, h=H, model=model), device=d)
        for key, (ms, window) in json.loads(spec).items():
            profile_step(builds[key]("cuda"), ms, key, window)
    return 0


def fps_runs(build, window, reps: int = 5, n_steps: int = 10, feed=None,
             clock: str = "device"):
    """Source frames/s of the pipeline build("cuda"): the median of `reps`
    runs of CUDA events around n_steps steps of a `window`-frame window
    (its data kept on the card), and every run's figure.  feed, for a
    graph with host sources, pushes its inputs (fed_input): every step
    then takes the same input window.  clock="host" times instead each
    run's run() of n_steps windows by the host clock, on a pipeline built
    and fed (feed(p, n_steps)) before the clock starts: for graphs whose
    elements work on the host after each window, outside the step.  A
    device-clock run whose warm-up steps took SLOW_STEP_S or more each
    takes the median of 3 runs of 4 steps."""
    import torch
    if clock == "host":
        out = []
        for _ in range(reps):
            p = build("cuda")
            p.negotiate()
            feed(p, n_steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.run(n_frames=n_steps * window, window=window)
            torch.cuda.synchronize()
            out.append(n_steps * window / (time.perf_counter() - t0))
        return statistics.median(out), out
    p = build("cuda")
    batch = fed_input(p, feed, window)
    step = p.compile(window)
    params, states = p.params(), p.init_states(window)
    holder = {"states": states}

    def one():
        holder["states"], leaves, _ = step(params, holder["states"], batch)
        holder["out"] = leaves[0]

    t0 = time.perf_counter()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    if (time.perf_counter() - t0) / 2 >= SLOW_STEP_S:
        n_steps, reps = min(n_steps, 4), min(reps, 3)
    out = []
    for _ in range(reps):
        ms = cuda_ms(one, iters=n_steps, warmup=0)
        out.append(window * 1000.0 / ms)
    return statistics.median(out), out


def launch_line(pattern: str, tail: str) -> str:
    return (f"videotestsrc pattern={pattern} width={W} height={H} "
            f"format=BGRx ! {tail} ! fakesink")


def iqa_close(key, got_msgs, cpu_msgs) -> float:
    """iqa's messages of a card run against the CPU port's: same elements,
    names, pts, fields and exceeded; dssim fields within 1e-5 (float32
    reductions in another order), ssim within 1e-12.  Returns the largest
    dssim difference."""
    if len(got_msgs) != len(cpu_msgs) or not got_msgs:
        fail(f"{key}: {len(got_msgs)} messages on the card, "
             f"{len(cpu_msgs)} on CPU")
    worst = 0.0
    for (ge, gn, gp, gf), (ce, cn, cp, cf) in zip(got_msgs, cpu_msgs):
        if (ge, gn, gp) != (ce, cn, cp) or sorted(gf) != sorted(cf):
            fail(f"{key}: message {(ge, gn, gp)} != {(ce, cn, cp)}")
        if gf["exceeded"] != cf["exceeded"] or not abs(
                gf["ssim"] - cf["ssim"]) <= 1e-12:
            fail(f"{key}: ssim {gf['ssim']} / {cf['ssim']}, exceeded "
                 f"{gf['exceeded']} / {cf['exceeded']}")
        for k in gf:
            if k.startswith("dssim"):
                worst = max(worst, abs(gf[k] - cf[k]))
    if not worst <= 1e-5:
        fail(f"{key}: dssim {worst:.3e} from the CPU port's (1e-5 allowed)")
    return worst


def bus_messages(p) -> list:
    return [(m.element, m.name, m.pts, m.fields) for m in p.bus.messages]


def tap_data(p, name: str, n_windows: int, window: int):
    """The output of element `name` over n_windows windows of pipeline p
    (a debug tap on the compiled step), on the host."""
    import torch
    step = p.compile(window, taps=(name,))
    params, states = p.params(), p.init_states(window)
    out = []
    for _ in range(n_windows):
        states, leaves, _ = step(params, states, None)
        out.append(p.taps_of(leaves)[name].data.cpu())
    return torch.cat(out)


def capture(module, name: str, store: dict):
    """Wrap module.<name> to record the arguments of each call (the inputs
    the main path gives a kernel) in store[name], a list.  Returns a
    function that puts the original back."""
    orig = getattr(module, name)

    def spy(*args, **kw):
        store.setdefault(name, []).append((args, kw))
        return orig(*args, **kw)

    # the wrapper counts its launches on the module's attribute, the spy
    # while it is installed: those launches are not the counted run's
    spy.launches = 0
    setattr(module, name, spy)
    return lambda: setattr(module, name, orig)


def runtime_surface(gtt, benchmarks, runs, counters, launches, card):
    """Phase 4d: the port's runtime surface on the card, each path with
    the launch counts set to 0 just before it and read just after (its
    counts join `launches`): a 1080p y4m file through the CLI against the
    CPU port, a checkpoint of config 5 against an uninterrupted run, live
    edits of the headline against fresh graphs, the committed validate
    scenarios; then a per-element profile of two graphs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gstbad_tpu_torch.cli import transcode_main
    from gstbad_tpu_torch.core.frame import map_tensors, upload_frames
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.io import y4m
    from gstbad_tpu_torch.utils.trace import PipelineTracer
    from gstbad_tpu_torch.utils.validate import run_validatetest

    def counted(key, fn, need):
        """fn() with every count at 0 just before and read just after;
        each kernel in `need` must have launched that many times."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        delta = {k: c.launches for k, c in counters.items()}
        log(f"{key}: launches {delta}")
        for k, n in need.items():
            if delta[k] != n:
                fail(f"{key}: {k} launched {delta[k]} times, {n} expected")
        for k in launches:
            launches[k] += delta[k]
        return out

    t_phase = time.perf_counter()
    blur_chain = ("videoconvert format=AYUV ! gaussianblur sigma=1.2 "
                  "! videoconvert format=I420")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # transcode_y4m_1080p: 64 frames of seeded noise (one window), the
        # card's output file against the CPU port's over the first 16
        rng = np.random.default_rng(9)
        planes = {"y": rng.integers(0, 256, (WINDOW, H, W), dtype=np.uint8),
                  "u": rng.integers(0, 256, (WINDOW, H // 2, W // 2),
                                    dtype=np.uint8),
                  "v": rng.integers(0, 256, (WINDOW, H // 2, W // 2),
                                    dtype=np.uint8)}
        i420 = MediaSpec(kind="video", format="I420", width=W, height=H)
        paths = {k: os.path.join(tmp, f"{k}.y4m")
                 for k in ("in", "in16", "card", "cpu16")}
        y4m.write_y4m(paths["in"], i420, planes)
        y4m.write_y4m(paths["in16"], i420,
                      {k: v[:16] for k, v in planes.items()})
        t0 = time.perf_counter()
        counted("transcode_y4m_1080p", lambda: transcode_main(
            [paths["in"], paths["card"], "--filters", blur_chain,
             "--device", "cuda", "--window", str(WINDOW)]),
            {"gaussian_blur_words": 1})
        e2e_s = time.perf_counter() - t0
        transcode_main([paths["in16"], paths["cpu16"], "--filters",
                        blur_chain, "--device", "cpu", "--window", "16"])
        with open(paths["card"], "rb") as f:
            card_bytes = f.read()
        with open(paths["cpu16"], "rb") as f:
            cpu_bytes = f.read()
        frame_bytes = 6 + W * H * 3 // 2       # "FRAME\n" and the planes
        header = len(cpu_bytes) - 16 * frame_bytes
        if (len(card_bytes) != header + WINDOW * frame_bytes
                or card_bytes[:len(cpu_bytes)] != cpu_bytes):
            fail("transcode_y4m_1080p: the card's y4m file differs from the "
                 "CPU port's over the first 16 frames")
        # the same work in parts: the file's read and parse, the window's
        # upload (its stack into one host buffer, then the copy), the step
        # on it (CUDA events), the download of its output and the write
        t0 = time.perf_counter()
        y4m.read_y4m(paths["in"])
        read_ms = (time.perf_counter() - t0) * 1e3
        p = gtt.parse_launch(f"appsrc name=tsrc format=I420 width={W} "
                             f"height={H} ! {blur_chain} ! appsink",
                             device="cuda")
        p.negotiate()
        src = p.get_by_name("tsrc")
        src.push_frames(planes)
        t0 = time.perf_counter()
        upload_frames("cpu", [{k: v[i] for k, v in planes.items()}
                              for i in range(WINDOW)],
                      np.zeros(WINDOW, np.int64), np.zeros(WINDOW, np.int32),
                      np.ones(WINDOW, bool))
        stack_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        win = p.pull_inputs(WINDOW)
        torch.cuda.synchronize()
        up_ms = (time.perf_counter() - t0) * 1e3
        step = p.compile(WINDOW)
        params, states = p.params(), p.init_states(WINDOW)
        holder = {}

        def one_step():
            holder["out"] = step(params, states, win)[1][0]

        step_ms = cuda_ms(one_step, iters=5, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = holder["out"].to_numpy()
        down_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        y4m.write_y4m(os.path.join(tmp, "write.y4m"), i420, out.data)
        write_ms = (time.perf_counter() - t0) * 1e3
        e2e_ms = e2e_s * 1e3
        parts = {"file read": read_ms, "upload": up_ms,
                 "device step": step_ms, "download": down_ms,
                 "write": write_ms}
        log(f"transcode_y4m_1080p: {WINDOW} I420 frames {W}x{H} through "
            f"the CLI in {e2e_ms:.1f} ms = {WINDOW / e2e_s:.1f} frames/s "
            "end to end; its parts, each alone, in ms and as shares of it: "
            + ", ".join(f"{k} {v:.3f} ({v / e2e_ms:.4f})"
                        for k, v in parts.items())
            + f" (the upload's host stack {stack_ms:.3f}), the rest "
            f"{e2e_ms - sum(parts.values()):.3f}; the first 16 frames "
            f"equal the CPU port's byte for byte ({card})")

        # checkpoint_config5: 2 windows, a checkpoint, a fresh pipeline,
        # 2 more windows, against 4 windows uninterrupted
        def config5():
            return benchmarks.config5_ivtc(W5, H5, device="cuda")

        telecine = {"metrics_default": 4, "comb_score_pairs": 4}
        whole = config5()
        ref = counted("checkpoint_config5 uninterrupted", lambda: whole.run(
            n_frames=4 * WINDOW, window=WINDOW), telecine)
        ck = os.path.join(tmp, "config5.ckpt")
        first, second = config5(), config5()

        def resumed():
            out = first.run(n_frames=2 * WINDOW, window=WINDOW)
            first.save_checkpoint(ck)
            second.load_checkpoint(ck)
            return out + second.run(n_frames=2 * WINDOW, window=WINDOW)

        got = counted("checkpoint_config5", resumed, telecine)
        batches_close("checkpoint_config5", got, ref, shape=(H5, W5),
                      dtype="uint8", against="the uninterrupted run")
        if bus_messages(first) + bus_messages(second) != bus_messages(whole):
            fail("checkpoint_config5: bus messages differ from the "
                 "uninterrupted run's")
        log(f"checkpoint_config5: {len(ref)} windows, "
            f"{sum(len(b.pts) for b in ref)} frames and "
            f"{len(whole.bus.messages)} bus messages equal the "
            f"uninterrupted run ({os.path.getsize(ck)} checkpoint bytes)")

        # edit_headline: the 1080p headline on ball, then without
        # zebrastripe (the prefix chain: K2), then with a new zebrastripe
        # after videoconvert; each window against the same graph built
        # fresh with the source at the same frame
        full = launch_line("ball", HEAD + " ! zebrastripe")
        prefix = launch_line("ball", HEAD)

        def fresh_at(desc, pos):
            p = gtt.parse_launch(desc, device="cuda")
            p.compile(WINDOW)
            st = p.init_states(WINDOW)
            st[0] = st[0] + pos        # videotestsrc's frame counter
            p.load_states(map_tensors(lambda t: t.cpu().numpy(), st))
            return p.run(n_frames=WINDOW, window=WINDOW)

        p = gtt.parse_launch(full, device="cuda")
        k1, k2 = {"dilate_zebra_fused": 1, "apply_word_table": 0}, \
            {"dilate_zebra_fused": 0, "apply_word_table": 2}
        edits = [("edit_headline full", None, full, k1),
                 ("edit_headline remove", lambda: p.remove("zebrastripe"),
                  prefix, k2),
                 ("edit_headline insert_after", lambda: p.insert_after(
                     "videoconvert", gtt.make("zebrastripe")), full, k1)]
        for i, (key, edit, desc, need) in enumerate(edits):
            if edit:
                edit()
            got = counted(key, lambda: p.run(n_frames=WINDOW, window=WINDOW),
                          need)
            batches_close(key, got, fresh_at(desc, i * WINDOW),
                          shape=(H, W, 4), dtype="uint8",
                          against="a fresh graph")
        log(f"edit_headline: 3 windows of {WINDOW} frames equal fresh "
            "graphs at the same source frame")

        # validate_scenarios: the committed scenarios on the card
        scenarios = sorted(glob.glob(os.path.join(
            ROOT, "tests", "validate", "*.validatetest")))
        if len(scenarios) != 6:
            fail(f"validate_scenarios: {len(scenarios)} scenarios, 6 "
                 "expected")
        for path in scenarios:
            name = os.path.basename(path)
            report = counted(f"validate_scenarios {name}",
                             lambda: run_validatetest(path, device="cuda"),
                             {})
            if not report.ok or report.recorded:
                fail(f"validate_scenarios {name}: " + "; ".join(
                    report.details))
        log(f"validate_scenarios: all {len(scenarios)} match their "
            "committed flow expectations on the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # profile_elements: the marginal device ms of each element (CUDA
    # events around 3 steps of each topological prefix)
    for key in ("headline_bars", "config2_blur_ball"):
        rep = PipelineTracer(runs[key]("cuda")).profile_elements(
            window=WINDOW, reps=3)
        log(f"profile_elements {key} window {WINDOW}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in rep.items())
            + f" ms ({card})")
    log(f"runtime_surface: {time.perf_counter() - t_phase:.1f} s")


WINDOW_CV = 16                  # the 1080p cv paths' window
WINDOW_LM, WINDOWS_LM = 64, 2   # lcms_motion_720p: 2 windows of 64
SWEEP_FRAMES = 4                # the equality sweep: 4-frame windows
SW, SH = 640, 360               # at 640x360


def batches_close(key, got, cpu, lsb: int = 0, share: float = 0.01,
                  skip=None, shape=None, dtype=None,
                  against: str = "the CPU port"):
    """Host batches of a card run against another run's (the CPU port's):
    same windows, pts, flags and valid; data (an array or {plane: array})
    of the same shapes and dtype, within `lsb`, with under `share` of its
    values differing where lsb > 0.  shape, where given, is each frame's
    shape after the frame axis (a tuple, or {plane: tuple} for planar
    frames) and dtype the data's (a numpy dtype name), both checked on
    both runs.  skip(window, frame) -> True leaves a frame's data out.
    Returns (largest difference, values differing, values)."""
    import numpy as np
    if len(got) != len(cpu):
        fail(f"{key}: {len(got)} windows on the card, {len(cpu)} in "
             f"{against}")
    worst = n_diff = total = 0
    for wi, (a, c) in enumerate(zip(got, cpu)):
        for f in ("pts", "flags", "valid"):
            if getattr(a, f).shape != getattr(c, f).shape or not (
                    getattr(a, f) == getattr(c, f)).all():
                fail(f"{key}: {f} differs from {against}")
        ad = a.data if isinstance(a.data, dict) else {"": a.data}
        cd = c.data if isinstance(c.data, dict) else {"": c.data}
        if sorted(ad) != sorted(cd):
            fail(f"{key}: planes {sorted(ad)} on the card, {sorted(cd)}")
        want = (shape if isinstance(shape, dict) else {"": shape}) \
            if shape is not None else None
        if want is not None and sorted(want) != sorted(ad):
            fail(f"{key}: planes {sorted(ad)}, {sorted(want)} expected")
        for k in ad:
            x, y = ad[k], cd[k]
            if x.shape != y.shape or x.dtype != y.dtype:
                fail(f"{key}: {k} {x.shape} {x.dtype} on the card, "
                     f"{y.shape} {y.dtype} in {against}")
            if (want is not None and x.shape[1:] != tuple(want[k])) or (
                    dtype is not None and x.dtype.name != dtype):
                fail(f"{key}: {k} frames {x.shape} {x.dtype}, "
                     f"{want[k] if want else ''} {dtype or ''} expected")
            d = np.abs(x.astype(np.float64) - y.astype(np.float64)) \
                if x.dtype.kind == "f" else np.abs(
                    x.astype(np.int64) - y.astype(np.int64))
            if skip is not None:
                for fi in range(d.shape[0]):
                    if skip(wi, fi):
                        d[fi] = 0
            worst = max(worst, d.max(initial=0))
            n_diff += int((d > 0).sum())
            total += d.size
    if worst > lsb or (lsb and n_diff > share * total):
        fail(f"{key}: {n_diff} of {total} values differ from {against}, "
             f"by up to {worst} ({lsb} on under {share} allowed)")
    return worst, n_diff, total


def messages_close(key, got, cpu, rtol: float = 0.0) -> None:
    """Bus messages of a card run against the CPU port's: the same
    elements, names, pts and fields; values equal, floats within rtol
    (arrays compared element by element)."""
    import numpy as np
    if len(got) != len(cpu):
        fail(f"{key}: {len(got)} bus messages on the card, {len(cpu)} on "
             "CPU")
    for (ge, gn, gp, gf), (ce, cn, cp, cf) in zip(got, cpu):
        if (ge, gn, gp) != (ce, cn, cp) or sorted(gf) != sorted(cf):
            fail(f"{key}: message {(ge, gn, gp)} != {(ce, cn, cp)}")
        for k in gf:
            x, y = np.asarray(gf[k]), np.asarray(cf[k])
            ok = x.shape == y.shape and (
                np.allclose(x, y, rtol=rtol, atol=0) if x.dtype.kind == "f"
                else (x == y).all())
            if not ok:
                fail(f"{key}: field {k} of {(ge, gn, gp)}: {gf[k]} on the "
                     f"card, {cf[k]} on CPU")


def cv_graphs(benchmarks, wide: str):
    """The five graphs of phase 4e, lcms_motion_720p's to the profile at
    path `wide`: {key: (build(device) -> Pipeline, window, windows of the
    counted run, frame shape, LSB allowed against the CPU port)}."""
    import numpy as np
    # dewarp's panorama: ROUND_UP_8 of the donut's mean circumference
    # and of its depth (1992 x 448 at 1920 wide)
    r1, r2 = W * 0.05, W * 0.28
    pano_w = (int(2.0 * np.pi * ((r2 + r1) / 2.0)) + 7) & ~7
    pano_h = (int(r2 - r1) + 7) & ~7
    return {
        "cv_edges_1080p": (lambda d: benchmarks.cv_edges_1080p(
            W, H, device=d), WINDOW_CV, 1, (H, W, 3), 0),
        "cv_median_1080p": (lambda d: benchmarks.cv_median_1080p(
            W, H, device=d), WINDOW_CV, 1, (H, W), 0),
        "undistort_1080p": (lambda d: benchmarks.undistort_1080p(
            W, H, device=d), WINDOW_CV, 1, (H, W, 3), 0),
        "dewarp_1080p": (lambda d: benchmarks.dewarp_1080p(
            W, H, device=d), WINDOW_CV, 1, (pano_h, pano_w, 4), 0),
        "lcms_motion_720p": (lambda d: benchmarks.lcms_motion_720p(
            wide, W5, H5, device=d), WINDOW_LM, WINDOWS_LM, (H5, W5, 3),
            1),
    }


def cv_slice(gtt, benchmarks, counters, card) -> dict:
    """Phase 4e: the opencv family, digitalzoom, lcms and codecalpha.

    Five paths through parse_launch on the card, each with the launch
    counts set to 0 just before its run and read just after: these paths
    hold no hand-written kernel, so every count must stay 0.  Their
    frames and bus messages against the same graph on the CPU port, the
    run's peak device memory and frames/s (median of 5); returns {key:
    (untraced step ms, window)}.
    Then the equality sweep: every new element under its properties on
    4-frame 640x360 windows, card against CPU port (exact, but retinex,
    bilateral, lcms and digitalzoom within 1 LSB on under 1% of the bytes
    and templatematch's scores within 1e-5 of the map's largest)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.ops import cv as cvops

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cv_")
    try:
        wide = os.path.join(tmp, "wide.icc")
        with open(wide, "wb") as f:
            f.write(benchmarks.wide_gamma22_icc())
        paths = cv_graphs(benchmarks, wide)
        step_ms = {}
        for key, (build, window, n_windows, shape, lsb) in paths.items():
            t0 = time.perf_counter()
            pipe = build("cuda")
            pipe.negotiate()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.launches = 0
            got = pipe.run(n_frames=n_windows * window, window=window)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            delta = {k: c.launches for k, c in counters.items()
                     if c.launches}
            if delta:
                fail(f"{key}: launched hand-written kernels {delta}; this "
                     "path holds none")
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu_pipe = build("cpu")
            cpu = cpu_pipe.run(n_frames=n_windows * window, window=window)
            t_cpu = time.perf_counter() - t0
            if got[0].data.shape[1:] != shape:
                fail(f"{key}: frames {got[0].data.shape}, {shape} expected")
            worst, n_diff, total = batches_close(key, got, cpu, lsb)
            msgs = bus_messages(pipe)
            messages_close(key, msgs, bus_messages(cpu_pipe))
            med, all_runs = fps_runs(build, window)
            step_ms[key] = (window * 1000.0 / med, window)
            log(f"{key}: no kernel launched; {n_windows} windows of {window} "
                f"frames {shape}, {n_diff} of {total} bytes differ from the "
                f"CPU port's (by up to {worst}), {len(msgs)} bus messages "
                f"equal; peak device memory {peak / 2**20:.1f} MiB; "
                f"counted run {t_card:.2f} s, CPU port {t_cpu:.2f} s")
            log(f"fps {key} window {window}: median {med:.1f} source "
                f"frames/s of {[round(x, 1) for x in all_runs]}, step "
                f"{step_ms[key][0]:.3f} ms ({card})")
        log(f"cv paths: {time.perf_counter() - t_phase:.1f} s")

        # the equality sweep
        t_sweep = time.perf_counter()
        rng = np.random.default_rng(23)
        n = SWEEP_FRAMES

        def rand(*shape):
            return rng.integers(0, 256, shape, dtype=np.uint8)

        data = {"RGB": rand(n, SH, SW, 3), "BGRx": rand(n, SH, SW, 4),
                "RGBA": rand(n, SH, SW, 4), "GRAY8": rand(n, SH, SW),
                "I420": {"y": rand(n, SH, SW),
                         "u": rand(n, SH // 2, SW // 2),
                         "v": rand(n, SH // 2, SW // 2)}}
        ball = [b.data for b in gtt.parse_launch(
            f"videotestsrc pattern=ball width={SW} height={SH} format=RGB "
            "! fakesink", device="cpu").run(n_frames=2 * n, window=n)]
        ty, tx = SH // 3, SW // 3
        templ = data["RGB"][1, ty:ty + 16, tx:tx + 24].copy()
        n_cases = 0

        def case(name, fmt, props=None, windows=None, setup=None,
                 label=""):
            nonlocal n_cases
            wins = windows if windows is not None else [data[fmt]]
            outs = {}
            for d in ("cuda", "cpu"):
                h = Harness(name, device=d, **(props or {}))
                if setup:
                    setup(h.element)
                h.set_src_spec(MediaSpec(kind="video", format=fmt,
                                         width=SW, height=SH))
                res = []
                for x in wins:
                    res += h.push(x)
                outs[d] = (res, bus_messages(h))
            key = f"sweep {name} {fmt} {label or props}"
            n_cases += 1
            return key, outs

        def check(name, fmt, props=None, lsb=0, **kw):
            key, outs = case(name, fmt, props, **kw)
            worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                                 outs["cpu"][0], lsb)
            messages_close(key, outs["cuda"][1], outs["cpu"][1])
            if lsb or worst or outs["cpu"][1]:
                log(f"{key}: {n_diff} of {total} bytes differ, by up to "
                    f"{worst}; {len(outs['cpu'][1])} bus messages equal")

        for props in ({"type": "blur", "kernel-width": 5,
                       "kernel-height": 3},
                      {"type": "gaussian", "kernel-width": 5,
                       "kernel-height": 5},
                      {"type": "median", "kernel-width": 5},
                      {"type": "gaussian", "kernel-width": 7, "color": 2.5,
                       "position-x": 300, "position-y": 100, "width": 500,
                       "height": 400}):
            check("cvsmooth", "RGB", props)
        check("cvsmooth", "RGB", {"type": "bilateral", "color": 30.0},
              lsb=1)
        for ap in (3, 5, 7):
            for mask in (True, False):
                check("cvsobel", "RGB", {"aperture-size": ap, "mask": mask})
                check("cvlaplace", "RGB", {
                    "aperture-size": ap, "mask": mask, "scale": 0.5,
                    "shift": 12.0})
            check("edgedetect", "RGB", {"aperture-size": ap})
        for name in ("cvdilate", "cverode"):
            for its in (1, 3):
                check(name, "RGB", {"iterations": its})
        check("cvequalizehist", "GRAY8")
        check("retinex", "RGB", {}, lsb=1)
        check("retinex", "RGB", {"method": "multiscale"}, lsb=1)
        for fmt in ("GRAY8", "RGB", "BGRx"):
            for alpha in (0.0, 0.5, 1.0):
                check("cameraundistort", fmt, {
                    "camera-matrix": "900 0 640 0 900 360 0 0 1",
                    "distortion-coeffs": benchmarks.UNDISTORT_D,
                    "alpha": alpha, "crop": True})
        for mode in ("single-panorama", "double-panorama", "quad-view"):
            for interp in ("bilinear", "nearest"):
                check("dewarp", "RGBA", {
                    "inner-radius": 0.05, "outer-radius": 0.28,
                    "display-mode": mode, "interpolation-method": interp})
        for method in ("hsv", "rgb"):
            for post in (True, False):
                check("skindetect", "RGB", {"method": method,
                                            "postprocess": post})
        for fmt in ("BGRx", "I420"):
            for zoom in (1.0, 1.7, 4.0):
                check("digitalzoom", fmt, {"zoom": zoom}, lsb=1)
            check("digitalzoom", fmt, lsb=1, label="per-frame zoom ramp",
                  windows=[data[fmt], data[fmt]],
                  setup=lambda el: el.set_control(
                      "zoom", lambda pts: 1.0 + (np.asarray(pts)
                                                 // 33333333) * 0.9))
        for intent in ("perceptual", "relative", "saturation", "absolute"):
            check("lcms", "BGRx", {"intent": intent, "dest-profile": wide},
                  lsb=1)
        check("lcms", "BGRx", {"dest-profile": wide,
                               "preserve-black": True}, lsb=1)
        check("motioncells", "RGB", {"gridx": 8, "gridy": 6,
                                     "sensitivity": 0.95},
              windows=ball, label="ball, 2 windows")
        # templatematch: the best location equal, or a near tie on the
        # CPU port's own score map; the drawn rectangle's green byte
        # (255 - 255^score, truncated) within 1
        for method in ("sqdiff", "sqdiff-normed", "ccorr", "ccorr-normed",
                       "ccoeff", "ccoeff-normed"):
            key, outs = case("templatematch", "RGB", {"method": method},
                             setup=lambda el: el.set_template(templ))
            score = cvops.match_template(torch.from_numpy(data["RGB"]),
                                         torch.from_numpy(templ),
                                         method.replace("-", "_")).numpy()
            ties = set()
            for fi, (g, c) in enumerate(zip(outs["cuda"][1],
                                            outs["cpu"][1])):
                scale = float(np.abs(score[fi]).max())
                if not abs(g[3]["result"] - c[3]["result"]) <= 1e-5 * scale:
                    fail(f"{key}: frame {fi} result {g[3]['result']} on the "
                         f"card, {c[3]['result']} on CPU")
                if (g[3]["x"], g[3]["y"]) != (c[3]["x"], c[3]["y"]):
                    gap = abs(score[fi, g[3]["y"], g[3]["x"]]
                              - score[fi, c[3]["y"], c[3]["x"]])
                    if not gap <= 1e-5 * scale:
                        fail(f"{key}: frame {fi} best at "
                             f"{(g[3]['x'], g[3]['y'])} on the card, "
                             f"{(c[3]['x'], c[3]['y'])} on CPU")
                    ties.add(fi)
                g2 = {k: v for k, v in g[3].items() if k != "result"}
                c2 = {k: v for k, v in c[3].items() if k != "result"}
                if fi not in ties and (g[:3] != c[:3] or g2 != c2):
                    fail(f"{key}: message {g} on the card, {c} on CPU")
            worst, n_diff, _ = batches_close(
                key, outs["cuda"][0], outs["cpu"][0], lsb=1,
                skip=lambda wi, fi: fi in ties)
            a = outs["cuda"][0][0].data.astype(int)
            c = outs["cpu"][0][0].data.astype(int)
            keep = [fi for fi in range(a.shape[0]) if fi not in ties]
            if (a[keep][..., [0, 2]] != c[keep][..., [0, 2]]).any():
                fail(f"{key}: the red or blue bytes differ from the CPU "
                     "port's")
            log(f"{key}: best locations equal but {len(ties)} near ties, "
                f"{n_diff} green bytes differ by up to {worst}")
        # alphacombine and codecalphademux: a fan-in graph, card against CPU
        for tail in ("", "codecalphademux ! "):
            desc = (f"videotestsrc pattern=ball width={SW} height={SH} "
                    f"format=I420 ! m.  videotestsrc pattern=gradient "
                    f"width={SW} height={SH} format=GRAY8 ! m.  "
                    f"alphacombine name=m ! {tail}fakesink")
            res = {}
            for d in ("cuda", "cpu"):
                p = gtt.parse_launch(desc, device=d)
                res[d] = (p.run(n_frames=2 * n, window=n), bus_messages(p))
            key = f"sweep alphacombine ! {tail}fakesink"
            batches_close(key, res["cuda"][0], res["cpu"][0])
            messages_close(key, res["cuda"][1], res["cpu"][1])
            n_cases += 1
        log(f"equality sweep: {n_cases} cases at {SW}x{SH}, {n} frames a "
            f"window, card against CPU port, in "
            f"{time.perf_counter() - t_sweep:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"cv_slice: {time.perf_counter() - t_phase:.1f} s")
    return step_ms


AUDIO_WINDOW = 64               # the audio-breadth paths' window
AUDIO_SWEEP = 4                 # the equality sweep's blocks a window


def audio_paths(benchmarks):
    """The audio-breadth paths of phase 4f: {key: (build(device) ->
    Pipeline, feed(pipeline, n_windows) pushing its seeded inputs (or
    None for a source graph), windows of the counted run, {kernel:
    launches a window}, comparison against the CPU port)}.  The
    comparison is "exact", ("lsb", n, mean) for S16 within n LSB with a
    mean difference under `mean`, or ("abs", x) for float samples within
    x."""
    w = AUDIO_WINDOW

    def push(name, frames):
        def feed(p, n_windows):
            p.get_by_name(name).push_frames(frames(n_windows))
        return feed

    def voip_feed(p, n_windows):
        near, far = benchmarks.voip_inputs(n_windows * w, seed=1)
        p.get_by_name("near").push_frames(near)
        p.get_by_name("far").push_frames(far)

    def dvi_feed(p, n_windows):
        # the encoder graph's output on the CPU port: the DVI blocks of a
        # 997 Hz sine (the encoder path holds the card's equal to them)
        enc = benchmarks.adpcm_dvi_44k_encode(device="cpu").run(
            n_frames=n_windows * w, window=w)
        p.get_by_name("dec").push_bytes(b"".join(
            b.data.tobytes() for b in enc))

    def ms_feed(p, n_windows):
        p.get_by_name("dec").push_bytes(
            benchmarks.ms_blocks(n_windows * w, seed=3).tobytes())

    paths = {
        "voip_webrtcdsp_48k": (benchmarks.voip_webrtcdsp_48k, voip_feed, 2,
                               {}, ("lsb", 4, 0.5)),
        "adpcm_dvi_44k_enc": (benchmarks.adpcm_dvi_44k_encode, None, 2,
                              {"adpcm_ima_encode": 1}, "exact"),
        "adpcm_dvi_44k_dec": (benchmarks.adpcm_dvi_44k_decode, dvi_feed, 2,
                              {"adpcm_ima_decode": 1}, "exact"),
        "adpcm_ms_44k": (benchmarks.adpcm_ms_44k, ms_feed, 2,
                         {"adpcm_ms_decode": 1}, "exact"),
        "headphone_bs2b_pitch_44k": (benchmarks.headphone_bs2b_pitch_44k,
                                     None, 1, {}, ("abs", 1e-3)),
    }
    for scope in benchmarks.SCOPES:
        paths[f"scopes_720p_{scope}"] = (
            (lambda sc: lambda d: benchmarks.scope_720p(sc, device=d))(scope),
            push("src", lambda n: benchmarks.music_like(n * w, seed=5)), 1,
            {"scope_filter": 1} if scope in ("wavescope", "spacescope")
            else {}, "exact")
    return paths


def fed_input(p, feed, window: int):
    """One window of p's host sources, fed by feed and pulled as the
    runner pulls it (Pipeline.pull_inputs): a FrameBatch, a list for
    several sources, or None for a source graph."""
    p.negotiate()
    if feed is None:
        return None
    feed(p, 1)
    return p.pull_inputs(window)


def audio_slice(gtt, benchmarks, counters, launches, err, card) -> dict:
    """Phase 4f: audio breadth.

    The new walks' kernels against their plain versions on the card
    (adpcm_ima_decode, adpcm_ms_decode, adpcm_ima_encode, scope_filter:
    bit for bit, at ragged shapes); then each path of audio_paths through
    parse_launch on the card, the launch counts set to 0 just before its
    counted run and read just after (each kernel of the path launched
    once a window, every other count 0), its frames and bus messages
    against the same inputs on the CPU port, its peak device memory and
    frames/s (median of 5); each kernel also against its plain version on
    the inputs the path gave it.  Then the equality sweep: all 17 new
    elements, card against CPU port, at small sizes in every format they
    accept under 2-4 property sets.  Returns {"step_ms": {key: (untraced
    step ms, window)}, "inputs": {kernel: its main-path arguments},
    "plain_s": {kernel: host seconds of its plain walk on them}}."""
    import numpy as np
    import torch
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.ops import audio

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(31)
    walks = ("adpcm_ima_decode", "adpcm_ms_decode", "adpcm_ima_encode",
             "scope_filter")

    def note(name, e):
        err[name] = max(err[name], e)

    # the kernels against their plain versions at ragged shapes: blocks of
    # one group, of an odd byte count, mono and stereo; encoder windows of
    # one sample and of odd block lengths; the filter on 1 and 3000
    # samples
    for ch, bsz in ((1, 8), (1, 1024), (2, 16), (2, 41), (2, 2048)):
        blocks = torch.from_numpy(rng.integers(0, 256, (37, bsz),
                                               dtype=np.uint8))
        for name, plain in (("adpcm_ima_decode",
                             audio.adpcm_ima_decode_plain),
                            ("adpcm_ms_decode", audio.adpcm_ms_decode_plain)):
            got = getattr(audio, name)(blocks.to(dev), ch).cpu()
            note(name, max_abs_err(got, plain(blocks, ch)))
    for shape in ((1, 1, 1), (3, 25, 2), (7, 1017, 1)):
        x = torch.from_numpy(rng.integers(-32768, 32768, shape).astype(
            np.int16))
        si0 = torch.from_numpy(rng.integers(0, 89, shape[2]).astype(
            np.int32))
        got = audio.adpcm_ima_encode(x.to(dev), si0.to(dev))
        note("adpcm_ima_encode", max(max_abs_err(g.cpu(), w) for g, w in zip(
            got, audio.adpcm_ima_encode_plain(x, si0))))
    for n, ch in ((1, 1), (3000, 1), (777, 2)):
        st = torch.from_numpy(rng.standard_normal(6 * ch) * 100)
        x = torch.from_numpy(rng.integers(-32768, 32768, (n, ch)).astype(
            np.int32))
        s1, t1 = audio.scope_filter(st.to(dev), x.to(dev))
        s2, t2 = audio.scope_filter_plain(st, x)
        note("scope_filter", max(float((s1.cpu() - s2).abs().max()),
                                 float((t1.cpu() - t2).abs().max())))
    log("audio walks at ragged shapes: max_abs_err "
        + ", ".join(f"{k} {err[k]}" for k in walks))
    if any(err[k] for k in walks):
        fail(f"audio walks disagree with their plain versions: "
             f"{ {k: err[k] for k in walks} }")

    paths = audio_paths(benchmarks)
    step_ms = {}
    for key, (build, feed, n_windows, need, cmp) in paths.items():
        t0 = time.perf_counter()
        window = AUDIO_WINDOW
        pipe = build("cuda")
        pipe.negotiate()
        if feed is not None:
            feed(pipe, n_windows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()   # earlier phases' tensors
        for c in counters.values():
            c.launches = 0
        got = pipe.run(n_frames=n_windows * window, window=window)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        delta = {k: c.launches for k, c in counters.items()}
        for k, c in delta.items():
            if c != need.get(k, 0) * n_windows:
                fail(f"{key}: {k} launched {c} times in {n_windows} windows "
                     f"({need.get(k, 0)} a window expected)")
        for k in launches:
            launches[k] += delta[k]
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_pipe = build("cpu")
        cpu_pipe.negotiate()
        if feed is not None:
            feed(cpu_pipe, n_windows)
        cpu = cpu_pipe.run(n_frames=n_windows * window, window=window)
        t_cpu = time.perf_counter() - t0
        msgs = bus_messages(pipe)
        messages_close(key, msgs, bus_messages(cpu_pipe))
        if cmp == "exact":
            worst, n_diff, total = batches_close(key, got, cpu)
            bound = "exact"
        elif cmp[0] == "lsb":
            worst, n_diff, total = batches_close(key, got, cpu, cmp[1],
                                                 share=1.0, dtype="int16")
            mean = float(np.mean(np.concatenate([
                np.abs(a.data.astype(int) - c.data.astype(int)).ravel()
                for a, c in zip(got, cpu)])))
            if not mean < cmp[2]:
                fail(f"{key}: mean difference {mean:.4f} LSB from the CPU "
                     f"port's ({cmp[2]} allowed)")
            bound = f"within {cmp[1]} LSB, mean {mean:.4f} LSB"
        else:
            worst, n_diff, total = batches_close(key, got, cpu, share=1.0,
                                                 lsb=cmp[1], dtype="float32")
            bound = f"within {cmp[1]}"
        med, all_runs = fps_runs(build, window, feed=feed)
        step_ms[key] = (window * 1000.0 / med, window)
        log(f"{key}: launches {delta}; {n_windows} windows of {window} "
            f"{got[0].data.shape[1:]} {got[0].data.dtype}, {n_diff} of "
            f"{total} values differ from the CPU port's (by up to {worst}; "
            f"{bound}), {len(msgs)} bus messages equal; peak device memory "
            f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above "
            f"the {held / 2**20:.1f} MiB held before the run); counted run "
            f"{t_card:.2f} s, CPU port {t_cpu:.2f} s")
        log(f"fps {key} window {window}: median {med:.1f} source "
            f"blocks/s of {[round(x, 1) for x in all_runs]}, step "
            f"{step_ms[key][0]:.3f} ms ({card})")
    log(f"audio paths: {time.perf_counter() - t_phase:.1f} s")

    # each kernel against its plain version on the inputs its path gives
    # it, recorded on uncounted runs
    inputs, plain_s = {}, {}
    for key, k in (("adpcm_dvi_44k_dec", "adpcm_ima_decode"),
                   ("adpcm_ms_44k", "adpcm_ms_decode"),
                   ("adpcm_dvi_44k_enc", "adpcm_ima_encode"),
                   ("scopes_720p_wavescope", "scope_filter")):
        build, feed, _, _, _ = paths[key]
        p = build("cuda")
        batch = fed_input(p, feed, AUDIO_WINDOW)
        step = p.compile(AUDIO_WINDOW)
        undo = capture(audio, k, inputs)
        try:
            step(p.params(), p.init_states(AUDIO_WINDOW), batch)
            torch.cuda.synchronize()
        finally:
            undo()
        if len(inputs.get(k, ())) != 1:
            fail(f"{key} gave {k} {len(inputs.get(k, ()))} inputs, 1 "
                 "expected")
    for k in walks:
        (args, kw) = inputs[k][0]
        inputs[k] = args
        got = getattr(audio, k)(*args)
        cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args]
        t0 = time.perf_counter()
        want = getattr(audio, f"{k}_plain")(*cpu_args)
        plain_s[k] = time.perf_counter() - t0
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        e = max((float((g.cpu().double() - w.double()).abs().max())
                 for g, w in zip(got, want)), default=0.0)
        note(k, e)
        log(f"{k} on its main-path input {[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}"
            f": max_abs_err {e} against its plain version (host "
            f"{plain_s[k]:.3f} s)")
    if any(err[k] for k in walks):
        fail(f"audio walks disagree with their plain versions on the main "
             f"paths' inputs: { {k: err[k] for k in walks} }")

    # the equality sweep: every new element, card against CPU port
    t_sweep = time.perf_counter()
    n_cases = 0
    nb = AUDIO_SWEEP

    def pcm(fmt, n, s, ch, amp=0.4, seed=0):
        r = np.random.default_rng(seed)
        t = np.arange(n * s) / 44100.0
        x = (amp * np.sin(2 * np.pi * 330 * t)[:, None]
             + 0.1 * r.standard_normal((n * s, ch))).reshape(n, s, ch)
        if fmt == "S16":
            return np.clip(x * 32767, -32768, 32767).astype(np.int16)
        if fmt == "S32":
            return np.clip(x * 2 ** 31, -2 ** 31, 2 ** 31 - 1).astype(
                np.int32)
        return x.astype(np.float32 if fmt == "F32" else np.float64)

    def harness_case(name, fmt, ch, rate, wins, props=None, lsb=0.0,
                     rtol=0.0, label=""):
        nonlocal n_cases
        outs = {}
        for d in ("cuda", "cpu"):
            h = Harness(name, device=d, **(props or {}))
            h.set_src_spec(MediaSpec(kind="audio", format=fmt, rate=rate,
                                     channels=ch))
            res = []
            for x in wins:
                res += h.push(x)
            outs[d] = (res, bus_messages(h))
        key = f"sweep {name} {fmt} {ch} ch {label or props or ''}"
        worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                             outs["cpu"][0], lsb, share=1.0)
        messages_close(key, outs["cuda"][1], outs["cpu"][1], rtol)
        n_cases += 1
        if worst:
            log(f"{key}: {n_diff} of {total} values differ, by up to "
                f"{worst}")

    def graph_case(desc, n_frames, window, lsb=0.0, feed=None, label=""):
        nonlocal n_cases
        outs = {}
        for d in ("cuda", "cpu"):
            p = gtt.parse_launch(desc, device=d)
            p.negotiate()
            if feed:
                feed(p)
            outs[d] = (p.run(n_frames=n_frames, window=window),
                       bus_messages(p))
        key = f"sweep {label or desc}"
        worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                             outs["cpu"][0], lsb, share=1.0)
        messages_close(key, outs["cuda"][1], outs["cpu"][1])
        n_cases += 1
        if worst:
            log(f"{key}: {n_diff} of {total} values differ, by up to "
                f"{worst}")

    for fmt in ("F32", "F64", "S16", "S32"):
        for props in ({}, {"preset": "jmeier"}, {"fcut": 1500, "feed": 20}):
            harness_case("bs2b", fmt, 2, 44100,
                         [pcm(fmt, nb, 500, 2, seed=i) for i in range(2)],
                         props)
        harness_case("audiobuffersplit", fmt, 2, 48000,
                     [pcm(fmt, nb, 700, 2, seed=i) for i in range(2)],
                     {"output-buffer-duration": "1/100"})
        harness_case("videoframe-audiolevel", fmt, 2, 48000,
                     [pcm(fmt, nb, 1600, 2)], rtol=1e-12)
    harness_case("bs2b", "F32", 1, 44100, [pcm("F32", nb, 300, 1)],
                 label="mono")
    for props in ({"gapless": True, "max-silence-time": 40_000_000},
                  {"alignment-threshold": 1_000_000, "discont-wait": 0}):
        wins = [pcm("S16", nb, 480, 1, seed=i) for i in range(2)]
        pts = [np.arange(nb) * 10_000_000, np.arange(nb) * 10_000_000
               + 75_000_000]
        outs = {}
        for d in ("cuda", "cpu"):
            h = Harness("audiobuffersplit", device=d, **props)
            h.set_src_spec(MediaSpec(kind="audio", format="S16", rate=48000,
                                     channels=1))
            outs[d] = sum((h.push(x, pts=t) for x, t in zip(wins, pts)), [])
        batches_close(f"sweep audiobuffersplit {props}", outs["cuda"],
                      outs["cpu"])
        n_cases += 1
    for props in ({"pitch": 1.25}, {"tempo": 1.2, "rate": 0.9},
                  {"output-rate": 2.0, "pitch": 0.7}):
        harness_case("pitch", "F32", 2, 44100,
                     [pcm("F32", 2, 1024, 2, seed=i) for i in range(2)],
                     props, lsb=1e-4)
    for fmt, ch in (("F32", 1), ("S16", 2)):
        t = np.arange(8000 * 12) / 8000.0
        beat = (np.maximum(np.sin(2 * np.pi * 2.0 * t), 0.0) ** 16
                * np.sin(2 * np.pi * 300 * t) * 0.6)
        x = np.repeat(beat[:, None], ch, 1).reshape(-1, 2000, ch)
        x = (np.clip(x * 32767, -32768, 32767).astype(np.int16)
             if fmt == "S16" else x.astype(np.float32))
        harness_case("bpmdetect", fmt, ch, 8000,
                     [x[i:i + 16] for i in range(0, 48, 16)])
    x = pcm("F32", nb, 4800, 1, amp=0.05)
    x[1, 1234, 0] = 0.9
    harness_case("audiolatency", "F32", 1, 48000, [x], lsb=1.2e-7)
    for layout, ch in (("dvi", 1), ("dvi", 2), ("microsoft", 1),
                       ("microsoft", 2)):
        bsz = 16 * ch * 8 if layout == "dvi" else 7 * ch + 100
        data = (benchmarks.ms_blocks(9, 5, bsz, ch) if layout == "microsoft"
                else rng.integers(0, 256, (9, bsz), dtype=np.uint8))
        graph_case(f"adpcmdec name=dec layout={layout} blocksize={bsz} "
                   f"rate=22050 channels={ch} ! fakesink", 0, 4,
                   feed=lambda p, b=data: p.get_by_name("dec").push_bytes(
                       b.tobytes()), label=f"adpcmdec {layout} {ch} ch")
    for ch in (1, 2):
        graph_case(f"audiotestsrc wave=sine freq=997 format=S16 rate=22050 "
                   f"channels={ch} samplesperbuffer=57 ! adpcmenc "
                   f"blocksize={32 * ch} ! fakesink", 12, 4)
    for props in ("freq=440", "freq=697 freq2=1209 volume=3 volume2=6 "
                  "on-time=50 off-time=30 repeat=true",
                  "freq=1000 on-time=20 off-time=10 on-time2=15 "
                  "off-time2=5 repeat=true samplesperbuffer=160"):
        graph_case(f"tonegeneratesrc {props} ! fakesink", 12, 4, lsb=1)
    tt = np.arange(800) / 8000.0
    tones = np.concatenate([
        np.concatenate([8000 * (np.sin(2 * np.pi * r * tt)
                                + np.sin(2 * np.pi * c * tt)), np.zeros(400)])
        for r, c in ((697, 1209), (770, 1336), (941, 1633))]).astype(
            np.int16)
    tones = np.concatenate([tones, np.zeros(-len(tones) % 1200, np.int16)])
    harness_case("dtmfdetect", "S16", 1, 8000, [tones.reshape(-1, 1200, 1)])
    for lost in ([1, 2], [0, 3]):
        outs = {}
        x = pcm("S16", 8, 160, 1)
        valid = np.ones(8, bool)
        valid[lost] = False
        from gstbad_tpu_torch.core.frame import FrameBatch
        for d in ("cuda", "cpu"):
            p = gtt.parse_launch("spanplc ! fakesink", device=d)
            p.negotiate(MediaSpec(kind="audio", format="S16", rate=8000,
                                  channels=1))
            res = []
            for i in (0, 4):
                batch = FrameBatch.make(
                    torch.from_numpy(x[i:i + 4]).to(d),
                    pts=torch.from_numpy(np.arange(i, i + 4) * 20_000_000
                                         ).to(d),
                    valid=torch.from_numpy(valid[i:i + 4]).to(d))
                res += p.run(inputs=batch)
            outs[d] = (res, bus_messages(p))
        batches_close(f"sweep spanplc lost {lost}", outs["cuda"][0],
                      outs["cpu"][0])
        messages_close(f"sweep spanplc lost {lost}", outs["cuda"][1],
                       outs["cpu"][1])
        n_cases += 1
    for scope in ("wavescope", "spacescope"):
        for style in ("dots", "lines", "color-dots", "color-lines"):
            for fmt in ("S16", "F32"):
                harness_case(scope, fmt, 2, 44100,
                             [pcm(fmt, nb, 400, 2, seed=i) for i in range(2)],
                             {"style": style, "width": 320, "height": 240})
    for shader in ("none", "fade-and-move-up", "fade-and-move-down",
                   "fade-and-move-left", "fade-and-move-right"):
        harness_case("wavescope", "S16", 1, 44100, [pcm("S16", nb, 400, 1)],
                     {"style": "lines", "shader": shader,
                      "shade-amount": 0x00402010})
    for fmt, ch in (("S16", 2), ("F32", 1), ("S16", 3)):
        harness_case("spectrascope", fmt, ch, 44100,
                     [pcm(fmt, nb, 800, ch), pcm(fmt, nb, 100, ch)],
                     {"width": 320, "height": 240})
    for fmt in ("S16", "F32"):
        harness_case("synaescope", fmt, 2, 44100,
                     [pcm(fmt, nb, 800, 2), pcm(fmt, nb, 100, 2)],
                     {"width": 320, "height": 240})
    near, far = benchmarks.voip_inputs(3 * nb, seed=7)
    for props in ("", "echo-suppression-level=high extended-filter=false "
                  "gain-control-mode=fixed-digital",
                  "noise-suppression-level=very-high "
                  "voice-detection-likelihood=high"):
        def voip(p, near=near, far=far):
            p.get_by_name("near").push_frames(near)
            p.get_by_name("far").push_frames(far)
        src = "appsrc name={} kind=audio format=S16 rate=48000 channels=1"
        graph_case(f"{src.format('near')} ! dsp.  {src.format('far')} ! "
                   "webrtcechoprobe ! dsp.  webrtcdsp name=dsp "
                   f"voice-detection=true {props} ! fakesink", 0, nb, lsb=4,
                   feed=voip, label=f"webrtcdsp {props or 'defaults'}")
    graph_case("videotestsrc pattern=ball width=64 height=48 format=RGB ! m."
               "  audiotestsrc wave=sine format=S16 rate=48000 channels=2 "
               "samplesperbuffer=1600 ! m.  videoframe-audiolevel name=m ! "
               "fakesink", 8, 4, label="videoframe-audiolevel A/V")
    log(f"audio equality sweep: {n_cases} cases, card against CPU port, in "
        f"{time.perf_counter() - t_sweep:.1f} s")
    log(f"audio_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "inputs": inputs, "plain_s": plain_s}


DETECT_W, DETECT_H = 1280, 720  # the face, stereo, segmentation, tracker paths
DETECT_SMALL = (176, 168)       # their card-against-CPU check (CPU time)
WINDOW_FACE = 16                # faceblur/facedetect/handdetect's window
WINDOW_STEREO = 4               # disparity's (the cost volume is 64 deep)
WINDOW_SEG = 64                 # segmentation's and cvtracker's
WINDOW_GC = 2                   # grabcut's
WINDOW_CODE = 2                 # zbar's and zxing's (host scanners)
ALT2 = os.path.join(ROOT, "gstbad_tpu_torch", "data",
                    "haarcascade_frontalface_alt2.xml")


def face_frames(n, w, h, seed=21):
    """n RGB frames: a seeded texture with the face fixture's 161x161
    frame pasted at four places that move by a few pixels a frame."""
    import numpy as np
    rng = np.random.default_rng(seed)
    face = np.load(os.path.join(ROOT, "gstbad_tpu_torch", "data",
                                "face_fixture.npz"))["frame"][..., None]
    base = rng.integers(30, 226, (h // 8 + 1, w // 8 + 1, 3)).astype(
        np.uint8).repeat(8, 0).repeat(8, 1)[:h, :w]
    out = np.repeat(base[None], n, 0)
    out = (out.astype(np.int16) + rng.integers(-12, 13, out.shape)).clip(
        0, 255).astype(np.uint8)
    for t in range(n):
        for k in range(4):
            x = (20 + k * (w - 181) // 3 + 3 * t) % (w - 161)
            y = (10 + (k % 2) * (h - 171) + 2 * t) % (h - 161)
            out[t, y:y + 161, x:x + 161] = face
    return out


def hand_frames(n, w, h, seed=22):
    """n RGB frames of a seeded smooth texture."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, h // 4 + 1, w // 4 + 1, 3)).astype(
        np.uint8).repeat(4, 1).repeat(4, 2)[:, :h, :w]
    return np.ascontiguousarray(base)


def stereo_frames(n, w, h, seed=23):
    """(left, right) n RGB frames each: a seeded texture, and the same
    texture shifted left by a disparity ramp of 2 to 40 pixels across the
    frame (right[x] = left[x - d(x)])."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (n, h, w + 48)).astype(np.uint8)
    xs = np.arange(w)
    d = (2 + 38 * xs / max(w - 1, 1)).astype(int)
    left = tex[:, :, 48:48 + w]
    right = tex[:, :, 48 + xs - d]
    rgb = lambda g: np.repeat(g[..., None], 3, -1)  # noqa: E731
    return rgb(left), rgb(right)


def code_frames(n, w=1920, h=1080):
    """n GRAY8 frames holding a QR symbol, an EAN-13 and a Code 128
    (the port's copied encoder and bar tables), moving a little."""
    import numpy as np
    from gstbad_tpu_torch.io import barcode1d, qr, qrdecode
    m = qr.encode("gst code scan", "M")
    q = np.where(np.kron(m, np.ones((8, 8), bool)), 20, 240).astype(np.uint8)
    ean = qrdecode.ean13_render("4006381333931", module_px=4)
    c128 = barcode1d.render_code128("GST-PORT-128", module_px=3)
    out = np.full((n, h, w), 255, np.uint8)
    for t in range(n):
        o = 4 * t
        out[t, 100 + o:100 + o + q.shape[0], 100:100 + q.shape[1]] = q
        out[t, 500:500 + ean.shape[0], 200 + o:200 + o + ean.shape[1]] = ean
        out[t, 800:800 + c128.shape[0], 900:900 + c128.shape[1]] = c128
    return out


def detect_paths(gtt):
    """The paths of phase 4g: {key: (build(device, small) -> Pipeline,
    feed(pipeline, n_windows, small) pushing its seeded inputs (or None
    for a videotestsrc graph), window, windows of the counted run,
    clock: "device" (CUDA events around the compiled step) or "host" (the
    host clock around run(): the scanners decode on the host after each
    window), fps_runs' clock)}.  `small` builds the same graph for the
    check against the CPU port at DETECT_SMALL, or for handdetect at its
    full size: the CPU port checks one frame, and the first 640x480 frame
    holds a palm that the cascades confirm (the random texture passes
    their first stages nowhere at 176x168).  The face paths confirm a
    window with one neighbour (min-neighbors=1, as the card tests run
    them): at the default 3 the fixture's face is not confirmed."""
    def size(small, w=DETECT_W, h=DETECT_H):
        return DETECT_SMALL if small else (w, h)

    def app(fmt, w, h, name="src"):
        return f"appsrc name={name} format={fmt} width={w} height={h}"

    def faces(el):
        def build(d, small=False):
            w, h = size(small)
            return gtt.parse_launch(f"{app('RGB', w, h)} ! {el} "
                                    f"profile={ALT2} min-neighbors=1 "
                                    "! fakesink", device=d)

        def feed(p, n, small=False):
            w, h = size(small)
            p.get_by_name("src").push_frames(face_frames(
                n * (2 if small else WINDOW_FACE), w, h))
        return build, feed

    def hands(d, small=False):
        return gtt.parse_launch(f"{app('RGB', 640, 480)} ! handdetect "
                                "! fakesink", device=d)

    def hands_feed(p, n, small=False):
        p.get_by_name("src").push_frames(hand_frames(
            n * (1 if small else WINDOW_FACE), 640, 480))

    def stereo(method):
        def build(d, small=False):
            w, h = size(small)
            return gtt.parse_launch(
                f"{app('RGB', w, h, 'l')} ! d.  {app('RGB', w, h, 'r')} ! d."
                f"  disparity name=d method={method} ! fakesink", device=d)

        def feed(p, n, small=False):
            w, h = size(small)
            left, right = stereo_frames(n * WINDOW_STEREO, w, h)
            p.get_by_name("l").push_frames(left)
            p.get_by_name("r").push_frames(right)
        return build, feed

    def ball(tail, fmt, w=DETECT_W, h=DETECT_H):
        def build(d, small=False):
            ws, hs = size(small, w, h)
            return gtt.parse_launch(
                f"videotestsrc pattern=ball width={ws} height={hs} "
                f"format={fmt} ! {tail} ! fakesink", device=d)
        return build

    def codes(el):
        def build(d, small=False):
            return gtt.parse_launch(f"{app('GRAY8', 1920, 1080)} ! {el} "
                                    "! fakesink", device=d)

        def feed(p, n, small=False):
            p.get_by_name("src").push_frames(code_frames(n * WINDOW_CODE))
        return build, feed

    fb, ff = faces("faceblur")
    db, df = faces("facedetect display=true")
    sb, sf = stereo("sgbm")
    bb, bf = stereo("sbm")
    zb, zf = codes("zbar")
    xb, xf = codes("zxing")
    return {
        "faceblur_720p": (fb, ff, WINDOW_FACE, 2, "device"),
        "facedetect_720p": (db, df, WINDOW_FACE, 2, "device"),
        "handdetect_640x480": (hands, hands_feed, WINDOW_FACE, 2, "device"),
        "disparity_720p": (sb, sf, WINDOW_STEREO, 2, "device"),
        "disparity_sbm_720p": (bb, bf, WINDOW_STEREO, 1, "device"),
        "segmentation_720p": (ball("segmentation method=mog2 test-mode=true",
                                   "RGBA"), None, WINDOW_SEG, 2, "device"),
        "cvtracker_720p": (ball("cvtracker object-initial-x=560 "
                                "object-initial-y=280 object-initial-width=160"
                                " object-initial-height=160", "RGB"), None,
                           WINDOW_SEG, 2, "device"),
        "grabcut_480p": (ball("grabcut test-mode=true bbox-x=200 bbox-y=120 "
                              "bbox-width=200 bbox-height=180", "RGBA", 640,
                              480), None, WINDOW_GC, 2, "device"),
        "zbar_1080p": (zb, zf, WINDOW_CODE, 1, "host"),
        "zxing_1080p": (xb, xf, WINDOW_CODE, 1, "host"),
    }


def n_scales(h, w, window, factor):
    """The pyramid scales ops/haar.detect_multi_scale evaluates."""
    from gstbad_tpu_torch.ops.haar import MAX_SCALES
    n, f = 0, 1.0
    while n < MAX_SCALES and int(h / f) >= window[1] and \
            int(w / f) >= window[0]:
        n += 1
        f *= factor
    return n


def cv_detect_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4g: the rest of the OpenCV family (facedetect, faceblur,
    handdetect, disparity, segmentation, cvtracker, grabcut, zbar, zxing).

    H1 (haar_cascade), H2 (tilted_integral) and H3 (sgm_aggregate)
    against their plain versions on the card at ragged shapes; then each
    path of detect_paths through parse_launch on the card at full width,
    the launch counts set to 0 just before its counted run and read just
    after (each kernel of the path launched as its pyramid or its passes
    say, every other count 0), its peak device memory and frames/s (median
    of 5 runs of 10 steps, of 3 of 4 where a step takes 50 ms or more, or
    of 2 runs of the host clock around run() for the scanners), and the
    same graph at DETECT_SMALL on the card against the
    CPU port (frames, valid and messages equal); then each kernel against
    its plain version on the inputs its main path gave it (H1: passed
    equal everywhere, score equal where passed).  Returns {"step_ms":
    {key: (untraced step ms, window)}, "times": {label: (ms, plain ms,
    None)}, "bounds": {label: (ms, by)}, "chains": {label: ms}}."""
    import numpy as np
    import torch
    from gstbad_tpu_torch.io.haarcascade import parse_cascade
    from gstbad_tpu_torch.ops import _cuda, haar, stereo
    from gstbad_tpu_torch.ops.resize import resize_linear

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(41)
    data = os.path.join(ROOT, "gstbad_tpu_torch", "data")
    packs = {"alt2": haar.pack(parse_cascade(ALT2), "arrays"),
             "fist": haar.pack(parse_cascade(os.path.join(data, "fist.xml")),
                               "unrolled"),
             "palm": haar.pack(parse_cascade(os.path.join(data, "palm.xml")),
                               "unrolled")}
    kernels = ("haar_cascade", "tilted_integral", "sgm_aggregate")

    def note(name, e):
        err[name] = max(err[name], e)

    def h1_check(pk, x):
        ny, nx = haar.grid(x.shape[-2], x.shape[-1], pk)
        ii, sq = haar.integral(x), haar.integral(x * x)
        tii = haar.tilted_integral(x) if pk.any_tilted else None
        if tii is not None:
            note("tilted_integral", float((tii.cpu() - haar.tilted_integral_plain(
                x.cpu())).abs().max()))
        kp, ks = haar.haar_cascade(ii, sq, tii, pk, ny, nx)
        pp, ps = haar.eval_cascade_plain(ii, sq, tii, pk, ny, nx)
        bad = int((kp != pp).sum()) + int((ks[pp] != ps[pp]).sum())
        note("haar_cascade", bad)
        return int(pp.sum())

    # the kernels against their plain versions at ragged shapes
    for (hh, ww) in ((161, 161), (47, 203), (20, 20), (101, 64)):
        x = torch.from_numpy((rng.random((3, hh, ww)) * 255).astype(
            np.float32)).to(dev)
        for pk in packs.values():
            if hh >= pk.window[1] and ww >= pk.window[0]:
                h1_check(pk, x)
    for (hh, ww, dd) in ((33, 70, 64), (48, 161, 40), (5, 300, 64)):
        tex = rng.integers(0, 256, (2, hh, ww + 60)).astype(np.uint8)
        l = torch.from_numpy(tex[:, :, 30:30 + ww].copy()).to(dev)
        r = torch.from_numpy(tex[:, :, 34:34 + ww].copy()).to(dev)
        cost = stereo.sgm_cost(l, r, dd)
        for axis, rev, shear in stereo.SGM_PASSES:
            tot = torch.full_like(cost, 7.0)
            want = stereo.sgm_aggregate_plain(cost, tot.clone(), axis, rev,
                                              shear, 200, 255)
            got = stereo.sgm_aggregate(cost, tot, axis, rev, shear, 200, 255)
            note("sgm_aggregate", float((got - want).abs().max()))
    torch.cuda.synchronize()
    log("cv detect kernels at ragged shapes: max_abs_err "
        + ", ".join(f"{k} {err[k]}" for k in kernels))
    if any(err[k] for k in kernels):
        fail(f"H1-H3 disagree with their plain versions: "
             f"{ {k: err[k] for k in kernels} }")

    paths = detect_paths(gtt)
    faces = n_scales(DETECT_H, DETECT_W, packs["alt2"].window, 1.25)
    hands = (n_scales(480, 640, packs["fist"].window, 1.1)
             + n_scales(480, 640, packs["palm"].window, 1.1))
    need = {"faceblur_720p": {"haar_cascade": faces},
            "facedetect_720p": {"haar_cascade": faces},
            "handdetect_640x480": {"haar_cascade": hands,
                                   "tilted_integral": hands},
            "disparity_720p": {"sgm_aggregate": len(stereo.SGM_PASSES)}}
    def found(key, got, msgs, small):
        """What a detection path found: (count, what), or None for the
        paths that detect nothing of the kind."""
        if key.startswith("facedetect"):
            return sum(int(f["n_faces"]) for _, n, _, f in msgs
                       if n == "facedetect"), "faces"
        if key.startswith("faceblur"):
            out = np.concatenate([np.asarray(b.data) for b in got])
            w, h = DETECT_SMALL if small else (DETECT_W, DETECT_H)
            return int((out != face_frames(len(out), w, h)).any(-1).sum()
                       ), "pixels blurred"
        if key.startswith("handdetect"):
            return sum(n == "hand-gesture" for _, n, _, _ in msgs), "gestures"
        return None

    step_ms = {}
    for key, (build, feed, window, n_windows, clock) in paths.items():
        t0 = time.perf_counter()
        pipe = build("cuda")
        pipe.negotiate()
        if feed is not None:
            feed(pipe, n_windows)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        got = pipe.run(n_frames=n_windows * window, window=window)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        delta = {k: c.launches for k, c in counters.items()}
        for k, c in delta.items():
            if c != need.get(key, {}).get(k, 0) * n_windows:
                fail(f"{key}: {k} launched {c} times in {n_windows} windows "
                     f"({need.get(key, {}).get(k, 0)} a window expected)")
        for k in launches:
            launches[k] += delta[k]
        t_card = time.perf_counter() - t0
        if sum(b.batch for b in got) != n_windows * window:
            fail(f"{key}: {sum(b.batch for b in got)} frames out, "
                 f"{n_windows * window} expected")
        n_msgs = len(pipe.bus.messages)
        hits = found(key, got, bus_messages(pipe), False)
        # the same graph at DETECT_SMALL, card against the CPU port
        t0 = time.perf_counter()
        outs = {}
        # one frame where the CPU port takes seconds a frame (the
        # cascades, the 1080p scanners), a whole window elsewhere
        n_small = 1 if key.startswith(("face", "hand", "zbar", "zxing")) \
            else window
        for d in ("cuda", "cpu"):
            p = build(d, True)
            p.negotiate()
            if feed is not None:
                feed(p, 1, True)
            outs[d] = (p.run(n_frames=n_small, window=n_small),
                       bus_messages(p))
        worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                             outs["cpu"][0])
        messages_close(key, outs["cuda"][1], outs["cpu"][1])
        t_cpu = time.perf_counter() - t0
        seen = ""
        if hits is not None:
            small_hits = found(key, outs["cpu"][0], outs["cpu"][1], True)
            if not hits[0] or not small_hits[0]:
                fail(f"{key}: {hits[0]} {hits[1]} in the counted run, "
                     f"{small_hits[0]} in the check against the CPU port "
                     "(the path must detect something in both)")
            seen = (f"; {hits[0]} {hits[1]} in the counted run, "
                    f"{small_hits[0]} in the check")
        # the scanners' windows are the longest by the host clock: 2 runs
        med, all_runs = fps_runs(build, window, feed=feed, clock=clock,
                                 n_steps=10 if clock == "device" else 1,
                                 reps=5 if clock == "device" else 2)
        step_ms[key] = (window * 1000.0 / med, window)
        log(f"{key}: launches {delta}; {n_windows} windows of {window} "
            f"{got[0].data.shape[1:]} {got[0].data.dtype}, {n_msgs} bus "
            f"messages; at {outs['cpu'][0][0].data.shape[1:]} the card "
            f"equals the CPU port "
            f"({total} values, {len(outs['cpu'][1])} messages){seen}; peak "
            f"device memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f}"
            f" MiB above the {held / 2**20:.1f} MiB held before the run); "
            f"counted run {t_card:.2f} s, card-against-CPU check {t_cpu:.2f} s")
        how = ("device step, 10 steps a run, 4 where a step takes "
               "50 ms or more" if clock == "device" else
               "host clock around run(), 1 window a run, 2 runs")
        log(f"fps {key} window {window}: median {med:.2f} source frames/s of "
            f"{[round(x, 2) for x in all_runs]}, step {step_ms[key][0]:.3f} "
            f"ms ({how}; {card})")

    # each kernel against its plain version on its main path's inputs
    # (uncounted runs), then its time, its plain version's and its bound
    inputs = {}
    for key, names, module in (
            ("facedetect_720p", ("haar_cascade",), haar),
            ("handdetect_640x480", ("haar_cascade", "tilted_integral"), haar),
            ("disparity_720p", ("sgm_aggregate",), stereo)):
        build, feed, window, _, _ = paths[key]
        p = build("cuda")
        batch = fed_input(p, feed, window)
        step = p.compile(window)
        store = inputs[key] = {}
        undo = [capture(module, k, store) for k in names]
        try:
            step(p.params(), p.init_states(window), batch)
            torch.cuda.synchronize()
        finally:
            for u in reversed(undo):
                u()
    times, bounds, chains = {}, {}, {}
    sm_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_per_s = n_sm * FP32_LANES * sm_hz
    probe = torch.zeros(2, dtype=torch.int64, device=dev)

    def h1_main(args, count=False):
        """H1 and its plain version on one launch the main path made:
        passed equal everywhere, score equal where passed.  -> (windows
        passing, the plain version's ms, its (window, node) evaluations
        with the early exit where count)"""
        kp, ks = haar.haar_cascade(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = haar.eval_cascade_plain(*args, count=count)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3   # a launch-bound loop
        pp, ps = res[:2]
        note("haar_cascade",
             int((kp != pp).sum()) + int((ks[pp] != ps[pp]).sum()))
        return int(pp.sum()), plain_ms, int(res[2].sum()) if count else None

    def h1_bound(args, n_eval):
        """The least loads (ii, sq and the rotated table read once, passed
        and score written) and FP32 operations (5 a rect and 3 a node of
        the evaluations made, 20 a window for its variance; a tilted
        feature's float64 ones counted at the FP32 rate) of one launch."""
        ii, sq, tii, pk, ny, nx = args
        rects = float((pk.weights != 0).sum(1).mean())
        t_bytes = 0 if tii is None else tii.numel() * tii.element_size()
        n_win = ii.shape[0] * ny * nx
        return bound(2 * ii.numel() * 4 + t_bytes + 5 * n_win,
                     n_eval * (5 * rects + 3) + n_win * 20, fp32_per_s)

    # H1 on the facedetect path: the largest scale (the window's frames at
    # 1280x720), timed, and the scale where the most windows pass
    face = [a for a, _ in inputs["facedetect_720p"]["haar_cascade"]]
    args = face[0]
    ii, sq, tii, pk, ny, nx = args
    n_pass, plain_ms, n_eval = h1_main(args, count=True)
    times["haar_cascade"] = (cuda_ms(lambda: haar.haar_cascade(*args)),
                             plain_ms, None)
    bounds["haar_cascade"] = h1_bound(args, n_eval)
    passes = [int(haar.haar_cascade(*a)[0].sum()) for a in face]
    most = max(range(1, len(face)), key=lambda i: passes[i])
    n_most, _, _ = h1_main(face[most])
    log(f"haar_cascade on facedetect_720p's largest scale {tuple(ii.shape)}"
        f" ({ny}x{nx} windows a frame): {n_pass} windows pass; "
        f"{n_eval} (window, node) evaluations with the early exit, against "
        f"{ii.shape[0] * ny * nx * int(pk.thr.shape[0])} without it; "
        f"{len(face)} launches a window, windows passing each "
        f"{passes}; also held against the plain version at scale {most} "
        f"{tuple(face[most][0].shape)} ({n_most} windows pass)")

    # H1 on the handdetect path: every launch of a window (fist's pyramid,
    # then palm's), the largest fist scale timed
    hand = [a for a, _ in inputs["handdetect_640x480"]["haar_cascade"]]
    n_fist = n_scales(480, 640, packs["fist"].window, 1.1)
    res = [h1_main(a, count=(i == 0)) for i, a in enumerate(hand)]
    args = hand[0]
    ii, sq, tii, pk, ny, nx = args
    times["haar_cascade_unrolled"] = (
        cuda_ms(lambda: haar.haar_cascade(*args)), res[0][1], None)
    bounds["haar_cascade_unrolled"] = h1_bound(args, res[0][2])
    log(f"haar_cascade on handdetect_640x480's {len(hand)} launches a window "
        f"(fist {n_fist} scales, palm {len(hand) - n_fist}), each held "
        f"against the plain version: {sum(r[0] for r in res[:n_fist])} fist "
        f"and {sum(r[0] for r in res[n_fist:])} palm windows pass; largest "
        f"fist scale {tuple(ii.shape)} ({ny}x{nx} windows a frame): "
        f"{res[0][2]} (window, node) evaluations with the early exit, "
        f"against {ii.shape[0] * ny * nx * int(pk.thr.shape[0])} without it")

    # H2 on the handdetect path's largest plane
    tilted = [a[0] for a, _ in inputs["handdetect_640x480"]["tilted_integral"]]
    for x in tilted:
        note("tilted_integral", float((haar.tilted_integral(x)
                                       - haar.tilted_integral_plain(x)
                                       ).abs().max()))
    x = tilted[0]
    times["tilted_integral"] = (
        cuda_ms(lambda: haar.tilted_integral(x)),
        cuda_ms(lambda: haar.tilted_integral_plain(x), iters=1, warmup=1),
        None)
    steps = 1 << 14
    _cuda.launch("gst_haar_tilted_step_cycles", probe, steps)
    torch.cuda.synchronize()
    cyc = probe[0].item() / steps
    b_, h_, w_ = x.shape
    wp = w_ + h_ + 2 * haar.TILT_PAD
    chains["tilted_integral"] = h_ * cyc / sm_hz * 1e3
    bounds["tilted_integral"] = bound(
        4 * x.numel() + 8 * b_ * (h_ + 1) * (wp + 1),
        4 * b_ * h_ * (wp + 1), fp32_per_s / 2, chains["tilted_integral"])
    log(f"tilted_integral on {tuple(x.shape)}: {h_} rows in order x "
        f"{cyc:.1f} cycles (probe, {steps} rows) = chain "
        f"{chains['tilted_integral']:.4f} ms; "
        f"{len(tilted)} launches a window, each held against the plain "
        "version")

    # H3 on the disparity path's cost volume, each pass
    (args, _), = inputs["disparity_720p"]["sgm_aggregate"][:1]
    cost = args[0]
    total = torch.zeros_like(cost)
    for axis, rev, shear in stereo.SGM_PASSES:
        want = stereo.sgm_aggregate_plain(cost, total.clone(), axis, rev,
                                          shear, 200, 255)
        total = stereo.sgm_aggregate(cost, total, axis, rev, shear, 200, 255)
        note("sgm_aggregate", float((total - want).abs().max()))
    times["sgm_aggregate"] = (
        cuda_ms(lambda: stereo.sgm_aggregate(cost, total, 0, False, 0, 200,
                                             255)),
        cuda_ms(lambda: stereo.sgm_aggregate_plain(cost, total, 0, False, 0,
                                                   200, 255),
                iters=1, warmup=1), None)
    _cuda.launch("gst_sgm_step_cycles", probe, steps)
    torch.cuda.synchronize()
    cyc3 = probe[0].item() / steps
    b_, h_, w_, d_ = cost.shape
    chains["sgm_aggregate"] = h_ * cyc3 / sm_hz * 1e3
    bounds["sgm_aggregate"] = bound(
        3 * 4 * cost.numel(), 8 * cost.numel(), fp32_per_s,
        chains["sgm_aggregate"])
    log(f"sgm_aggregate on {tuple(cost.shape)} (a row pass): {h_} steps in "
        f"order x {cyc3:.1f} cycles (probe) = chain "
        f"{chains['sgm_aggregate']:.4f} ms; "
        f"{len(inputs['disparity_720p']['sgm_aggregate'])} launches a "
        "window")
    log("cv detect kernels on their main paths' inputs: max_abs_err "
        + ", ".join(f"{k} {err[k]}" for k in kernels))
    if any(err[k] for k in kernels):
        fail(f"H1-H3 disagree with their plain versions on the main paths' "
             f"inputs: { {k: err[k] for k in kernels} }")
    log(f"cv_detect_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "times": times, "bounds": bounds,
            "chains": chains}


WINDOW_OVERLAY = 64             # the overlay paths' window
OVERLAY_SMALL = (320, 180)      # their card-against-CPU check
SEC = 10 ** 9
LOGO_SVG = ('<svg xmlns="http://www.w3.org/2000/svg" width="240" '
            'height="96"><rect x="4" y="4" width="232" height="88" rx="18" '
            'fill="#1030c0" fill-opacity="0.55"/><circle cx="56" cy="48" '
            'r="30" fill="#ffd000"/><path d="M110 20 L220 48 L110 76 Z" '
            'fill="#ffffff" fill-opacity="0.8"/></svg>')


def _bits(pairs):
    """Bytes of a bit string given as (value, width) pairs, zero padded."""
    bits = "".join(format(v, f"0{n}b") for v, n in pairs)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def uvc_mjpeg(seed=41, n_aux=2, seg=1000):
    """A UVC H.264 camera's MJPEG frame, made from `seed`: SOI, an APP0,
    then n_aux auxiliary payloads (H264, then YUY2 and NV12 in turn) each
    split over APP4 segments of at most `seg` bytes (the first carrying
    the 22-byte AuxiliaryStreamHeader and the payload size), then SOS,
    scan bytes and EOI (sys/uvch264/gstuvch264_mjpgdemux.c's layout).
    -> (frame bytes, [(fourcc, payload)], the frame without its APP4s)."""
    import struct

    import numpy as np
    rng = np.random.default_rng(seed)
    head = b"\xff\xd8" + b"\xff\xe0" + struct.pack(">H", 16) \
        + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    scan = b"\xff\xda" + rng.integers(0, 256, 3000, dtype=np.uint8
                                       ).tobytes() + b"\xff\xd9"
    app4, payloads = b"", []
    for k in range(n_aux):
        fourcc = ("H264", "YUY2", "NV12")[k % 3]
        data = rng.integers(0, 256, int(rng.integers(500, 4000)),
                            dtype=np.uint8).tobytes()
        payloads.append((fourcc, data))
        hdr = (struct.pack(">H", 0x0100) + struct.pack("<H", 22)
               + fourcc.encode() + struct.pack("<HHIHI", 640 >> k, 480 >> k,
                                               333333, 40 + k, 1000 * k)
               + struct.pack("<I", len(data)))
        body, first = data, True
        while body or first:
            room = seg - (len(hdr) if first else 0)
            part, body = body[:room], body[room:]
            content = (hdr if first else b"") + part
            app4 += b"\xff\xe4" + struct.pack(">H", len(content) + 2) \
                + content
            first = False
    return head + app4 + scan, payloads, head + scan


def dvb_display_sets(n_sets, step_ns, seed=31):
    """n_sets seeded DVB subtitle display sets (ETSI EN 300 743 segments,
    one PES payload each) every step_ns: two regions each, a 4-bit one
    with a 16-entry CLUT and an 8-bit one with a 256-entry CLUT, pixel
    by pixel codes of seeded colours.  -> [(payload, pts_ns)]."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def seg(stype, payload):
        return bytes([0x0F, stype, 0, 1, len(payload) >> 8,
                      len(payload) & 0xFF]) + payload

    def region(rid, w, h, depth, clut_id, oid):
        exp = {4: 2, 8: 3}[depth]
        return seg(0x11, bytes([rid, 1 << 3, w >> 8, w & 0xFF, h >> 8,
                                h & 0xFF, exp << 2, clut_id, 0, 0,
                                oid >> 8, oid & 0xFF, 0, 0, 0, 0]))

    def obj(oid, rows, depth):
        code = 0x11 if depth == 4 else 0x12
        end = [(0, 4), (0, 4)] if depth == 4 else [(0, 8), (0, 1), (0, 7)]
        fields = []
        for parity in (0, 1):
            lines = [bytes([code]) + _bits([(int(c), depth) for c in r]
                                           + end)
                     for r in rows[parity::2]]
            fields.append(b"\xf0".join(lines) + b"\xf0")
        top, bot = fields
        return seg(0x13, bytes([oid >> 8, oid & 0xFF, 0, len(top) >> 8,
                                len(top) & 0xFF, len(bot) >> 8,
                                len(bot) & 0xFF]) + top + bot)

    def clut(clut_id, flag, n):
        body = bytearray([clut_id, 0])
        for e in range(1, n):
            y, cr, cb = rng.integers(32, 236, 3)
            body += bytes([e, flag | 1, int(y), int(cr), int(cb),
                           int(rng.integers(0, 160))])
        return seg(0x12, bytes(body))

    out = []
    for i in range(n_sets):
        w4, h4 = 360 + 8 * (i % 5), 36
        w8, h8 = 240, 24
        rows4 = rng.integers(1, 16, (h4, w4))
        rows8 = rng.integers(1, 256, (h8, w8))
        x4, y4 = 80 + 10 * i, 460
        x8, y8 = 300, 40 + 6 * i
        pes = (b"\x20\x00"
               + seg(0x10, bytes([3, 0, 1, 0, x4 >> 8, x4 & 0xFF, y4 >> 8,
                                  y4 & 0xFF, 2, 0, x8 >> 8, x8 & 0xFF,
                                  y8 >> 8, y8 & 0xFF]))
               + region(1, w4, h4, 4, 0, 7) + region(2, w8, h8, 8, 1, 8)
               + clut(0, 0x40, 16) + clut(1, 0x20, 256)
               + obj(7, rows4, 4) + obj(8, rows8, 8) + seg(0x80, b"")
               + b"\xff")
        out.append((pes, i * step_ns))
    return out


def spu_packets(n, step_ns, w=400, h=60, seed=32):
    """n seeded VobSub subpicture packets every step_ns, each a w x h
    picture of four-colour runs at a seeded place, shown at once and
    hidden after 90 ticks (1.05 s).  -> [(packet, pts_ns, clut)]."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def rle(run, colour):
        code = (run << 2) | colour
        if run == 0:
            return [0, 0, 0, colour]
        for lim, k in ((0x10, 1), (0x100, 2), (0x1000, 3)):
            if code < lim:
                return [(code >> (4 * s)) & 0xF for s in range(k - 1, -1, -1)]
        return [(code >> (4 * s)) & 0xF for s in range(3, -1, -1)]

    def field(rows):
        nibs = []
        for r in rows:
            ln, x = [], 0
            while x < w:
                run = min(int(rng.integers(2, 40)), w - x)
                ln += rle(run, int(rng.integers(0, 4)))
                x += run
            nibs += ln + [0] * (len(ln) % 2)
        nibs += [0] * (len(nibs) % 2)
        return bytes((nibs[i] << 4) | nibs[i + 1]
                     for i in range(0, len(nibs), 2))

    out = []
    for i in range(n):
        top, left = int(rng.integers(8, 400)), int(rng.integers(8, 300))
        topf, botf = field(range(0, h, 2)), field(range(1, h, 2))
        pix0, pix1 = 4, 4 + len(topf)
        dcsqt = pix1 + len(botf)
        right, bottom = left + w - 1, top + h - 1
        cmds = bytes([0x03, 0x01, 0x23, 0x04, 0xFF, 0xF0, 0x05, left >> 4,
                      ((left & 0xF) << 4) | (right >> 8), right & 0xFF,
                      top >> 4, ((top & 0xF) << 4) | (bottom >> 8),
                      bottom & 0xFF, 0x06, pix0 >> 8, pix0 & 0xFF,
                      pix1 >> 8, pix1 & 0xFF, 0x01, 0xFF])
        dcsq2 = dcsqt + 4 + len(cmds)
        pkt = bytearray(b"\x00\x00" + bytes([dcsqt >> 8, dcsqt & 0xFF]))
        pkt += topf + botf + bytes([0, 0, dcsq2 >> 8, dcsq2 & 0xFF]) + cmds
        pkt += bytes([0, 90, dcsq2 >> 8, dcsq2 & 0xFF, 0x02, 0xFF])
        pkt[0], pkt[1] = len(pkt) >> 8, len(pkt) & 0xFF
        clut = rng.integers(0, 1 << 24, 16).astype(np.uint32)
        out.append((bytes(pkt), i * step_ns, clut))
    return out


def cea708_feeds(n, step_ns):
    """cc_data feeds that rewrite a DTVCC caption window every step_ns
    (window 0 defined once, then new text, a colour change and a
    flusher each time).  -> [(cc_data, pts_ns)]."""
    from gstbad_tpu_torch.io import cea708 as C

    def cc(payload):
        blk = bytes([(1 << 5) | len(payload)]) + payload
        if len(blk) % 2 == 0:
            blk += b"\x00"
        pkt = bytes([(len(blk) + 1) // 2]) + blk
        pkt += b"\x00" * (len(pkt) % 2)
        return b"".join(bytes([0x04 | (3 if i == 0 else 2), pkt[i],
                               pkt[i + 1]]) for i in range(0, len(pkt), 2))

    df0 = bytes([C.CMD_DF0, 0x20, 60, 40, 0x01, 31, 0])
    out = []
    for i in range(n):
        text = f"CAPTION {i:02d} PORT".encode()
        body = (df0 if i == 0 else bytes([C.CMD_CLW, 0x01])) + bytes(
            [C.CMD_SPC, 0x20 + (i % 3) * 8, 0x00, 0x00]) + text + b"\x03"
        out.append((cc(body), i * step_ns))
        out.append((cc(b"\x03"), i * step_ns + 1))
    return out


def ass_script(n_events=16, seed=33):
    """An ASS script at 1920x1080 with two styles and n_events seeded
    events of 0.4-1.2 s, some overlapping."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = ["[Script Info]", "PlayResX: 1920", "PlayResY: 1080", "",
             "[V4+ Styles]",
             "Format: Name, Fontname, Fontsize, PrimaryColour, "
             "OutlineColour, BackColour, Bold, Italic, Outline, Alignment, "
             "MarginL, MarginR, MarginV",
             "Style: Default,Arial,64,&H00FFFFFF,&H00000000,&H80000000,0,0,"
             "3,2,40,40,60",
             "Style: Sign,Arial,48,&H0000FFFF,&H00202020,&H80000000,1,0,2,8,"
             "40,40,30", "", "[Events]",
             "Format: Layer, Start, End, Style, Name, MarginL, MarginR, "
             "MarginV, Effect, Text"]

    def ts(ms):
        return (f"{ms // 3600000}:{ms // 60000 % 60:02d}:"
                f"{ms // 1000 % 60:02d}.{ms // 10 % 100:02d}")

    for i in range(n_events):
        start = int(i * 260 + rng.integers(0, 120))
        end = start + int(rng.integers(400, 1200))
        style = "Sign" if i % 3 == 0 else "Default"
        lines.append(f"Dialogue: 0,{ts(start)},{ts(end)},{style},,0,0,0,,"
                     f"Line {i} of the port\\Nsubtitle test {seed + i}")
    return "\n".join(lines) + "\n"


def imsc_document(n=8):
    """An IMSC (TTML) document of n paragraphs, 0.5 s apart and 0.8 s
    long, in two regions."""
    def clock(ms):
        return f"00:00:{ms // 1000:02d}.{ms % 1000:03d}"

    ps = "".join(
        f'<p region="{"r_bottom" if i % 2 == 0 else "r_top"}" '
        f'style="s_white" begin="{clock(500 * i)}" '
        f'end="{clock(500 * i + 800)}">Paragraph {i} '
        '<span style="s_yellow">of the port</span></p>' for i in range(n))
    return ('<?xml version="1.0" encoding="UTF-8"?>\n'
            '<tt xmlns="http://www.w3.org/ns/ttml" '
            'xmlns:tts="http://www.w3.org/ns/ttml#styling" '
            'xmlns:ttp="http://www.w3.org/ns/ttml#parameter" '
            'ttp:cellResolution="40 24" xml:lang="en"><head><styling>'
            '<style xml:id="s_white" tts:color="#FFFFFF" tts:fontSize="100%" '
            'tts:backgroundColor="#000000AA" tts:textAlign="center"/>'
            '<style xml:id="s_yellow" tts:color="#FFFF00"/></styling><layout>'
            '<region xml:id="r_bottom" tts:origin="10% 80%" '
            'tts:extent="80% 15%" tts:displayAlign="after"/>'
            '<region xml:id="r_top" tts:origin="10% 5%" tts:extent="80% 15%"'
            '/></layout></head><body><div>' + ps + '</div></body></tt>')


def teletext_packets(n_pages=4):
    """Teletext PES payloads (EN 300 472 data units) of n_pages
    subpages of page 100, each completed by the next header."""
    from gstbad_tpu_torch.io import teletext as tt

    def unit(line42, line_no):
        return bytes([0x02, 44, 0x20 | line_no, 0xE4]) + bytes(
            tt.rev8(b) for b in line42)

    out = []
    for sub in range(n_pages + 1):
        pkt = unit(tt.build_header(1, 0, 0, subno=sub), 7)
        if sub < n_pages:
            pkt += unit(tt.build_row(1, 2, f"  PAGE {sub} NEWS".encode()),
                        8)
            pkt += unit(tt.build_row(1, 20, b"\x03SUBTITLE ROW"), 9)
        out.append(pkt)
    return out


def overlay_libraries() -> dict:
    """Which of the host libraries the text and SVG paths render with
    load here: {"pango": bool, "rsvg": bool, "PIL": bool}."""
    from gstbad_tpu_torch.io import pangocairo, rsvg
    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    return {"pango": pangocairo.available(), "rsvg": rsvg.available(),
            "PIL": pil}


def overlay_paths(gtt, libs, tmp):
    """The paths of phase 4h: {key: (build(device, small) -> Pipeline,
    feed(pipeline, n_windows, small), window, windows of the counted run,
    clock, H4 launches a window, H1 launches a window)}.  Paths whose
    library does not load here are left out (overlay_slice reports them).
    Inputs render before negotiation in build (scripts, documents,
    display sets); feed pushes the video."""
    import numpy as np
    from gstbad_tpu_torch.elements.video.qroverlay import DebugQrOverlay
    W_, H_ = W, H
    win = WINDOW_OVERLAY
    dur = 10 ** 9 * 1001 // 30000     # 29.97 frames/s

    def size(small, w=W_, h=H_):
        return OVERLAY_SMALL if small else (w, h)

    def base(n, w, h, c, seed):
        frame = np.random.default_rng(seed).integers(
            0, 256, (h, w, c), dtype=np.uint8)
        return np.broadcast_to(frame, (n, h, w, c))

    def app(fmt, w, h, name="src", rate="30000/1001"):
        return (f"appsrc name={name} format={fmt} width={w} height={h} "
                f"framerate={rate}")

    def video(fmt, el, setup=None, w=W_, h=H_, c=4, seed=40):
        def build(d, small=False):
            ws, hs = size(small, w, h)
            # debugqroverlay's JSON names its instance: number each
            # pipeline's from 0, so the card's and the CPU's symbols agree
            DebugQrOverlay._instances = 0
            p = gtt.parse_launch(f"{app(fmt, ws, hs)} ! {el} name=el "
                                 "! fakesink", device=d)
            if setup:
                setup(p.get_by_name("el"))
            return p

        def feed(p, n, small=False):
            ws, hs = size(small, w, h)
            p.get_by_name("src").push_frames(
                base(n * (8 if small else win), ws, hs, c, seed))
        return build, feed, win, 2, "device"

    sets = dvb_display_sets(8, int(0.8 * SEC))
    spus = spu_packets(6, int(0.7 * SEC))
    feeds = cea708_feeds(8, 16 * dur)
    script, doc = ass_script(), imsc_document()

    def push_all(method, items):
        def setup(el):
            for it in items:
                getattr(el, method)(*it)
        return setup

    paths = {}
    paths["dvbsub_1080p"] = video("AYUV", "dvbsuboverlay",
                                  push_all("push_pes", sets)) + (1, 0)
    paths["dvdspu_720x480"] = video("AYUV", "dvdspu",
                                    push_all("push_spu", spus), 720,
                                    480) + (1, 0)
    paths["cea708_1080p"] = video("AYUV", "ceaccoverlay face=fixed",
                                  push_all("push_cc", feeds)) + (1, 0)
    if libs["pango"]:
        paths["cea708_pango_1080p"] = video(
            "AYUV", "ceaccoverlay face=pango",
            push_all("push_cc", feeds)) + (1, 0)
    paths["assrender_1080p"] = video(
        "BGRx", "assrender face=fixed",
        lambda el: el.push_script(script)) + (1, 0)
    paths["ttmlrender_1080p"] = video(
        "BGRx", "ttmlrender", lambda el: el.push_ttml(doc)) + (1, 0)
    paths["qroverlay_1080p"] = video(
        "BGRx", 'qroverlay data="gstbad port qroverlay 1080p" '
        "pixel-size=6") + (1, 0)
    paths["debugqroverlay_1080p"] = video(
        "BGRx", "debugqroverlay max-frames=8 pixel-size=4 "
        "extra-data-name=K extra-data-array=a,b,c "
        "extra-data-interval-buffers=4") + (1, 0)
    if libs["rsvg"]:
        logo = os.path.join(tmp, "logo.svg")
        with open(logo, "w") as f:
            f.write(LOGO_SVG)
        paths["rsvgoverlay_1080p"] = video(
            "BGRA", f"rsvgoverlay location={logo} x=1600 y=40") + (1, 0)
    # faceoverlay on phase 4g's face frames: H1 once a pyramid scale; the
    # overlay an SVG where librsvg loads, else a PNG where PIL does, else
    # none (detection only)
    face_el = f"faceoverlay profile={ALT2}"
    if libs["rsvg"]:
        face_el += f" location={os.path.join(tmp, 'logo.svg')}"
    elif libs["PIL"]:
        from PIL import Image
        rgba = np.zeros((96, 80, 4), np.uint8)
        rgba[..., 0], rgba[..., 2] = 255, 64
        rgba[..., 3] = np.linspace(40, 230, 80).astype(np.uint8)[None, :]
        face_el += f" location={os.path.join(tmp, 'face.png')}"
        Image.fromarray(rgba, "RGBA").save(os.path.join(tmp, "face.png"))

    def face_build(d, small=False):
        w, h = DETECT_SMALL if small else (DETECT_W, DETECT_H)
        return gtt.parse_launch(f"{app('RGBx', w, h)} ! {face_el} "
                                "! fakesink", device=d)

    def face_feed(p, n, small=False):
        w, h = DETECT_SMALL if small else (DETECT_W, DETECT_H)
        rgb = face_frames(n * (2 if small else WINDOW_FACE), w, h)
        p.get_by_name("src").push_frames(np.concatenate(
            [rgb, np.zeros(rgb.shape[:3] + (1,), np.uint8)], -1))
    from gstbad_tpu_torch.ops.haar import pack
    from gstbad_tpu_torch.io.haarcascade import parse_cascade
    alt2 = pack(parse_cascade(ALT2), "arrays")
    paths["faceoverlay_720p"] = (face_build, face_feed, WINDOW_FACE, 2,
                                 "device", 0,
                                 n_scales(DETECT_H, DETECT_W, alt2.window,
                                          1.25))

    # cccombiner ! line21encoder ! line21decoder ! ccextractor, 720x525
    def l21_build(d, small=False):
        return gtt.parse_launch(
            f"{app('I420', 720, 525, 'v')} ! m.  "
            f"{app('I420', 6, 1, 'c')} ! m.  cccombiner name=m "
            "! line21encoder ! line21decoder ! ccextractor "
            "remove-caption-meta=true ! fakesink", device=d)

    def l21_feed(p, n, small=False):
        rng = np.random.default_rng(44)
        k = n * (8 if small else win)
        ch = 263
        p.get_by_name("v").push_frames({
            "y": base(k, 720, 525, 1, 45)[..., 0],
            "u": base(k, 360, ch, 1, 46)[..., 0],
            "v": base(k, 360, ch, 1, 47)[..., 0]})
        cc = np.zeros((k, 6), np.uint8)
        par = lambda v: v | (0x80 * (bin(v).count("1") % 2 == 0))  # noqa
        for i in range(k):
            a, b, c, d = rng.integers(0x20, 0x7F, 4)
            cc[i] = [0x80, par(a), par(b), 0x00, par(c), par(d)]
        p.get_by_name("c").push_frames(cc)
    paths["line21_525"] = (l21_build, l21_feed, win, 2, "device", 0, 0)

    # ccconverter: CDP at 29.97 frames/s to cc_data at 59.94, the host
    # walk timed by the host clock around run()
    from gstbad_tpu_torch.io import cea608

    def cdp_frames(k):
        rng = np.random.default_rng(48)
        rows = []
        for i in range(k):
            ccd = bytes([0xFC, *rng.integers(0x20, 0x7F, 2), 0xFD,
                         *rng.integers(0x20, 0x7F, 2)]) + b"".join(
                bytes([0xFE, *rng.integers(0, 256, 2)]) for _ in range(4))
            rows.append(np.frombuffer(cea608.cc_data_to_cdp(
                ccd, (30000, 1001), sequence=i), np.uint8))
        return np.stack(rows)

    def cc_build(d, small=False):
        return gtt.parse_launch(
            f"{app('I420', 73, 1, 'c')} ! ccconverter input-type=cdp "
            "output-type=cc-data output-framerate=60000/1001 ! fakesink",
            device=d)

    def cc_feed(p, n, small=False):
        p.get_by_name("c").push_frames(cdp_frames(n * (8 if small else win)))
    paths["ccconverter_cdp"] = (cc_build, cc_feed, win, 2, "host", 0, 0)
    return paths


def host_element_checks(gtt, libs):
    """dvbsubenc, ttmlparse, teletextdec and rsvgdec (host elements) on
    the card against the CPU port: frames, pts, valid and messages.
    -> {name: messages}."""
    import numpy as np
    out = {}

    def both(name, build, feed=None, n=None, window=8, posts=True):
        res = {}
        for d in ("cuda", "cpu"):
            p = build(d)
            p.negotiate()
            if feed:
                feed(p)
            res[d] = (p.run(n_frames=n, window=window) if n
                      else p.run(window=window), bus_messages(p))
        batches_close(name, res["cuda"][0], res["cpu"][0])
        messages_close(name, res["cuda"][1], res["cpu"][1])
        if posts and not res["cpu"][1]:
            fail(f"{name}: no bus messages")
        out[name] = len(res["cpu"][1])

    imgs = np.zeros((16, 576, 720, 4), np.uint8)
    for i in range(0, 16, 3):
        imgs[i, 460:520, 100 + 10 * i:500 + 10 * i] = [255, 200, 128 + i,
                                                       128]
    both("dvbsubenc", lambda d: gtt.parse_launch(
        "appsrc name=s format=AYUV width=720 height=576 framerate=25/1 "
        "! dvbsubenc ! fakesink", device=d),
        lambda p: p.get_by_name("s").push_frames(imgs))
    doc = imsc_document()

    def ttml_build(d):
        p = gtt.parse_launch("videotestsrc pattern=ball width=64 height=48 "
                             "format=RGBx ! ttmlparse name=t ! fakesink",
                             device=d)
        p.get_by_name("t").push_ttml(doc)
        return p
    both("ttmlparse", ttml_build, n=8)

    def tt_build(d):
        p = gtt.parse_launch("teletextdec name=t page=100 ! fakesink",
                             device=d)
        for pkt in teletext_packets():
            p.get_by_name("t").push_packet(pkt)
        return p
    both("teletextdec", tt_build, window=2)
    if libs["rsvg"]:
        def svg_build(d):
            p = gtt.parse_launch("rsvgdec name=r ! fakesink", device=d)
            p.get_by_name("r").push_data((LOGO_SVG * 3).encode())
            return p
        both("rsvgdec", svg_build, window=2, posts=False)
    return out


def overlay_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4h: overlay and the text renderers (dvbsuboverlay, dvdspu,
    ceaccoverlay, assrender, ttmlrender, qroverlay, debugqroverlay,
    rsvgoverlay, faceoverlay; the line-21 and ccconverter caption paths;
    the host elements).

    H4 (overlay_blend) against its plain version on the card at ragged
    shapes in every mode (C = 1, 3 and 4, odd sizes, 1-3 layers that
    overlap, strided and shifted planes); then each path of overlay_paths
    through parse_launch at full width, the launch counts set to 0 just
    before its counted run and read just after (H4 once a window where
    the path composites, H1 once a pyramid scale for faceoverlay, every
    other count 0), its peak device memory and frames/s (median of 5),
    and the same graph at OVERLAY_SMALL on the card against the CPU port
    (frames, pts, valid and messages equal); the host elements the same
    way; then H4 against its plain version on every launch each path
    made, timed on dvbsub_1080p's and assrender_1080p's.  Returns
    {"step_ms", "times", "bounds"} as cv_detect_slice does."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gstbad_tpu_torch.ops import overlay as ovops

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(51)
    libs = overlay_libraries()
    log("overlay libraries here: " + ", ".join(
        f"{k} {'loads' if v else 'missing'}" for k, v in libs.items())
        + "; not run for want of one: " + (", ".join(
            k for k, need in (("cea708_pango_1080p", "pango"),
                              ("rsvgoverlay_1080p", "rsvg"),
                              ("rsvgdec", "rsvg"))
            if not libs[need]) or "none")
        + " (faceoverlay's overlay is an SVG through librsvg, else a PNG "
          "through PIL, else none: it then detects and posts only)")

    def note(e):
        err["overlay_blend"] = max(err["overlay_blend"], e)

    def check(args, kw):
        got = ovops.overlay_blend(*args, **kw)
        want = ovops.overlay_blend_plain(*args, **kw)
        note(max_abs_err(got, want))

    # H4 at ragged shapes, every mode
    n_cases = 0
    for mode in ovops.MODES:
        for c, (h, w), n_l in ((4, (5, 7), 1), (3, (13, 17), 3),
                               (4, (67, 129), 2), (3, (1, 1), 2),
                               (1, (9, 31), 3), (4, (1080, 1921), 3)):
            b, k = (3 if h > 500 else 5), 4
            frames = torch.from_numpy(rng.integers(
                0, 256, (b, h, w, c), dtype=np.uint8)).to(dev)
            bank = torch.from_numpy(rng.integers(
                0, 256, (k, 2 * h + 1, 2 * w + 1, 4), dtype=np.uint8)).to(dev)
            layers = torch.from_numpy(rng.integers(
                -1, k, (b, n_l)).astype(np.int32)).to(dev)
            alpha = bank[:, ::2, ::2, 0][:, :h, :w]
            planes = [(bank[:, :h, :w, 1], 0), (bank[..., 2], 1),
                      (bank[:, 1::2, 1::2, 3], 0)]
            if c == 1:
                chan = (int(rng.integers(0, 3)),)
            elif c == 3:
                chan = (2, 0, 3 if mode == "cairo_over" else 1)
            else:
                chan = (3 if mode == "cairo_over" else None, 1, 0, 2)
            ac = 0 if mode == "shr8_rgb_alpha" and c == 4 else None
            check((frames, alpha, planes, layers, chan, mode),
                  {"alpha_chan": ac})
            n_cases += 1
    torch.cuda.synchronize()
    log(f"overlay_blend at ragged shapes: {n_cases} cases in "
        f"{len(ovops.MODES)} modes, max_abs_err {err['overlay_blend']}")
    if err["overlay_blend"]:
        fail("overlay_blend disagrees with its plain version")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_overlay_")
    try:
        paths = overlay_paths(gtt, libs, tmp)
        step_ms = {}
        for key, (build, feed, window, n_windows, clock, h4, h1) in \
                paths.items():
            t0 = time.perf_counter()
            pipe = build("cuda")
            pipe.negotiate()
            feed(pipe, n_windows)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for c in counters.values():
                c.launches = 0
            got = pipe.run(n_frames=n_windows * window, window=window)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            delta = {k: c.launches for k, c in counters.items()}
            need = {"overlay_blend": h4, "haar_cascade": h1}
            for k, c in delta.items():
                if c != need.get(k, 0) * n_windows:
                    fail(f"{key}: {k} launched {c} times in {n_windows} "
                         f"windows ({need.get(k, 0)} a window expected)")
            for k in launches:
                launches[k] += delta[k]
            t_card = time.perf_counter() - t0
            n_out = sum(int(np.asarray(b.valid).sum()) for b in got)
            if not n_out:
                fail(f"{key}: no frames out")
            n_msgs = len(pipe.bus.messages)
            # the same graph at OVERLAY_SMALL, card against the CPU port
            t0 = time.perf_counter()
            outs = {}
            for d in ("cuda", "cpu"):
                p = build(d, True)
                p.negotiate()
                feed(p, 1, True)
                outs[d] = (p.run(window=8 if window > 8 else window),
                           bus_messages(p))
            worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                                 outs["cpu"][0])
            messages_close(key, outs["cuda"][1], outs["cpu"][1])
            t_cpu = time.perf_counter() - t0
            med, all_runs = fps_runs(build, window, feed=feed, clock=clock,
                                     n_steps=10 if clock == "device" else 2)
            step_ms[key] = (window * 1000.0 / med, window)
            log(f"{key}: launches {delta}; {n_windows} windows of {window}, "
                f"{n_out} frames out, {n_msgs} bus messages; at the small "
                f"size the card equals the CPU port ({total} values, "
                f"{len(outs['cpu'][1])} messages); peak device memory "
                f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB "
                f"above the {held / 2**20:.1f} MiB held before the run); "
                f"counted run {t_card:.2f} s, card-against-CPU check "
                f"{t_cpu:.2f} s")
            how = ("device step, 10 steps a run, 4 where a step takes "
                   "50 ms or more" if clock == "device" else
                   "host clock around run(), 2 windows a run")
            log(f"fps {key} window {window}: median {med:.2f} source "
                f"frames/s of {[round(x, 2) for x in all_runs]}, step "
                f"{step_ms[key][0]:.3f} ms ({how}; {card})")
        hosts = host_element_checks(gtt, libs)
        log(f"host elements on the card equal the CPU port: {hosts} "
            "messages" + ("; rsvgdec's frames too" if libs["rsvg"] else ""))

        # H4 on every launch each compositing path made in one step
        inputs = {}
        for key, (build, feed, window, _, _, h4, _) in paths.items():
            if not h4:
                continue
            p = build("cuda")
            batch = fed_input(p, feed, window)
            step = p.compile(window)
            store = inputs[key] = {}
            undo = capture(ovops, "overlay_blend", store)
            try:
                step(p.params(), p.init_states(window), batch)
                torch.cuda.synchronize()
            finally:
                undo()
            for args, kw in store.get("overlay_blend", []):
                check(args, kw)
        n_calls = sum(len(s.get("overlay_blend", [])) for s in
                      inputs.values())
        log(f"overlay_blend on its main paths' inputs: {n_calls} launches, "
            f"max_abs_err {err['overlay_blend']}")
        if err["overlay_blend"]:
            fail("overlay_blend disagrees with its plain version on the "
                 "main paths' inputs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # times and bounds on dvbsub_1080p's and assrender_1080p's launches
    sm_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = n_sm * INT32_LANES * sm_hz
    times, bounds = {}, {}
    for label, key in (("overlay_blend", "dvbsub_1080p"),
                       ("overlay_blend_assrender", "assrender_1080p")):
        (args, kw), = inputs[key]["overlay_blend"][:1]
        frames, alpha, planes, layers, chan = args[:5]
        times[label] = (
            cuda_ms(lambda: ovops.overlay_blend(*args, **kw)),
            cuda_ms(lambda: ovops.overlay_blend_plain(*args, **kw),
                    iters=3, warmup=1), None)
        b, h, w, c = frames.shape
        used = torch.unique(layers[layers >= 0]).numel()
        active = int((layers >= 0).sum())
        n_src = sum(j is not None for j in chan)
        nbytes = (2 * frames.numel() + layers.numel() * 4
                  + used * h * w * (1 + len(planes)))
        # per active (pixel, layer): the index and alpha loads, then a
        # load and about 6 integer operations for each blended byte
        ops = active * h * w * (2 + 7 * n_src)
        bounds[label] = bound(nbytes, ops, int32_per_s)
        log(f"{label} on {key}'s window {tuple(frames.shape)}, layers "
            f"{tuple(layers.shape)} ({active} set, {used} bank entries): "
            f"{nbytes} bytes, {ops} operations")
    log(f"overlay_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "times": times, "bounds": bounds}


WINDOW_4I = 64                  # phase 4i's window
CHECK_4I = 16                   # its card-against-CPU checks' (CPU time)
NETSIM_1080P = (f"videotestsrc pattern=ball width={W} height={H} "
                "format=BGRx framerate=30/1 ! netsim max-kbps=1500000 "
                "max-bucket-size=200000 drop-packets=3 drop-probability={} "
                "duplicate-probability={} delay-probability={} "
                "delay-distribution=gamma min-delay=20 max-delay=80 "
                "allow-reordering=false ! fakesink")


def i420_frames(n, seed=61):
    """n seeded I420 frames of W x H, {plane: [n, ...]} (uint8)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w, h = W, H
    return {"y": rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            "u": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            "v": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)}


def deferred_paths(gtt):
    """The paths of phase 4i: {key: (build(device) -> Pipeline, feed(p,
    n_windows) or None, n_windows of the counted run, clock, H5 launches
    a window)}."""
    import numpy as np

    def launch(desc):
        return lambda device: gtt.parse_launch(desc, device=device)

    raw = []

    def push_raw(p, n, frames=WINDOW_4I):
        """n times the first `frames` of 64 seeded frames, as raw I420
        bytes."""
        if not raw:
            planes = i420_frames(WINDOW_4I)
            raw.append(b"".join(planes[k][i].tobytes()
                                for i in range(WINDOW_4I)
                                for k in ("y", "u", "v")))
        p.get_by_name("vp").push_bytes(raw[0][:frames * W * H * 3 // 2]
                                       * n)

    return {
        # a receiver's jitter buffer tested against a constrained, lossy
        # link: 66355 Kb frames against 50000 Kb of tokens a frame interval
        "netsim_1080p": (launch(NETSIM_1080P.format(0.02, 0.05, 0.2)),
                         None, 2, "device", 1),
        "speed_48k": (launch(
            "audiotestsrc wave=sine format=F32 rate=48000 channels=2 "
            f"samplesperbuffer={AUDIO_BLOCK} ! speed speed=1.5 ! fakesink"),
            None, 2, "device", 0),
        "timecode_1080p_2997df": (launch(
            f"videotestsrc width={W} height={H} framerate=30000/1001 "
            "! timecodestamper drop-frame=true ! fakesink"),
            None, 2, "device", 0),
        "videoparse_1080p": (launch(
            f"videoparse name=vp format=I420 width={W} height={H} "
            "framerate=30/1 ! videoconvert format=BGRx ! checksumsink "
            "name=c"), push_raw, 2, "host", 0),
        "autovideoconvert_1080p": (launch(
            f"videotestsrc pattern=ball width={W} height={H} format=I420 "
            "! autovideoconvert ! videoconvert format=BGRx ! solarize "
            "! fakesink"), None, 2, "device", 0),
    }


def deferred_host_checks(gtt, tmp):
    """The host elements of phase 4i at small sizes, each on the card
    against the CPU port: aesenc -> aesdec, id3mux, pnmenc/pnmdec,
    aiffparse, aifffilesrc ! aifffilesink, accurip, uvch264mjpgdemux,
    switchbin, watchdog, clockselect and jaxfilter.  -> {name: what was
    compared}."""
    import numpy as np
    import torch
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.io import aiff
    rng = np.random.default_rng(71)
    out = {}

    def on_both(make):
        res = {d: make(d) for d in ("cuda", "cpu")}
        return res["cuda"], res["cpu"]

    def el(name, device, **props):
        e = gtt.make(name, **props)
        e.device = torch.device(device)
        return e

    payload = rng.integers(0, 256, 20003, dtype=np.uint8).tobytes()
    key = "1f9423681beb9a79215820f6bda73d0f"
    iv = "e9aa8e834d8d70b7e0d254ff670dd718"

    def aes(d):
        """Two buffers, each padded, the IV in band before the first."""
        enc = el("aesenc", d, key=key, iv=iv, **{"serialize-iv": True})
        cts = [enc.chain(payload[:9000]), enc.chain(payload[9000:]),
               enc.finish()]
        dec = el("aesdec", d, key=key, iv=iv, **{"serialize-iv": True})
        return b"".join(cts), b"".join(
            [dec.chain(x) for x in cts if x] + [dec.finish()])
    a, b = on_both(aes)
    if a != b or a[1] != payload:
        fail("aesenc -> aesdec: the card's bytes differ from the CPU port's "
             "or the round trip does not return the payload")
    out["aes"] = f"{len(a[0])} bytes"

    def id3(d):
        mux = el("id3mux", d, **{"write-v1": True, "v2-version": 4})
        mux.set_tags(title="chip smoke", artist="seeded", date=2026,
                     **{"track-number": 7})
        mux.chain(payload[:4000])
        return mux.finish()
    a, b = on_both(id3)
    if a != b or a[:3] != b"ID3":
        fail("id3mux: the card's bytes differ from the CPU port's")
    out["id3mux"] = f"{len(a)} bytes"
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)

    def pnm(d):
        doc = el("pnmenc", d).chain(img)
        return doc, el("pnmdec", d).chain(doc)
    a, b = on_both(pnm)
    if a[0] != b[0] or not np.array_equal(a[1], img):
        fail("pnmenc/pnmdec: the card's differ from the CPU port's")
    out["pnm"] = f"{len(a[0])} bytes"
    # 47 blocks of 1024: the last window of 16 holds 15
    samples = rng.integers(-30000, 30000, (47 * 1024, 2)).astype(np.int16)
    src = os.path.join(tmp, "in.aiff")
    aiff.write_aiff(src, MediaSpec(kind="audio", format="S16", rate=48000,
                                   channels=2), samples)
    with open(src, "rb") as f:
        blob = f.read()

    def parse(d):
        p = el("aiffparse", d)
        p.chain(blob[:777])
        p.chain(blob[777:])
        return p.finish()
    a, b = on_both(parse)
    if a["caps"] != b["caps"] or not np.array_equal(a["data"], samples):
        fail("aiffparse: the card's differs from the CPU port's")

    def aiff_files(d):
        dst = os.path.join(tmp, f"out_{d}.aiff")
        p = gtt.parse_launch(f"aifffilesrc location={src} "
                             "samplesperbuffer=1024 ! identity ! "
                             f"aifffilesink location={dst}", device=d)
        res = p.run(window=16)
        p.close()
        with open(dst, "rb") as f:
            return res, f.read()
    a, b = on_both(aiff_files)
    batches_close("aifffilesrc", a[0], b[0])
    if a[1] != b[1] or not np.array_equal(aiff.read_aiff(a[1])[1], samples):
        fail("aifffilesink: the card's file differs from the CPU port's or "
             "from the input")
    out["aiff"] = f"{len(a[1])} bytes"

    def accurip(d):
        p = gtt.parse_launch("appsrc name=s kind=audio format=S16 rate=44100 "
                             "channels=2 ! accurip name=a ! fakesink",
                             device=d)
        p.get_by_name("s").push_frames(samples[:47040].reshape(80, 588, 2))
        p.run(window=16)
        e = p.get_by_name("a")
        return e.crc, e.crc_v2
    a, b = on_both(accurip)
    if a != b or not a[0]:
        fail(f"accurip: CRCs {a} on the card, {b} on the CPU port")
    out["accurip"] = f"v1 {a[0]:08x} v2 {a[1]:08x}"
    frame, payloads, bare = uvc_mjpeg(43, 3, 700)
    a, b = on_both(lambda d: el("uvch264mjpgdemux", d).chain(frame, 10**9))
    if a != b or a["jpeg"] != bare or [(x["fourcc"], x["data"])
                                       for x in a["aux"]] != payloads:
        fail("uvch264mjpgdemux: the card's differs from the CPU port's or "
             "from the fixture's payloads")
    out["uvch264mjpgdemux"] = f"{len(a['aux'])} payloads"
    graphs = {
        "switchbin": "videotestsrc pattern=ball width=320 height=240 "
                     "format=GRAY8 ! switchbin paths=\"video/x-raw,"
                     "format=GRAY8 : zebrastripe threshold=90 ; ANY : "
                     "identity\" ! fakesink",
        "watchdog_clockselect": "videotestsrc pattern=ball width=320 "
                                "height=240 ! watchdog name=w timeout=600000 "
                                "! clockselect name=k clock-id=monotonic "
                                "! fakesink",
        "jaxfilter": "videotestsrc pattern=ball width=320 height=240 "
                     "format=BGRx ! fakesink"}
    for name, desc in graphs.items():
        res = {}
        for d in ("cuda", "cpu"):
            p = gtt.parse_launch(desc, device=d)
            if name == "jaxfilter":
                p.insert_after("videotestsrc", gtt.make(
                    "jaxfilter", fn=lambda x: 255 - x))
            res[d] = p.run(n_frames=8, window=4)
            if name == "watchdog_clockselect":
                p.get_by_name("w").check()
                if p.get_by_name("k").clock() is not time.monotonic:
                    fail("clockselect: clock-id=monotonic is not "
                         "time.monotonic")
        batches_close(name, res["cuda"], res["cpu"])
        out[name] = f"{sum(b.batch for b in res['cpu'])} frames"
    src = gtt.parse_launch(graphs["jaxfilter"], device="cpu").run(
        n_frames=8, window=4)
    if not all(np.array_equal(x.data, 255 - y.data)
               for x, y in zip(res["cuda"], src)):
        fail("jaxfilter: the card's frames are not 255 - the source's")
    return out


def deferred_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4i: what the runtime slice deferred and the small elements of
    begun modules (netsim, speed, timecodestamper, videoparse with
    checksumsink, the GDP transcode, autovideoconvert; the host elements).

    H5 (netsim_bucket) against its plain walk at ragged shapes; then each
    path of deferred_paths at full width, the launch counts set to 0 just
    before its counted run and read just after (H5 once a window on
    netsim_1080p, every other count 0), its peak device memory and
    frames/s (median of 5; the host clock around run() where the host
    hashes), and the card against the CPU port: netsim with its
    probabilities at 0 exactly, with them on the doubled window's frames
    and flags, H5's inputs (its bucket and counter) and valid within H5's
    keep; its gamma, normal and uniform delays on the card by a KS test
    against scipy.stats' draws; the rest exactly (frames, pts, valid,
    messages, checksums); transcode_gdp_1080p through the CLI (the .gdp
    bytes equal the CPU port's, the round trip back to y4m returns the
    input's bytes); then the host elements; then H5 on every launch the
    paths made, timed on netsim_1080p's.  Returns {"step_ms", "times",
    "bounds", "chains"}."""
    import shutil
    import tempfile

    import numpy as np
    import scipy.stats
    import torch
    from gstbad_tpu_torch.cli import transcode_main
    from gstbad_tpu_torch.core.spec import MediaSpec
    from gstbad_tpu_torch.io import y4m
    from gstbad_tpu_torch.ops import _cuda
    from gstbad_tpu_torch.ops import netsim as netsim_ops

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(81)

    def check_h5(args):
        got = netsim_ops.netsim_bucket(*args)
        want = netsim_ops.netsim_bucket_plain(*args)
        e = int(not (torch.equal(got[0].cpu(), want[0].cpu())
                     and torch.equal(got[1].cpu(), want[1].cpu())))
        err["netsim_bucket"] = max(err["netsim_bucket"], e)

    # H5 at ragged shapes: window lengths 0-200, the carry threaded through
    n_cases = 0
    for kbps, mbs, dropn, bits in ((1500000, 200000, 3, 66355200),
                                   (-1, 50, 0, 1536), (0, 40, 9, 1536),
                                   (45, -1, 2, 1536), (30, 5, 1, 1536),
                                   (2**31 - 1, 2**31 - 1, 0, 2**40)):
        carry = torch.tensor([mbs * 1000 if mbs > 0 else 0, -1, dropn],
                             device=dev)
        k = torch.tensor(kbps, dtype=torch.int32, device=dev)
        m = torch.tensor(mbs, dtype=torch.int32, device=dev)
        t = 0
        for n in (64, 1, 0, 200, 17):
            pts = t + np.cumsum(rng.integers(-20, 80, n) * 10**6)
            t = int(pts[-1]) if n else t
            args = (torch.from_numpy(pts.astype(np.int64)).to(dev),
                    torch.from_numpy(rng.random(n) < 0.8).to(dev), bits, k,
                    m, carry)
            check_h5(args)
            carry = netsim_ops.netsim_bucket_plain(*args)[1]
            n_cases += 1
    torch.cuda.synchronize()
    log(f"netsim_bucket at ragged shapes: {n_cases} windows, max_abs_err "
        f"{err['netsim_bucket']}")
    if err["netsim_bucket"]:
        fail("netsim_bucket disagrees with its plain version")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_deferred_")
    try:
        paths = deferred_paths(gtt)
        step_ms = {}
        for key, (build, feed, n_windows, clock, h5) in paths.items():
            t0 = time.perf_counter()
            pipe = build("cuda")
            pipe.negotiate()
            if feed is not None:
                feed(pipe, n_windows)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for c in counters.values():
                c.launches = 0
            got = pipe.run(n_frames=n_windows * WINDOW_4I, window=WINDOW_4I)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            delta = {k: c.launches for k, c in counters.items()}
            for k, c in delta.items():
                want = h5 * n_windows if k == "netsim_bucket" else 0
                if c != want:
                    fail(f"{key}: {k} launched {c} times in {n_windows} "
                         f"windows ({want} expected)")
            for k in launches:
                launches[k] += delta[k]
            t_card = time.perf_counter() - t0
            n_out = sum(int(np.asarray(b.valid).sum()) for b in got)
            if not n_out:
                fail(f"{key}: no frames out")
            # the card against the CPU port, one window of CHECK_4I
            t0 = time.perf_counter()
            outs = {}
            for d in ("cuda", "cpu"):
                p = build(d)
                p.negotiate()
                if feed is not None:
                    feed(p, 1, CHECK_4I)
                outs[d] = (p.run(n_frames=CHECK_4I, window=CHECK_4I),
                           bus_messages(p), p)
            if key != "netsim_1080p":
                worst, n_diff, total = batches_close(key, outs["cuda"][0],
                                                     outs["cpu"][0])
                messages_close(key, outs["cuda"][1], outs["cpu"][1])
                what = f"{total} values, {len(outs['cpu'][1])} messages"
            else:
                what = "pts after the delays not compared (random)"
            if key == "videoparse_1080p":
                sums = [outs[d][2].get_by_name("c").checksums
                        for d in ("cuda", "cpu")]
                if sums[0] != sums[1] or len(sums[0]) != CHECK_4I:
                    fail("videoparse_1080p: checksums differ from the CPU "
                         "port's")
                what += f", {len(sums[0])} checksums"
            if key == "timecode_1080p_2997df" and not outs["cpu"][1]:
                fail("timecode_1080p_2997df: no timecode messages")
            t_cpu = time.perf_counter() - t0
            med, all_runs = fps_runs(build, WINDOW_4I, feed=feed,
                                     clock=clock,
                                     n_steps=10 if clock == "device" else 2)
            step_ms[key] = (WINDOW_4I * 1000.0 / med, WINDOW_4I)
            log(f"{key}: launches {delta}; {n_windows} windows of "
                f"{WINDOW_4I}, {n_out} frames out, "
                f"{len(pipe.bus.messages)} bus messages; the card equals "
                f"the CPU port ({what}); peak device memory "
                f"{peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB "
                f"above the {held / 2**20:.1f} MiB held before the run); "
                f"counted run {t_card:.2f} s, card-against-CPU check "
                f"{t_cpu:.2f} s")
            how = ("device step, 10 steps a run, 4 where a step takes "
                   "50 ms or more" if clock == "device" else
                   "host clock around run(), 2 windows a run")
            log(f"fps {key} window {WINDOW_4I}: median {med:.2f} source "
                f"frames/s of {[round(x, 2) for x in all_runs]}, step "
                f"{step_ms[key][0]:.3f} ms ({how}; {card})")

        # netsim_1080p, deterministic parts: with its probabilities at 0
        # the card equals the CPU port exactly; with them, the doubled
        # window's frames and flags, H5's inputs (bucket, counter, carry)
        # and valid within H5's keep, over two windows
        t0 = time.perf_counter()
        res = {}
        for d in ("cuda", "cpu"):
            p = gtt.parse_launch(NETSIM_1080P.format(0, 0, 0), device=d)
            res[d] = p.run(n_frames=2 * WINDOW_4I, window=WINDOW_4I)
        batches_close("netsim_1080p at probability 0", res["cuda"],
                      res["cpu"])
        n_zero = sum(b.batch for b in res["cpu"])
        steps = {}
        for d in ("cuda", "cpu"):
            p = gtt.parse_launch(NETSIM_1080P.format(0.02, 0.05, 0.2),
                                 device=d)
            step = p.compile(WINDOW_4I)
            params, states = p.params(), p.init_states(WINDOW_4I)
            store = {}
            undo = capture(netsim_ops, "netsim_bucket", store)
            wins = []
            try:
                for wi in range(2):
                    states, leaves, _ = step(params, states, None)
                    b = leaves[0]
                    wins.append((b.data.cpu() if wi == 0 else None,
                                 b.flags.cpu(), b.valid.cpu()))
            finally:
                undo()
            steps[d] = (wins, store["netsim_bucket"])
        kept = 0
        for wi in range(2):
            (cd, cf, cv), (pd, pf, pv) = steps["cuda"][0][wi], \
                steps["cpu"][0][wi]
            (ca, _), (pa, _) = steps["cuda"][1][wi], steps["cpu"][1][wi]
            same_in = all(torch.equal(torch.as_tensor(x).cpu(),
                                      torch.as_tensor(y).cpu())
                          for x, y in zip(ca, pa))
            if not same_in or not torch.equal(cf, pf) or (
                    cd is not None and not torch.equal(cd, pd)):
                fail("netsim_1080p: H5's inputs, the flags or the frames "
                     "differ from the CPU port's")
            keep = netsim_ops.netsim_bucket_plain(*pa)[0].cpu()
            kept += int(keep.sum())
            for v in (cv, pv):
                b = WINDOW_4I
                if (v[:b] & ~keep).any() or (v[b:] & ~v[:b]).any():
                    fail("netsim_1080p: a frame the bucket dropped came out")
        # the delays on the card, against scipy.stats' draws of the same
        # distributions (rounded as the element rounds them)
        ks = {}
        ref_rng = np.random.default_rng(17)
        lo, hi = 20, 80
        for dist in ("gamma", "normal", "uniform"):
            e = gtt.make("netsim", **{"delay-distribution": dist,
                                      "min-delay": lo, "max-delay": hi})
            e.device = dev
            e.set_info(MediaSpec(kind="video", format="BGRx", width=W,
                                 height=H))
            gen = torch.Generator(device=dev).manual_seed(3)
            drawn = e._delay_ms((20000,), e.dynamic_params(), gen).cpu(
                ).numpy()
            if dist == "uniform":
                ref = scipy.stats.randint(lo, hi + 1).rvs(
                    20000, random_state=ref_rng)
            else:
                x = (scipy.stats.norm((lo + hi) / 2, (hi - lo) / 3.92)
                     if dist == "normal" else scipy.stats.gamma(
                         1.25, loc=lo, scale=(hi - lo) / 3.4640381)).rvs(
                    20000, random_state=ref_rng)
                ref = np.maximum(np.round(x), 0)
            ks[dist] = scipy.stats.ks_2samp(drawn, ref).pvalue
            if not ks[dist] > 1e-3:
                fail(f"netsim_1080p: the card's {dist} delays fail the KS "
                     f"test against scipy.stats (p {ks[dist]:.2e})")
        log(f"netsim_1080p: at probability 0 the card equals the CPU port "
            f"({n_zero} frames); with the probabilities H5's inputs, the "
            f"flags and the frames equal the CPU port's over 2 windows "
            f"({kept} frames the bucket and counter keep of "
            f"{2 * WINDOW_4I}); delays on the card against scipy.stats, KS "
            "p " + ", ".join(f"{k} {v:.3f}" for k, v in ks.items())
            + f" ({time.perf_counter() - t0:.2f} s)")

        # transcode_gdp_1080p: the CLI, y4m in and .gdp out on the card,
        # against the CPU port's bytes; then the .gdp back to y4m
        planes = i420_frames(WINDOW_4I, seed=62)
        i420 = MediaSpec(kind="video", format="I420", width=W, height=H)
        files = {k: os.path.join(tmp, f"{k}") for k in (
            "in.y4m", "card.gdp", "cpu.gdp", "back.y4m")}
        y4m.write_y4m(files["in.y4m"], i420, planes)
        for c in counters.values():
            c.launches = 0
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            transcode_main([files["in.y4m"], files["card.gdp"], "--profile",
                            "gdp", "--device", "cuda", "--window",
                            str(WINDOW_4I)])
            runs.append(WINDOW_4I / (time.perf_counter() - t0))
        if any(c.launches for c in counters.values()):
            fail("transcode_gdp_1080p: a kernel launched")
        transcode_main([files["in.y4m"], files["cpu.gdp"], "--profile",
                        "gdp", "--device", "cpu", "--window",
                        str(WINDOW_4I)])
        transcode_main([files["card.gdp"], files["back.y4m"], "--device",
                        "cuda", "--window", str(WINDOW_4I)])
        data = {}
        for k in files:
            with open(files[k], "rb") as f:
                data[k] = f.read()
        if data["card.gdp"] != data["cpu.gdp"]:
            fail("transcode_gdp_1080p: the card's .gdp differs from the CPU "
                 "port's")
        if data["back.y4m"] != data["in.y4m"]:
            fail("transcode_gdp_1080p: y4m -> gdp -> y4m does not return "
                 "the input's bytes")
        med = statistics.median(runs)
        step_ms["transcode_gdp_1080p"] = (WINDOW_4I * 1000.0 / med,
                                          WINDOW_4I)
        log(f"transcode_gdp_1080p: {WINDOW_4I} I420 frames {W}x{H} to a "
            f"{len(data['card.gdp'])}-byte .gdp through the CLI equal the "
            "CPU port's bytes; back to y4m gives the input's bytes")
        log(f"fps transcode_gdp_1080p window {WINDOW_4I}: median {med:.2f} "
            f"source frames/s of {[round(x, 2) for x in runs]} (host clock "
            f"around the CLI, end to end; {card})")

        hosts = deferred_host_checks(gtt, tmp)
        log("phase 4i host elements on the card equal the CPU port: "
            + "; ".join(f"{k} {v}" for k, v in hosts.items()))

        # H5 on every launch the paths made in one step
        inputs = []
        for key, (build, feed, _, _, h5) in paths.items():
            if not h5:
                continue
            p = build("cuda")
            store = {}
            undo = capture(netsim_ops, "netsim_bucket", store)
            try:
                step = p.compile(WINDOW_4I)
                step(p.params(), p.init_states(WINDOW_4I), None)
                torch.cuda.synchronize()
            finally:
                undo()
            inputs += store["netsim_bucket"]
        for args, kw in inputs:
            check_h5(args)
        log(f"netsim_bucket on its main path's inputs: {len(inputs)} "
            f"launches, max_abs_err {err['netsim_bucket']}")
        if err["netsim_bucket"] or not inputs:
            fail("netsim_bucket disagrees with its plain version on the "
                 "main path's inputs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # H5's time and bound on netsim_1080p's launch: the chain of its frames
    # walked in order, one dependent step each (gst_netsim_step_cycles on
    # registers); its bytes are a few hundred
    sm_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int32_per_s = n_sm * INT32_LANES * sm_hz
    args, _ = inputs[0]
    times = {"netsim_bucket": (
        cuda_ms(lambda: netsim_ops.netsim_bucket(*args)),
        cuda_ms(lambda: netsim_ops.netsim_bucket_plain(*args), iters=3,
                warmup=1), None)}
    probe = torch.zeros(2, dtype=torch.int64, device=dev)
    probe_steps = 1 << 16
    _cuda.launch("gst_netsim_step_cycles", probe, probe_steps)
    torch.cuda.synchronize()
    cycles = probe[0].item() / probe_steps
    n = args[0].numel()
    chains = {"netsim_bucket": n * cycles / sm_hz * 1e3}
    # pts read (8 bytes), valid (1) and keep written (1) a frame; the two
    # properties and the carry in and out.  About 30 int64 operations a
    # frame, each two INT32 instructions
    nbytes = 10 * n + 2 * 4 + 2 * 24
    bounds = {"netsim_bucket": bound(nbytes, 60 * n, int32_per_s,
                                     chains["netsim_bucket"])}
    log(f"netsim_bucket on netsim_1080p's window ({n} frames): {n} steps in "
        f"order x {cycles:.3f} cycles (probe, {probe_steps} steps) at "
        f"{sm_hz / 1e6:.0f} MHz = chain {chains['netsim_bucket']:.4f} ms; "
        f"{nbytes} bytes")
    log(f"deferred_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "times": times, "bounds": bounds,
            "chains": chains}


WINDOW_4J = 64                  # phase 4j's window
CHECK_4J = 16                   # its card-against-CPU checks: 2 windows
RATE_WINDOWS_4J = 10            # the Play paths' host-clock rate
SESSION_HEADLINE = launch_line("ball", HEAD + " ! zebrastripe")
SESSION_AUDIO = ("audiotestsrc wave=sine freq=440 "
                 f"samplesperbuffer={AUDIO_BLOCK} ! fakeaudiosink")
SESSION_CAMERA = (f"videotestsrc pattern=ball width={W} height={H} "
                  "format=AYUV")
# play_headline_1080p's colour balance (channel, value in [0, 1])
SESSION_BALANCE = (("hue", 0.6), ("saturation", 0.7), ("brightness", 0.55))
# phase 4j's device graphs the profile traces
TRACED_4J = ("play_headline_1080p", "play_vis_48k", "camera_1080p")


def session_play(key, device, window, n_frames, on_frame=None):
    """The Play of play_headline_1080p (the headline on ball with a colour
    balance) or play_vis_48k (a 440 Hz sine at half volume with a
    wavescope in the color-lines style, whose taps come from
    scope_filter), paced by nothing."""
    from gstbad_tpu_torch.session import Play
    if key == "play_headline_1080p":
        p = Play(SESSION_HEADLINE, window=window, realtime=False,
                 n_frames=n_frames, on_frame=on_frame, device=device)
        for channel, value in SESSION_BALANCE:
            p.set_color_balance(channel, value)
        return p
    p = Play(SESSION_AUDIO, window=window, realtime=False,
             n_frames=n_frames, on_frame=on_frame, device=device)
    p.set_volume(0.5)
    if not p.set_visualization("wavescope"):
        fail("play_vis_48k: no wavescope")
    p.set_visualization_enabled(True)
    # the style on the element Play made, as playbin's vis-plugin takes a
    # configured element (the default style, dots, takes no filter)
    if not p._prepare():
        fail(f"play_vis_48k: {p.message_bus.pop(name='error')}")
    p._vis_node.element.set_property("style", "color-lines")
    return p


def session_camera(device, mode, window, location, tone="sepia",
                   wb="daylight"):
    """camera_1080p's Camera: ball AYUV 1920x1080, digital zoom 2, EV +1,
    ISO 400, white balance `wb` (daylight), colour tone `tone` (sepia,
    which replaces the chroma), previews posted."""
    from gstbad_tpu_torch.session import camera
    cam = camera.Camera(source=SESSION_CAMERA, mode=mode, zoom=2.0,
                        window=window, post_previews=True,
                        location=location, device=device)
    if not (cam.set_ev_compensation(1.0) and cam.set_iso_speed(400)
            and cam.set_white_balance_mode(wb)
            and cam.set_color_tone_mode(tone)):
        fail("camera_1080p: a photography setting was refused")
    return cam


def session_graphs():
    """{key: build(device) -> Pipeline}: the device graphs of phase 4j,
    for the frames/s of their steps and the profile (the Play's active
    pipeline, the Camera's pipeline)."""
    from gstbad_tpu_torch.session import camera

    def play_graph(key):
        def build(device):
            play = session_play(key, device, WINDOW_4J, WINDOW_4J)
            if not play._prepare():
                fail(f"{key}: {play.message_bus.pop(name='error')}")
            return play._run_p
        return build

    return {"play_headline_1080p": play_graph("play_headline_1080p"),
            "play_vis_48k": play_graph("play_vis_48k"),
            "camera_1080p": lambda device: session_camera(
                device, camera.MODE_VIDEO, WINDOW_4J, "unused_%d").pipeline}


class FrameLog:
    """A Play on_frame callback keeping every dispatched frame: (pts,
    flags, valid, data), the data a host copy ({plane: array} if
    planar)."""

    def __init__(self):
        self.frames = []

    def __call__(self, b, i):
        import numpy as np
        d = b.data
        data = ({k: np.array(v[i]) for k, v in d.items()}
                if isinstance(d, dict) else np.array(d[i]))
        self.frames.append((int(b.pts[i]), int(b.flags[i]),
                            bool(b.valid[i]), data))


def session_fields(v):
    """A message field in a form that compares across devices: media info
    and specs as dicts, states by value, arrays as (dtype, shape, bytes),
    file names without their directory."""
    import dataclasses
    import enum
    import numpy as np
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: session_fields(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (list, tuple)):
        return [session_fields(x) for x in v]
    if isinstance(v, dict):
        return {k: os.path.basename(x) if k in ("filename", "location")
                else session_fields(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    return v


def session_messages(bus):
    return [(m.element, m.name, m.pts, session_fields(m.fields))
            for m in bus.messages]


def frames_equal(key, got, cpu) -> int:
    """Dispatched frames of a card run against the CPU port's: the same
    pts, flags, valid and bytes, in order.  Returns the frame count."""
    import numpy as np
    if len(got) != len(cpu):
        fail(f"{key}: {len(got)} frames dispatched on the card, {len(cpu)} "
             "on the CPU port")
    for n, (a, c) in enumerate(zip(got, cpu)):
        if a[:3] != c[:3]:
            fail(f"{key}: frame {n}: pts, flags, valid {a[:3]} on the card, "
                 f"{c[:3]} on the CPU port")
        ad = a[3] if isinstance(a[3], dict) else {"": a[3]}
        cd = c[3] if isinstance(c[3], dict) else {"": c[3]}
        if sorted(ad) != sorted(cd) or any(
                ad[k].dtype != cd[k].dtype or not np.array_equal(ad[k], cd[k])
                for k in ad):
            fail(f"{key}: frame {n} (pts {a[0]}) differs from the CPU "
                 "port's")
    return len(got)


def play_to_eos(key, play, timeout=600.0) -> float:
    """play() and wait for the worker to stop at the end of the stream;
    an `error` message fails the run.  Returns the host seconds."""
    t0 = time.perf_counter()
    play.play()
    while play.state.value != "stopped":
        if time.perf_counter() - t0 > timeout:
            fail(f"{key}: no end of stream in {timeout} s")
        time.sleep(0.0005)
    dt = time.perf_counter() - t0
    errors = play.message_bus.pop(name="error")
    if errors:
        fail(f"{key}: {errors[0].fields}")
    return dt


def adaptive_checks(gtt) -> dict:
    """hlsdemux, dashdemux and mssdemux on in-memory manifests (the shapes
    of tests/test_adaptive.py) with an injected fetch and clock: host
    code (the elements never touch a tensor; tests/test_torch_adaptive.py
    holds them against the JAX package), checked for what each fragment
    list should cover (URIs, byte ranges, caps changes, bitrate
    switches, seeks, needs-manifest).  -> {name: what was checked}."""
    master = ("#EXTM3U\n#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=100000\n"
              "low.m3u8\n#EXT-X-STREAM-INF:PROGRAM-ID=1,BANDWIDTH=1000000\n"
              "high.m3u8\n")

    def media(prefix, n=6, ranges=False):
        out = "#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-VERSION:4\n"
        for i in range(n):
            out += (f"#EXTINF:2,\n#EXT-X-BYTERANGE:25000@{i * 25000}\n"
                    f"{prefix}.ts\n" if ranges
                    else f"#EXTINF:2,\n{prefix}{i}.ts\n")
        return out + "#EXT-X-ENDLIST\n"

    mpd = ('<?xml version="1.0"?><MPD xmlns="urn:mpeg:dash:schema:mpd:2011"'
           ' type="static" mediaPresentationDuration="PT12S"><Period>'
           '<AdaptationSet contentType="video" mimeType="video/mp4">'
           '<SegmentTemplate media="$RepresentationID$/seg-$Number$.m4s" '
           'initialization="$RepresentationID$/init.mp4" duration="2" '
           'timescale="1" startNumber="1"/><Representation id="low" '
           'bandwidth="100000" width="320" height="180" codecs="avc1.42c00d"'
           '/><Representation id="high" bandwidth="1000000" width="1280" '
           'height="720" codecs="avc1.640028"/></AdaptationSet></Period>'
           '</MPD>')
    mss = ('<SmoothStreamingMedia TimeScale="10000000" Duration="80000000">'
           '<StreamIndex Type="video" Url="QualityLevels({bitrate})/'
           'Fragments(video={start time})"><QualityLevel Bitrate="300000" '
           'FourCC="H264" MaxWidth="320" MaxHeight="180"/><QualityLevel '
           'Bitrate="2000000" FourCC="H264" MaxWidth="1280" MaxHeight="720"'
           '/><c t="0" d="20000000" r="4"/></StreamIndex>'
           '</SmoothStreamingMedia>')

    class Net:
        def __init__(self, files, rate_bps):
            self.files, self.rate, self.t, self.log = dict(files), rate_bps, \
                0.0, []

        def clock(self):
            return self.t

        def fetch(self, uri, byte_range=None):
            data = self.files[uri]
            if byte_range is not None:
                data = data[byte_range[0]:byte_range[0] + byte_range[1]]
            self.t += len(data) * 8 / self.rate
            self.log.append((uri, byte_range))
            return data

    def hls():
        files = {"http://x/low.m3u8": media("http://x/low").encode(),
                 "http://x/high.m3u8": media("http://x/high", ranges=True)
                 .encode(), "http://x/high.ts": b"H" * 150000}
        files.update((f"http://x/low{i}.ts", b"L" * 25000)
                     for i in range(6))
        net = Net(files, 10_000_000)
        el = gtt.make("hlsdemux")
        el.load(master, net.fetch, uri="http://x/master.m3u8",
                clock=net.clock)
        frags = list(el.fragments(max_fragments=3))
        el.demux.seek(5_000_000_000)
        frags += list(el.fragments())
        live = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-MEDIA-SEQUENCE:0\n"
                "#EXTINF:2,\nhttp://x/s0.ts\n")
        lnet = Net({"http://x/live.m3u8": live.encode(),
                    "http://x/s0.ts": b"a" * 100,
                    "http://x/s1.ts": b"b" * 100}, 1_000_000)
        it = gtt.make("hlsdemux").load(live, lnet.fetch,
                                       uri="http://x/live.m3u8",
                                       clock=lnet.clock).fragments()
        frags += [next(it), next(it)]
        lnet.files["http://x/live.m3u8"] = (
            live + "#EXTINF:2,\nhttp://x/s1.ts\n").encode()
        frags.append(next(it))
        return frags, net.log + lnet.log

    def dash():
        files = {}
        for rep, size in (("low", 25000), ("high", 250000)):
            files[f"http://d/{rep}/init.mp4"] = b"I" * 500
            files.update((f"http://d/{rep}/seg-{n}.m4s", b"x" * size)
                         for n in range(1, 7))
        net = Net(files, 10_000_000)
        el = gtt.make("dashdemux", **{"bitrate-limit": 0.8})
        el.load(mpd, net.fetch, base_uri="http://d/", clock=net.clock)
        frags = list(el.fragments(max_fragments=4))
        el.demux.seek(7_000_000_000)
        return frags + list(el.fragments()), net.log

    def smooth():
        files = {f"http://m/QualityLevels({q})/Fragments(video={t})":
                 b"f" * n for q, n in (("300000", 20000),
                                       ("2000000", 200000))
                 for t in range(0, 80000000, 20000000)}
        net = Net(files, 50_000_000)
        el = gtt.make("mssdemux")
        el.load(mss, net.fetch, base_uri="http://m/", clock=net.clock)
        frags = list(el.fragments())
        el.demux.seek(4_500_000_000)
        return frags + list(el.fragments()), net.log

    out = {}
    for name, run in (("hlsdemux", hls), ("dashdemux", dash),
                      ("mssdemux", smooth)):
        frags, fetched = run()
        uris = [f.get("uri") for f in frags]
        if name == "hlsdemux":
            # the switch up after the first fragment (byte ranges of
            # high.ts), the seek, then the live playlist's update
            ok = (uris[0] == "http://x/low0.ts"
                  and uris[1] == "http://x/high.ts"
                  and ("http://x/high.ts", (25000, 25000)) in fetched
                  and frags[1].get("caps", {}).get("bandwidth") == 1000000
                  and frags[-2].get("needs-manifest")
                  and uris[-1] == "http://x/s1.ts")
        elif name == "dashdemux":
            # init and segment 1 on low, the switch's init and segment 2
            # on high, the seek's init again and segments 4-6
            ok = ([f["is-init"] for f in frags]
                  == [True, False, True, False, True, False, False, False]
                  and uris[2] == "http://d/high/init.mp4"
                  and frags[3]["caps"]["width"] == 1280
                  and uris[5] == "http://d/high/seg-4.m4s"
                  and frags[5]["pts"] == 6_000_000_000)
        else:
            # the switch up after the first fragment, the seek to 4 s
            ok = (frags[0]["caps"]["width"] == 320
                  and "QualityLevels(2000000)" in uris[1]
                  and len(frags) == 6 and frags[4]["pts"] == 4_000_000_000
                  and frags[4]["caps"]["width"] == 1280)
        if not ok:
            fail(f"{name}: fragments "
                 f"{[(u, f.get('pts')) for u, f in zip(uris, frags)]}")
        out[name] = f"{len(frags)} fragments, {len(fetched)} fetches"
    return out


def scope_on_play(key, err) -> dict:
    """scope_filter on the input play_vis_48k's path gives it at a window
    of WINDOW_4J: the second window of a two-window Play (the carries
    from the first), recorded on an uncounted run, against its plain
    version (exact).  -> {"inputs": (state, x), "plain_s": the plain
    walk's host seconds}."""
    import torch
    from gstbad_tpu_torch.ops import audio
    store = {}
    p = session_play(key, "cuda", WINDOW_4J, 2 * WINDOW_4J)
    undo = capture(audio, "scope_filter", store)
    try:
        play_to_eos(key, p)
    finally:
        undo()
    p.stop()
    calls = store.get("scope_filter", [])
    if len(calls) != 2:
        fail(f"{key} gave scope_filter {len(calls)} inputs in 2 windows")
    args = tuple(a.clone() for a in calls[-1][0])
    got = audio.scope_filter(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = audio.scope_filter_plain(*(a.cpu() for a in args))
    plain_s = time.perf_counter() - t0
    e = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    err["scope_filter"] = max(err["scope_filter"], e)
    log(f"scope_filter on {key}'s input {[tuple(a.shape) for a in args]} "
        f"(window {WINDOW_4J}): max_abs_err {e} against its plain version "
        f"(host {plain_s:.3f} s)")
    if e:
        fail(f"{key}: scope_filter differs from its plain version by {e}")
    return {"inputs": args, "plain_s": plain_s}


def session_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4j: the sessions — Play driving the headline with a colour
    balance (play_headline_1080p: K1 once a window), Play of a sine with
    a color-lines wavescope (play_vis_48k: scope_filter once a window),
    Camera
    recording ball at 1080p (camera_1080p: no kernel), each with the
    counts set to 0 just before its counted run and read just after, its
    peak device memory, its rate (the Play paths by the host clock from
    play() to end-of-stream over 10 windows, the Camera's viewfinder by
    CUDA events around 10 steps), and the card against the CPU port at a
    window of 16 over 2 windows: frames, pts, flags, valid, messages,
    snapshots and written bytes equal; scope_filter held against its
    plain version on play_vis_48k's input (scope_on_play); then the
    adaptive demuxers (host only, untimed).  Returns {"step_ms",
    "scope"}."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from gstbad_tpu_torch.session import camera

    t_phase = time.perf_counter()
    dur = 10**9 // 30
    step_ms, scope = {}, None
    graphs = session_graphs()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    try:
        for key, kname in (("play_headline_1080p", "dilate_zebra_fused"),
                           ("play_vis_48k", "scope_filter")):
            n_frames = RATE_WINDOWS_4J * WINDOW_4J
            warm = session_play(key, "cuda", WINDOW_4J, WINDOW_4J)
            play_to_eos(key, warm)
            warm.stop()
            runs, peaks = [], []
            for _ in range(3):
                play = session_play(key, "cuda", WINDOW_4J, n_frames)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                for c in counters.values():
                    c.launches = 0
                runs.append(n_frames / play_to_eos(key, play))
                play.stop()
                torch.cuda.synchronize()
                peaks.append((torch.cuda.max_memory_allocated(), held))
                delta = {k: c.launches for k, c in counters.items()}
                for k, c in delta.items():
                    want = RATE_WINDOWS_4J if k == kname else 0
                    if c != want:
                        fail(f"{key}: {k} launched {c} times in "
                             f"{RATE_WINDOWS_4J} windows ({want} expected)")
                for k in launches:
                    launches[k] += delta[k]
            med = statistics.median(runs)
            peak, held = peaks[-1]
            unit = "frames" if key == "play_headline_1080p" else "blocks"
            log(f"{key}: launches {kname} {RATE_WINDOWS_4J} in "
                f"{RATE_WINDOWS_4J} windows of {WINDOW_4J}, every other "
                f"count 0; peak device memory {peak / 2**20:.1f} MiB "
                f"({(peak - held) / 2**20:.1f} MiB above the "
                f"{held / 2**20:.1f} MiB held before the run)")
            log(f"rate {key}: median {med:.2f} source {unit}/s of "
                f"{[round(x, 2) for x in runs]} (host clock from play() to "
                f"end-of-stream, {RATE_WINDOWS_4J} windows of {WINDOW_4J}; "
                f"{card})")
            # the active pipeline's device step alone (CUDA events), and,
            # for the video path, the download of one output window to
            # the host as Pipeline.run takes it (a new pageable array)
            dmed, druns = fps_runs(graphs[key], WINDOW_4J)
            step_ms[key] = (WINDOW_4J * 1000.0 / dmed, WINDOW_4J)
            log(f"fps {key} (its active pipeline's device step) window "
                f"{WINDOW_4J}: median {dmed:.2f} source {unit}/s of "
                f"{[round(x, 2) for x in druns]}, step "
                f"{step_ms[key][0]:.3f} ms of the "
                f"{WINDOW_4J * 1000.0 / med:.3f} ms a window end to end "
                f"({card})")
            if key == "play_headline_1080p":
                win = torch.zeros((WINDOW_4J, H, W, 4), dtype=torch.uint8,
                                  device="cuda")
                down = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    win.cpu().numpy()
                    down.append((time.perf_counter() - t0) * 1e3)
                del win
                log(f"{key}: the download of one {WINDOW_4J}-frame AYUV "
                    f"window to the host (a new pageable array, as "
                    f"Pipeline.run takes it): median "
                    f"{statistics.median(down):.3f} ms of "
                    f"{[round(x, 3) for x in down]} (host clock; {card})")
            else:
                scope = scope_on_play(key, err)

            # the card against the CPU port, windows of CHECK_4J
            t0 = time.perf_counter()
            got = {}
            for d in ("cuda", "cpu"):
                rec = FrameLog()
                if key == "play_headline_1080p":
                    # seek-accurate to frame 320, 2 windows forward; then
                    # rate -1 from frame 31 down to 0, 2 windows reversed
                    p = session_play(key, d, CHECK_4J, 320 + 2 * CHECK_4J,
                                     rec)
                    p.set_config(seek_accurate=True)
                    p.seek(320 * dur)
                    play_to_eos(key, p)
                    snaps = [p.get_video_snapshot("native")]
                    p.stop()
                    p.seek((2 * CHECK_4J - 1) * dur)
                    p.set_rate(-1.0)
                    play_to_eos(key, p)
                    snaps.append(p.get_video_snapshot("native"))
                    want = ([(320 + i) * dur for i in range(2 * CHECK_4J)]
                            + [(2 * CHECK_4J - 1 - i) * dur
                               for i in range(2 * CHECK_4J)])
                else:
                    # 2 windows at half volume, then muted from the start
                    p = session_play(key, d, CHECK_4J, 2 * CHECK_4J, rec)
                    play_to_eos(key, p)
                    p.set_mute(True)
                    n_loud = len(rec.frames)
                    play_to_eos(key, p)
                    snaps = []
                    muted = [f for f in rec.frames[n_loud:]
                             if f[3].ndim == 2]
                    if not muted or any(f[3].any() for f in muted):
                        fail(f"{key}: muted samples are not all zero")
                    want = None
                p.stop()
                msgs = session_messages(p.message_bus)
                got[d] = (rec.frames, msgs, snaps)
                if want is not None and [f[0] for f in rec.frames] != want:
                    fail(f"{key}: dispatched pts {[f[0] for f in rec.frames]}"
                         f" on {d}, {want} expected")
            n = frames_equal(key, got["cuda"][0], got["cpu"][0])
            if got["cuda"][1] != got["cpu"][1]:
                fail(f"{key}: the messages differ from the CPU port's")
            for (s1, f1), (s2, f2) in zip(got["cuda"][2], got["cpu"][2]):
                if s1 != s2 or not np.array_equal(f1, f2):
                    fail(f"{key}: the snapshot differs from the CPU port's")
            names = [m[1] for m in got["cuda"][1]]
            need = (("position-updated", "seek-done",
                     "video-dimensions-changed", "state-changed")
                    if key == "play_headline_1080p"
                    else ("volume-changed", "mute-changed", "state-changed"))
            if key == "play_headline_1080p":
                order = [names.index(x) for x in need if x in names]
                if len(order) != len(need):
                    fail(f"{key}: messages {sorted(set(names))}, missing "
                         f"some of {need}")
            elif not all(x in names for x in need):
                fail(f"{key}: messages {sorted(set(names))}, missing some "
                     f"of {need}")
            log(f"{key}: the card equals the CPU port at a window of "
                f"{CHECK_4J}: {n} frames, {len(names)} messages "
                f"({', '.join(sorted(set(names)))}), "
                f"{len(got['cuda'][2])} snapshots "
                f"({time.perf_counter() - t0:.2f} s)")

        # camera_1080p: the counted run is the viewfinder over 2 windows
        key = "camera_1080p"
        cam = session_camera("cuda", camera.MODE_VIDEO, WINDOW_4J,
                             os.path.join(tmp, "unused_%d"))
        cam.run_viewfinder(1)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        seen = []
        cam.set_viewfinder(lambda b, spec: seen.append(int(b.valid.sum())))
        cam.run_viewfinder(2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        delta = {k: c.launches for k, c in counters.items() if c.launches}
        if delta:
            fail(f"{key}: kernels launched {delta} (none expected)")
        if seen != [WINDOW_4J, WINDOW_4J]:
            fail(f"{key}: viewfinder windows of {seen} frames")
        med, all_runs = fps_runs(graphs[key], WINDOW_4J)
        step_ms[key] = (WINDOW_4J * 1000.0 / med, WINDOW_4J)
        log(f"{key}: launches 0 in 2 viewfinder windows of {WINDOW_4J}; "
            f"peak device memory {peak / 2**20:.1f} MiB "
            f"({(peak - held) / 2**20:.1f} MiB above the "
            f"{held / 2**20:.1f} MiB held before the run)")
        log(f"fps {key} window {WINDOW_4J}: median {med:.2f} viewfinder "
            f"frames/s of {[round(x, 2) for x in all_runs]}, step "
            f"{step_ms[key][0]:.3f} ms (device step, CUDA events around 10 "
            f"steps; {card})")
        del cam
        # the card against the CPU port: a recording over 2 windows of
        # CHECK_4J and, in MODE_IMAGE, one capture (PNM: the luma only);
        # and a recording over 1 window in tone normal under the cloudy
        # gains, whose chroma goes through the float64 arithmetic that
        # sepia replaces
        t0 = time.perf_counter()
        got = {}
        for d in ("cuda", "cpu"):
            os.makedirs(os.path.join(tmp, d))
            vid = session_camera(d, camera.MODE_VIDEO, CHECK_4J,
                                 os.path.join(tmp, d, "vid_%d.raw"))
            vid.start_capture()
            vid.step()
            paths = [vid.stop_capture()]
            img = session_camera(d, camera.MODE_IMAGE, CHECK_4J,
                                 os.path.join(tmp, d, "img_%d.pnm"))
            paths.append(img.start_capture())
            wb = session_camera(d, camera.MODE_VIDEO, CHECK_4J,
                                os.path.join(tmp, d, "wb_%d.raw"),
                                tone="normal", wb="cloudy")
            wb.start_capture()
            paths.append(wb.stop_capture())
            data = []
            for path in paths:
                with open(path, "rb") as f:
                    data.append(f.read())
                os.remove(path)
            got[d] = (data, session_messages(vid.bus)
                      + session_messages(img.bus) + session_messages(wb.bus))
        if got["cuda"][0] != got["cpu"][0]:
            fail(f"{key}: the written bytes differ from the CPU port's")
        if got["cuda"][1] != got["cpu"][1]:
            fail(f"{key}: the messages differ from the CPU port's")
        sepia, _, cloudy = got["cuda"][0]
        if len(cloudy) != CHECK_4J * W * H * 4 \
                or cloudy == sepia[:len(cloudy)]:
            fail(f"{key}: the cloudy recording ({len(cloudy)} bytes) is "
                 "not one window or equals the sepia one")
        names = [m[1] for m in got["cuda"][1]]
        if names != ["preview-image", "video-done", "preview-image",
                     "image-done", "preview-image", "video-done"]:
            fail(f"{key}: messages {names}")
        rec_bytes = len(sepia)
        if rec_bytes != 2 * CHECK_4J * W * H * 4:
            fail(f"{key}: a {rec_bytes}-byte recording")
        log(f"{key}: the card equals the CPU port at a window of "
            f"{CHECK_4J}: a {rec_bytes}-byte recording over 2 windows (raw "
            f"AYUV), a {len(got['cuda'][0][1])}-byte PNM capture, a "
            f"{len(cloudy)}-byte recording in tone normal under the cloudy "
            f"gains, messages {names} ({time.perf_counter() - t0:.2f} s)")

        demux = adaptive_checks(gtt)
        log("phase 4j adaptive demuxers (host only, untimed): "
            + "; ".join(f"{k} {v}" for k, v in demux.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"session_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"step_ms": step_ms, "scope": scope}


WINDOW_4K = 64                  # phase 4k's window
MESH_SHARDS = 4                 # its mesh: dp 2 x sp 2
TRANSPORT_FRAMES = 16           # 1080p AYUV frames through each transport


def mesh_paths(benchmarks):
    """The paths of phase 4k: {key: (build(device) -> Pipeline,
    {kernel: launches a window under the dp 2 x sp 2 mesh})}.  K1 and K3
    run once a shard (with their halo rows), K7, K4 and K5 by the gather
    rule once a window."""
    from gstbad_tpu_torch.core.pipeline import parse_launch
    shards = MESH_SHARDS
    return {
        "mesh_headline_1080p": (
            lambda d: benchmarks.ten_element_graph(W, H, device=d),
            {"dilate_zebra_fused": shards}),
        "mesh_warp_1080p": (
            lambda d: benchmarks.warp_1080p(W, H, device=d),
            {"warp_words": 1}),
        "mesh_config5_ivtc": (
            lambda d: benchmarks.config5_ivtc(W5, H5, device=d),
            {"metrics_default": 1, "comb_score_pairs": 1}),
        "mesh_blur_ball_1080p": (
            lambda d: parse_launch(
                f"videotestsrc pattern=ball width={W} height={H} "
                "format=AYUV ! gaussianblur sigma=1.2 ! fakesink",
                device=d),
            {"gaussian_blur_words": shards}),
        "mesh_bs2b_48k": (
            lambda d: parse_launch(
                "audiotestsrc wave=sine freq=440 format=F32 rate=48000 "
                f"channels=2 samplesperbuffer={AUDIO_BLOCK} ! bs2b "
                "preset=cmoy ! fakesink", device=d),
            {}),
    }


def transport_round_trip(gtt, kind: str, frames, per_packet: int,
                         slots: int) -> float:
    """Push host frames (AYUV, [N, H, W, 4]) through `kind` ("shm":
    appsrc ! shmsink, shmsrc ! fakesink; "ipc": ipcpipelinesink,
    ipcpipelinesrc), both ends in this process (the reader on a thread,
    the ring holding `slots` packets of `per_packet` frames), on the card;
    fail unless the bytes read equal the bytes written.  Returns MB/s by
    the host clock from the first push to the last frame read."""
    import threading
    import uuid

    import numpy as np
    n, h, w = frames.shape[:3]
    name = f"gstbad-4k-{kind}-{uuid.uuid4().hex[:8]}"
    slot = per_packet * h * w * 4 + (1 << 16)
    if kind == "shm":
        sink_desc = (f"shmsink socket-path={name} shm-size={slot * slots} "
                     f"num-slots={slots}")
        src_desc = f"shmsrc socket-path={name} timeout-ms=60000"
    else:
        sink_desc = (f"ipcpipelinesink name-prefix={name} "
                     f"shm-size={slot * slots} num-slots={slots}")
        src_desc = f"ipcpipelinesrc name-prefix={name} timeout-ms=60000"
    writer = gtt.parse_launch(
        f"appsrc format=AYUV width={w} height={h} ! {sink_desc}",
        device="cuda")
    writer.negotiate()             # the sink makes its ring(s) here
    sink = writer.elements[-1]
    got, errors = [], []

    def read():
        try:
            reader = gtt.parse_launch(f"{src_desc} ! fakesink",
                                      device="cuda")
            got.extend(reader.run(window=per_packet))
            src = reader.elements[0]
            if kind == "shm":
                src._ring.close()
            else:
                src.slave.close()
        except Exception as e:     # noqa: BLE001 - reported below
            errors.append(e)

    t0 = time.perf_counter()
    thread = threading.Thread(target=read)
    thread.start()
    writer.elements[0].push_frames(frames)
    writer.run(window=per_packet)
    sink.eos()
    thread.join(timeout=300)
    seconds = time.perf_counter() - t0
    if kind == "shm":
        sink._ring.close()
    else:
        sink.master.close()
    if thread.is_alive() or errors:
        fail(f"phase 4k {kind}: the reader failed: {errors}")
    back = np.concatenate([np.asarray(b.data) for b in got]) if got \
        else np.zeros((0,), np.uint8)
    if back.dtype == np.int32:
        back = back.view(np.uint8).reshape(back.shape + (4,))
    if back.shape != frames.shape or not np.array_equal(back, frames):
        fail(f"phase 4k {kind}: {back.shape} frames read back differ from "
             f"the {frames.shape} written")
    return frames.nbytes / 1e6 / seconds


def mesh_slice(gtt, counters, launches, err, card) -> None:
    """Phase 4k: the mesh.  On [cuda:i for i in range(count)], repeated
    up to four logical shards (dp 2 x sp 2): each path of mesh_paths at
    full width, 2 windows of 64 through the sharded step with the counts
    set to 0 just before and read just after (K1 and K3 once a shard a
    window, K7, K4 and K5 once a window, nothing else), equal field for
    field to the unsharded card step's, and the nodes the gather rule ran
    printed; K1 and K3 held against their plain versions on the shard
    inputs the mesh gave them; the headline's sharded and unsharded
    frames/s; then a window of the headline's 1080p frames, downloaded
    from the card, through shmsink ! shmsrc and ipcpipelinesink !
    ipcpipelinesrc in this process, bytes equal, MB/s."""
    import numpy as np
    import torch
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.ops import blur, chainfuse
    from gstbad_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i % count) for i in range(MESH_SHARDS)]
    mesh = make_mesh(dp=2, sp=2, devices=devices)
    log(f"phase 4k mesh: dp 2 x sp 2 on {[str(d) for d in devices]}")

    def windows(p, mesh_, n=2):
        """n windows through p's step: per window, the leaf's host
        (data, pts, flags, valid) and the messages."""
        step = p.compile(WINDOW_4K, mesh=mesh_)
        params, states = p.params(), p.init_states(WINDOW_4K)
        outs = []
        for _ in range(n):
            states, leaves, msgs = step(params, states, None)
            leaf = leaves[-1].gather() if mesh_ is not None else leaves[-1]
            fb = leaf.to_numpy()
            outs.append(((fb.data, fb.pts, fb.flags, fb.valid),
                         {k: {f: v.cpu().numpy() for f, v in m.items()}
                          for k, m in msgs.items()}))
        return outs, step, params, states

    head_frames = None
    for key, (build, plan) in mesh_paths(benchmarks).items():
        p0 = build("cuda")
        p0.negotiate()
        want, step0, prm0, st0 = windows(p0, None)
        p1 = build("cuda")
        p1.negotiate()
        p1.compile(WINDOW_4K, mesh=mesh)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        got, step1, prm1, st1 = windows(p1, mesh)
        torch.cuda.synchronize()
        delta = {k: c.launches for k, c in counters.items()}
        for k, c in delta.items():
            if c != 2 * plan.get(k, 0):
                fail(f"{key}: {k} launched {c} times in 2 windows on the "
                     f"mesh ({2 * plan.get(k, 0)} expected)")
        for k in launches:
            launches[k] += delta[k]
        for i, ((wd, wm), (gd, gm)) in enumerate(zip(want, got)):
            for name, a, b in zip(("data", "pts", "flags", "valid"), wd, gd):
                if a.shape != b.shape or not np.array_equal(a, b):
                    fail(f"{key}: window {i} {name} sharded differs from "
                         "the unsharded card step")
            if sorted(wm) != sorted(gm) or any(
                    not np.array_equal(wm[k][f], gm[k][f])
                    for k in wm for f in wm[k]):
                fail(f"{key}: window {i} messages differ on the mesh")
        gathered = {k: c["gather"] for k, c in p1.shard_counts.items()
                    if c["gather"]}
        halos = {k: c["halo"] for k, c in p1.shard_counts.items()
                 if c["halo"]}
        if key == "mesh_headline_1080p":
            if gathered:
                fail(f"{key}: the gather rule ran on {gathered}")
            head_frames = got[0][0][0][:TRANSPORT_FRAMES]
            # frames/s, sharded and unsharded, in one call
            rates = {}
            for label, step, prm, st in (("unsharded", step0, prm0, st0),
                                         ("sharded", step1, prm1, st1)):
                holder = {"st": st}

                def one(step=step, prm=prm, holder=holder):
                    holder["st"], _, _ = step(prm, holder["st"], None)

                one()
                rates[label] = statistics.median(
                    WINDOW_4K * 1000.0 / cuda_ms(one, iters=5, warmup=1)
                    for _ in range(3))
            log(f"mesh fps {key} window {WINDOW_4K}: sharded dp 2 x sp 2 "
                f"{rates['sharded']:.1f}, unsharded "
                f"{rates['unsharded']:.1f} source frames/s ({card})")
        log(f"{key}: sharded == unsharded over 2 windows; launches "
            f"{ {k: v for k, v in delta.items() if v} }; gather rule on "
            f"{gathered or 'no node'}; halo exchanges {halos or 'none'}")

    # K1 and K3 on the shard inputs the mesh gives them
    for module, name, build in (
            (chainfuse, "dilate_zebra_fused",
             mesh_paths(benchmarks)["mesh_headline_1080p"][0]),
            (blur, "gaussian_blur_words",
             mesh_paths(benchmarks)["mesh_blur_ball_1080p"][0])):
        store = {}
        restore = capture(module, name, store)
        try:
            p = build("cuda")
            p.negotiate()
            step = p.compile(WINDOW_4K, mesh=mesh)
            step(p.params(), p.init_states(WINDOW_4K), None)
        finally:
            restore()
        shapes = []
        for args, kw in store[name]:
            got = getattr(module, name)(*args, **kw)
            if name == "dilate_zebra_fused":
                src, rank_t, word_t, index, erode, thr, phase = args
                b = kw["batch"]
                scal = torch.stack([chainfuse._per_frame_i32(v, b, src.device)
                                    for v in (erode, thr, phase)])
                want = chainfuse.dilate_zebra_plain(src, rank_t, word_t,
                                                    index, scal)
            else:
                want = blur.gaussian_blur_words_plain(*args, **kw)
            e = byte_err(got, want)
            err[name] = max(err[name], e)
            shapes.append((tuple(args[0].shape), kw.get("batch")))
            if e:
                fail(f"{name} on the mesh's shard inputs {shapes[-1]}: "
                     f"{e} from its plain version")
        log(f"{name} on the mesh's shard inputs (source shape, batch) "
            f"{shapes}: equal to its plain version")

    # the transports, both ends in this process
    import os
    free = os.statvfs("/dev/shm")
    free = free.f_bavail * free.f_frsize
    fb = H * W * 4
    per_packet, slots = next(
        ((k, s) for k, s in ((4, 4), (2, 4), (1, 2))
         if s * (k * fb + (1 << 16)) * 2 <= free), (None, None))
    if per_packet is None:
        fail(f"/dev/shm holds {free} bytes: too few for 1080p packets")
    frames = np.ascontiguousarray(head_frames).view(np.uint8).reshape(
        head_frames.shape + (4,))
    for kind in ("shm", "ipc"):
        rate = transport_round_trip(gtt, kind, frames, per_packet, slots)
        log(f"transport {kind}: {frames.shape[0]} 1080p AYUV frames from "
            f"the card in packets of {per_packet} through a ring of "
            f"{slots} slots, bytes equal, {rate:.1f} MB/s (host clock; "
            f"/dev/shm {free / 2**20:.0f} MiB free; {card})")
    log(f"mesh_slice: {time.perf_counter() - t_phase:.1f} s")


WINDOW_4L = 16                  # phase 4l's window
RTP_WINDOWS = 2                 # rtp_headline_1080p's windows
# rtp_headline_1080p: raw BGRA 1080p60 in over RTP (RFC 4175), the
# headline's filter chain, raw BGRA out over RTP
RTP_HEADLINE = (
    "rtpsrc uri=rtp://127.0.0.1:{pin}?latency=50&timeout=30 "
    'caps="application/x-rtp,media=video,encoding-name=RAW,sampling=BGRA,'
    'width={w},height={h},framerate=60/1" ! videoconvert format=BGRx ! '
    + HEAD + " ! zebrastripe ! videoconvert format=BGRA "
    "! rtpsink uri=rtp://127.0.0.1:{pout}")
# ts_over_rtp: an 8 Mb/s H.264 1080p25 elementary stream of 10 s, muxed
# with a seeded audio PID, 7 TS packets per RTP datagram (IPTV's layout)
TS_SECONDS, TS_FPS, TS_AU_BYTES = 10, 25, 40000


# the receiver of rtp_headline_1080p's output, run as `python -c`: binds
# the port with the largest receive buffer it is granted (printed), takes
# datagrams until an empty one, then writes the monotonic time of the last,
# the count, the lengths and the datagrams to stdout
UDP_COLLECTOR = r"""
import socket, struct, sys, time
s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
for opt in (getattr(socket, "SO_RCVBUFFORCE", None), socket.SO_RCVBUF):
    try:
        s.setsockopt(socket.SOL_SOCKET, opt, 1 << 28)
        break
    except (OSError, TypeError):
        pass
s.bind(("127.0.0.1", int(sys.argv[1])))
sys.stdout.write(f"{s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)}\n")
sys.stdout.flush()
buf = bytearray(1 << 30)
view, pos, lens, last = memoryview(buf), 0, [], 0.0
while True:
    n = s.recv_into(view[pos:pos + 65536])
    if n == 0:
        break
    last = time.monotonic()
    lens.append(n)
    pos += n
out = sys.stdout.buffer
out.write(struct.pack("<dQ", last, len(lens)))
out.write(struct.pack(f"<{len(lens)}I", *lens))
out.write(view[:pos])
out.flush()
"""


def free_udp_port_pair() -> int:
    """An even localhost UDP port whose odd neighbour is free too (RTP on
    the port, RTCP on the next)."""
    import socket
    for _ in range(64):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        if port % 2 or port >= 65534:
            continue
        socks = []
        try:
            for p in (port, port + 1):
                t = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(t)
                t.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
        return port
    fail("no free even localhost UDP port pair")


def udp_rcvbuf() -> int:
    """The receive buffer a UDP socket gets by default here (rtpsrc sets
    none): getsockopt on a fresh socket."""
    import socket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    n = s.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
    s.close()
    return n


def moving_bgra(n, w, h, seed=71):
    """n seeded BGRA frames of noise that moves 4 pixels right and 2 down
    a frame (a window onto one larger seeded image)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * n, w + 4 * n, 4), dtype=np.uint8)
    return np.stack([base[2 * i:2 * i + h, 4 * i:4 * i + w]
                     for i in range(n)])


def element_named(p, name):
    return next(n.element for n in p.nodes if n.element.NAME == name)


def rtp_datagrams(frames, window):
    """The sender's RFC 4175 datagrams of `frames` (BGRA, the port's
    RawVideoPayloader at an MTU of 1400), window by window, with 90 kHz
    timestamps of a 60 fps stream; and the payloader."""
    from gstbad_tpu_torch.io import rtpnet
    n, h, w = frames.shape[:3]
    pay = rtpnet.RawVideoPayloader("BGRA", w, h)
    return [[pk.serialize() for i in range(k, min(k + window, n))
             for pk in pay.pay_frame(frames[i], 1500 * i)]
            for k in range(0, n, window)], pay


def rtp_headline_path(gtt, device, frames, window, dgrams=None):
    """rtp_headline_1080p through gtt.parse_launch(..., device=device).
    Without `dgrams`: a feeder thread pays the frames (rtp_datagrams)
    before the clock starts, then sends each window's datagrams while
    rtpsrc pulls that window, paced (a burst never larger than half of
    what the receiving socket's default buffer holds, the next burst only
    once rtpsrc has taken the one before off its socket), and ends the
    stream with an RTCP BYE; a collector thread receives what rtpsink
    sends and depays it with the port's RawVideoDepayloader.  With
    `dgrams` (the CPU reference) rtpsrc takes them by push_packet.
    Returns a dict of what came out and the counts."""
    import gc
    import socket
    import struct
    import threading
    import torch
    from gstbad_tpu_torch.io import rtpnet

    n, h, w = frames.shape[:3]
    p_in, p_out = free_udp_port_pair(), free_udp_port_pair()
    p = gtt.parse_launch(RTP_HEADLINE.format(pin=p_in, pout=p_out, w=w,
                                             h=h), device=device)
    p.negotiate()
    src, sink = element_named(p, "rtpsrc"), element_named(p, "rtpsink")
    out = {"p": p, "inputs": []}
    orig_pull = src.pull_window

    if dgrams is not None:
        # rtpsink's datagrams go to a socket of this process's own that
        # nothing reads: no other process can bind the port meanwhile
        sink_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sink_rx.bind(("127.0.0.1", p_out))
        for win in dgrams:
            for d in win:
                src.push_packet(rtpnet.RtpPacket.parse(d))

        def pull_pushed(k):
            if len(out["inputs"]) == len(dgrams):
                src.event_eos()      # the stream's end, as a BYE would
            b = orig_pull(k)
            out["inputs"].append(b)
            return b
        src.pull_window = pull_pushed
        out["outs"] = p.run(window=window)
        p.close()
        sink_rx.close()
        return out

    src.open()
    taken = [0]
    orig_insert = src._jb.insert

    def insert(pkt, now=None):
        taken[0] += 1
        return orig_insert(pkt, now)
    src._jb.insert = insert
    burst = max(8, udp_rcvbuf() // 2 // 4096)
    requests, paid, errors = [], {}, []
    wake, ready, done = (threading.Event(), threading.Event(),
                         threading.Event())

    def feeder():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            paid["dgrams"], paid["pay"] = rtp_datagrams(frames, window)
            ready.set()
            k = 0
            while not done.is_set():
                wake.wait()
                wake.clear()
                while k < len(requests):
                    if k < len(paid["dgrams"]):
                        base = taken[0]
                        for i, d in enumerate(paid["dgrams"][k]):
                            while i - (taken[0] - base) >= burst:
                                time.sleep(0.0001)
                            tx.sendto(d, ("127.0.0.1", p_in))
                    else:
                        # end of stream: a BYE, then one datagram of
                        # another source, which wakes rtpsrc's drain to
                        # read the BYE (the jitter buffer drops it)
                        tx.sendto(rtpnet.rtcp_bye(paid["pay"].ssrc),
                                  ("127.0.0.1", p_in + 1))
                        tx.sendto(rtpnet.RtpPacket(
                            payload_type=96, ssrc=paid["pay"].ssrc ^ 1
                        ).serialize(), ("127.0.0.1", p_in))
                        return
                    k += 1
        except Exception as e:    # reported by the phase
            errors.append(repr(e))
            ready.set()
        finally:
            tx.close()

    # the receiver of rtpsink's datagrams runs in a process of its own, so
    # that it drains its socket while this interpreter pays and sends
    rx = subprocess.Popen([sys.executable, "-c", UDP_COLLECTOR,
                           str(p_out)], stdout=subprocess.PIPE)
    rcvbuf = int(rx.stdout.readline())
    got, last = [], [0.0]

    def collector():
        """Take the receiver's datagrams when the stream has ended and
        depay them (below)."""
        blob = rx.stdout.read()
        pos, lens = 0, []
        last[0], count = struct.unpack_from("<dQ", blob, 0)
        lens = struct.unpack_from(f"<{count}I", blob, 16)
        pos = 16 + 4 * count
        for n_ in lens:
            got.append(blob[pos:pos + n_])
            pos += n_

    # the host clock inside rtpsrc's pulls and rtpsink's host_process
    spent = {"pull": 0.0, "sink": 0.0}
    orig_host = sink.host_process

    def pull(k):
        requests.append(k)
        wake.set()
        t_ = time.monotonic()
        b = orig_pull(k)
        spent["pull"] += time.monotonic() - t_
        out["inputs"].append(b)
        return b

    def host_process(np_batch, bus):
        t_ = time.monotonic()
        orig_host(np_batch, bus)
        spent["sink"] += time.monotonic() - t_
    src.pull_window = pull
    sink.host_process = host_process
    threads = [threading.Thread(target=feeder, daemon=True),
               threading.Thread(target=collector, daemon=True)]
    for t in threads:
        t.start()
    ready.wait()
    try:
        t0 = time.monotonic()
        out["outs"] = p.run(window=window)
        if device != "cpu":
            torch.cuda.synchronize()
        t_run = time.monotonic()
        p.close()
    finally:
        done.set()
        wake.set()
        # an empty datagram ends the receiver
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"", ("127.0.0.1", p_out))
        s.close()
        for t in threads:
            t.join(timeout=60)
        if rx.wait(timeout=60) != 0:
            fail(f"rtp_headline_1080p: the receiver exited {rx.returncode}")
        src.close()
    if errors or any(t.is_alive() for t in threads):
        fail(f"rtp_headline_1080p: the feeder failed: {errors}")
    depay = rtpnet.RawVideoDepayloader("BGRA", w, h)
    back = []
    gc.disable()         # the receiver's own lists, not the system's
    try:
        for d in got:
            back += depay.depay(rtpnet.RtpPacket.parse(d))
    finally:
        gc.enable()
    out.update(back=back, dgrams=paid["dgrams"], spent=spent,
               t_wall=max(last[0], t_run) - t0, rcvbuf=rcvbuf,
               sent=sum(len(x) for x in paid["dgrams"]),
               received=taken[0], sink_sent=sink._pay.packet_count,
               collected=len(got), depay_dropped=depay.num_dropped,
               src_dropped=src._depay.num_dropped,
               jb_lost=src._jb.num_lost, burst=burst)
    return out


def h264_bits():
    """An MSB-first bit writer with Exp-Golomb codes (ITU-T H.264 7.2,
    9.1) and the RBSP trailing bits."""
    class Bits:
        def __init__(self):
            self.v, self.n = 0, 0

        def u(self, x, k):
            self.v = (self.v << k) | (x & ((1 << k) - 1))
            self.n += k
            return self

        def ue(self, x):
            x += 1
            k = x.bit_length()
            return self.u(0, k - 1).u(x, k)

        def rbsp(self) -> bytes:
            self.u(1, 1)
            self.u(0, -self.n % 8)
            return self.v.to_bytes(self.n // 8, "big")
    return Bits()


def h264_epb(raw: bytes) -> bytes:
    """Emulation prevention (7.4.1): 00 00 followed by a byte <= 3 takes
    an 03 between; the non-overlapping matches are the sequential rule's."""
    import re
    return re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", raw)


def h264_stream(seconds, fps, au_bytes, seed=81):
    """A seeded H.264 Annex-B stream, Main profile level 4.0, 1920x1080
    (1088 coded rows cropped by 8) at `fps` (VUI timing): an IDR access
    unit (SPS, PPS and an IDR slice) each second, non-IDR slices between,
    each slice a valid slice-header start (first_mb_in_slice 0,
    slice_type, pps 0, frame_num) and a random emulation-prevented payload
    of about au_bytes.  Returns [(access unit bytes, pts ns)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sps = h264_bits().u(77, 8).u(0, 8).u(40, 8).ue(0).ue(0).ue(2).ue(1) \
        .u(0, 1).ue(119).ue(67).u(1, 1).u(1, 1).u(1, 1).ue(0).ue(0).ue(0) \
        .ue(4).u(1, 1).u(0, 4).u(1, 1).u(1, 32).u(2 * fps, 32).u(1, 1) \
        .u(0, 5).rbsp()
    pps = h264_bits().ue(0).ue(0).u(0, 1).u(0, 1).ue(0).ue(0).ue(0) \
        .u(0, 1).u(0, 2).ue(1).ue(1).ue(0).u(1, 1).u(0, 1).u(0, 1).rbsp()
    start = b"\x00\x00\x00\x01"
    out = []
    for i in range(seconds * fps):
        idr = i % fps == 0
        hdr = h264_bits().ue(0).ue(7 if idr else 5).ue(0).u(i % 16, 4)
        if idr:
            hdr.ue(i // fps % 65536)
        head = hdr.v << (-hdr.n % 8)
        body = (head.to_bytes(-(-hdr.n // 8), "big")
                + rng.integers(0, 256, int(au_bytes * rng.uniform(0.8, 1.2)),
                               np.uint8).tobytes() + b"\x80")
        slice_nal = bytes([0x65 if idr else 0x41]) + h264_epb(body)
        au = (start + b"\x67" + h264_epb(sps) + start + b"\x68"
              + h264_epb(pps) if idr else b"") + start + slice_nal
        out.append((au, i * 1_000_000_000 // fps))
    return out


def ts_over_rtp(gtt, card) -> dict:
    """ts_over_rtp on the card's host: the seeded H.264 stream and a
    seeded audio PID through mpegtsmux, 7 TS packets per RTP datagram
    (Mp2tPayloader) over localhost UDP into rtpsrc (encoding-name=MP2T),
    each pull_bytes as it comes through tsparse, tsdemux and h264parse,
    then mpegtsmux again and tsdemux: the elementary streams and their pts
    come back exactly, with no continuity error.  Returns the figures."""
    import socket
    import numpy as np
    from gstbad_tpu_torch.io import rtpnet

    rng = np.random.default_rng(82)
    aus = h264_stream(TS_SECONDS, TS_FPS, TS_AU_BYTES)
    audio = [(rng.integers(0, 256, 480, np.uint8).tobytes(),
              i * 1_000_000_000 // 50) for i in range(TS_SECONDS * 50)]
    es_bytes = sum(len(a) for a, _ in aus) + sum(len(a) for a, _ in audio)

    def mux(video, sound):
        m = gtt.make("mpegtsmux")
        v, a = m.connect("video/x-h264"), m.connect("audio/aac")
        blob, j = [], 0
        for au, pts in video:
            while j < len(sound) and sound[j][1] <= pts:
                blob.append(m.chain(a, sound[j][0], pts_ns=sound[j][1]))
                j += 1
            blob.append(m.chain(v, au, pts_ns=pts, dts_ns=pts,
                                random_access=au[4] == 0x67))
        blob += [m.chain(a, d, pts_ns=t_) for d, t_ in sound[j:]]
        return b"".join(blob)

    class Receiver:
        """tsdemux, then h264parse on each video PES (an access unit a
        PES: pushed, then drained with its pts)."""

        def __init__(self):
            self.dmx, self.h264 = gtt.make("tsdemux"), gtt.make("h264parse")
            self.video, self.sound = [], []

        def push(self, chunk, eos=False):
            pes = self.dmx.push_bytes(chunk)
            if eos:
                pes += self.dmx.event_eos()
            for o in pes:
                if o["pid"] == 0x40:
                    self.video += [
                        (x["data"], x["pts"]) for x in
                        self.h264.push(o["data"], pts_ns=o["pts"])
                        + self.h264.finish(pts_ns=o["pts"])]
                else:
                    self.sound.append((o["data"], o["pts"]))

        def check(self, what):
            if self.dmx.continuity_errors:
                fail(f"ts_over_rtp {what}: {self.dmx.continuity_errors} "
                     "continuity errors")
            if self.video != aus or self.sound != audio:
                fail(f"ts_over_rtp {what}: {len(self.video)} access units "
                     f"and {len(self.sound)} audio buffers out of "
                     f"{len(aus)} and {len(audio)}, or their bytes or pts "
                     "differ")

    t0 = time.perf_counter()
    ts = mux(aus, audio)
    port = free_udp_port_pair()
    src = gtt.make("rtpsrc", address="127.0.0.1", port=port,
                   caps="application/x-rtp,media=video,encoding-name=MP2T")
    src.negotiate(None)
    src.open()
    dgrams = [pk.serialize() for pk in rtpnet.Mp2tPayloader().pay(ts)]
    # bursts of at most half what the socket's default buffer holds, each
    # taken off by pull_bytes before the next is sent
    burst = max(8, udp_rcvbuf() // 2 // 4096)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    parse, rx = gtt.make("tsparse"), Receiver()
    got, passed = [], []
    for i in range(0, len(dgrams), burst):
        for d in dgrams[i:i + burst]:
            tx.sendto(d, ("127.0.0.1", port))
        got.append(src.pull_bytes())
        passed.append(parse.chain(got[-1]))
        rx.push(passed[-1], eos=i + burst >= len(dgrams))
    tx.close()
    src.close()
    if b"".join(got) != ts or b"".join(passed) != ts:
        fail(f"ts_over_rtp: {sum(map(len, got))} TS bytes came out of "
             f"rtpsrc and {sum(map(len, passed))} out of tsparse, "
             f"{len(ts)} went in, or they differ")
    if parse.programs != {1: 0x20} or sorted(parse.streams) != [0x40,
                                                                0x41]:
        fail(f"ts_over_rtp: tsparse programs {parse.programs}, streams "
             f"{parse.streams}")
    rx.check("rtpsrc ! tsparse ! tsdemux ! h264parse")
    caps = rx.h264.src_caps
    if (caps["width"], caps["height"], caps["framerate"][0]
            / caps["framerate"][1]) != (1920, 1080, TS_FPS):
        fail(f"ts_over_rtp: h264parse caps {caps}")
    remux = mux(rx.video, rx.sound)
    again = Receiver()
    for i in range(0, len(remux), 65536):
        again.push(remux[i:i + 65536], eos=i + 65536 >= len(remux))
    again.check("mpegtsmux ! tsdemux")
    if remux != ts:
        fail("ts_over_rtp: the second mux differs from the first")
    secs = time.perf_counter() - t0
    mbps = es_bytes / secs / 1e6
    log(f"ts_over_rtp: {len(aus)} access units of H.264 1920x1080 "
        f"({sum(len(a) for a, _ in aus) * 8 / TS_SECONDS / 1e6:.2f} Mb/s) "
        f"and {len(audio)} audio buffers, {len(ts)} TS bytes in "
        f"{len(dgrams)} datagrams of 7 packets (bursts of {burst}): "
        f"rtpsrc, tsparse, tsdemux, h264parse and mpegtsmux give back "
        f"every access unit and pts exactly, continuity errors 0; "
        f"{mbps:.2f} MB/s of elementary stream through the whole chain, "
        f"both muxes included ({secs:.1f} s, host clock; {card})")
    return {"aus": aus, "mbps": mbps}


# the upstream unit-test vectors of four parsers
# (tests/check/elements/{h265parse,mpeg4videoparse,mpegvideoparse,
# h263parse}.c): 128x128 HEVC, 32x24 MPEG-4 part 2 and MPEG-2, CIF H.263
H265_128 = bytes.fromhex(
    "0000000140010c01ffff01600000030090000003000003003f95980900000001"
    "42010101600000030090000003000003003fa0102020596566924cafff000100"
    "01010000030001000003001e08000000014401c172b42240"
)
H265_128_IDR = bytes.fromhex(
    "000000012801af0ee034821584f4704fffed413fffe4cdc47c030cc2bbb074e5"
    "ef4fe1a3d40002c2"
)
MPEG4_CONFIG = bytes.fromhex(
    "000001b001000001b58913000001000000012000c48d8800f501040314630000"
    "01b3001007"
)
MPEG4_VOP = bytes.fromhex(
    "000001b6106091823db7f1b6dfc6db7f1b6dfb"
)
MPEG2_SEQ = bytes.fromhex(
    "000001b302001815ffffe028000001b5148a00010000000001b800080000"
)
MPEG2_PIC = bytes.fromhex(
    "00000100000ffff8000001b58ffff341800000010123f87d29488b94a5222000"
    "00010223f87d29488b94a52220"
)
H263_PIC = bytes.fromhex(
    "000080020c042620202021ffff310101010ffff9880808087fffcc40404043ff"
    "fe620202021ffff310101010ffff9880808087fffcc40404043fffe620202021"
    "ffff310101010ffff9880808087fffcc40404043fffe620202021ffff3101010"
    "10ffff9880808087fffcc40404043fffe620202021ffff310101010ffff98808"
)


def transport_host_checks(gtt, card, frame, dgrams, aus) -> None:
    """The transport plane's other names once each on the card's host,
    on seeded inputs, each against its own round-trip or stream-table
    invariant: sdpdemux on an SDP of rtp_headline_1080p's session with
    one frame's datagrams, the ONVIF pair on them, pcapparse on a pcap and
    irtspparse on RTSP-interleaved framing of them, the PS mux and demux
    on ts_over_rtp's access units, and each of the eleven parsers on a
    stream of its format."""
    import json
    import struct
    import zlib
    import numpy as np
    from gstbad_tpu_torch.io import dirac, rtpnet, vc1

    t0 = time.perf_counter()
    h, w = frame.shape[:2]
    rows = frame.reshape(h, -1)

    def depays_to_frame(datagrams, what):
        depay = rtpnet.RawVideoDepayloader("BGRA", w, h)
        done = []
        for d in datagrams:
            done += depay.depay(rtpnet.RtpPacket.parse(d))
        if len(done) != 1 or not np.array_equal(done[0][1], rows):
            fail(f"{what}: the datagrams do not depay to the frame")

    # sdpdemux: the session of rtp_headline_1080p, then its RTP by port
    sdp = ("v=0\no=- 1 1 IN IP4 127.0.0.1\ns=rtp_headline_1080p\n"
           "c=IN IP4 127.0.0.1\nt=0 0\nm=video 5004 RTP/AVP 96\n"
           "a=rtpmap:96 raw/90000\na=fmtp:96 sampling=BGRA; width=1920; "
           "height=1080; depth=8; colorimetry=BT709-2; exactframerate=60\n")
    el = gtt.make("sdpdemux")
    streams = el.push_sdp(sdp)
    caps = streams[0].caps
    if (len(streams), streams[0].pt, streams[0].rtp_port,
            caps["encoding-name"], caps["sampling"], caps["width"]) != (
            1, 96, 5004, "RAW", "BGRA", "1920"):
        fail(f"sdpdemux: streams {streams}")
    for d in dgrams:
        if el.push_rtp(d, port=5004) is not streams[0]:
            fail("sdpdemux: a datagram went to no stream")
    pulled = el.pull(0)
    if [o["payload"] for o in pulled] != [
            rtpnet.RtpPacket.parse(d).payload for d in dgrams]:
        fail("sdpdemux: the stream's packets differ from those pushed")
    depays_to_frame([rtpnet.RtpPacket(
        payload_type=96, seq=o["seq"], timestamp=o["timestamp"],
        marker=o["marker"], payload=o["payload"]).serialize()
        for o in pulled], "sdpdemux")

    # rtponviftimestamp ! rtponvifparse: the extension on, then read
    ntp_offset = 3600 * 1_000_000_000
    stamp = gtt.make("rtponviftimestamp", **{"ntp-offset": ntp_offset,
                                             "set-e-bit": True})
    stamped = []
    for i, d in enumerate(dgrams):
        stamped += stamp.chain(d, pts_ns=0, keyframe=i == 0)
    stamped += stamp.event_eos()
    parse = gtt.make("rtponvifparse")
    parsed = [parse.chain(d) for d in stamped]
    if (len(parsed) != len(dgrams) or parsed[0]["pts"] != ntp_offset
            or not parsed[0]["keyframe"] or not parsed[0]["discont"]
            or [rtpnet.RtpPacket.parse(o["data"]).payload for o in parsed]
            != [rtpnet.RtpPacket.parse(d).payload for d in dgrams]):
        fail("rtponviftimestamp/rtponvifparse: the round trip differs")
    depays_to_frame([o["data"] for o in parsed], "rtponvifparse")

    # pcapparse on Ethernet/IPv4/UDP records of the datagrams
    blob = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for i, d in enumerate(dgrams):
        udp = struct.pack(">HHHH", 5004, 5004, 8 + len(d), 0) + d
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(udp), 0, 0, 64,
                         17, 0, bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
        eth = bytes(12) + b"\x08\x00" + ip + udp
        blob += struct.pack("<IIII", 1, i, len(eth), len(eth)) + eth
    pcap = gtt.make("pcapparse", **{"dst-port": 5004})
    recs = []
    for i in range(0, len(blob), 65536):
        recs += pcap.chain(blob[i:i + 65536])
    if [r["data"] for r in recs] != dgrams or recs[-1]["pts"] != (
            10 ** 9 + (len(dgrams) - 1) * 1000):
        fail("pcapparse: the records differ from the datagrams")

    # irtspparse: RTP on channel 0 interleaved with RTCP on channel 1
    sr = rtpnet.RtcpSR(ssrc=1, ntp=0, rtp_ts=0, packet_count=len(dgrams),
                       octet_count=0).serialize()
    stream = b"".join(bytes([0x24, 0]) + struct.pack(">H", len(d)) + d
                      + (bytes([0x24, 1]) + struct.pack(">H", len(sr)) + sr
                         if i % 100 == 0 else b"")
                      for i, d in enumerate(dgrams))
    rtsp = gtt.make("irtspparse", **{"channel-id": 0})
    frames_out = []
    for i in range(0, len(stream), 4096):
        frames_out += rtsp.chain(stream[i:i + 4096])
    if [f["data"] for f in frames_out] != dgrams:
        fail("irtspparse: the channel's frames differ from the datagrams")

    # mpegpsmux ! mpegpsdemux on the first 2 s of ts_over_rtp's stream
    mux = gtt.make("mpegpsmux")
    v = mux.connect("video/x-h264")
    a = mux.connect("audio/mpeg")
    ps = b""
    for i, (au, pts) in enumerate(aus[:2 * TS_FPS]):
        ps += mux.chain(v, au, pts_ns=pts)
        ps += mux.chain(a, bytes([i]) * 384, pts_ns=pts)
    ps += mux.event_eos()
    dmx = gtt.make("mpegpsdemux")
    pes = dmx.push_bytes(ps)
    if ([(o["data"], o["pts"]) for o in pes if o["stream_id"] == 0xE0]
            != aus[:2 * TS_FPS] or not dmx.saw_end
            or sorted(dmx.stream_types) != [0xC0, 0xE0]):
        fail("mpegpsmux/mpegpsdemux: the round trip differs")
    log(f"transport host checks: sdpdemux, rtponviftimestamp, "
        f"rtponvifparse, pcapparse and irtspparse on one 1080p frame's "
        f"{len(dgrams)} datagrams, mpegpsmux/mpegpsdemux on "
        f"{2 * TS_FPS} access units: every round trip exact")

    # the eleven parsers, each on a stream of its format
    data = os.path.join(ROOT, "tests", "data")

    def vectors(name):
        blob = open(os.path.join(data, name + ".bin"), "rb").read()
        return blob, json.load(open(os.path.join(data, name + ".json")))

    def run(name, stream, step=4096, finish=True, **setup):
        el = gtt.make(name)
        for method, args in setup.items():
            getattr(el, method)(*args)
        feed = el.chain if name == "vc1parse" else el.push
        out = []
        for i in range(0, len(stream), step):
            out += feed(stream[i:i + step])
        if finish:
            out += el.finish()
        return [o["data"] for o in out], el.src_caps

    def check(name, got, want, caps, keys):
        if got != want or any(caps.get(k) != v for k, v in keys.items()):
            fail(f"{name}: {len(got)} buffers out of {len(want)}, or they "
                 f"differ, or caps {caps} are not {keys}")

    stream = b"".join(a for a, _ in aus[:TS_FPS])
    got, caps = run("h264parse", stream, step=65536)
    check("h264parse", got, [a for a, _ in aus[:TS_FPS]], caps,
          {"width": 1920, "height": 1080, "framerate": (2 * TS_FPS, 2)})
    got, caps = run("h265parse", H265_128 + H265_128_IDR * 3, step=7)
    check("h265parse", got, [H265_128 + H265_128_IDR] + [H265_128_IDR] * 2,
          caps, {"width": 128, "height": 128, "profile": "main"})
    got, caps = run("mpegvideoparse", MPEG2_SEQ + MPEG2_PIC * 3, step=7)
    check("mpegvideoparse", got, [MPEG2_SEQ + MPEG2_PIC] + [MPEG2_PIC] * 2,
          caps, {"width": 32, "height": 24, "mpegversion": 2})
    got, caps = run("mpeg4videoparse", MPEG4_CONFIG + MPEG4_VOP * 3, step=7)
    check("mpeg4videoparse", got, [MPEG4_CONFIG + MPEG4_VOP]
          + [MPEG4_VOP] * 2, caps, {"width": 32, "height": 24})
    got, caps = run("h263parse", H263_PIC * 5, step=13)
    check("h263parse", got, [H263_PIC] * 5, caps,
          {"width": 352, "height": 288})
    blob, idx = vectors("av1_streams")
    off, ln = idx["arrays"]["stream_no_annexb_av1"]
    av1 = blob[off:off + ln]
    got, caps = run("av1parse", av1, step=1000,
                    set_output=("obu-stream", "frame"))
    check("av1parse", [len(g) for g in got],
          idx["nums"]["stream_av1_frame_size"], caps,
          {"width": 400, "height": 300})
    if b"".join(got) != av1:
        fail("av1parse: the frames do not make up the stream")
    blob, idx = vectors("vp9_frames")
    vp9 = [blob[f["offset"]:f["offset"] + f["len"]] for f in idx["frames"]]
    el = gtt.make("vp9parse")
    sizes = [[len(o["data"]) for o in el.push(f)] for f in vp9[:3]]
    check("vp9parse", sizes, [[len(vp9[0])], [idx["first_len"],
                                               idx["last_len"]],
                              [len(vp9[2])]], el.src_caps,
          {"width": 256, "height": 144})
    blob, idx = vectors("jpeg2000_frames")
    j2k = blob[idx["rgb_32_32_j2k"][0]:sum(idx["rgb_32_32_j2k"])]
    got, caps = run("jpeg2000parse", j2k * 3, step=17)
    check("jpeg2000parse", got, [j2k] * 3, caps, {"width": 32, "height": 32})
    layer = vc1.make_sequence_layer(vc1.PROFILE_MAIN,
                                    vc1.StructC(profile=vc1.PROFILE_MAIN),
                                    320, 240, 2, 25, 1)
    fl = [vc1.make_frame_layer_header(4, i == 0, 40 * i) + bytes([i]) * 4
          for i in range(3)]
    el = gtt.make("vc1parse")
    el.set_caps(header_format="sequence-layer")
    got = [o["data"] for o in el.chain(layer + b"".join(fl))]
    check("vc1parse", got, [layer] + fl, {"stream-format":
                                          el.in_stream_format},
          {"stream-format": "sequence-layer-frame-layer"})

    def png(wd, ht):
        def chunk(code, payload):
            return (struct.pack(">I", len(payload)) + code + payload
                    + struct.pack(">I", zlib.crc32(code + payload)))
        raw = b"".join(b"\x00" + bytes(range(wd)) for _ in range(ht))
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", wd, ht, 8, 0, 0, 0,
                                             0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    got, caps = run("pngparse", png(64, 48) * 3, step=100)
    check("pngparse", got, [png(64, 48)] * 3, caps,
          {"width": 64, "height": 48})
    hdr = dirac.SequenceHeader(
        major_version=2, minor_version=2, profile=8, level=0, index=0,
        width=352, height=288, chroma_format=2, interlaced=0,
        frame_rate_numerator=25, frame_rate_denominator=1,
        aspect_ratio_numerator=1, aspect_ratio_denominator=1,
        clean_width=352, clean_height=288, luma_offset=0,
        luma_excursion=255, chroma_offset=128, chroma_excursion=255)
    seq = dirac.build_parse_unit(dirac.PARSE_CODE_SEQUENCE_HEADER,
                                 dirac.build_sequence_header_payload(hdr))
    pics = [dirac.build_parse_unit(0x0C if i == 0 else 0x08,
                                   bytes([i]) * 9) for i in range(3)]
    got, caps = run("diracparse", seq + b"".join(pics), step=11)
    check("diracparse", got, [seq + pics[0]] + pics[1:], caps,
          {"width": 352, "height": 288, "framerate": (25, 1)})
    log(f"the eleven parsers: h264parse, h265parse, mpegvideoparse, "
        f"mpeg4videoparse, h263parse, av1parse, vp9parse, jpeg2000parse, "
        f"vc1parse, pngparse and diracparse each give back the buffers "
        f"of a stream of its format, with its caps "
        f"({time.perf_counter() - t0:.1f} s with the checks above)")


def rtp_reference_main(path: str) -> int:
    """chip_smoke.py --rtp-reference PATH: rtp_headline_1080p's frames
    through the same graph by the port on the CPU (rtpsrc fed by
    push_packet), its output frames and pts saved to PATH (.npz)."""
    import gc
    import numpy as np
    import torch
    import gstbad_tpu_torch as gtt
    # it runs beside the card's timed run: behind it, on half the cores;
    # its collections would change no byte of its output
    os.nice(10)
    torch.set_num_threads(4)
    gc.disable()
    frames = moving_bgra(WINDOW_4L * RTP_WINDOWS, W, H)
    dgrams, _ = rtp_datagrams(frames, WINDOW_4L)
    out = rtp_headline_path(gtt, "cpu", frames, WINDOW_4L, dgrams=dgrams)
    np.savez(path, data=np.concatenate([b.data for b in out["outs"]]),
             pts=np.concatenate([b.pts for b in out["outs"]]))
    return 0


def transport_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4l: the transport plane.  rtp_headline_1080p on the card
    (rtp_headline_path) with the counts set to 0 just before its run and
    read just after (K1 once a window, nothing else): every frame back,
    in order, its pts within one 90 kHz tick, and equal byte for byte to
    the CPU port's output of the same graph (run meanwhile in a process of
    its own, rtp_reference_main); K1 held against its plain version on
    this path's own window and timed there; frames/s end to end, the
    device step, the idle share and the datagrams.  Then ts_over_rtp and
    the other names on the host (transport_host_checks).  Returns K1's
    time and bound on this path."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gstbad_tpu_torch.ops import chainfuse

    t_phase = time.perf_counter()
    n = WINDOW_4L * RTP_WINDOWS
    # the CPU port's run of the same frames, in a process of its own
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rtp_")
    ref_path = os.path.join(tmp, "reference.npz")
    ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            "--rtp-reference", ref_path])
    try:
        frames = moving_bgra(n, W, H)
        for c in counters.values():
            c.launches = 0
        run = rtp_headline_path(gtt, "cuda", frames, WINDOW_4L)
        torch.cuda.synchronize()
        delta = {k: c.launches for k, c in counters.items()}
        for k, c in delta.items():
            want = RTP_WINDOWS if k == "dilate_zebra_fused" else 0
            if c != want:
                fail(f"rtp_headline_1080p: {k} launched {c} times in "
                     f"{RTP_WINDOWS} windows ({want} expected)")
        for k in launches:
            launches[k] += delta[k]
        back, ts90 = run["back"], [1500 * i for i in range(n)]
        if len(back) != n:
            fail(f"rtp_headline_1080p: {n - len(back)} of {n} frames lost "
                 f"(rtpsink sent {run['sink_sent']} datagrams, the "
                 f"receiver got {run['collected']}; rtpsrc took "
                 f"{run['received']} of {run['sent']}, dropped "
                 f"{run['src_dropped']} frames)")
        if any(abs(ts - want) > 1 for (ts, _), want in zip(back, ts90)):
            fail(f"rtp_headline_1080p: pts {[ts for ts, _ in back]} are "
                 f"not within one 90 kHz tick of {ts90}")
        card_out = np.concatenate([b.data for b in run["outs"]])
        card_pts = np.concatenate([b.pts for b in run["outs"]])
        gc.disable()     # the check's own lists, not the system's
        try:
            got = np.stack([f for _, f in back]).reshape(card_out.shape)
        finally:
            gc.enable()
        if not np.array_equal(got, card_out):
            fail("rtp_headline_1080p: what the receiver depaid differs from "
                 "what the pipeline gave rtpsink")

        # K1 on this path's own window (an uncounted replay of the step on
        # the first window rtpsrc uploaded), against its plain version
        p, batch = run["p"], run["inputs"][0]
        step = p.compile(WINDOW_4L)
        params, states = p.params(), p.init_states(WINDOW_4L)
        store = {}
        restore = capture(chainfuse, "dilate_zebra_fused", store)
        try:
            step(params, states, batch)
        finally:
            restore()
        (args, kw), = store["dilate_zebra_fused"]
        src, rank_t, word_t, index, erode, thr, phase = args
        if tuple(src.shape) != (WINDOW_4L, H, W) or kw.get("batch") not in (
                None, WINDOW_4L):
            fail(f"rtp_headline_1080p: K1 took {tuple(src.shape)} "
                 f"(batch {kw.get('batch')}), not a materialized window")
        b = WINDOW_4L
        scal = torch.stack([chainfuse._per_frame_i32(v, b, src.device)
                            for v in (erode, thr, phase)])
        k1 = chainfuse.dilate_zebra_fused(*args, **kw)
        e = byte_err(k1, chainfuse.dilate_zebra_plain(src, rank_t, word_t,
                                                      index, scal))
        err["dilate_zebra_fused"] = max(err["dilate_zebra_fused"], e)
        if e:
            fail(f"rtp_headline_1080p: K1 is {e} from its plain version on "
                 "the path's window")
        times = {"K1_rtp": (
            cuda_ms(lambda: chainfuse.dilate_zebra_fused(*args, **kw)),
            cuda_ms(lambda: chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, index, scal), iters=5), None)}
        sm_hz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout.split()[0]) * 1e6
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        int32_per_s = n_sm * INT32_LANES * sm_hz
        # as K1_materialized: B words read and written, 8 operations a
        # pixel
        bounds = {"K1_rtp": bound(2 * b * H * W * 4, 8 * b * H * W,
                                  int32_per_s)}
        step_ms = cuda_ms(lambda: step(params, states, batch), iters=5,
                          warmup=1)
        fps = n / run["t_wall"]
        idle = 1.0 - RTP_WINDOWS * step_ms / (run["t_wall"] * 1e3)
        log(f"rtp_headline_1080p: {n} seeded moving 1920x1080 BGRA frames "
            f"in {RTP_WINDOWS} windows of {WINDOW_4L} over RTP (RFC 4175, "
            f"MTU 1400): every frame back in order, pts within one 90 kHz "
            f"tick; launches {({k: v for k, v in delta.items() if v})}; K1 "
            f"equal to its plain version on the path's window "
            f"[{WINDOW_4L}, {H}, {W}], {times['K1_rtp'][0]:.4f} ms "
            f"(plain {times['K1_rtp'][1]:.4f} ms)")
        log(f"rtp_headline_1080p: {fps:.2f} frames/s end to end (host "
            f"clock, {run['t_wall']:.3f} s from run() to the last datagram "
            f"received; the CPU reference ran meanwhile at nice 10 in a "
            f"process of its own), device step {step_ms:.3f} ms a window (CUDA "
            f"events), idle share {idle:.4f}; datagrams: the feeder sent "
            f"{run['sent']}, rtpsrc took {run['received'] - 1} (and the "
            f"end-of-stream wake), rtpsink sent {run['sink_sent']}, the "
            f"receiver got {run['collected']} (receive buffer "
            f"{run['rcvbuf']} bytes; feeder bursts of {run['burst']}) "
            f"({card})")
        sp = run["spent"]
        log(f"rtp_headline_1080p host clock: rtpsrc's pulls (receive, "
            f"parse, jitter buffer, depayload, the upload) "
            f"{sp['pull']:.3f} s, rtpsink's host_process (payload, send) "
            f"{sp['sink']:.3f} s, the rest (steps, downloads, the runner) "
            f"{run['t_wall'] - sp['pull'] - sp['sink']:.3f} s of "
            f"{run['t_wall']:.3f} s")
        ts_res = ts_over_rtp(gtt, card)
        transport_host_checks(gtt, card, frames[0],
                              rtp_datagrams(frames[:1], 1)[0][0],
                              ts_res["aus"])
        if ref.wait(timeout=600) != 0:
            fail(f"rtp_headline_1080p: the CPU reference exited "
                 f"{ref.returncode}")
        with np.load(ref_path) as z:
            if not (np.array_equal(z["data"], card_out)
                    and np.array_equal(z["pts"], card_pts)):
                fail("rtp_headline_1080p: the card's output differs from the "
                     "CPU port's")
        log("rtp_headline_1080p: the card's output equals the CPU port's "
            "byte for byte (frames and pts)")
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"transport_slice: {time.perf_counter() - t_phase:.1f} s")
    return {"times": times, "bounds": bounds}


VMNC_WINDOW = 32                # vmnc_headline_1080p's window
VMNC_WINDOWS = 2                # and its windows
# vmnc_headline_1080p: a VMware screen recording through the headline
VMNC_HEADLINE = "vmncdec framerate=60/1 ! " + HEAD + " ! zebrastripe ! fakesink"
ONNX_WINDOW = 16                # onnx_detect_1080p's window
ONNX_WINDOWS = 2                # and its windows
ONNX_THRESHOLD = 0.5
ONNX_DETECT = ("videotestsrc pattern=ball width={w} height={h} format=BGRx "
               "! onnxobjectdetector model-file={model} "
               "input-image-format=chw score-node-index=0 box-node-index=1 "
               f"class-node-index=2 score-threshold={ONNX_THRESHOLD} "
               "! fakesink")
ONNX_TOL = 1e-4                 # scores and boxes, card against the CPU port
FP_RATE, FP_SECONDS, FP_BLOCK = 44100, 120, 4410   # fingerprint_native_44k
CHROMA_TOL = 1e-5               # the chroma rows (unit norm), card to CPU
FP_CODE_SHARE = 0.005           # differing 2-bit codes allowed
RFB_FRAMES = 16                 # rfbsrc's frames from the scripted server
RFB_PASSWORD = "pr4m-vnc"
MUX_PAYLOADS = 64               # mxf's and asf's seeded 1080p payloads
# the EXIF/XMP taglist of the jifmux check (tests/check/elements/jifmux.c)
JIF_TAGS = {
    "artist": "some artist", "copyright": "My copyright notice",
    "device-manufacturer": "MyFavoriteBrand", "device-model": "123v42.1",
    "description": "some description", "application-name": "chip_smoke",
    "capturing-shutter-speed": (1, 30), "capturing-focal-ratio": 2.0,
    "capturing-iso-speed": 800, "datetime": "2000:10:05 08:45:13",
    "geo-location-latitude": -32.375, "geo-location-longitude": 76.0125,
    "geo-location-elevation": 300.85, "image-orientation": "rotate-90",
}


def screen_updates(n, w, h, seed=91, vmware=True):
    """n seeded FramebufferUpdate messages of a w x h 32-bit truecolour
    screen laid out as BGRx (little-endian, red at bit 16, green 8, blue
    0): the first a RAW full-screen update (a desktop gradient with
    noise); every later one a COPY of a (w/3 x 4h/9) window dragged a few
    pixels, then HEXTILE rectangles of text-like tiles (a background, a
    foreground and 6-12 subrects; some tiles with coloured subrects, some
    raw) over about 3% of the screen.  vmware: VMnc packets (vmncdec's
    input), the first with the WMVi descriptor and a 16x16 colour cursor
    (WMVd, shown by WMVe), every later one moving it (WMVd, WMVf); else
    plain RFB updates (an RFB server's, without the pseudo-rectangles)."""
    import struct
    import numpy as np
    from gstbad_tpu_torch.io import vmnc
    rng = np.random.default_rng(seed)

    def rect(x, y, rw, rh, rtype, body=b""):
        return struct.pack(">HHHHI", x, y, rw, rh, rtype) + body

    def px(bgr):
        return bytes((int(bgr[0]), int(bgr[1]), int(bgr[2]), 0))

    yy, xx = np.mgrid[0:h, 0:w]
    desk = np.zeros((h, w, 4), np.uint8)
    desk[..., 0] = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
    desk[..., 1] = (yy * 255 // max(h - 1, 1)).astype(np.uint8)
    desk[..., 2] = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cw = ch = min(16, w, h)
    cursor = rng.integers(0, 256, (2, ch, cw, 4), dtype=np.uint8)
    cursor[..., 3] = 0
    wmvd = rect(1, 1, cw, ch, vmnc.TYPE_WMVd,
                bytes([vmnc.CURSOR_COLOUR, 0]) + cursor.tobytes())
    first = [rect(0, 0, w, h, vmnc.TYPE_RAW, desk.tobytes())]
    if vmware:
        first = ([rect(0, 0, w, h, vmnc.TYPE_WMVi,
                       bytes([32, 24, 0, 1])
                       + struct.pack(">HHH", 255, 255, 255)
                       + bytes([16, 8, 0, 0, 0, 0]))] + first
                 + [wmvd, rect(0, 0, 0, 0, vmnc.TYPE_WMVe,
                               struct.pack(">H", 1)),
                    rect(w // 2, h // 2, 0, 0, vmnc.TYPE_WMVf)])
    updates = [first]
    step = max(1, w // 640)
    ww, wh = w // 3, 4 * h // 9
    wx, wy = w // 5, h // 5
    tiles = max(1, round(0.03 * w * h / 256))
    for k in range(1, n):
        d = step if (k // 4) % 2 == 0 else -step
        rects = [rect(wx + d, wy + d, ww, wh, vmnc.TYPE_COPY,
                      struct.pack(">HH", wx, wy))]
        wx, wy = wx + d, wy + d
        left = tiles
        while left > 0:
            nt = min(4, left, w // 16)
            left -= nt
            rx = 16 * int(rng.integers(0, w // 16 - nt + 1))
            ry = 16 * int(rng.integers(0, h // 16))
            body = b""
            for _ in range(nt):
                kind = int(rng.integers(0, 10))
                if kind == 0:                                 # raw tile
                    body += b"\x01" + rng.integers(
                        0, 256, 16 * 16 * 4, dtype=np.uint8).tobytes()
                    continue
                subs = int(rng.integers(6, 13))
                body += bytes([0x0E | (0x10 if kind == 1 else 0)])
                body += px(rng.integers(200, 256, 3))       # background
                body += px(rng.integers(0, 60, 3))          # foreground
                body += bytes([subs])
                for _ in range(subs):
                    sx, sy = int(rng.integers(0, 16)), int(rng.integers(0, 16))
                    sw = int(rng.integers(1, 17 - sx))
                    sh = int(rng.integers(1, 17 - sy))
                    if kind == 1:
                        body += px(rng.integers(0, 256, 3))
                    body += bytes([(sx << 4) | sy, ((sw - 1) << 4) | (sh - 1)])
            rects.append(rect(rx, ry, 16 * nt, 16, vmnc.TYPE_HEXTILE, body))
        if vmware:
            rects += [wmvd, rect((w // 2 + 7 * k) % w, (h // 2 + 3 * k) % h,
                                 0, 0, vmnc.TYPE_WMVf)]
        updates.append(rects)
    return [struct.pack(">BBH", 0, 0, len(r)) + b"".join(r) for r in updates]


def vmnc_headline_path(gtt, device, packets, window):
    """vmnc_headline_1080p through gtt.parse_launch(..., device=device):
    the recording's packets pushed before the run (push_packet), then
    run() to its end.  Returns the pipeline, its output batches, the
    input windows vmncdec uploaded, the host clock inside the decoder
    (feed_packet and output_frame) and inside vmncdec's pulls (the
    decode, the window's stack and its upload), and run()'s."""
    import torch
    p = gtt.parse_launch(VMNC_HEADLINE, device=device)
    src = element_named(p, "vmncdec")
    for pk in packets:
        src.push_packet(pk)
    p.negotiate()
    out = {"p": p, "inputs": [], "decode_s": 0.0, "pull_s": 0.0}
    dec, orig_pull = src._dec, src.pull_window

    def timed(fn):
        def wrapped(*a):
            t = time.perf_counter()
            r = fn(*a)
            out["decode_s"] += time.perf_counter() - t
            return r
        return wrapped
    dec.feed_packet = timed(dec.feed_packet)
    dec.output_frame = timed(dec.output_frame)

    def pull(k):
        t = time.perf_counter()
        b = orig_pull(k)
        out["pull_s"] += time.perf_counter() - t
        if b is not None:
            out["inputs"].append(b)
        return b
    src.pull_window = pull
    t0 = time.perf_counter()
    out["outs"] = p.run(window=window)
    if device != "cpu":
        torch.cuda.synchronize()
    out["t_wall"] = time.perf_counter() - t0
    return out


def onnx_model(seed=95):
    """A seeded detector as ONNX ModelProto bytes, written here with a
    small protobuf writer: a 3x320x320 input; Conv 3->16 (k3 s2 p1),
    BatchNormalization, Relu; Conv 16->32 (k3 s2 p1), LeakyRelu; MaxPool
    (k2, strides 2); a depthwise Conv (group 32, k3 s2 p1), a 1x1 Conv to
    64 and Clip (0, 6); Conv 64->128 (k3 s2 p1); a 1x1 head to 6 values
    at each cell of the 10x10 grid; Reshape and Transpose to 100
    detections of 6; then three products (MatMul) pick the score logit
    (Sigmoid: the scores output), the 4 box values (the boxes output) and
    the class value (the classes output).  Weights are scaled so that
    every layer's outputs stay of order 1 on 0..255 inputs."""
    import struct
    import numpy as np
    rng = np.random.default_rng(seed)

    def vint(v):
        out = b""
        while True:
            b7, v = v & 0x7F, v >> 7
            if not v:
                return out + bytes([b7])
            out += bytes([b7 | 0x80])

    def ld(f, payload):
        return vint((f << 3) | 2) + vint(len(payload)) + payload

    def vi(f, v):
        return vint(f << 3) + vint(v & ((1 << 64) - 1))

    def tensor(name, arr):
        arr = np.asarray(arr)
        dt = {np.dtype("float32"): 1, np.dtype("int64"): 7}[arr.dtype]
        return (b"".join(vi(1, d) for d in arr.shape) + vi(2, dt)
                + ld(8, name.encode()) + ld(9, arr.tobytes()))

    def ints(name, vals):
        return ld(1, name.encode()) + b"".join(vi(8, v) for v in vals)

    def one_int(name, v):
        return ld(1, name.encode()) + vi(3, v)

    def one_float(name, v):
        return ld(1, name.encode()) + vint((2 << 3) | 5) \
            + struct.pack("<f", v)

    def node(op, ins, outs, attrs=()):
        return (b"".join(ld(1, i.encode()) for i in ins)
                + b"".join(ld(2, o.encode()) for o in outs)
                + ld(4, op.encode()) + b"".join(ld(5, a) for a in attrs))

    def vinfo(name, shape):
        dims = b"".join(ld(1, vi(1, d)) for d in shape)
        return ld(1, name.encode()) + ld(2, ld(1, vi(1, 1) + ld(2, dims)))

    def conv_w(o, i, k, gain=1.0):
        return (rng.standard_normal((o, i, k, k)) * gain
                / np.sqrt(i * k * k)).astype(np.float32)

    def conv(x, w, b, y, k, s, p, group=1):
        a = [ints("kernel_shape", [k, k]), ints("strides", [s, s]),
             ints("pads", [p] * 4)]
        if group > 1:
            a.append(one_int("group", group))
        return node("Conv", [x, w, b], [y], a)

    init = {
        "w1": conv_w(16, 3, 3, 1 / 128.0), "b1": np.zeros(16, np.float32),
        "bn_scale": (1 + 0.1 * rng.standard_normal(16)).astype(np.float32),
        "bn_bias": (0.1 * rng.standard_normal(16)).astype(np.float32),
        "bn_mean": (0.2 * rng.standard_normal(16)).astype(np.float32),
        "bn_var": (1 + 0.2 * rng.random(16)).astype(np.float32),
        "w2": conv_w(32, 16, 3), "b2": (0.1 * rng.standard_normal(32)
                                       ).astype(np.float32),
        "w3": conv_w(32, 1, 3), "b3": np.zeros(32, np.float32),
        "w4": conv_w(64, 32, 1), "b4": (0.1 * rng.standard_normal(64)
                                       ).astype(np.float32),
        "w5": conv_w(128, 64, 3), "b5": np.zeros(128, np.float32),
        "w6": conv_w(6, 128, 1, 2.0), "b6": (0.5 * rng.standard_normal(6)
                                            ).astype(np.float32),
        "shape": np.array([1, 6, 100], np.int64),
        "pick_score": np.eye(6, dtype=np.float32)[:, :1],
        "pick_box": np.eye(6, dtype=np.float32)[:, 1:5],
        "pick_class": np.eye(6, dtype=np.float32)[:, 5:],
    }
    nodes = [
        conv("x", "w1", "b1", "c1", 3, 2, 1),
        node("BatchNormalization", ["c1", "bn_scale", "bn_bias", "bn_mean",
                                    "bn_var"], ["n1"],
             [one_float("epsilon", 1e-5)]),
        node("Relu", ["n1"], ["r1"]),
        conv("r1", "w2", "b2", "c2", 3, 2, 1),
        node("LeakyRelu", ["c2"], ["l2"], [one_float("alpha", 0.1)]),
        node("MaxPool", ["l2"], ["p2"], [ints("kernel_shape", [2, 2]),
                                         ints("strides", [2, 2])]),
        conv("p2", "w3", "b3", "c3", 3, 2, 1, group=32),
        conv("c3", "w4", "b4", "c4", 1, 1, 0),
        node("Clip", ["c4"], ["k4"], [one_float("min", 0.0),
                                      one_float("max", 6.0)]),
        conv("k4", "w5", "b5", "c5", 3, 2, 1),
        conv("c5", "w6", "b6", "head", 1, 1, 0),
        node("Reshape", ["head", "shape"], ["flat"]),
        node("Transpose", ["flat"], ["det"], [ints("perm", [0, 2, 1])]),
        node("MatMul", ["det", "pick_score"], ["logit"]),
        node("Sigmoid", ["logit"], ["scores"]),
        node("MatMul", ["det", "pick_box"], ["boxes"]),
        node("MatMul", ["det", "pick_class"], ["classes"]),
    ]
    g = b"".join(ld(1, nd) for nd in nodes)
    g += b"".join(ld(5, tensor(k, v)) for k, v in init.items())
    g += ld(11, vinfo("x", [1, 3, 320, 320]))
    for name, shape in (("scores", [1, 100, 1]), ("boxes", [1, 100, 4]),
                        ("classes", [1, 100, 1])):
        g += ld(12, vinfo(name, shape))
    return ld(7, g)


def onnx_detect_path(gtt, device, model_path, w, h):
    """onnx_detect_1080p's ONNX_WINDOWS windows through
    gtt.parse_launch(..., device=device): its bus messages."""
    p = gtt.parse_launch(ONNX_DETECT.format(w=w, h=h, model=model_path),
                         device=device)
    p.run(n_frames=ONNX_WINDOW * ONNX_WINDOWS, window=ONNX_WINDOW)
    return bus_messages(p)


def detections_close(got, cpu, tol=ONNX_TOL, thr=ONNX_THRESHOLD) -> dict:
    """onnxobjectdetector's messages of a card run against the CPU port's:
    the same elements, names and pts; scores, boxes and classes within
    `tol` where both keep a detection; where one keeps it and the other
    not, the kept score within `tol` of the threshold (counted: `near`).
    Returns the largest differences and the counts."""
    import numpy as np
    if len(got) != len(cpu) or not got:
        fail(f"onnx_detect_1080p: {len(got)} messages on the card, "
             f"{len(cpu)} on the CPU")
    worst = {"scores": 0.0, "boxes": 0.0, "classes": 0.0}
    near = kept = 0
    for (ge, gn, gp, gf), (ce, cn, cp, cf) in zip(got, cpu):
        if (ge, gn, gp) != (ce, cn, cp) or sorted(gf) != sorted(cf):
            fail(f"onnx_detect_1080p: message {(ge, gn, gp)} != "
                 f"{(ce, cn, cp)}")
        gs, cs = np.asarray(gf["scores"]), np.asarray(cf["scores"])
        gk, ck = gs > 0, cs > 0
        both = gk & ck
        flip = gk != ck
        if flip.any():
            s = np.where(gk, gs, cs)[flip]
            if not (np.abs(s - thr) <= tol).all():
                fail(f"onnx_detect_1080p: keep masks differ away from the "
                     f"threshold (scores {s.tolist()})")
            near += int(flip.sum())
        if int(gf["count"]) - int(cf["count"]) != int(
                gk.sum()) - int(ck.sum()):
            fail("onnx_detect_1080p: count disagrees with the keep masks")
        kept += int(both.sum())
        for k in worst:
            a, b = np.asarray(gf[k]), np.asarray(cf[k])
            d = np.abs(a - b)[both]
            worst[k] = max(worst[k], float(d.max()) if d.size else 0.0)
    if not max(worst.values()) <= tol:
        fail(f"onnx_detect_1080p: {worst} from the CPU port's ({tol} "
             "allowed)")
    return {"worst": worst, "near": near, "kept": kept}


def chord_audio(seconds, rate, seed=97):
    """Seeded stereo S16 music: a chord (three partials and their
    harmonics) that changes every half second, over noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = seconds * rate
    t = np.arange(n) / rate
    seg = rate // 2
    roots = 110.0 * 2 ** (rng.integers(0, 24, -(-n // seg)) / 12.0)
    f0 = np.repeat(roots, seg)[:n]
    x = np.zeros(n)
    for ratio in (1.0, 1.25, 1.5):
        for harm, amp in ((1, 0.3), (2, 0.12), (3, 0.05)):
            x += amp * np.sin(2 * np.pi * f0 * ratio * harm * t)
    x = x / 3.0 + 0.02 * rng.standard_normal(n)
    right = 0.8 * x + 0.02 * rng.standard_normal(n)
    return (np.clip(np.stack([x, right], 1), -1, 1) * 32767
            ).astype(np.int16)


def fingerprint_path(gtt, device, samples):
    """fingerprint_native_44k: `samples` ([n, 2] S16) through appsrc !
    chromaprint engine=native ! ofa ! fakesink in FP_BLOCK blocks, then
    each one's end of stream (chromaprint posts at its 120 s cap, ofa at
    the end: 120 s is under its 135 s cap).  Returns the
    fingerprints, the engine chromaprint took, the bus's tag messages, the
    arguments of each chroma image the elements computed and the host
    clock of each fingerprint's computation (resample, chroma image on the
    device, quantizer, string)."""
    from gstbad_tpu_torch.elements.audio import fingerprint
    p = gtt.parse_launch(
        f"appsrc name=src kind=audio format=S16 rate={FP_RATE} channels=2 "
        "! chromaprint name=cp engine=native ! ofa name=ofa ! fakesink",
        device=device)
    p.get_by_name("src").push_frames(samples.reshape(-1, FP_BLOCK, 2))
    cp, ofa = p.get_by_name("cp"), p.get_by_name("ofa")
    store, spent = {}, {}
    restore = capture(fingerprint, "_chroma_image", store)
    for el in (cp, ofa):
        orig = el._finalize

        def finalize(bus, _el=el, _orig=orig):
            if not _el._posted:
                t = time.perf_counter()
                _orig(bus)
                spent[_el.NAME] = time.perf_counter() - t
        el._finalize = finalize
    try:
        p.run(window=64)
        for el in (cp, ofa):        # their end of stream: post if not yet
            el.eos(p.bus)
    finally:
        restore()
    return {"cp": cp.fingerprint, "ofa": ofa.fingerprint,
            "engine": "library" if cp._use_library() else "native",
            "tags": [(m.element, m.fields) for m in p.bus.messages
                     if m.name == "tag"],
            "chroma_args": store.get("_chroma_image", []), "ms": spent}


def code_diff_share(a: str, b: str) -> float:
    """The share of 2-bit codes that differ between two fingerprint
    strings (base64 of little-endian uint32 sub-fingerprints)."""
    import base64
    import numpy as np
    x = np.frombuffer(base64.urlsafe_b64decode(a), "<u4")
    y = np.frombuffer(base64.urlsafe_b64decode(b), "<u4")
    if x.shape != y.shape:
        return 1.0
    if not x.size:
        return 0.0
    d = x ^ y
    codes = sum(int(((d >> (2 * i)) & 3).astype(bool).sum())
                for i in range(16))
    return codes / (16 * x.size)


def mjpeg_frames(n, seed=41):
    """n 1920x1080 MJPEG frames of a UVC camera: phase 4i's uvc_mjpeg
    frames with a baseline SOF0 (4:2:0), a scan header and byte-stuffed
    scan bytes, so that they frame as JPEG (SOI, APP0, the APP4
    auxiliary payloads, SOF0, SOS, scan, EOI)."""
    import struct
    out = []
    for k in range(n):
        frame, _, _ = uvc_mjpeg(seed + k, 2, 1000)
        sos = frame.index(b"\xff\xda")
        scan = frame[sos + 2:-2].replace(b"\xff", b"\xff\x00")
        sof = b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, H, W, 3) + bytes(
            [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
        sos_hdr = b"\xff\xda" + struct.pack(">HB", 12, 3) + bytes(
            [1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
        out.append(frame[:sos] + sof + sos_hdr + scan + b"\xff\xd9")
    return out


def asf_payloads(stream: bytes) -> list:
    """The media objects of an ASF stream, read back from its data
    packets (asfparse's alignment, then each packet's payload parsing
    information and payloads, with or without the 0x82 ECC block), in the
    order of their first payload: [(stream number, keyframe, media object
    number, presentation time ms, bytes)]."""
    import struct
    from gstbad_tpu_torch.io import asf
    parse, units = asf.AsfParse(), []
    for i in range(0, len(stream), 1 << 16):    # one push copies its buffer
        units += parse.push(stream[i:i + (1 << 16)])
    sizes = {0: 0, 1: 1, 2: 2, 3: 4}
    fmt = {1: "<B", 2: "<H", 4: "<I"}
    objs, order = {}, []

    def field(pkt, pos, kind):
        n = sizes[kind]
        return (struct.unpack_from(fmt[n], pkt, pos)[0] if n else 0), pos + n

    for pkt in units[1:]:
        pos = 1 + (pkt[0] & 0x0F) if pkt[0] & 0x80 else 0
        flags, prop = pkt[pos], pkt[pos + 1]
        pos += 2
        _, pos = field(pkt, pos, (flags >> 5) & 3)          # packet length
        _, pos = field(pkt, pos, (flags >> 1) & 3)          # sequence
        _, pos = field(pkt, pos, (flags >> 3) & 3)          # padding
        pos += 6                                    # send time, duration
        count, len_kind = 1, 2
        if flags & 1:
            count, len_kind = pkt[pos] & 0x3F, pkt[pos] >> 6
            pos += 1
        for _ in range(count):
            num = pkt[pos]
            pos += 1
            obj, pos = field(pkt, pos, (prop >> 4) & 3)
            off, pos = field(pkt, pos, (prop >> 2) & 3)
            rep, pos = field(pkt, pos, prop & 3)
            size, pts = struct.unpack_from("<II", pkt, pos)
            pos += rep
            n, pos = field(pkt, pos, len_kind)
            key = (num & 0x7F, obj)
            if key not in objs:
                objs[key] = [num >> 7, pts, bytearray(size), 0]
                order.append(key)
            o = objs[key]
            o[2][off:off + n] = pkt[pos:pos + n]
            o[3] += n
            pos += n
    return [(k[0], bool(objs[k][0]), k[1], objs[k][1], bytes(objs[k][2]))
            for k in order if objs[k][3] == len(objs[k][2])]


RFB_SERVER_STARTED = "rfb-server-port"


def rfb_serve(srv, n, w, h, seed) -> list:
    """A scripted RFB 3.8 server for one client on the listening socket
    `srv`: VNC authentication with RFB_PASSWORD (the response checked
    against the port's DES), a BGRx ServerInit, then one update of
    screen_updates(..., vmware=False) for each update request the client
    sends.  Returns the SHA-256 of its framebuffer after each update
    (replayed by the port's VMnc decoder)."""
    import hashlib
    import struct
    from gstbad_tpu_torch.io import rfb, vmnc
    updates = screen_updates(n, w, h, seed, vmware=False)
    wmvi = struct.pack(">BBH", 0, 0, 1) + struct.pack(
        ">HHHHI", 0, 0, w, h, vmnc.TYPE_WMVi) + bytes(
        [32, 24, 0, 1]) + struct.pack(">HHH", 255, 255, 255) + bytes(
        [16, 8, 0, 0, 0, 0])
    dec = vmnc.VMncDecoder()
    dec.feed_packet(wmvi)
    hashes = []
    for u in updates:
        if dec.feed_packet(u) != len(u):
            raise RuntimeError("rfb server: an update the decoder refuses")
        hashes.append(hashlib.sha256(dec.imagedata.tobytes()).hexdigest())
    srv.settimeout(120)
    conn, _ = srv.accept()
    conn.settimeout(120)
    rx = conn.makefile("rb")

    def read(k):
        data = rx.read(k)
        if len(data) != k:
            raise RuntimeError("rfb server: the client went away")
        return data

    try:
        conn.sendall(b"RFB 003.008\n")
        if read(12) != b"RFB 003.008\n":
            raise RuntimeError("rfb server: the client did not answer 3.8")
        conn.sendall(bytes([1, rfb.SECURITY_VNC]))
        if read(1)[0] != rfb.SECURITY_VNC:
            raise RuntimeError("rfb server: the client took another "
                               "security type")
        challenge = hashlib.sha256(b"%d" % seed).digest()[:16]
        conn.sendall(challenge)
        ok = read(16) == rfb.vnc_auth_response(RFB_PASSWORD, challenge)
        conn.sendall(struct.pack(">I", 0 if ok else 1))
        if not ok:
            raise RuntimeError("rfb server: VNC authentication failed")
        read(1)                                 # ClientInit: shared
        name = b"chip_smoke rfb"
        conn.sendall(struct.pack(">HH", w, h) + bytes([32, 24, 0, 1])
                     + struct.pack(">HHH", 255, 255, 255)
                     + bytes([16, 8, 0, 0, 0, 0])
                     + struct.pack(">I", len(name)) + name)
        head = read(4)                          # SetEncodings
        read(4 * struct.unpack_from(">H", head, 2)[0])
        for u in updates:
            req = read(10)
            if req[0] != 3:
                raise RuntimeError(f"rfb server: message {req[0]}, not an "
                                   "update request")
            conn.sendall(u)
    finally:
        rx.close()
        conn.close()
    return hashes


def rfb_server_main(args) -> int:
    """chip_smoke.py --rfb-server N W H SEED: rfb_serve on a localhost TCP
    port (printed first), then its framebuffer hashes as a JSON line."""
    import socket
    n, w, h, seed = (int(a) for a in args)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    print(RFB_SERVER_STARTED, srv.getsockname()[1], flush=True)
    try:
        hashes = rfb_serve(srv, n, w, h, seed)
    finally:
        srv.close()
    print(json.dumps(hashes), flush=True)
    return 0


def rfb_server_process():
    """rfb_server_main in a process of its own (RFB_FRAMES updates at W x
    H, seed 7), started early: it makes its updates and their hashes
    before it accepts the client."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--rfb-server", str(RFB_FRAMES), str(W), str(H),
                             "7"], stdout=subprocess.PIPE, text=True)


def file_format_host_checks(gtt, card, srv) -> dict:
    """The host names of phase 4m, each once, each against its round
    trip: jpegparse and jifmux on mjpeg_frames (the frames and caps back;
    EXIF and XMP written and read back, libexif's reading compared where
    the host has libexif); kate text and SPU through kateenc -> kateparse
    -> katedec; mxfmux -> mxfdemux and asfmux -> asfparse on MUX_PAYLOADS
    seeded 1080p payloads (every byte and timestamp back; MB/s by the host
    clock); rfbsrc against rfb_server_main in a process of its own over
    localhost TCP at W x H (srv, rfb_server_process), RFB 3.8 with VNC
    authentication (every frame equal to the server's framebuffer;
    frames/s of pull_frame).  -> {name: what was checked}."""
    import hashlib
    import numpy as np
    from gstbad_tpu_torch.io import exif, kate as kate_io, xmp
    out = {}
    sec = 10 ** 9

    # jpegparse and jifmux
    frames = mjpeg_frames(4)
    stream = b"".join(frames)
    parse = gtt.make("jpegparse")
    got = []
    for i in range(0, len(stream), 4096):
        got += parse.chain(stream[i:i + 4096])
    if [g["data"] for g in got] != frames or any(
            (g["caps"]["width"], g["caps"]["height"], g["caps"]["format"])
            != (W, H, "I420") for g in got):
        fail("jpegparse: the frames or their caps did not come back")
    mux = gtt.make("jifmux")
    mux.set_tags(**JIF_TAGS)
    tagged = mux.chain(frames[0])
    back = gtt.make("jpegparse").chain(tagged)
    if len(back) != 1 or back[0]["data"] != tagged:
        fail("jifmux: its output does not frame as one JPEG")
    segs, pos = {}, 2
    while tagged[pos + 1] != 0xDA:
        n = int.from_bytes(tagged[pos + 2:pos + 4], "big")
        segs.setdefault(tagged[pos + 1], []).append(
            tagged[pos + 4:pos + 2 + n])
        pos += 2 + n
    ex_blob = next(s for s in segs[0xE1] if s[:6] == b"Exif\x00\x00")
    xmp_blob = next(s for s in segs[0xE1] if s[:29] == xmp.XMP_HEADER)
    if ex_blob != exif.build_exif(JIF_TAGS) or tagged[
            tagged.index(b"\xff\xda"):] != frames[0][
            frames[0].index(b"\xff\xda"):]:
        fail("jifmux: the EXIF block or the scan differs")
    read = xmp.parse_xmp(xmp_blob[29:])
    for k in ("artist", "copyright", "description", "device-model",
              "image-orientation"):
        if read.get(k) != JIF_TAGS[k]:
            fail(f"jifmux: XMP {k} read back as {read.get(k)!r}")
    if exif.libexif_available():
        raw = exif.read_exif_raw(ex_blob, [(exif.IFD0, 0x013B),
                                           (exif.IFD0, 0x0112),
                                           (exif.IFD_EXIF, 0x8827)])
        if raw != {(exif.IFD0, 0x013B): "some artist",
                   (exif.IFD0, 0x0112): 6, (exif.IFD_EXIF, 0x8827): 800}:
            fail(f"jifmux: libexif reads {raw}")
        lib = "libexif agrees"
    else:
        lib = "no libexif on this host"
    out["jpegparse_jifmux"] = (f"{len(frames)} frames, EXIF "
                               f"{len(ex_blob)} B, XMP {len(xmp_blob)} B, "
                               f"{lib}")

    # kate: text and SPU, kateenc -> kateparse -> katedec
    def kate_round(props, caps, feed):
        enc = gtt.make("kateenc", **props)
        enc.set_caps(caps)
        pkts = feed(enc) + enc.event_eos()
        kp = gtt.make("kateparse")
        parsed = []
        for p_ in pkts:
            parsed += kp.chain(p_["data"], granulepos=p_["granulepos"],
                               pts_ns=p_["pts"], dur_ns=p_["duration"])
        parsed += kp.event_eos()
        kd = gtt.make("katedec")
        return parsed, sum((kd.chain(p_["data"]) for p_ in parsed), [])
    texts = [f"line {i}: café — {i * 7}".encode() for i in range(8)]
    _, dec = kate_round({"category": "SUB", "language": "en"},
                        "text/x-raw, format=utf8",
                        lambda e: sum((e.push_text(t, 2 * i * sec, sec)
                                       for i, t in enumerate(texts)), []))
    if [(d["text"], d["pts"]) for d in dec if d["kind"] == "text"] != [
            (t.decode(), 2 * i * sec) for i, t in enumerate(texts)]:
        fail("kate: the texts did not come back")
    spus = spu_packets(4, 2 * sec)

    def feed_spu(enc):
        r = []
        for data, pts, clut in spus:
            enc.set_clut([int(c) for c in clut])
            r += enc.push_spu(data, pts)
        return r
    parsed, dec = kate_round({"category": "spu-subtitles"},
                             "subpicture/x-dvd", feed_spu)
    # the kate events in the parsed stream carry each picture as
    # spu_decode reads it; katedec hands each on as an SPU at its pts
    kd = kate_io.KateDecoder()
    events = [ev for kind, ev in map(kd.packetin, (p_["data"]
                                                   for p_ in parsed))
              if kind == "event"]
    dec = [d for d in dec if d["kind"] == "spu"]
    if len(events) != len(spus) or [d["pts"] for d in dec] != [
            pts for _, pts, _ in spus]:
        fail(f"kate: {len(events)} events and {len(dec)} SPUs for "
             f"{len(spus)} pictures")
    lost = lines = 0
    for ev, d, (data, _, clut) in zip(events, dec, spus):
        region, bitmap, _, _, _ = kate_io.spu_decode(
            data, [int(c) for c in clut])
        if (not np.array_equal(ev.bitmap.pixels, bitmap.pixels)
                or (ev.region.x, ev.region.y) != (region.x, region.y)):
            fail("kate: a picture changed between kateenc and katedec")
        again = kate_io.spu_decode(
            d["data"], [d["clut_event"][f"clut{i:02d}"] for i in range(16)]
        )[1].pixels
        rows = min(len(again), len(bitmap.pixels))
        lines += len(bitmap.pixels)
        lost += int((again[:rows] != bitmap.pixels[:rows]).any(1).sum()
                    + abs(len(again) - len(bitmap.pixels)))
    out["kate"] = (f"{len(texts)} texts, {len(spus)} SPUs; katedec's SPUs "
                   f"read back by spu_decode differ in {lost} of {lines} "
                   "lines (its end-of-line code with a colour, ROADMAP "
                   "queue 3)")

    # mxfmux -> mxfdemux, asfmux -> asfparse
    rng = np.random.default_rng(99)
    payloads = [rng.integers(0, 256, int(rng.integers(100_000, 400_000)),
                             dtype=np.uint8).tobytes()
                for _ in range(MUX_PAYLOADS)]
    total = sum(len(x) for x in payloads)
    t0 = time.perf_counter()
    mm = gtt.make("mxfmux")
    mm.connect_video(W, H, (25, 1))
    for x in payloads:
        mm.chain_video(x)
    blob = mm.event_eos()
    dm = gtt.make("mxfdemux")
    fr = []
    for i in range(0, len(blob), 1 << 20):
        fr += dm.push_bytes(blob[i:i + (1 << 20)])
    t_mxf = time.perf_counter() - t0
    if [f["data"] for f in fr] != payloads or [f["pts"] for f in fr] != [
            i * 40_000_000 for i in range(MUX_PAYLOADS)]:
        fail("mxf: the payloads or their timestamps did not come back")
    t0 = time.perf_counter()
    am = gtt.make("asfmux")
    v = am.connect_video(b"MPG2", W, H)
    for i, x in enumerate(payloads):
        am.chain(v, x, pts_ns=i * 40_000_000, keyframe=i % 12 == 0)
    stream = am.event_eos()
    ap = gtt.make("asfparse")
    units = []
    for i in range(0, len(stream), 1 << 20):
        units += ap.chain(stream[i:i + (1 << 20)])
    objs = asf_payloads(stream)
    t_asf = time.perf_counter() - t0
    if (b"".join(units) != stream or [o[4] for o in objs] != payloads
            or [(o[1], o[3]) for o in objs] != [
                (i % 12 == 0, 40 * i + 5000) for i in range(MUX_PAYLOADS)]):
        fail("asf: the packets, payloads or timestamps did not come back")
    out["mxf"] = (f"{MUX_PAYLOADS} payloads, {total} B, "
                  f"{total / t_mxf / 1e6:.2f} MB/s mux and demux")
    out["asf"] = (f"{MUX_PAYLOADS} payloads, {len(units) - 1} packets, "
                  f"{total / t_asf / 1e6:.2f} MB/s mux, parse and read back")

    # rfbsrc against a scripted server in a process of its own
    try:
        line = srv.stdout.readline().split()
        if line[:1] != [RFB_SERVER_STARTED]:
            fail(f"rfbsrc: the server did not start ({line})")
        src = gtt.make("rfbsrc", host="127.0.0.1", port=int(line[1]),
                       version="3.8", password=RFB_PASSWORD,
                       **{"use-copyrect": True})
        src.connect_tcp()
        t0 = time.perf_counter()
        pulled = [src.pull_frame() for _ in range(RFB_FRAMES)]
        t_rfb = time.perf_counter() - t0
        want = json.loads(srv.stdout.readline())
        if srv.wait(timeout=60) != 0:
            fail(f"rfbsrc: the server exited {srv.returncode}")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    got = [hashlib.sha256(f.tobytes()).hexdigest() for f in pulled]
    if got != want or src.format != "BGRx" or pulled[0].shape != (H, W, 4):
        fail("rfbsrc: a frame differs from the server's framebuffer")
    out["rfbsrc"] = (f"{RFB_FRAMES} {W}x{H} frames, "
                     f"{RFB_FRAMES / t_rfb:.2f} frames/s of pull_frame")
    return out


def file_format_reference_main(path: str, which: str) -> int:
    """chip_smoke.py --file-format-reference DIR PATH: one of phase 4m's
    CPU references by the port, beside the card's runs: "vmnc",
    vmnc_headline_1080p's frames and pts (DIR/vmnc.npz), or "onnx",
    onnx_detect_1080p's messages (DIR/onnx.pkl; the model at
    DIR/model.onnx)."""
    import gc
    import pickle
    import numpy as np
    import torch
    import gstbad_tpu_torch as gtt
    os.nice(10)
    torch.set_num_threads(3)
    gc.disable()
    if which == "vmnc":
        run = vmnc_headline_path(
            gtt, "cpu", screen_updates(VMNC_WINDOW * VMNC_WINDOWS, W, H),
            VMNC_WINDOW)
        np.savez(os.path.join(path, "vmnc.npz"),
                 data=np.concatenate([b.data for b in run["outs"]]),
                 pts=np.concatenate([b.pts for b in run["outs"]]))
        return 0
    msgs = onnx_detect_path(gtt, "cpu", os.path.join(path, "model.onnx"),
                            W, H)
    with open(os.path.join(path, "onnx.pkl"), "wb") as f:
        pickle.dump(msgs, f)
    return 0


def file_format_slice(gtt, counters, launches, err, card) -> dict:
    """Phase 4m: the file formats and the last in-repo device engines.
    vmnc_headline_1080p on the card (vmnc_headline_path) with the counts
    set to 0 just before its run and read just after (K1 once a window,
    nothing else), every frame equal to the CPU port's (run meanwhile in
    a process of its own, file_format_reference_main), K1 held against
    its plain version on the path's own window and timed there; frames/s
    end to end, the decoder's host clock, the device step and the idle
    share.  onnx_detect_1080p: its messages against the CPU port's
    (detections_close), no kernel launched, frames/s by events.
    fingerprint_native_44k: chromaprint engine=native and ofa on the card,
    each chroma image within CHROMA_TOL of the CPU port's, the strings
    equal or within FP_CODE_SHARE.  Then file_format_host_checks.
    Returns K1's time and bound on this path, and onnx_detect_1080p's
    step."""
    import gc
    import pickle
    import shutil
    import tempfile
    import numpy as np
    import torch
    from gstbad_tpu_torch.elements.audio import fingerprint
    from gstbad_tpu_torch.ops import chainfuse

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4m_")
    model = os.path.join(tmp, "model.onnx")
    with open(model, "wb") as f:
        f.write(onnx_model())
    refs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--file-format-reference", tmp, which])
            for which in ("vmnc", "onnx")]
    rfb = rfb_server_process()
    spent = {}
    t_mark = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        spent[name] = now - t_mark[0]
        t_mark[0] = now
    try:
        # vmnc_headline_1080p
        n = VMNC_WINDOW * VMNC_WINDOWS
        packets = screen_updates(n, W, H)
        for c in counters.values():
            c.launches = 0
        run = vmnc_headline_path(gtt, "cuda", packets, VMNC_WINDOW)
        torch.cuda.synchronize()
        delta = {k: c.launches for k, c in counters.items()}
        for k, c in delta.items():
            want = VMNC_WINDOWS if k == "dilate_zebra_fused" else 0
            if c != want:
                fail(f"vmnc_headline_1080p: {k} launched {c} times in "
                     f"{VMNC_WINDOWS} windows ({want} expected)")
        for k in launches:
            launches[k] += delta[k]
        card_out = np.concatenate([b.data for b in run["outs"]])
        card_pts = np.concatenate([b.pts for b in run["outs"]])
        if card_out.shape != (n, H, W, 4):
            fail(f"vmnc_headline_1080p: {card_out.shape} out of {n} frames")

        # K1 on this path's own window, against its plain version
        p, batch = run["p"], run["inputs"][0]
        step = p.compile(VMNC_WINDOW)
        params, states = p.params(), p.init_states(VMNC_WINDOW)
        store = {}
        restore = capture(chainfuse, "dilate_zebra_fused", store)
        try:
            step(params, states, batch)
        finally:
            restore()
        (args, kw), = store["dilate_zebra_fused"]
        src, rank_t, word_t, index, erode, thr, phase = args
        b = VMNC_WINDOW
        if tuple(src.shape) != (b, H, W) or kw.get("batch") not in (None, b):
            fail(f"vmnc_headline_1080p: K1 took {tuple(src.shape)} "
                 f"(batch {kw.get('batch')}), not a materialized window")
        scal = torch.stack([chainfuse._per_frame_i32(v, b, src.device)
                            for v in (erode, thr, phase)])
        e = byte_err(chainfuse.dilate_zebra_fused(*args, **kw),
                     chainfuse.dilate_zebra_plain(src, rank_t, word_t,
                                                  index, scal))
        err["dilate_zebra_fused"] = max(err["dilate_zebra_fused"], e)
        if e:
            fail(f"vmnc_headline_1080p: K1 is {e} from its plain version "
                 "on the path's window")
        times = {"K1_vmnc": (
            cuda_ms(lambda: chainfuse.dilate_zebra_fused(*args, **kw)),
            cuda_ms(lambda: chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, index, scal), iters=5), None)}
        sm_hz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout.split()[0]) * 1e6
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        bounds = {"K1_vmnc": bound(2 * b * H * W * 4, 8 * b * H * W,
                                   n_sm * INT32_LANES * sm_hz)}
        step_ms = cuda_ms(lambda: step(params, states, batch), iters=5,
                          warmup=1)
        idle = 1.0 - VMNC_WINDOWS * step_ms / (run["t_wall"] * 1e3)
        log(f"vmnc_headline_1080p: {n} frames of a seeded {W}x{H} VMnc "
            f"recording ({sum(len(x) for x in packets)} bytes: a RAW "
            f"frame, then COPY, HEXTILE and cursor updates) in "
            f"{VMNC_WINDOWS} windows of {VMNC_WINDOW}; launches "
            f"{({k: v for k, v in delta.items() if v})}; K1 equal to its "
            f"plain version on the path's window [{b}, {H}, {W}], "
            f"{times['K1_vmnc'][0]:.4f} ms (plain {times['K1_vmnc'][1]:.4f} "
            "ms)")
        log(f"vmnc_headline_1080p: {n / run['t_wall']:.2f} frames/s end to "
            f"end (host clock, {run['t_wall']:.3f} s for run(); the CPU "
            f"reference ran meanwhile at nice 10), the decoder "
            f"{run['decode_s']:.3f} s ({run['decode_s'] / n * 1e3:.2f} ms a "
            f"frame), vmncdec's pulls (decode, stack, upload) "
            f"{run['pull_s']:.3f} s, device step {step_ms:.3f} ms a window "
            f"(CUDA events), idle share {idle:.4f} ({card})")

        mark("vmnc_headline_1080p")

        # onnx_detect_1080p
        for c in counters.values():
            c.launches = 0
        got = onnx_detect_path(gtt, "cuda", model, W, H)
        torch.cuda.synchronize()
        if any(c.launches for c in counters.values()):
            fail("onnx_detect_1080p: a hand-written kernel launched: "
                 f"{ {k: c.launches for k, c in counters.items()} }")

        def onnx_build(d):
            return gtt.parse_launch(ONNX_DETECT.format(w=W, h=H,
                                                       model=model),
                                    device=d)
        fps, fps_all = fps_runs(onnx_build, ONNX_WINDOW)
        onnx_step = ONNX_WINDOW * 1000.0 / fps
        mark("onnx_detect_1080p")

        # fingerprint_native_44k
        samples = chord_audio(FP_SECONDS, FP_RATE)
        t0 = time.perf_counter()
        fp = fingerprint_path(gtt, "cuda", samples)
        t_fp = time.perf_counter() - t0
        if fp["engine"] != "native" or not fp["cp"] or not fp["ofa"]:
            fail(f"fingerprint_native_44k: engine {fp['engine']}, "
                 f"fingerprints {fp['cp']!r:.40} / {fp['ofa']!r:.40}")
        worst, share = 0.0, {}
        for (args, _), key in zip(fp["chroma_args"], ("cp", "ofa")):
            mono, dev = args
            if torch.device(dev).type != "cuda":
                fail(f"fingerprint_native_44k: a chroma image on {dev}")
            a = fingerprint._chroma_image(mono, "cuda")
            c_img = fingerprint._chroma_image(mono, "cpu")
            worst = max(worst, float(np.abs(a - c_img).max()))
            cpu_fp = fingerprint._fingerprint_string(
                fingerprint._quantize(c_img))
            share[key] = code_diff_share(fp[key], cpu_fp)
        if len(fp["chroma_args"]) != 2 or not worst <= CHROMA_TOL:
            fail(f"fingerprint_native_44k: chroma {worst:.3e} from the CPU "
                 f"port's ({CHROMA_TOL} allowed)")
        if max(share.values()) > FP_CODE_SHARE:
            fail(f"fingerprint_native_44k: {share} of the 2-bit codes "
                 "differ from the CPU port's")

        mark("fingerprint_native_44k")
        for k, v in file_format_host_checks(gtt, card, rfb).items():
            log(f"phase 4m host check {k}: {v}")
        mark("host checks")

        # the CPU references
        for ref in refs:
            if ref.wait(timeout=600) != 0:
                fail(f"phase 4m: a CPU reference exited {ref.returncode}")
        mark("waiting for the CPU references")
        with np.load(os.path.join(tmp, "vmnc.npz")) as z:
            if not (np.array_equal(z["data"], card_out)
                    and np.array_equal(z["pts"], card_pts)):
                fail("vmnc_headline_1080p: the card's output differs from "
                     "the CPU port's")
        with open(os.path.join(tmp, "onnx.pkl"), "rb") as f:
            cpu_msgs = pickle.load(f)
        gc.disable()
        try:
            close = detections_close(got, cpu_msgs)
        finally:
            gc.enable()
        if not close["kept"]:
            fail("onnx_detect_1080p: no detection kept")
        log("vmnc_headline_1080p: the card's output equals the CPU port's "
            "byte for byte (frames and pts)")
        log(f"onnx_detect_1080p: {len(got)} frames' messages within "
            f"{ONNX_TOL} of the CPU port's (largest: "
            + ", ".join(f"{k} {v:.3e}" for k, v in close["worst"].items())
            + f"); {close['kept']} detections kept on both, "
            f"{close['near']} scores within {ONNX_TOL} of the threshold "
            f"{ONNX_THRESHOLD} kept on one side only; no kernel launched; "
            f"{fps:.2f} frames/s by events (median of "
            f"{[round(x, 2) for x in fps_all]}), step {onnx_step:.3f} ms a "
            f"window of {ONNX_WINDOW} ({card})")
        log(f"fingerprint_native_44k: engine {fp['engine']} "
            f"(chromaprint) and ofa on {FP_SECONDS} s of seeded "
            f"{FP_RATE} Hz stereo S16 through appsrc; chroma images within "
            f"{worst:.3e} of the CPU port's (rows of unit norm); 2-bit codes "
            f"differing from the CPU port's: "
            + ", ".join(f"{k} {v:.5f}" for k, v in share.items())
            + "; fingerprint "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in fp["ms"].items())
            + f" (host clock, the chroma image on the card); the path "
            f"{t_fp:.2f} s ({card})")
    finally:
        for proc in refs + [rfb]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"file_format_slice: {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()) + ")")
    return {"times": times, "bounds": bounds,
            "onnx_step": (onnx_step, ONNX_WINDOW)}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import gstbad_tpu_torch as gtt
    from gstbad_tpu_torch.core.tablefuse import LinearIndex, TableChain
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.golden import geometric
    from gstbad_tpu_torch.ops import (_cuda, audio, blur, chainfuse, comb,
                                      fieldanalysis, lut, remap)

    dev = torch.device("cuda", 0)
    device_kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    t_start = time.perf_counter()
    t_mark = [t_start]

    def phase_done(name):
        """Log the seconds since the last phase ended."""
        now = time.perf_counter()
        log(f"phase {name}: {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    sm_hz = float(smi.stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_per_s = n_sm * FP32_LANES * sm_hz
    int32_per_s = n_sm * INT32_LANES * sm_hz
    log(f"top SM clock: {sm_hz / 1e6:.0f} MHz, {n_sm} SMs: {fp32_per_s:.4g} "
        f"FP32 and {int32_per_s:.4g} INT32 instructions/s")
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "absent"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} triton "
        f"{triton} python {sys.version.split()[0]} devices {count}")

    phase_done("1")

    # 2. build
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    log(f"build: {time.perf_counter() - t0:.2f} s total, nvcc "
        f"{info['seconds']:.2f} s, built={info['built']}, {info['path']}")
    for line in str(info["log"]).splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            log(f"  ptxas: {line.strip()}")

    phase_done("2")

    # 3. kernels against their plain versions on the card
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand_i32(*shape, lo=-2**31, hi=2**31 - 1):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def rand_frames(n, h, w):
        """uint8 frames: noise, with every other one a smooth gradient
        plus a little noise, so comb scores fall on both sides of the
        thresholds and metrics on both sides of the noise floor."""
        f = rand_i32(n, h, w, lo=0, hi=256).to(torch.uint8)
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        smooth = (xx * 3 + yy * 2) % 256
        noise = rand_i32((n + 1) // 2, h, w, lo=-3, hi=4)
        f[0::2] = (smooth + noise).clamp(0, 255).to(torch.uint8)
        return f

    word_t = rand_i32(256)
    rank_t = TableChain.rank_table(rand_i32(256, lo=0, hi=60000))
    luma = LinearIndex((19, 183, 54, 0), 8, 16)      # sepia head on BGRx
    mean2 = LinearIndex((0, 1, 1, 0), 0, 1)
    err = {k: 0 for k in ("dilate_zebra_fused", "apply_word_table",
                          "metrics_default", "comb_score_pairs",
                          "comb_mask", "gaussian_blur_words",
                          "warp_words", "vad_powers_serial",
                          "vad_powers_bracket", "freeverb_scan",
                          "adpcm_ima_decode", "adpcm_ms_decode",
                          "adpcm_ima_encode", "scope_filter",
                          "haar_cascade", "tilted_integral",
                          "sgm_aggregate", "overlay_blend",
                          "netsim_bucket")}
    wide = LinearIndex((300, 1000, 7, 0), 0, 11)     # weights above 255

    def check_k1(shape, batch, index, erode, thr):
        """K1 against its plain version on random words; erode and thr
        per frame ([B] tensors) or one value for all."""
        src = rand_i32(*shape)
        b = batch or shape[0]
        phase = torch.arange(b, dtype=torch.int32, device=dev) + 5
        got = chainfuse.dilate_zebra_fused(src, rank_t, word_t, index, erode,
                                           thr, phase, batch=batch)
        scal = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                            .expand(b) for v in (erode, thr, phase)])
        want = chainfuse.dilate_zebra_plain(src, rank_t, word_t, index, scal)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err["dilate_zebra_fused"] = max(err["dilate_zebra_fused"], e)
        return e

    cases = [((WINDOW, H, W), None, luma), ((1, H, W), WINDOW, luma),
             ((3, 37, 333), None, mean2), ((1, 37, 333), 5, mean2)]
    for shape, batch, index in cases:
        for erode in (False, True):
            e = check_k1(shape, batch, index, erode, 120)
            log(f"K1 dilate_zebra_fused src {shape} batch "
                f"{batch or shape[0]} erode {erode}: max_abs_err {e}")
    # a broadcast base whose frames mix erode values and thresholds (a
    # wrong reuse of the dilated tile across frames shows here), and the
    # index whose weights exceed 255 (the kernel's wide path)
    mixed_erode = (torch.arange(WINDOW, device=dev) // 3 % 2).to(torch.int32)
    mixed_thr = (torch.arange(WINDOW, device=dev) * 37 % 300 - 20).to(
        torch.int32)
    for shape, batch in (((1, H, W), WINDOW), ((WINDOW, H, W), None)):
        for index, name in ((luma, "luma"), (wide, "wide")):
            e = check_k1(shape, batch, index, mixed_erode, mixed_thr)
            log(f"K1 dilate_zebra_fused src {shape} batch {WINDOW} {name} "
                f"index, mixed erode and thresholds: max_abs_err {e}")
    # rows that are not 16-byte aligned take the kernel's scalar path
    hard = []
    for w in (1, 2, 3, 5, 127, 129, 333):
        for shape, batch in (((3, 37, w), None), ((1, 37, w), 5)):
            for index in (luma, wide):
                hard.append(check_k1(shape, batch, index,
                                     mixed_erode[:batch or 3],
                                     mixed_thr[:batch or 3]))
    log(f"K1 dilate_zebra_fused W 1, 2, 3, 5, 127, 129, 333 (H 37, "
        f"materialized and broadcast, luma and wide index, mixed frames): "
        f"{len(hard)} cases, max_abs_err {max(hard)}")
    for shape in ((WINDOW, H, W), (3, 37, 333)):
        idx = rand_i32(*shape, lo=0, hi=256)
        got = lut.apply_word_table(idx, word_t)
        want = lut.apply_word_table_plain(idx, word_t)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        log(f"K2 apply_word_table idx {shape}: max_abs_err {e}")
        err["apply_word_table"] = max(err["apply_word_table"], e)

    def check_telecine(label, pool, cur, prev, nf, pair_pool, top, bot,
                       frames):
        """K4, K5 and K6 against their plain versions on one input set."""
        got = fieldanalysis.metrics_default(pool, cur, prev, nf)
        want = fieldanalysis.metrics_default_plain(pool, cur, prev, nf)
        torch.cuda.synchronize()
        e4 = max(float((g - w).abs().max()) for g, w in zip(got, want))
        got = comb.comb_score_pairs(pair_pool, top, bot)
        want = comb.comb_score_pairs_plain(pair_pool, top, bot)
        torch.cuda.synchronize()
        e5 = max_abs_err(got, want)
        gm, gs = comb.comb_mask(frames)
        wm, ws = comb.comb_mask_plain(frames)
        torch.cuda.synchronize()
        e6 = max(max_abs_err(gm, wm), max_abs_err(gs, ws))
        log(f"K4/K5/K6 {label}: pool {tuple(pool.shape)}, {cur.numel()} "
            f"frames, {top.numel()} pairs (score sum {int(ws.sum())} / "
            f"{int(want.sum())}), mask {tuple(frames.shape)}: max_abs_err "
            f"{e4} / {e5} / {e6}")
        err["metrics_default"] = max(err["metrics_default"], e4)
        err["comb_score_pairs"] = max(err["comb_score_pairs"], e5)
        err["comb_mask"] = max(err["comb_mask"], e6)

    n_slots = 2 * WINDOW        # interlace's output slots per window
    n_pairs = 8 + 3 * n_slots - 1
    nf16 = torch.tensor(16, dtype=torch.int32, device=dev)
    for (p, h, w), npairs in (((n_slots + 1, H5, W5), n_pairs),
                              ((7, 50, 130), 13)):
        pool = rand_frames(p, h, w)
        cur = torch.arange(1, p, dtype=torch.int32, device=dev)
        prev = (cur - 1 - (cur % 3 == 0).to(torch.int32)).clamp(min=0)
        top = rand_i32(npairs, lo=0, hi=p)
        bot = rand_i32(npairs, lo=0, hi=p)
        check_telecine("random", pool, cur, prev, nf16, pool, top, bot,
                       pool[1:])

    def weave_frames(n, h, w):
        """Frames whose rows alternate 0 and 255, so that every cell of the
        band is an outlier; the odd frames inverted, so that a pair of one
        parity weaves to the same and of two parities to a flat frame."""
        f = torch.zeros((n, h, w), dtype=torch.uint8, device=dev)
        f[:, 1::2] = 255
        f[1::2] = 255 - f[1::2]
        return f

    def pairs_plain(pool, top, bot):
        """K5's plain version on the pairs inside the pool; a pair outside
        it scores 0 (the kernel reads nothing for it)."""
        p = pool.shape[0]
        inside = (top >= 0) & (top < p) & (bot >= 0) & (bot < p)
        want = torch.zeros(top.shape, dtype=torch.int32, device=dev)
        want[inside] = comb.comb_score_pairs_plain(pool, top[inside],
                                                   bot[inside])
        return want

    # repeated pairs, and indices below, at and far past the pool's end
    hard_top = torch.tensor([0, 0, 2, -1, 3, 0, 1, 1, 2**31 - 1],
                            dtype=torch.int32, device=dev)
    hard_bot = torch.tensor([1, 0, 2, 1, 0, 100, 1, 1, 0],
                            dtype=torch.int32, device=dev)
    for w in (1, 31, 33, 1281, 3840, 8192):
        scores = []
        for h in (4, 5, 6, 64):
            frames = weave_frames(3, h, w)
            gm, gs = comb.comb_mask(frames)
            got = comb.comb_score_pairs(frames, hard_top, hard_bot)
            wm, ws = comb.comb_mask_plain(frames)
            want = pairs_plain(frames, hard_top, hard_bot)
            torch.cuda.synchronize()
            e5 = max_abs_err(got, want)
            e6 = max(max_abs_err(gm, wm), max_abs_err(gs, ws))
            err["comb_score_pairs"] = max(err["comb_score_pairs"], e5)
            err["comb_mask"] = max(err["comb_mask"], e6)
            scores.append(f"H {h}: {int(ws.sum())} / {int(want.sum())} "
                          f"(err {e6} / {e5})")
        log(f"K6/K5 all-outlier weave W {w}, 3 frames, 9 pairs: score sums "
            + "; ".join(scores))

    def check_blur(label, src, kern, rows, cols, batch=None):
        """K3 against its plain version on one input."""
        got = blur.gaussian_blur_words(src, kern, rows, cols, batch=batch)
        want = blur.gaussian_blur_words_plain(src, kern, rows, cols,
                                              batch=batch)
        torch.cuda.synchronize()
        e = byte_err(got, want)
        log(f"K3 gaussian_blur_words {label} src {tuple(src.shape)} batch "
            f"{batch or src.shape[0]} taps {kern.numel()}: "
            f"max_abs_err {e} (bytes)")
        err["gaussian_blur_words"] = max(err["gaussian_blur_words"], e)

    def blur_tables(sigma, h, w):
        return [torch.from_numpy(t).to(dev)
                for t in blur.make_blur_tables(sigma, h, w)]

    def check_warp(label, src, mp, bg, batch=None):
        """K7 against its plain version on one input."""
        got = remap.warp_words(src, mp, bg, batch=batch)
        want = remap.warp_words_plain(src, mp, bg, batch=batch)
        torch.cuda.synchronize()
        e = byte_err(got, want)
        log(f"K7 warp_words {label} src {tuple(src.shape)} batch "
            f"{batch or src.shape[0]} bg {bg:#x}: max_abs_err {e} (bytes)")
        err["warp_words"] = max(err["warp_words"], e)

    def warp_map(warp, h, w, off_edge="ignore"):
        flat, valid = remap.fix_map(geometric.MAP_BUILDERS[warp](w, h), w, h,
                                    off_edge)
        return torch.from_numpy(remap.word_map(flat, valid)).to(dev)

    bg_ayuv = remap.background_word(b"\xff\x10\x80\x80")
    src_full, src_bcast = rand_i32(WINDOW, H, W), rand_i32(1, H, W)
    for sigma in (1.2, -2.0, 3.2, 8.0, 20.0):
        tables = blur_tables(sigma, H, W)
        check_blur(f"sigma {sigma}", src_full, *tables)
        check_blur(f"sigma {sigma}", src_bcast, *tables, batch=WINDOW)
        check_blur(f"sigma {sigma}", rand_i32(3, 37, 333),
                   *blur_tables(sigma, 37, 333))
    # frames one below, at and one above the tile: 64 columns, and 64 rows
    # at centres 4 and 50 (sigma 1.2, 20.0), 32 at centre 20 (sigma 8.0)
    for sigma in (1.2, 8.0, 20.0):
        before = err["gaussian_blur_words"]
        err["gaussian_blur_words"] = 0
        n = 0
        for h in (15, 16, 17, 31, 32, 33, 63, 64, 65):
            for w in (63, 64, 65):
                tables = blur_tables(sigma, h, w)
                for shape, batch in (((2, h, w), None), ((1, h, w), 3)):
                    src = rand_i32(*shape)
                    got = blur.gaussian_blur_words(src, *tables, batch=batch)
                    want = blur.gaussian_blur_words_plain(src, *tables,
                                                          batch=batch)
                    torch.cuda.synchronize()
                    err["gaussian_blur_words"] = max(
                        err["gaussian_blur_words"], byte_err(got, want))
                    n += 1
        log(f"K3 gaussian_blur_words sigma {sigma} at H 15-17, 31-33, 63-65 "
            f"and W 63-65 (materialized and broadcast): {n} cases, "
            f"max_abs_err {err['gaussian_blur_words']} (bytes)")
        err["gaussian_blur_words"] = max(err["gaussian_blur_words"], before)
    src4 = rand_i32(WINDOW4, H4, W4)
    for warp in ("fisheye", "twirl"):
        mp = warp_map(warp, H, W)
        check_warp(warp, src_full, mp, bg_ayuv)
        check_warp(warp, src_bcast, mp, 0, batch=WINDOW)
        check_warp(warp, src4, warp_map(warp, H4, W4), 0)
    check_warp("rotate wrap", rand_i32(3, 37, 333),
               warp_map("rotate", 37, 333, "wrap"), bg_ayuv)
    check_warp("rotate", rand_i32(1, 37, 333), warp_map("rotate", 37, 333),
               bg_ayuv, batch=5)
    del src_full, src_bcast, src4

    def vad_rows(kind, nb, n):
        """S16 VAD blocks: noise (the brackets close), DC 30000 and a 440 Hz
        square (they stay open), silence."""
        if kind == "noise":
            return rand_i32(nb, n, lo=-32768, hi=32768).to(torch.int16)
        if kind == "dc":
            return torch.full((nb, n), 30000, dtype=torch.int16, device=dev)
        if kind == "silence":
            return torch.zeros((nb, n), dtype=torch.int16, device=dev)
        t = torch.arange(nb * n, dtype=torch.float64, device=dev)
        return (26213 * torch.sign(torch.sin(2 * torch.pi * 440 * t
                                             / AUDIO_RATE))
                ).to(torch.int16).reshape(nb, n)

    def check_vad(label, data, p0):
        """K8's two modes against their plain versions on one input; the
        serial plain version on a CPU copy (one Python step per sample)."""
        got = audio.vad_powers_serial(data, p0)
        lo, hi = audio.vad_powers_bracket(data)
        want = audio.vad_powers_serial_plain(data.cpu(), p0.cpu())
        want_lo, want_hi = audio.vad_powers_bracket_plain(data)
        torch.cuda.synchronize()
        es = max_abs_err(got.cpu(), want)
        eb = max(max_abs_err(lo, want_lo), max_abs_err(hi, want_hi))
        closed = int((want_lo == want_hi).sum())
        log(f"K8 vad_powers serial/bracket {label} {tuple(data.shape)}: "
            f"max_abs_err {es} / {eb} ({closed} of {data.shape[0]} "
            "brackets closed)")
        err["vad_powers_serial"] = max(err["vad_powers_serial"], es)
        err["vad_powers_bracket"] = max(err["vad_powers_bracket"], eb)

    p0 = torch.tensor(123456789, dtype=torch.int64, device=dev)
    for kind in ("noise", "dc", "silence", "square"):
        check_vad(kind, vad_rows(kind, WINDOW, AUDIO_BLOCK), p0)
    for nb, n in ((3, 300), (5, 4801)):
        for kind in ("noise", "square"):
            check_vad(kind, vad_rows(kind, nb, n), p0)

    # K4's hard cases: both load paths (8-byte rows at W 1280, bytes at the
    # rest and on pools whose base is not 8-byte aligned), the smallest
    # heights, either side of the band height (128) and of the height
    # where a frame splits into two bands (192), the gates' edges (nf -1
    # and 0 keep every pixel, 255 and 256 put nf^2 at and past the largest
    # square, 46341 past int32), frames whose indices lie outside the pool
    # (zeros), and more frames than the card has SMs
    def metrics_or_zeros(pool, cur, prev, nf):
        p = pool.shape[0]
        inside = (cur >= 0) & (cur < p) & (prev >= 0) & (prev < p)
        want = [torch.zeros(cur.shape, dtype=torch.float32, device=dev)
                for _ in range(5)]
        if inside.any():
            for a, b in zip(want, fieldanalysis.metrics_default_plain(
                    pool, cur[inside], prev[inside], nf)):
                a[inside] = b
        return want

    def check_k4(pool, cur, prev, nf):
        got = fieldanalysis.metrics_default(pool, cur, prev, nf)
        want = metrics_or_zeros(pool, cur, prev, nf)
        torch.cuda.synchronize()
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err["metrics_default"] = max(err["metrics_default"], e)
        return e

    hard_cur = torch.tensor([1, 2, 3, 4, 0, 5, 2], dtype=torch.int32,
                            device=dev)
    hard_prev = torch.tensor([0, 1, 2, 3, -1, 4, 2**31 - 1],
                             dtype=torch.int32, device=dev)
    k4_nfs = [torch.tensor(v, dtype=torch.int32, device=dev)
              for v in (-1, 0, 16, 255, 256, 46341)]
    n_cases, e4 = 0, 0.0
    for w in (1, 3, 5, 12, 15, 17, 127, 129, 1280, 1281):
        for h in (4, 6, 8, 126, 128, 130, 190, 192, 194):
            pool = rand_frames(5, h, w)
            for nf in k4_nfs:
                e4 = max(e4, check_k4(pool, hard_cur, hard_prev, nf))
                n_cases += 1
    flat = rand_frames(1, 1, 4 * 40 * 64 + 8).reshape(-1)
    frames300 = torch.arange(1, 301, dtype=torch.int32, device=dev)
    for pool, cur in ([(rand_frames(301, 36, 40), frames300)]
                      + [(flat[o:o + 4 * 40 * 64].view(4, 40, 64),
                          frames300[:3]) for o in (1, 2, 4)]):
        e4 = max(e4, check_k4(pool, cur, cur - 1, k4_nfs[2]))
        n_cases += 1
    log(f"K4 metrics_default hard cases: {n_cases} (W 1-1281, H 4-194, nf "
        "-1 to 46341, out-of-pool indices, 300 frames, unaligned pools): "
        f"max_abs_err {e4}")

    # K8's bracket on its hard cases: rows shorter than a batch of 32
    # squares and either side of it, across chunks of 2048 squares, odd
    # lengths (2-byte staging) and 9600 (16-byte staging, five chunks),
    # one row, the main path's 64 and 300; brackets that close (noise,
    # silence) and stay open (DC, square); a base that is not 16-byte
    # aligned
    def check_bracket(data):
        lo, hi = audio.vad_powers_bracket(data)
        want_lo, want_hi = audio.vad_powers_bracket_plain(data)
        torch.cuda.synchronize()
        e = max(max_abs_err(lo, want_lo), max_abs_err(hi, want_hi))
        err["vad_powers_bracket"] = max(err["vad_powers_bracket"], e)
        return e, int((want_lo == want_hi).sum())

    n_cases, e8, closed = 0, 0, 0
    for n in (1, 31, 33, 300, 4801, 9600):
        for nb in (1, WINDOW, 300):
            for kind in ("noise", "dc", "square", "silence"):
                e, c = check_bracket(vad_rows(kind, nb, n))
                e8, closed, n_cases = max(e8, e), closed + c, n_cases + 1
    flat = vad_rows("noise", 1, WINDOW * AUDIO_BLOCK + 8).reshape(-1)
    for o in (1, 8):
        e, c = check_bracket(flat[o:o + WINDOW * AUDIO_BLOCK].view(
            WINDOW, AUDIO_BLOCK))
        e8, closed, n_cases = max(e8, e), closed + c, n_cases + 1
    log(f"K8 vad_powers_bracket hard cases: {n_cases} (n 1-9600, nb 1-300, "
        f"noise/DC/square/silence, unaligned rows): max_abs_err {e8} "
        f"({closed} brackets closed)")

    # freeverb_scan against its plain version, which runs on a CPU copy
    # (one Python step a sample); both take the C's operation order
    fv_params = {k: v.to(dev) for k, v in gtt.make(
        "freeverb").dynamic_params().items()}
    fv_plain_s = {}

    def check_freeverb(label, rate, mono, xs, params=fv_params):
        """freeverb_scan over the blocks xs (host float32 arrays), the state
        carried from block to block, against freeverb_scan_plain on the
        CPU: the largest difference of any output sample or state value."""
        cpu_params = {k: v.cpu() for k, v in params.items()}
        st = audio.freeverb_init_state(rate, dev)
        ref = audio.freeverb_init_state(rate, "cpu")
        e = 0.0
        for x in xs:
            st, y = audio.freeverb_scan(st, x.to(dev), params, rate, mono)
            t0 = time.perf_counter()
            ref, want = audio.freeverb_scan_plain(ref, x, cpu_params, rate,
                                                  mono)
            fv_plain_s[label] = time.perf_counter() - t0
            torch.cuda.synchronize()
            e = max(e, float((y.cpu() - want).abs().max()),
                    *(float((st[k].cpu().double() - ref[k].double())
                            .abs().max()) for k in ref))
        err["freeverb_scan"] = max(err["freeverb_scan"], e)
        log(f"freeverb_scan {label} at {rate} Hz "
            f"{'mono' if mono else 'stereo'}, blocks "
            f"{[tuple(x.shape) for x in xs]}: max_abs_err {e:.3e}")
        return e

    def fv_noise(n, mono, scale=0.9):
        shape = (n,) if mono else (n, 2)
        return ((torch.rand(shape, generator=gen, device=dev) - 0.5)
                * (2 * scale)).cpu()

    # the full [64 x 2205, 2] window is checked on freeverb_22k's own
    # input below; here 4 blocks, mono and stereo
    n_fv = 4 * FV_BLOCK
    for mono in (False, True):
        check_freeverb(f"[{n_fv}{'' if mono else ', 2'}]", FV_RATE, mono,
                       [fv_noise(n_fv, mono)])
    # hard cases: 8 kHz (an allpass ring of 40 samples, shorter than the
    # kernel's 128-sample chunk), 16 kHz and 31999 Hz (the largest rings);
    # a block of one sample and one a sample shorter than the shortest
    # ring, then a long one, the state carried across the three calls;
    # the element's other corners (damping 0.9, room size 1)
    for rate in (8000, 16000, 31999):
        short = int(min(v.min() for v in audio.freeverb_sizes(
            rate).values())) - 1
        for mono in (False, True):
            check_freeverb("hard", rate, mono,
                           [fv_noise(n, mono) for n in (1, short, 3000)])
    hard_params = {k: v.to(dev) for k, v in gtt.make(
        "freeverb", damping=0.9, **{"room-size": 1.0}).dynamic_params()
        .items()}
    check_freeverb("damping 0.9, room-size 1", FV_RATE, False,
                   [fv_noise(2000, False)], hard_params)
    if not err["freeverb_scan"] <= 2e-6:
        fail(f"freeverb_scan: {err['freeverb_scan']:.3e} from its plain "
             "version (2e-6 allowed)")
    if any(v for k, v in err.items() if k != "freeverb_scan"):
        fail(f"kernels disagree with their plain versions: {err}")

    phase_done("3")

    # 4. the main paths through parse_launch on the card
    runs, windows = main_graphs(gtt, benchmarks)
    audio_keys = ("config3_audio", "vad_square")
    counters = kernel_counters()
    # (windows, window) of each path's counted run, and the launches each
    # kernel must make per window on it
    plan = {"headline_bars": (3, 8, {"dilate_zebra_fused": 1}),
            "headline_ball": (3, 8, {"dilate_zebra_fused": 1}),
            "prefix_bars": (3, 8, {"apply_word_table": 2}),
            "config5_ivtc": (2, WINDOW, {"metrics_default": 1,
                                         "comb_score_pairs": 1}),
            "combdetect_720p": (2, WINDOW, {"comb_mask": 1}),
            "config2_blur_bars": (2, 8, {"gaussian_blur_words": 1}),
            "config2_blur_ball": (2, 8, {"gaussian_blur_words": 1}),
            "config4_warp": (1, WINDOW4, {"warp_words": 2}),
            "warp_1080p": (2, WINDOW, {"warp_words": 1}),
            # a sine's brackets close: the serial mode never runs
            "config3_audio": (2, WINDOW, {"vad_powers_bracket": 1,
                                          "vad_powers_serial": 0}),
            "vad_square": (2, WINDOW, {"vad_powers_bracket": 1,
                                       "vad_powers_serial": 1}),
            "transcode_i420_blur": (2, 8, {"gaussian_blur_words": 1}),
            "iqa_dssim_1080p": (2, 4, {"gaussian_blur_words": 1}),
            # a window of 16: the CPU port walks its 35280 samples one by
            # one (the kernel's plain check takes the 64-block window)
            "freeverb_22k": (1, 16, {"freeverb_scan": 1})}
    shapes = {"headline_bars": (H, W, 4), "headline_ball": (H, W, 4),
              "prefix_bars": (H, W, 4), "config5_ivtc": (H5, W5),
              "combdetect_720p": (H5, W5), "config2_blur_bars": (H, W, 4),
              "config2_blur_ball": (H, W, 4), "config4_warp": (H4, W4, 4),
              "warp_1080p": (H, W, 4), "iqa_dssim_1080p": (H, W, 4)}

    # K3 to K7's main-path inputs, recorded on uncounted runs
    inputs = {}
    undo = [capture(fieldanalysis, "metrics_default", inputs),
            capture(comb, "comb_score_pairs", inputs),
            capture(comb, "comb_mask", inputs),
            capture(blur, "gaussian_blur_words", inputs),
            capture(remap, "warp_words", inputs)]
    runs["config5_ivtc"]("cuda").run(n_frames=2 * WINDOW, window=WINDOW)
    runs["combdetect_720p"]("cuda").run(n_frames=WINDOW, window=WINDOW)
    for key in ("config2_blur_bars", "config2_blur_ball", "config4_warp",
                "warp_1080p"):
        runs[key]("cuda").run(n_frames=windows[key], window=windows[key])
    # K8's: config 3's bracket input and vad_square's serial input; config
    # 3's freeverb output on the card, held against the CPU port's below
    undo += [capture(audio, "vad_powers_bracket", inputs),
             capture(audio, "vad_powers_serial", inputs),
             capture(audio, "freeverb_scan", inputs)]
    fv_card = tap_data(runs["config3_audio"]("cuda"), "freeverb", 2, WINDOW)
    runs["vad_square"]("cuda").run(n_frames=WINDOW, window=WINDOW)
    runs["freeverb_22k"]("cuda").run(n_frames=WINDOW, window=WINDOW)
    for u in undo:
        u()
    torch.cuda.synchronize()
    fv_err = float((fv_card - tap_data(runs["config3_audio"]("cpu"),
                                       "freeverb", 2, WINDOW)).abs().max())
    log(f"config3_audio: freeverb output on the card within {fv_err:.3e} "
        "of the CPU port's (2e-6 allowed)")
    if not fv_err <= 2e-6:
        fail("config3_audio: freeverb output differs from the CPU port's")
    (x_bracket,), _ = inputs["vad_powers_bracket"][0]
    (x_serial, p0_serial), _ = inputs["vad_powers_serial"][0]
    check_vad("main-path inputs config3_audio", x_bracket, p0_serial)
    check_vad("main-path inputs vad_square", x_serial, p0_serial)
    # freeverb_22k's window, as the element gives it to the walk: its F32
    # output within 2e-6 of the plain version's is the path's F32 check
    if len(inputs["freeverb_scan"]) != 1:
        fail(f"freeverb_22k gave freeverb_scan "
             f"{len(inputs['freeverb_scan'])} inputs, 1 expected")
    fv_args, _ = inputs["freeverb_scan"][0]
    fv_st_mp, fv_x_mp, fv_p_mp, fv_rate_mp, fv_mono_mp = fv_args
    check_freeverb("main-path input freeverb_22k", fv_rate_mp, fv_mono_mp,
                   [fv_x_mp.cpu()], fv_p_mp)
    if not err["freeverb_scan"] <= 2e-6:
        fail(f"freeverb_scan: {err['freeverb_scan']:.3e} from its plain "
             "version on freeverb_22k's input (2e-6 allowed)")
    if len(inputs["vad_powers_bracket"]) != 3 or len(
            inputs["vad_powers_serial"]) != 1:
        fail("main paths gave K8's bracket "
             f"{len(inputs['vad_powers_bracket'])} and its serial mode "
             f"{len(inputs['vad_powers_serial'])} inputs, 3 and 1 expected")
    pool_mp, cur_mp, prev_mp, nf_mp = inputs["metrics_default"][-1][0]
    pool5, top_mp, bot_mp = inputs["comb_score_pairs"][-1][0]
    (frames_mp,) = inputs["comb_mask"][-1][0]
    check_telecine("main-path inputs", pool_mp, cur_mp, prev_mp, nf_mp,
                   pool5, top_mp, bot_mp, frames_mp)
    # blur: bars (broadcast base), ball (materialized); warp: config 4's
    # fisheye and twirl (materialized 4K), warp_1080p's fisheye (broadcast)
    blur_mp = inputs["gaussian_blur_words"]
    warp_mp = inputs["warp_words"]
    for (args, kw), label in zip(blur_mp, ("config2_blur_bars",
                                           "config2_blur_ball")):
        check_blur(f"main-path inputs {label}", *args, **kw)
    for (args, kw), label in zip(warp_mp, ("config4_warp fisheye",
                                           "config4_warp twirl",
                                           "warp_1080p fisheye")):
        check_warp(f"main-path inputs {label}", *args, **kw)
    if len(blur_mp) != 2 or len(warp_mp) != 3:
        fail(f"main paths gave K3 {len(blur_mp)} and K7 {len(warp_mp)} "
             "inputs, 2 and 3 expected")
    if any(v for k, v in err.items() if k != "freeverb_scan"):
        fail(f"kernels disagree with their plain versions: {err}")

    launches = {k: 0 for k in counters}
    outs, msgs = {}, {}
    for key, build in runs.items():
        n_windows, window, need = plan[key]
        pipe = build("cuda")
        for c in counters.values():
            c.launches = 0
        outs[key] = pipe.run(n_frames=n_windows * window, window=window)
        torch.cuda.synchronize()
        msgs[key] = bus_messages(pipe)
        delta = {k: c.launches for k, c in counters.items()}
        log(f"{key}: launches {delta}")
        for k, per in need.items():
            if delta[k] != per * n_windows:
                fail(f"{key}: {k} launched {delta[k]} times in {n_windows} "
                     f"windows ({per} per window expected)")
        for k in launches:
            launches[k] += delta[k]
    log(f"main path launches {launches}")
    for key, build in runs.items():
        n_windows, window, _ = plan[key]
        t0 = time.perf_counter()
        pipe = build("cpu")
        cpu = pipe.run(n_frames=n_windows * window, window=window)
        log(f"{key}: the CPU port's run {time.perf_counter() - t0:.1f} s")
        if key in audio_keys or key == "freeverb_22k":
            # S16 samples within 1 LSB (config 3 and freeverb_22k: the
            # float32 reverb's sums), exact for vad_square, at any share
            lsb = 0 if key == "vad_square" else 1
            block = (FV_BLOCK, 2) if key == "freeverb_22k" else (
                AUDIO_BLOCK, 1)
            worst, n_diff, total = batches_close(
                key, outs[key], cpu, lsb, share=1.0, shape=block,
                dtype="int16")
            messages_close(key, msgs[key], bus_messages(pipe))
            log(f"{key}: {len(cpu)} windows; {n_diff} of {total} samples "
                f"({n_diff / total:.6f}) differ from the CPU port's, by at "
                f"most {worst} LSB; pts, valid and {len(msgs[key])} bus "
                "messages equal")
            continue
        if key == "transcode_i420_blur":
            batches_close(key, outs[key], cpu, dtype="uint8", shape={
                "y": (H, W), "u": (H // 2, W // 2), "v": (H // 2, W // 2)})
            log(f"{key}: {len(cpu)} windows, "
                f"{sum(len(b.pts) for b in cpu)} I420 frames equal the CPU "
                "port")
            continue
        if key == "iqa_dssim_1080p":
            worst = iqa_close(key, msgs[key], bus_messages(pipe))
            log(f"{key}: {len(msgs[key])} IQA messages within {worst:.3e} "
                "(dssim) of the CPU port's; " + "; ".join(
                    f"pts {m[2]} dssim {m[3]['dssim']:.6f} ssim "
                    f"{m[3]['ssim']:.6f}" for m in msgs[key][:2]))
        batches_close(key, outs[key], cpu, shape=shapes[key], dtype="uint8")
        log(f"{key}: {len(cpu)} windows, {sum(len(b.pts) for b in cpu)} "
            "frames equal the CPU port")
    fid = {d: benchmarks.config5_fidelity(W5, H5, device=d)
           for d in ("cuda", "cpu")}
    log(f"config5_fidelity card {fid['cuda']} cpu {fid['cpu']}")
    if fid["cuda"] != fid["cpu"]:
        fail("config5_fidelity differs between the card and the CPU port")

    phase_done("4")

    # 4b. videoconvert's format matrix: every (source, target) pair of its
    # 26 formats on a random 64x48 window of 4 frames, card against CPU
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat as VF
    from gstbad_tpu_torch.elements.video.convert import _ALL as CONVERT_ALL

    def random_frames(fmt, b, h, w):
        def u8(*shape):
            return rand_i32(*shape, lo=0, hi=256).to(torch.uint8)

        def u16(*shape):
            return rand_i32(*shape, lo=0, hi=65536).to(torch.uint16)
        planes = {VF.I420: (h // 2, w // 2), VF.YV12: (h // 2, w // 2),
                  VF.Y444: (h, w), VF.Y42B: (h, w // 2), VF.Y41B: (h, w // 4)}
        if fmt in planes:
            return {"y": u8(b, h, w), "u": u8(b, *planes[fmt]),
                    "v": u8(b, *planes[fmt])}
        if fmt in VF.SEMIPLANAR_YUV:
            return {"y": u8(b, h, w), "uv": u8(b, h // 2, w)}
        if fmt in VF.PACKED_RGB16:
            return u16(b, h, w)
        if fmt == VF.ARGB64:
            return u16(b, h, w, 4)
        if fmt == VF.GRAY8:
            return u8(b, h, w)
        if fmt in VF.PACKED_YUV422:
            return u8(b, h, 2 * w)
        return u8(b, h, w, VF.n_channels(fmt))

    def convert_on(device, src, dst, data):
        el = gtt.make("videoconvert", format=dst)
        el.device = torch.device(device)
        el.set_info(MediaSpec(kind="video", format=src, width=CONVERT_W,
                              height=CONVERT_H))
        tree = ({k: v.to(device) for k, v in data.items()}
                if isinstance(data, dict) else data.to(device))
        out = el.process(el.dynamic_params(), None,
                         FrameBatch.make(tree))[1].data
        return ({k: v.cpu() for k, v in out.items()}
                if isinstance(out, dict) else out.cpu())

    n_pairs = 0
    for src in CONVERT_ALL:
        data = random_frames(src, 4, CONVERT_H, CONVERT_W)
        for dst in CONVERT_ALL:
            card_out = convert_on("cuda", src, dst, data)
            cpu_out = convert_on("cpu", src, dst, data)
            pairs = ([(card_out[k], cpu_out[k]) for k in cpu_out]
                     if isinstance(cpu_out, dict) else [(card_out, cpu_out)])
            if isinstance(cpu_out, dict) != isinstance(card_out, dict) or any(
                    a.dtype != c.dtype or not torch.equal(a, c)
                    for a, c in pairs):
                fail(f"videoconvert {src} -> {dst}: the card differs from "
                     "the CPU port")
            n_pairs += 1
    log(f"videoconvert format matrix: {n_pairs} pairs of "
        f"{len(CONVERT_ALL)} formats at {CONVERT_W}x{CONVERT_H}, 4 frames: "
        "card equals CPU")

    phase_done("4b")

    # 4c. the noise sources: window independence and determinism on the
    # card, card against CPU (both draw from the same integer hash)
    def noise_run(desc, device, n, window):
        res = gtt.parse_launch(desc, device=device).run(n_frames=n,
                                                        window=window)
        first = res[0].data
        if isinstance(first, dict):
            return {k: np.concatenate([b.data[k] for b in res])
                    for k in first}
        return {"": np.concatenate([b.data for b in res])}

    def same(a, b):
        return sorted(a) == sorted(b) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a)

    for fmt in ("AYUV", "I420", "GRAY8"):
        desc = (f"videotestsrc pattern=noise width={W} height={H} "
                f"format={fmt} seed=7 ! fakesink")
        a = noise_run(desc, "cuda", 8, 4)
        if not (same(a, noise_run(desc, "cuda", 8, 8))
                and same(a, noise_run(desc, "cuda", 8, 4))
                and same(a, noise_run(desc, "cpu", 8, 2))):
            fail(f"videotestsrc pattern=noise {fmt}: windows 4 and 8, a "
                 "second run and the CPU port do not agree")
        drawn = a["y"] if "y" in a else a[""]
        if fmt == "AYUV":
            drawn = drawn[..., 1:]
        hist = np.bincount(drawn.ravel(), minlength=256)
        expect = drawn.size / 256
        log(f"videotestsrc pattern=noise {fmt} {W}x{H}, 8 frames: windows "
            "4 and 8, two runs and the CPU port equal; byte chi-squared "
            f"{((hist - expect) ** 2 / expect).sum():.1f} over 255 degrees "
            "of freedom")
    desc = ("audiotestsrc wave=white-noise channels=2 format=F32 seed=7 "
            f"samplesperbuffer={AUDIO_BLOCK} ! fakesink")
    a = noise_run(desc, "cuda", WINDOW, 16)
    if not (same(a, noise_run(desc, "cuda", WINDOW, WINDOW))
            and same(a, noise_run(desc, "cpu", WINDOW, 32))):
        fail("audiotestsrc wave=white-noise: windows 16 and 64 and the CPU "
             "port do not agree")
    x = a[""][..., 0].astype(np.float64)
    if not (x[:16] != x[16:32]).mean() > 0.99:
        fail("audiotestsrc wave=white-noise: consecutive windows repeat")
    log(f"audiotestsrc wave=white-noise {WINDOW} blocks of {AUDIO_BLOCK}: "
        f"windows 16 and 64 and the CPU port equal; mean {x.mean():.6f}, "
        f"variance {x.var():.6f} (uniform on [-0.8, 0.8]: 0, "
        f"{0.64 / 3:.6f})")

    phase_done("4c")

    # 4d. the runtime surface (runtime_surface)
    runtime_surface(gtt, benchmarks, runs, counters, launches, card)
    phase_done("4d")

    # 4e. the opencv family, digitalzoom, lcms and codecalpha (cv_slice)
    cv_slice(gtt, benchmarks, counters, card)
    phase_done("4e")

    # 4f. audio breadth (audio_slice)
    walk = audio_slice(gtt, benchmarks, counters, launches, err, card)
    phase_done("4f")

    # 4g. the rest of the OpenCV family (cv_detect_slice)
    detect = cv_detect_slice(gtt, counters, launches, err, card)
    phase_done("4g")

    # 4h. overlay and the text renderers (overlay_slice)
    overlays = overlay_slice(gtt, counters, launches, err, card)
    phase_done("4h")

    # 4i. what the runtime slice deferred and the small elements of begun
    # modules (deferred_slice)
    deferred = deferred_slice(gtt, counters, launches, err, card)
    phase_done("4i")

    # 4j. the sessions (session_slice)
    sessions = session_slice(gtt, counters, launches, err, card)
    phase_done("4j")

    # 4k. the mesh and the inter-process transports (mesh_slice)
    mesh_slice(gtt, counters, launches, err, card)
    phase_done("4k")

    # 4l. the transport plane (transport_slice)
    transport = transport_slice(gtt, counters, launches, err, card)
    phase_done("4l")

    # 4m. the file formats and the last in-repo device engines
    # (file_format_slice)
    formats = file_format_slice(gtt, counters, launches, err, card)
    phase_done("4m")

    # 5. timing
    fps = {}
    for key, build in runs.items():
        med, all_runs = fps_runs(build, windows[key])
        fps[key] = med
        log(f"fps {key} window {windows[key]}: median {med:.1f} source "
            f"frames/s of {[round(x, 1) for x in all_runs]} ({card})")
    for key in audio_keys:
        rt = fps[key] * AUDIO_BLOCK / AUDIO_RATE
        log(f"realtime {key}: {fps[key]:.1f} source blocks/s of "
            f"{AUDIO_BLOCK} samples = {rt:.2f}x realtime at 48 kHz "
            f"({card})")
    rt = fps["freeverb_22k"] * FV_BLOCK / FV_RATE
    log(f"realtime freeverb_22k: {fps['freeverb_22k']:.1f} source blocks/s "
        f"of {FV_BLOCK} samples = {rt:.2f}x realtime at {FV_RATE} Hz "
        f"({card})")
    log("realtime config3_audio: the compiled C chain of BASELINE config 3 "
        f"on the host CPU runs {C_AUDIO_REALTIME_X}x realtime "
        f"(BASELINE_C.json): the card's graph is "
        f"{fps['config3_audio'] * AUDIO_BLOCK / AUDIO_RATE / C_AUDIO_REALTIME_X:.3f}"
        "x that")
    step_ms = {key: (windows[key] * 1000.0 / fps[key], windows[key])
               for key in runs}
    # the traces: the fourteen and phase 4j's device graphs; the earlier
    # slices' traces stand in PERF.md section 5 from their own runs
    # (tracing them took most of the profile process)
    step_ms.update((k, sessions["step_ms"][k]) for k in TRACED_4J)
    step_ms["onnx_detect_1080p"] = formats["onnx_step"]
    phase_done("5 (frames/s)")
    profile_graphs(step_ms)
    phase_done("5 (profiles)")

    src_bcast = rand_i32(1, H, W)
    src_full = rand_i32(WINDOW, H, W)
    phase = torch.arange(WINDOW, dtype=torch.int32, device=dev)
    scal = torch.stack([torch.zeros(WINDOW, dtype=torch.int32, device=dev),
                        torch.full((WINDOW,), 213, dtype=torch.int32,
                                   device=dev), phase])
    idx = rand_i32(WINDOW, H, W, lo=0, hi=256)
    times = {}   # label -> (ms, plain ms, library ms or None)
    # K1 takes its per-frame erode, threshold and phase as tensors on the
    # card, as zebrastripe passes them: Python scalars would add two
    # uploads to every timed call
    for label, src, batch in (("bcast", src_bcast, WINDOW),
                              ("materialized", src_full, None)):
        times[f"K1_{label}"] = (
            cuda_ms(lambda: chainfuse.dilate_zebra_fused(
                src, rank_t, word_t, luma, scal[0], scal[1], phase,
                batch=batch)),
            cuda_ms(lambda: chainfuse.dilate_zebra_plain(
                src, rank_t, word_t, luma, scal), iters=5), None)
    # K2's one-call library form: the same lookup as a single indexing call
    times["K2"] = (cuda_ms(lambda: lut.apply_word_table(idx, word_t)),
                   cuda_ms(lambda: lut.apply_word_table_plain(idx, word_t),
                           iters=5),
                   cuda_ms(lambda: word_t[idx], iters=5))
    times["K4"] = (
        cuda_ms(lambda: fieldanalysis.metrics_default(
            pool_mp, cur_mp, prev_mp, nf_mp)),
        cuda_ms(lambda: fieldanalysis.metrics_default_plain(
            pool_mp, cur_mp, prev_mp, nf_mp), iters=3), None)
    # K4's kernel alone, on the same inputs: the wrapper adds no device
    # op of its own when the noise floor is an int32 tensor on the card
    k4_out = torch.empty((5, cur_mp.numel()), dtype=torch.float32,
                         device=dev)
    k4_nf = torch.as_tensor(nf_mp, device=dev).to(torch.int32).reshape(1)
    k4_alone = cuda_ms(lambda: _cuda.launch(
        "gst_fieldanalysis_metrics", pool_mp, cur_mp, prev_mp, k4_nf,
        k4_out, pool_mp.shape[0], cur_mp.numel(), pool_mp.shape[1],
        pool_mp.shape[2]))
    log(f"K4 metrics_default: kernel alone {k4_alone:.4f} ms, through its "
        f"wrapper {times['K4'][0]:.4f} ms ({card})")
    times["K5"] = (
        cuda_ms(lambda: comb.comb_score_pairs(pool5, top_mp, bot_mp)),
        cuda_ms(lambda: comb.comb_score_pairs_plain(pool5, top_mp, bot_mp),
                iters=1, warmup=1), None)
    times["K6"] = (
        cuda_ms(lambda: comb.comb_mask(frames_mp)),
        cuda_ms(lambda: comb.comb_mask_plain(frames_mp), iters=1, warmup=1),
        None)
    # K5/K6 at widths past the main paths' (1440p, 4K, and the widest
    # accepted): 16 random frames, 16 pairs of them
    wide_pairs = torch.arange(16, dtype=torch.int32, device=dev)
    for w in (2560, 3840, 8192):
        wide = torch.randint(0, 256, (16, H5, w), dtype=torch.uint8,
                             device=dev)
        t6 = cuda_ms(lambda: comb.comb_mask(wide))
        t5 = cuda_ms(lambda: comb.comb_score_pairs(wide, wide_pairs,
                                                   wide_pairs.flip(0)))
        log(f"K6/K5 at [16, {H5}, {w}]: {t6:.4f} / {t5:.4f} ms = "
            f"{t6 * 1e6 / (H5 - 4):.1f} / {t5 * 1e6 / (H5 - 4):.1f} ns per "
            f"row ({card})")
    # K3 on config2_blur's inputs (bars: a broadcast base; ball: a
    # materialized window); no one PyTorch call has the border-sum
    # normalisation and the rounding, so no library time
    for label, (args, kw) in zip(("K3_bcast", "K3_materialized"), blur_mp):
        times[label] = (
            cuda_ms(lambda: blur.gaussian_blur_words(*args, **kw)),
            cuda_ms(lambda: blur.gaussian_blur_words_plain(*args, **kw),
                    iters=3), None)
    for sigma, ms in blur_sigma_ms(blur).items():
        log(f"K3 gaussian_blur_words materialized [{WINDOW}, {H}, {W}] "
            f"sigma {sigma} ({blur.make_blur_tables(sigma, 1, 1)[0].size} "
            f"taps): {ms:.4f} ms ({card})")
    # K7 on config4_warp's fisheye input (4K x 16, materialized) and on
    # warp_1080p's (a broadcast base, 64 frames); the library form is the
    # gather alone, index_select, without the background select
    for label, (args, kw) in zip(("K7_4k", "K7_1080p_bcast"),
                                 (warp_mp[0], warp_mp[2])):
        src, mp, bg = args
        b = kw.get("batch") or src.shape[0]
        flat = mp.clamp(min=0)
        full = src.expand(b, -1, -1).reshape(b, -1)
        times[label] = (
            cuda_ms(lambda: remap.warp_words(*args, **kw)),
            cuda_ms(lambda: remap.warp_words_plain(*args, **kw), iters=5),
            cuda_ms(lambda: full.index_select(1, flat), iters=5))

    # K8 on its main-path inputs: the serial mode on vad_square's window,
    # the bracket on config 3's; the plain serial version is a Python loop
    # on the host (it copies the samples there); no PyTorch call computes
    # a truncating recurrence, so no library time
    times["K8_serial"] = (
        cuda_ms(lambda: audio.vad_powers_serial(x_serial, p0_serial)),
        cuda_ms(lambda: audio.vad_powers_serial_plain(x_serial, p0_serial),
                iters=1, warmup=0), None)
    times["K8_bracket"] = (
        cuda_ms(lambda: audio.vad_powers_bracket(x_bracket)),
        cuda_ms(lambda: audio.vad_powers_bracket_plain(x_bracket), iters=1,
                warmup=1), None)
    # freeverb_scan on freeverb_22k's window; its plain version is the
    # Python walk on a CPU copy, timed by the host clock where phase 4 ran
    # it on the same input; no PyTorch call computes the walk
    times["freeverb_scan"] = (
        cuda_ms(lambda: audio.freeverb_scan(*fv_args)),
        fv_plain_s["main-path input freeverb_22k"] * 1e3, None)
    # the latency of one step of the chain, from the probe kernel
    probe = torch.zeros(2, dtype=torch.int64, device=dev)
    probe_steps = 1 << 20
    _cuda.launch("gst_vad_step_cycles", probe, probe_steps)
    torch.cuda.synchronize()
    step_cycles = probe[0].item() / probe_steps
    log(f"K8 step latency: {step_cycles:.3f} cycles per dependent step "
        f"({probe_steps} steps on registers)")
    # the comb recurrence's dependent step down a column: the clamp of the
    # carried cell, the next row's select and add.  The bound's chain is
    # the H - 4 rows of a column; the kernel's wavefront also walks the
    # W - 1 columns of a row in order
    row_steps = 1 << 16
    _cuda.launch("gst_comb_row_cycles", probe, row_steps)
    torch.cuda.synchronize()
    row_cycles = probe[0].item() / row_steps
    comb_chain = (H5 - 4) * row_cycles / sm_hz * 1e3
    wavefront = (H5 - 4 + W5 - 1) * row_cycles / sm_hz * 1e3
    log(f"K5/K6 row step latency: {row_cycles:.3f} cycles per dependent "
        f"step ({row_steps} steps on registers); chain {H5 - 4} rows = "
        f"{comb_chain:.4f} ms at {sm_hz / 1e6:.0f} MHz; the wavefront's "
        f"{H5 - 4} + {W5 - 1} steps = {wavefront:.4f} ms")
    # bounds: each input byte read once, each output byte written once,
    # and the integer operations the function needs per element
    frame4 = H * W * 4
    hw5 = H5 * W5
    k4_frames = torch.unique(torch.cat([cur_mp, prev_mp])).numel()
    k5_bytes = (torch.unique(top_mp).numel() * ((H5 + 1) // 2)
                + torch.unique(bot_mp).numel() * (H5 // 2)) * W5
    n_k5, n_k6 = top_mp.numel(), frames_mp.shape[0]
    cells = (H5 - 4) * W5
    # the integer kernels' least instructions on the INT32 pipe, counted
    # as if every operation on bytes packed four to an instruction and
    # every one on 16-bit values two (what dp4a, vabsdiff4 and byte
    # permutes allow, or fewer): so no kernel can need fewer
    bounds = {
        # write B words; read one source frame.  A pixel: its index (a dp4a
        # and a shift), the largest of four rank keys (3), the threshold
        # compare, the stripe phase test and the select (3): 8 a pixel;
        # a broadcast base dilates once and stripes each frame
        "K1_bcast": bound(WINDOW * frame4 + frame4,
                          5 * H * W + 3 * WINDOW * H * W, int32_per_s),
        "K1_materialized": bound(2 * WINDOW * frame4, 8 * WINDOW * H * W,
                                 int32_per_s),
        "K2": bound(2 * WINDOW * frame4, WINDOW * H * W, int32_per_s),
        # the distinct frames read.  A pixel of a frame: the ssd's |y - p|,
        # gate, select and dp4a square-and-add on bytes (4 ops / 4 = 1);
        # y and p widened to 16 bits for the taps (2 / 2 = 1); on even
        # rows (half of them) the three 5-tap sums share y's and p's row
        # sums (9 ops) and each takes |.|, its gate, select and add (12):
        # 21 / 2 / 2 = 5.25.  29/4 a pixel
        "K4": bound(k4_frames * hw5 + cur_mp.numel() * 5 * 8,
                    29 * cur_mp.numel() * hw5 / 4, int32_per_s),
        # the woven rows read.  A cell: the outlier test on bytes (min,
        # max, two saturating differences, their max, the compare: 6 / 4 =
        # 1.5) and its mask widened (1 / 2); the recurrence in 16-bit lanes
        # (a run clamped at 1000 in the row scores as the unclamped one):
        # the add, the select, the clamp, the compare and the count (5 / 2
        # = 2.5): 18/4 a cell; K6 narrows its mask to bytes (1 / 4 more).
        # The chain of H - 4 dependent row steps
        "K5": bound(k5_bytes + 4 * n_k5, 18 * n_k5 * cells / 4, int32_per_s,
                    comb_chain),
        "K6": bound(2 * n_k6 * hw5 + 4 * n_k6, 19 * n_k6 * cells / 4,
                    int32_per_s, comb_chain),
    }
    for label, (args, kw) in zip(("K3_bcast", "K3_materialized"), blur_mp):
        src, kern = args[0], args[1]
        b = kw.get("batch") or src.shape[0]
        px = b * src.shape[1] * src.shape[2]
        # read the source frames and the tables once, write B frames; per
        # pixel and channel of each distinct source frame (one for a
        # broadcast base), on the FP32 pipe: 2 (2c + 1) products and
        # 2 (2c + 1) - 2 sums (the first product starts each sum), the two
        # divisions, the +0.5 and the saturating conversion (the clamp)
        table_bytes = 4 * (kern.numel() + src.shape[1] + src.shape[2])
        bounds[label] = bound(
            4 * px + src.numel() * 4 + table_bytes,
            (4 * kern.numel() - 2 + K3_DIV_INSTR + 2) * 4 * src.numel(),
            fp32_per_s)
    for label, (args, kw) in zip(("K7_4k", "K7_1080p_bcast"),
                                 (warp_mp[0], warp_mp[2])):
        src, mp = args[0], args[1]
        b = kw.get("batch") or src.shape[0]
        px = b * mp.numel()
        # read the map and the source pixels the map names once per source
        # frame, write B frames; one select per pixel
        named = torch.unique(mp[mp >= 0]).numel()
        bounds[label] = bound(4 * px + 4 * named * src.shape[0]
                              + 4 * mp.numel(), px, int32_per_s)
        log(f"{label}: the map names {named} of {mp.numel()} source pixels")
    # K8: the samples read once (2 bytes each), the powers written once;
    # per sample 3 operations for the squared term and 2 per walk of the
    # step (multiply-high, add); the bracket walks each sample twice.  The
    # chain: the samples walked in order, times the step's latency, at
    # the top SM clock
    chains = {"K5": comb_chain, "K6": comb_chain}
    for label, x, walks in (("K8_serial", x_serial, 1),
                            ("K8_bracket", x_bracket, 2)):
        nb, n = x.shape
        in_order = nb * n if label == "K8_serial" else n
        chains[label] = in_order * step_cycles / sm_hz * 1e3
        bounds[label] = bound(2 * nb * n + 8 * walks * nb + 8,
                              (3 + 2 * walks) * nb * n, int32_per_s,
                              chains[label])
        log(f"{label}: {nb} blocks of {n} samples; chain {in_order} steps "
            f"x {step_cycles:.3f} cycles at {sm_hz / 1e6:.0f} MHz = "
            f"{chains[label]:.4f} ms")
    # freeverb_scan: its chain is one comb's walk, the window's samples in
    # order, each one dependent step (a multiply and an add) of the
    # filterstore recurrence, measured by a probe kernel on registers.
    # Bytes: the window read once, the output and the state written once;
    # operations: per sample and side, 8 combs (5 each: 3 products and 2
    # sums), 8 tap sums, 4 allpasses (3 each), the offset and the mix (4)
    fv_steps = 1 << 18
    _cuda.launch("gst_freeverb_step_cycles", probe, fv_steps)
    torch.cuda.synchronize()
    fv_cycles = probe[0].item() / fv_steps
    n_fv_mp = fv_x_mp.shape[0]
    chains["freeverb_scan"] = n_fv_mp * fv_cycles / sm_hz * 1e3
    state_bytes = 2 * 4 * sum(v.numel() for v in fv_st_mp.values())
    bounds["freeverb_scan"] = bound(
        4 * fv_x_mp.numel() + 8 * n_fv_mp + state_bytes,
        2 * (8 * 5 + 8 + 4 * 3 + 4) * n_fv_mp, fp32_per_s,
        chains["freeverb_scan"])
    log(f"freeverb_scan: {n_fv_mp} samples at {fv_rate_mp} Hz; comb step "
        f"{fv_cycles:.3f} cycles ({fv_steps} steps on registers); chain "
        f"{n_fv_mp} steps = {chains['freeverb_scan']:.4f} ms at "
        f"{sm_hz / 1e6:.0f} MHz; plain version on the host CPU")
    # the audio walks on their main-path inputs.  Their plain versions:
    # the decoders' loop of torch ops on the card, the encoder's and the
    # filter's walks on the host (timed by the host clock where phase 4f
    # ran them on the same input).  No PyTorch call computes a walk.
    # Bounds: each input byte read once and each output byte written once
    # over HBM, the integer or float64 operations over their pipe, or the
    # chain: the samples one thread walks in order, times the cycles of
    # one dependent step measured by a probe kernel on registers
    wi = walk["inputs"]
    for k in ("adpcm_ima_decode", "adpcm_ms_decode"):
        args = wi[k]
        plain = getattr(audio, f"{k}_plain")
        times[k] = (cuda_ms(lambda: getattr(audio, k)(*args)),
                    cuda_ms(lambda: plain(*args), iters=1, warmup=1), None)
    for k in ("adpcm_ima_encode", "scope_filter"):
        args = wi[k]
        times[k] = (cuda_ms(lambda: getattr(audio, k)(*args)),
                    walk["plain_s"][k] * 1e3, None)
    # scope_filter on play_vis_48k's window (phase 4j)
    pv_state, pv_x = sessions["scope"]["inputs"]
    times["scope_filter_play_vis"] = (
        cuda_ms(lambda: audio.scope_filter(pv_state, pv_x)),
        sessions["scope"]["plain_s"] * 1e3, None)
    cycles = {}
    for kind, k in enumerate(("adpcm_ima_decode", "adpcm_ms_decode",
                              "adpcm_ima_encode")):
        _cuda.launch("gst_adpcm_step_cycles", probe, 1 << 16, kind)
        torch.cuda.synchronize()
        cycles[k] = probe[0].item() / (1 << 16)
    _cuda.launch("gst_scope_step_cycles", probe, 1 << 16)
    torch.cuda.synchronize()
    cycles["scope_filter"] = probe[0].item() / (1 << 16)
    cycles["scope_filter_play_vis"] = cycles["scope_filter"]
    blocks_ima, ch_ima = wi["adpcm_ima_decode"]
    blocks_ms, ch_ms = wi["adpcm_ms_decode"]
    enc_x, _ = wi["adpcm_ima_encode"]
    sf_state, sf_x = wi["scope_filter"]
    walk_shapes = {
        # (bytes, operations per second of the pipe, operations, steps a
        # thread walks in order); per sample: IMA 12 integer operations,
        # MS 14, the encoder 30, the filter 12 float64 (6 multiplies or
        # FMAs, 6 sums) on the FP64 pipe (half the FP32 lanes)
        "adpcm_ima_decode": (
            blocks_ima.numel() + 2 * blocks_ima.shape[0] * (
                1 + 8 * audio.adpcm_ima_groups(blocks_ima.shape[1], ch_ima))
            * ch_ima, int32_per_s, 12 * 2 * blocks_ima.numel(),
            8 * audio.adpcm_ima_groups(blocks_ima.shape[1], ch_ima)),
        "adpcm_ms_decode": (
            blocks_ms.numel() + 2 * blocks_ms.shape[0] * ch_ms
            * audio.adpcm_ms_samples(blocks_ms.shape[1], ch_ms),
            int32_per_s, 14 * 2 * blocks_ms.numel(),
            audio.adpcm_ms_samples(blocks_ms.shape[1], ch_ms) - 2),
        "adpcm_ima_encode": (
            2 * enc_x.numel() + 4 * enc_x.numel() + 8 * enc_x.shape[0]
            * enc_x.shape[2], int32_per_s, 30 * enc_x.numel(),
            enc_x.shape[0] * enc_x.shape[1]),
        "scope_filter": (
            4 * sf_x.numel() + 8 * 3 * sf_x.numel() + 16 * sf_state.numel(),
            fp32_per_s / 2, 12 * sf_x.numel(), sf_x.shape[0]),
        "scope_filter_play_vis": (
            4 * pv_x.numel() + 8 * 3 * pv_x.numel() + 16 * pv_state.numel(),
            fp32_per_s / 2, 12 * pv_x.numel(), pv_x.shape[0]),
    }
    for k, (nbytes, rate, ops, steps) in walk_shapes.items():
        chains[k] = steps * cycles[k] / sm_hz * 1e3
        bounds[k] = bound(nbytes, ops, rate, chains[k])
        log(f"{k}: {steps} steps in order x {cycles[k]:.3f} cycles at "
            f"{sm_hz / 1e6:.0f} MHz = chain {chains[k]:.4f} ms; {nbytes} "
            f"bytes, {ops} operations")
    # H1-H3 (phase 4g): timed on their main paths' inputs there
    times.update(detect["times"])
    bounds.update(detect["bounds"])
    # H4 (phase 4h): timed on its main paths' inputs there
    times.update(overlays["times"])
    bounds.update(overlays["bounds"])
    chains.update(detect["chains"])
    # H5 (phase 4i): timed on netsim_1080p's window there
    times.update(deferred["times"])
    bounds.update(deferred["bounds"])
    chains.update(deferred["chains"])
    # K1 on rtp_headline_1080p's own window (phase 4l)
    times.update(transport["times"])
    bounds.update(transport["bounds"])
    # K1 on vmnc_headline_1080p's own window (phase 4m)
    times.update(formats["times"])
    bounds.update(formats["bounds"])
    for label, (ms, plain_ms, lib_ms) in times.items():
        b_ms, b_by = bounds[label]
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        chain = (f", chain {chains[label]:.4f} ms" if label in chains
                 else "")
        if label in ("K5", "K6"):
            chain += f", {ms * 1e6 / (H5 - 4):.1f} ns per row"
        log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib} ms, bound {b_ms:.4f} ms ({b_by}){chain} "
            f"({card})")
    log(f"K4 inputs: pool {tuple(pool_mp.shape)}, {cur_mp.numel()} frames, "
        f"{k4_frames} distinct; K5: {n_k5} pairs; K6: "
        f"{tuple(frames_mp.shape)}")

    def entry(kname, label, source, replaces, mode=None):
        ms, plain_ms, lib_ms = times[label]
        b_ms, b_by = bounds[label]
        e = {"name": kname, "route": "cuda",
             "source": f"gstbad_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches[kname],
             "max_abs_err": err[kname], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if mode:   # the mode or the path a kernel of two rows was timed on
            e["mode"] = mode
        return e

    kernels = [
        entry("dilate_zebra_fused", "K1_bcast", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/chainfuse.py:78", "broadcast"),
        entry("dilate_zebra_fused", "K1_materialized",
              "tablefuse_kernels.cu", "gstbad_tpu/ops/chainfuse.py:78",
              "materialized"),
        entry("dilate_zebra_fused", "K1_rtp", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/chainfuse.py:78", "rtp_headline_1080p"),
        entry("dilate_zebra_fused", "K1_vmnc", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/chainfuse.py:78", "vmnc_headline_1080p"),
        entry("apply_word_table", "K2", "tablefuse_kernels.cu",
              "gstbad_tpu/ops/lut.py:91"),
        entry("metrics_default", "K4", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/fieldanalysis.py:190"),
        entry("comb_score_pairs", "K5", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/comb.py:258"),
        entry("comb_mask", "K6", "deinterlace_kernels.cu",
              "gstbad_tpu/ops/comb.py:102"),
        entry("gaussian_blur_words", "K3_bcast", "blur_kernels.cu",
              "gstbad_tpu/ops/blur_pallas.py:56", "broadcast"),
        entry("gaussian_blur_words", "K3_materialized", "blur_kernels.cu",
              "gstbad_tpu/ops/blur_pallas.py:56", "materialized"),
        entry("warp_words", "K7_4k", "warp_kernels.cu",
              "gstbad_tpu/ops/warp_pallas.py:215"),
        entry("vad_powers_serial", "K8_serial", "vad_kernels.cu",
              "gstbad_tpu/ops/audio.py:585"),
        entry("vad_powers_bracket", "K8_bracket", "vad_kernels.cu",
              "gstbad_tpu/ops/audio.py:653"),
        # not TPU kernels: each replaces an XLA lax.scan of the JAX package
        entry("freeverb_scan", "freeverb_scan", "freeverb_kernels.cu",
              "gstbad_tpu/ops/audio.py:500"),
        entry("adpcm_ima_decode", "adpcm_ima_decode", "adpcm_kernels.cu",
              "gstbad_tpu/ops/audio.py:1442"),
        entry("adpcm_ms_decode", "adpcm_ms_decode", "adpcm_kernels.cu",
              "gstbad_tpu/ops/audio.py:1485"),
        entry("adpcm_ima_encode", "adpcm_ima_encode", "adpcm_kernels.cu",
              "gstbad_tpu/ops/audio.py:1532"),
        entry("scope_filter", "scope_filter", "scope_kernels.cu",
              "gstbad_tpu/elements/audio/visualizers.py:228",
              "scopes_720p_wavescope"),
        entry("scope_filter", "scope_filter_play_vis", "scope_kernels.cu",
              "gstbad_tpu/elements/audio/visualizers.py:228",
              "play_vis_48k"),
        # not TPU kernels: the Haar cascade's tree scan and its unrolled
        # form, the rotated table's row scan, SGM's path scans
        entry("haar_cascade", "haar_cascade", "haar_kernels.cu",
              "gstbad_tpu/ops/haar.py:343", "arrays"),
        entry("haar_cascade", "haar_cascade_unrolled", "haar_kernels.cu",
              "gstbad_tpu/ops/haar.py:130", "unrolled"),
        entry("tilted_integral", "tilted_integral", "haar_kernels.cu",
              "gstbad_tpu/ops/haar.py:72"),
        entry("sgm_aggregate", "sgm_aggregate", "stereo_kernels.cu",
              "gstbad_tpu/ops/stereo.py:136"),
        # not a TPU kernel: the overlay elements' whole-window jnp blends
        entry("overlay_blend", "overlay_blend", "overlay_kernels.cu",
              "gstbad_tpu/elements/video/overlay.py:149",
              "shr8_keep_alpha"),
        entry("overlay_blend", "overlay_blend_assrender",
              "overlay_kernels.cu",
              "gstbad_tpu/elements/video/assrender.py:128", "premul_floor"),
        # not a TPU kernel: netsim's token-bucket scan
        entry("netsim_bucket", "netsim_bucket", "netsim_kernels.cu",
              "gstbad_tpu/elements/observability.py:223"),
    ]
    phase_done("5 (kernels)")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile"]:
        sys.exit(profile_main(sys.argv[2]))
    if sys.argv[1:2] == ["--rtp-reference"]:
        sys.exit(rtp_reference_main(sys.argv[2]))
    if sys.argv[1:2] == ["--file-format-reference"]:
        sys.exit(file_format_reference_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--rfb-server"]:
        sys.exit(rfb_server_main(sys.argv[2:]))
    sys.exit(main())
