"""The benchmark pipeline graphs of the port (the JAX package's
models/benchmarks.py: the headline graph, configs 1, 2, 2b (gaussianblur),
3 (the audio chain), 4 (bayer and warps) and 5, the single-warp graphs and
combdetect; and vad_square, the I420 transcode around gaussianblur, the
iqa DSSIM fan-in and freeverb at 22.05 kHz), config 5's quality gate, and
the opencv family's paths: edges and median denoising at 1080p, lens
undistortion, a fisheye-donut unwrap, and colour-managed motion cells;
and audio breadth's: a voice call through webrtcdsp, IMA and Microsoft
ADPCM at 44.1 kHz, the four scopes at 720p, and bs2b with pitch.

Each entry builds a Pipeline in launch-string form, so the element API is
exercised exactly the way users drive it, on `device`.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from gstbad_tpu_torch.core.pipeline import Pipeline, parse_launch


def config1_sepia(width=1920, height=1080, device="cuda") -> Pipeline:
    """coloreffects preset=sepia on 1080p30 (BASELINE config 1)."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! coloreffects preset=sepia ! fakesink", device=device)


def config2_gaudi(width=1920, height=1080, device="cuda") -> Pipeline:
    """solarize -> chromium -> dodge -> burn -> exclusion fused
    (BASELINE config 2, the point-op family)."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! solarize ! chromium ! dodge ! burn ! exclusion "
        "! fakesink", device=device)


def ten_element_graph(width=1920, height=1080, device="cuda") -> Pipeline:
    """The north-star 10-element 1080p filter graph."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! coloreffects preset=sepia ! solarize ! chromium "
        "! dodge ! burn ! exclusion ! dilate ! chromahold "
        "! videoconvert format=AYUV ! zebrastripe ! fakesink", device=device)


def config2_blur(width=1920, height=1080, device="cuda") -> Pipeline:
    """gaussianblur sigma=1.2 on AYUV bars (BASELINE config 2b)."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=AYUV ! gaussianblur sigma=1.2 ! fakesink", device=device)


def transcode_i420_blur(width=1920, height=1080, device="cuda") -> Pipeline:
    """I420 in, gaussianblur on AYUV, I420 out: the transcode chain every
    y4m file takes (all y4m input is I420)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=I420 ! videoconvert format=AYUV ! gaussianblur sigma=1.2 "
        "! videoconvert format=I420 ! fakesink", device=device)


def iqa_dssim_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """A stream scored against its source by iqa's multiscale DSSIM: the
    source (the reference pad) fans in beside its blurred copy
    (BASELINE's quality oracle)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=AYUV name=ref ! m.  ref. ! gaussianblur sigma=1.2 ! m.  "
        "iqa name=m ! fakesink", device=device)


def freeverb_22k(samplesperbuffer=2205, device="cuda") -> Pipeline:
    """freeverb on 22.05 kHz stereo: below 32 kHz the reverb runs its
    per-sample walk (ops.audio.freeverb_scan)."""
    return parse_launch(
        "audiotestsrc wave=sine channels=2 format=F32 rate=22050 "
        f"samplesperbuffer={samplesperbuffer} ! freeverb "
        "! audioconvert format=S16 ! fakesink", device=device)


def config3_audio(samplesperbuffer=4800, device="cuda") -> Pipeline:
    """audiomixmatrix -> freeverb -> audioconvert -> removesilence, 48 kHz
    8-channel sine in (BASELINE config 3).  On a sine the VAD's power
    bracket closes on every block, so the serial recurrence never runs."""
    matrix = "<" + ",".join(
        "<" + ",".join("1.0" if i == o else "0.125" for i in range(8)) + ">"
        for o in range(2)) + ">"
    return parse_launch(
        "audiotestsrc wave=sine channels=8 format=F32 "
        f"samplesperbuffer={samplesperbuffer} "
        f"! audiomixmatrix matrix='{matrix}' ! freeverb "
        "! audioconvert format=S16 channels=1 ! removesilence ! fakesink",
        device=device)


def vad_square(samplesperbuffer=4800, device="cuda") -> Pipeline:
    """removesilence on a 440 Hz square wave: a constant squared sample,
    whose power recurrence has neighbouring fixed points, so the bracket
    never closes and every window takes the serial recurrence.  The power
    settles near 2.75e9, under the 0 dB threshold (2^32 - 1): every block
    is silence, one silence_detected message is posted, and with
    remove=false every frame reaches the sink."""
    return parse_launch(
        "audiotestsrc wave=square channels=1 format=S16 "
        f"samplesperbuffer={samplesperbuffer} "
        "! removesilence silent=false threshold=0 ! fakesink", device=device)


def config4_warp(width=3840, height=2160, device="cuda") -> Pipeline:
    """bayer2rgb + fisheye warp at 4K (BASELINE config 4)."""
    return parse_launch(
        f"videotestsrc pattern=gradient width={width} height={height} "
        "format=ARGB ! rgb2bayer ! bayer2rgb format=ARGB "
        "! fisheye ! twirl ! fakesink", device=device)


def warp_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """Single fisheye warp, 1080p."""
    return parse_launch(
        f"videotestsrc pattern=bars width={width} height={height} "
        "format=BGRx ! fisheye ! fakesink", device=device)


def warp_4k(width=3840, height=2160, device="cuda") -> Pipeline:
    """Single fisheye warp at 4K."""
    return warp_1080p(width, height, device=device)


def config5_ivtc(width=1280, height=720, device="cuda") -> Pipeline:
    """interlace (2:3 telecine) -> fieldanalysis -> ivtc round trip
    (BASELINE config 5; config5_fidelity scores it)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 "
        "! fieldanalysis ! ivtc ! fakesink", device=device)


def combdetect_720p(width=1280, height=720, device="cuda") -> Pipeline:
    """interlace -> combdetect zebra paint (BASELINE combdetect row)."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! interlace pattern=2:3 "
        "! combdetect ! fakesink", device=device)


def cv_edges_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """Gaussian smoothing then Canny edges on RGB: the edge maps ahead of
    detection in camera and robotics pipelines."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=RGB ! cvsmooth type=gaussian kernel-width=5 kernel-height=5 "
        "! edgedetect ! fakesink", device=device)


def cv_median_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """A 5x5 median then histogram equalization on GRAY8: denoising and
    normalising low-light surveillance video."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 ! cvsmooth type=median kernel-width=5 "
        "! cvequalizehist ! fakesink", device=device)


# a wide-angle lens at 1080p: focal length 1400 px, the principal point at
# the centre, barrel distortion k1 -0.30
UNDISTORT_K = "1400 0 960 0 1400 540 0 0 1"
UNDISTORT_D = "-0.30 0.10 0.001 0.0005 -0.02"


def undistort_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """cameraundistort of a wide-angle lens on RGB."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        f'format=RGB ! cameraundistort camera-matrix="{UNDISTORT_K}" '
        f'distortion-coeffs="{UNDISTORT_D}" ! fakesink', device=device)


def dewarp_1080p(width=1920, height=1080, device="cuda") -> Pipeline:
    """The 360-degree fisheye donut (radii 0.05 and 0.28 of the width, so
    it fits a 1080p frame) unwrapped bilinearly to a 1992x448 panorama."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=RGBA ! dewarp inner-radius=0.05 outer-radius=0.28 "
        "! fakesink", device=device)


def wide_gamma22_icc() -> bytes:
    """A gamma-2.2 display profile with wide (Adobe-RGB-like, D50-adapted)
    primaries: lcms_motion_720p's destination."""
    from gstbad_tpu_torch.io import icc
    return icc.write_icc(icc.IccProfile(
        matrix=np.array([[0.6097, 0.2053, 0.1492],
                         [0.3111, 0.6257, 0.0632],
                         [0.0195, 0.0609, 0.7446]]),
        trc=[icc.Curve("gamma", gamma=2.2)] * 3,
        white=np.array([0.9642, 1.0, 0.8249])), "wide gamma 2.2")


def lcms_motion_720p(dest_profile: str, width=1280, height=720,
                     device="cuda") -> Pipeline:
    """Colour-managed capture feeding motion alerts: lcms from sRGB to the
    profile at `dest_profile` (a path: wide_gamma22_icc's bytes for the
    path's cell) on BGRx, videoconvert to RGB, motioncells.  The ball
    covers a few percent of a 10x10 grid's cells, so at the default
    sensitivity (0.5: half a cell's pixels must change) no alert would
    ever fire; at 0.9 (a tenth of a cell) it fires on some frames and not
    on others."""
    return parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        f'format=BGRx ! lcms dest-profile="{dest_profile}" '
        "! videoconvert format=RGB ! motioncells sensitivity=0.9 "
        "! fakesink", device=device)


def config5_fidelity(width=1280, height=720, n_frames=30, window=10,
                     device="cuda"):
    """BASELINE config 5's quality gate (the JAX package's
    bench.py:config5_fidelity on the port): the telecine round trip scored
    by the compare/iqa SSIM oracle against the progressive source
    (gst/debugutils/gstcompare.c:355-428).

    ivtc's first emitted frame predates its field queue warm-up and is
    skipped; each remaining output frame is scored against its
    best-aligned source frame (the inverse-telecine cadence duplicates
    frames, so alignment is by content, monotone in the source)."""
    import torch

    from gstbad_tpu_torch.ops.ssim import ssim_plane

    src = parse_launch(
        f"videotestsrc pattern=ball width={width} height={height} "
        "format=GRAY8 framerate=24/1 ! fakesink", device=device)
    orig = np.concatenate([b.data for b in src.run(n_frames=n_frames,
                                                   window=window)])
    chain = config5_ivtc(width, height, device=device)
    out = np.concatenate([b.data for b in chain.run(n_frames=n_frames,
                                                    window=window)])
    scores = []
    j0 = 0
    for i in range(1, out.shape[0]):      # skip the warm-up frame
        # monotone best-match within the cadence lookahead
        cand = range(j0, min(j0 + 4, orig.shape[0]))
        if not len(cand):
            break
        errs = [np.abs(out[i].astype(np.int64)
                       - orig[j].astype(np.int64)).mean() for j in cand]
        j = j0 + int(np.argmin(errs))
        j0 = j
        scores.append(float(ssim_plane(torch.from_numpy(out[i]).to(device),
                                       torch.from_numpy(orig[j]).to(device))))
    ssim = float(np.mean(scores)) if scores else 0.0
    return {"ssim": round(ssim, 6),
            "dssim": round((1.0 - ssim) / 2.0, 6),   # compare.c dssim
            "frames_scored": len(scores)}


# -- audio breadth: the slice's card paths ------------------------------------
# Each graph here is called by name (chip_smoke.py's audio_slice) and stays
# out of BENCHMARKS: its inputs are seeded numpy pushed through appsrc or
# push_bytes, so card and CPU see the same bytes.

VOIP_RATE, VOIP_BLOCK = 48000, 480          # 10 ms blocks at 48 kHz


def voip_webrtcdsp_48k(device="cuda") -> Pipeline:
    """A video call's capture path: the near end (microphone) and the far
    end (what the loudspeaker plays, through webrtcechoprobe) into
    webrtcdsp with its defaults (high-pass, echo cancellation with the
    extended 16-partition filter, moderate noise suppression,
    adaptive-digital gain, the limiter) and voice detection.  Feed it
    with voip_inputs through appsrc near and far."""
    src = (f"appsrc name={{}} kind=audio format=S16 rate={VOIP_RATE} "
           "channels=1")
    return parse_launch(
        f"{src.format('near')} ! dsp.  {src.format('far')} ! "
        "webrtcechoprobe ! dsp.  webrtcdsp name=dsp voice-detection=true "
        "! fakesink", device=device)


def voip_inputs(n_blocks: int, seed: int = 0):
    """(near, far) int16 [n_blocks, 480, 1]: far a speech-like signal
    (three harmonics under a 3 Hz syllable envelope, about -15 dBFS
    peaks); near the far end through a seeded 40 ms decaying echo path,
    plus a near talker at -20 dB and noise at -50 dBFS."""
    rng = np.random.default_rng(seed)
    n = n_blocks * VOIP_BLOCK
    t = np.arange(n) / VOIP_RATE

    def talker(f0, phase):
        env = (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t + phase)) ** 2
        return env * (np.sin(2 * np.pi * f0 * t)
                      + 0.5 * np.sin(2 * np.pi * 2 * f0 * t + 1)
                      + 0.3 * np.sin(2 * np.pi * 4 * f0 * t + 2))

    far = talker(220.0, 0.0) * 6000.0
    taps = int(0.040 * VOIP_RATE)
    echo_path = (rng.standard_normal(taps)
                 * np.exp(-np.arange(taps) / (0.008 * VOIP_RATE)) * 0.2)
    echo = np.convolve(far, echo_path)[:n]
    near = (echo + talker(170.0, 1.3) * 600.0
            + rng.standard_normal(n) * 32768 * 10 ** (-50 / 20))

    def s16(x):
        return np.clip(np.round(x), -32768, 32767).astype(np.int16).reshape(
            n_blocks, VOIP_BLOCK, 1)

    return s16(near), s16(far)


ADPCM_RATE, ADPCM_BLOCKSIZE = 44100, 2048   # 2041 samples a stereo block


def adpcm_dvi_44k_encode(device="cuda") -> Pipeline:
    """WAV IMA-ADPCM encoding of a 44.1 kHz stereo sine: 2041-sample
    blocks into 2048-byte DVI blocks."""
    return parse_launch(
        f"audiotestsrc wave=sine format=S16 rate={ADPCM_RATE} channels=2 "
        "samplesperbuffer=2041 ! adpcmenc "
        f"blocksize={ADPCM_BLOCKSIZE} ! fakesink", device=device)


def adpcm_dvi_44k_decode(device="cuda") -> Pipeline:
    """The DVI decoder on 2048-byte stereo blocks (push_bytes to the node
    named dec)."""
    return parse_launch(
        f"adpcmdec name=dec layout=dvi blocksize={ADPCM_BLOCKSIZE} "
        f"rate={ADPCM_RATE} channels=2 ! fakesink", device=device)


def adpcm_ms_44k(device="cuda") -> Pipeline:
    """The Microsoft ADPCM decoder on 2048-byte stereo blocks (push_bytes
    to the node named dec; ms_blocks makes valid ones)."""
    return parse_launch(
        f"adpcmdec name=dec layout=microsoft blocksize={ADPCM_BLOCKSIZE} "
        f"rate={ADPCM_RATE} channels=2 ! fakesink", device=device)


def ms_blocks(n: int, seed: int = 0, blocksize: int = ADPCM_BLOCKSIZE,
              channels: int = 2) -> np.ndarray:
    """n valid Microsoft ADPCM blocks, uint8 [n, blocksize]: predictor
    indices 0-6, initial deltas 16-1024, two header samples per channel,
    and random codes."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (n, blocksize), dtype=np.uint8)
    out[:, :channels] = rng.integers(0, 7, (n, channels))

    def put16(off, vals):
        v = vals.astype(np.int64) & 0xFFFF
        out[:, off] = v & 0xFF
        out[:, off + 1] = v >> 8

    for c in range(channels):
        put16(channels + 2 * c, rng.integers(16, 1025, n))
        put16(3 * channels + 2 * c, rng.integers(-20000, 20000, n))
        put16(5 * channels + 2 * c, rng.integers(-20000, 20000, n))
    return out


SCOPE_RATE, SCOPE_BLOCK = 44100, 1764       # one 25 fps frame of audio
SCOPES = {"wavescope": "style=color-lines", "spacescope": "style=color-lines",
          "spectrascope": "", "synaescope": ""}


def scope_720p(scope: str, device="cuda") -> Pipeline:
    """A music player's full-screen visualizer: 44.1 kHz stereo S16 in
    1764-sample blocks (one frame at 25 fps) from appsrc (named src; feed
    it music_like) into `scope` at 1280x720."""
    return parse_launch(
        f"appsrc name=src kind=audio format=S16 rate={SCOPE_RATE} "
        f"channels=2 ! {scope} {SCOPES[scope]} width=1280 height=720 "
        "! fakesink", device=device)


def music_like(n_blocks: int, block: int = SCOPE_BLOCK, seed: int = 0,
               rate: int = SCOPE_RATE) -> np.ndarray:
    """int16 [n_blocks, block, 2]: a seeded stereo mix of a bass line, a
    chord and a lead with vibrato, at about -6 dBFS peaks, panned apart."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * block) / rate
    notes = rng.choice([110.0, 130.8, 146.8, 164.8, 196.0], 8)
    bar = (t * 2).astype(int) % 8
    bass = np.sin(2 * np.pi * notes[bar] * t)
    chord = sum(np.sin(2 * np.pi * f * t + k) for k, f in
                enumerate((261.6, 329.6, 392.0)))
    lead = np.sin(2 * np.pi * 880 * t + 3 * np.sin(2 * np.pi * 5 * t))
    left = 0.25 * bass + 0.08 * chord + 0.12 * lead
    right = 0.25 * bass + 0.10 * chord + 0.05 * lead
    x = np.stack([left, right], -1) * 32767
    return x.astype(np.int16).reshape(n_blocks, block, 2)


def headphone_bs2b_pitch_44k(device="cuda") -> Pipeline:
    """Headphone listening with a pitch shift: bs2b's cmoy crossfeed then
    pitch 1.25 on 44.1 kHz stereo F32 in 4096-sample blocks."""
    return parse_launch(
        "audiotestsrc wave=sine format=F32 rate=44100 channels=2 "
        "samplesperbuffer=4096 ! bs2b preset=cmoy ! pitch pitch=1.25 "
        "! fakesink", device=device)


# the cv paths above are called by name and stay out of this table:
# lcms_motion_720p needs a profile path, and callers that walk the table
# build each graph with width/height alone and know its output layout
BENCHMARKS: Dict[str, Callable[..., Pipeline]] = {
    "config1_sepia": config1_sepia,
    "config2_gaudi": config2_gaudi,
    "config2_blur": config2_blur,
    "config3_audio": config3_audio,
    "vad_square": vad_square,
    "config4_warp": config4_warp,
    "warp_1080p": warp_1080p,
    "warp_4k": warp_4k,
    "config5_ivtc": config5_ivtc,
    "combdetect_720p": combdetect_720p,
    "ten_element": ten_element_graph,
    "transcode_i420_blur": transcode_i420_blur,
    "iqa_dssim_1080p": iqa_dssim_1080p,
    "freeverb_22k": freeverb_22k,
}


def build(name: str, **kw) -> Pipeline:
    return BENCHMARKS[name](**kw)
