"""The benchmark pipeline graphs of the port (the JAX package's
models/benchmarks.py: the headline graph, configs 1, 2, 2b (gaussianblur),
3 (the audio chain), 4 (bayer and warps) and 5, the single-warp graphs and
combdetect; and vad_square), and config 5's quality gate.

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
}


def build(name: str, **kw) -> Pipeline:
    return BENCHMARKS[name](**kw)
