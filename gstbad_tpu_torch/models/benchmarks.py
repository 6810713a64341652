"""The benchmark pipeline graphs of the port (the JAX package's
models/benchmarks.py: the headline graph and configs 1 and 2).

Each entry builds a Pipeline in launch-string form, so the element API is
exercised exactly the way users drive it, on `device`.
"""

from __future__ import annotations

from typing import Callable, Dict

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


BENCHMARKS: Dict[str, Callable[..., Pipeline]] = {
    "config1_sepia": config1_sepia,
    "config2_gaudi": config2_gaudi,
    "ten_element": ten_element_graph,
}


def build(name: str, **kw) -> Pipeline:
    return BENCHMARKS[name](**kw)
