"""testbin:// URI handling — the testsrcbin analog
(gst/debugutils/gsttestsrcbin.c).

The reference is a GstBin with a GstURIHandler: `testbin://audio+video`
(or per-stream props, `testbin://audio,volume=0.5+video,pattern=white`)
expands into audiotestsrc/videotestsrc children with one sometimes-pad per
stream (gsttestsrcbin.c:353-415: '+' splits streams, each segment is a
caps-structure whose fields become child properties).  Here the same URI
grammar expands into pipeline chains: heterogeneous streams are disjoint
chains of one Pipeline (the fused window program runs them side by side).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# properties forwarded to the inner testsrc elements; anything else in the
# URI is rejected loudly rather than silently dropped
_VIDEO_PROPS = {"pattern", "format", "width", "height", "framerate",
                "foreground-color", "seed"}
_AUDIO_PROPS = {"wave", "freq", "volume", "format", "rate", "channels",
                "samplesperbuffer", "seed"}


def parse_testbin_uri(uri: str) -> List[Tuple[str, Dict[str, str]]]:
    """'testbin://video,pattern=ball+audio,freq=330' ->
    [('video', {'pattern': 'ball'}), ('audio', {'freq': '330'})]."""
    if not uri.startswith("testbin://"):
        raise ValueError(f"not a testbin URI: {uri!r}")
    location = uri[len("testbin://"):]
    if not location:
        raise ValueError("testbin URI names no streams")
    streams = []
    for segment in location.split("+"):
        parts = [p for p in segment.split(",") if p]
        if not parts:
            continue
        kind = parts[0].strip()
        if kind not in ("audio", "video"):
            raise ValueError(f"testbin: unknown stream type {kind!r} "
                             "(want audio or video)")
        allowed = _VIDEO_PROPS if kind == "video" else _AUDIO_PROPS
        props = {}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            k = k.strip()
            if k not in allowed:
                raise ValueError(
                    f"testbin: {kind} stream has no property {k!r} "
                    f"(have {sorted(allowed)})")
            props[k] = v.strip()
        streams.append((kind, props))
    if not streams:
        raise ValueError("testbin URI names no streams")
    return streams


def testbin_launch(uri: str, video_sink: str = "fakevideosink",
                   audio_sink: str = "fakeaudiosink") -> str:
    """Expand a testbin:// URI into a (possibly multi-chain) launch string,
    one chain per stream — the playbin-uri consumption path."""
    chains = []
    for kind, props in parse_testbin_uri(uri):
        el = "videotestsrc" if kind == "video" else "audiotestsrc"
        args = " ".join(f"{k}={v}" for k, v in props.items())
        sink = video_sink if kind == "video" else audio_sink
        chains.append(f"{el} {args} ! {sink}".replace("  ", " "))
    return "  ".join(chains)
