"""Play — the GstPlay session API analog (gst-libs/gst/play/gstplay.c,
8k LoC; the GstPlayer wrapper lives in session/player.py).

The reference runs a dedicated GMainContext thread wrapping playbin and
marshals API calls into it (gstplay.c:276,510,616-628).  Here Play owns a
worker thread stepping a Pipeline window-by-window, optionally paced to the
stream framerate.  API parity map (reference -> here):

  gst_play_play/pause/stop                 -> play()/pause()/stop()
  gst_play_seek (gstplay.c:2906-2977)      -> seek(ns): flush + reposition
      source counters; GST_SEEK_FLAG_ACCURATE from config seek-accurate
      (accurate rounds to the nearest frame, keyframe mode floors to the
      latest sync point <= position); SEEK_DONE posted when applied
  gst_play_set_rate (gstplay.c:2999,574-   -> set_rate(): pacing scales by
      628: rate!=1 -> TRICKMODE, negative      |rate|; negative rates step
      rates seek (0, position))                the window span backwards and
                                               reverse frames; EOS at 0
  volume/mute (playbin volume property)    -> a _PlayVolume gain stage
      auto-inserted on every audio chain (dynamic params: no recompile)
  track select/enable (set_*_track[_enabled]) -> stream components of the
      pipeline DAG; the active sub-pipeline is rebuilt so unselected
      streams are not computed (playbin's unselected branches don't decode)
  gst_play_get_media_info                  -> MediaInfo dataclasses
  gst_play_set_subtitle_uri                -> SRT/WebVTT cues dispatched as
      on_subtitle callbacks (the suburi subparse path)
  audio-video-offset / subtitle-video-offset -> dispatched-audio pts shift /
      cue-window shift
  gst_play_set_visualization (playbin vis) -> an audiovisualizer element
      (wavescope/spacescope/...) teed off the selected audio chain
  color balance (playbin colorbalance)     -> a _ColorBalance stage on the
      selected video chain (videobalance-equation luma/chroma math)
  gst_play_get_video_snapshot              -> last video frame, optionally
      through videoconvert
  message API bus (gstplay.h:94-108)       -> message_bus: Message records
      named uri-loaded/position-updated/duration-changed/state-changed/
      buffering/end-of-stream/error/warning/video-dimensions-changed/
      media-info-updated/volume-changed/mute-changed/seek-done
  config (user-agent, position-update-interval, seek-accurate,
      gstplay.c gst_play_set_config)       -> set_config()/get_config()

Documented divergences: TRICKMODE does not drop frames (every frame is
computed); heterogeneous audio/video chains advance per-window in their
own stream time (the fused-window scheduler has no per-sink clock).

The port: every pipeline Play builds (the parsed launch string, the
testbin, y4m and typefind pipelines, the active sub-pipeline) is bound to
`device` ("cuda", the default, or "cpu"; a CUDA request without a card
raises, and nothing falls back to the CPU).  Pipeline.run hands back each
window's valid frames on the host, so dispatch, reversal, the av-offset
and the snapshot work on numpy arrays.  The worker thread and the
prefetch producer queue their device work on the stream that was current
where play() was called; an exception in either posts an `error` message
and stops playback.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from enum import Enum
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Bus, Message
from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, map_tensors
from gstbad_tpu_torch.core.pipeline import Node, Pipeline, parse_launch, \
    resolve_device
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops.numerics import fma64

NSEC = 1_000_000_000


class PlayState(Enum):
    """GstPlayState (gstplay.h:63-69)."""
    STOPPED = "stopped"
    BUFFERING = "buffering"
    PAUSED = "paused"
    PLAYING = "playing"


#: GstPlayMessage names (gstplay.h:94-108, gst_play_message_get_name)
PLAY_MESSAGES = (
    "uri-loaded", "position-updated", "duration-changed", "state-changed",
    "buffering", "end-of-stream", "error", "warning",
    "video-dimensions-changed", "media-info-updated", "volume-changed",
    "mute-changed", "seek-done",
)


# ---------------------------------------------------------------------------
# media info model (gstplay-media-info.h)

@dataclasses.dataclass
class StreamInfo:
    """GstPlayStreamInfo (gstplay-media-info.h:52-71)."""
    index: int
    stream_type: str                      # 'video' | 'audio' | 'subtitle'
    caps: Optional[MediaSpec] = None
    codec: Optional[str] = None
    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class VideoInfo(StreamInfo):
    """GstPlayVideoInfo (gstplay-media-info.h:94-122)."""
    width: int = 0
    height: int = 0
    framerate: Tuple[int, int] = (0, 1)
    pixel_aspect_ratio: Tuple[int, int] = (1, 1)
    bitrate: int = -1
    max_bitrate: int = -1


@dataclasses.dataclass
class AudioInfo(StreamInfo):
    """GstPlayAudioInfo (gstplay-media-info.h:143-165)."""
    channels: int = 0
    sample_rate: int = 0
    language: Optional[str] = None
    bitrate: int = -1
    max_bitrate: int = -1


@dataclasses.dataclass
class SubtitleInfo(StreamInfo):
    """GstPlaySubtitleInfo (gstplay-media-info.h:185-194)."""
    language: Optional[str] = None


@dataclasses.dataclass
class MediaInfo:
    """GstPlayMediaInfo (gstplay-media-info.h:215-268)."""
    uri: Optional[str]
    duration: Optional[int]               # ns, None = GST_CLOCK_TIME_NONE
    seekable: bool
    is_live: bool = False
    title: Optional[str] = None
    container_format: Optional[str] = None
    image_sample: Optional[Any] = None
    video_streams: List[VideoInfo] = dataclasses.field(default_factory=list)
    audio_streams: List[AudioInfo] = dataclasses.field(default_factory=list)
    subtitle_streams: List[SubtitleInfo] = dataclasses.field(
        default_factory=list)

    @property
    def stream_list(self) -> List[StreamInfo]:
        return (list(self.video_streams) + list(self.audio_streams)
                + list(self.subtitle_streams))

    @property
    def number_of_streams(self) -> int:
        return len(self.stream_list)

    @property
    def number_of_video_streams(self) -> int:
        return len(self.video_streams)

    @property
    def number_of_audio_streams(self) -> int:
        return len(self.audio_streams)

    @property
    def number_of_subtitle_streams(self) -> int:
        return len(self.subtitle_streams)


# ---------------------------------------------------------------------------
# internal compute stages

class _PlayVolume(Element):
    """The playbin volume/mute property pair as a gain stage on the audio
    chain (gstplay.c PROP_VOLUME/PROP_MUTE forward to playbin).  Dynamic
    params: volume/mute changes apply from the next window, with no
    rebuild.  The float32 gain multiplies in float64; integer samples
    round half to even, as jnp.round does, and saturate."""

    NAME = "play-volume"
    KIND = "filter"
    PROPERTIES = (
        Property("volume", float, 1.0, 0.0, 10.0),
        Property("mute", bool, False),
    )

    def process(self, params, state, batch: FrameBatch):
        x = batch.data
        gain = torch.where(params["mute"], torch.zeros_like(params["volume"]),
                           params["volume"]).to(torch.float64)
        y = x.to(torch.float64) * gain
        if x.is_floating_point():
            return state, batch.with_data(y.to(x.dtype))
        info = torch.iinfo(x.dtype)
        out = y.round_().clamp_(info.min, info.max).to(x.dtype)
        return state, batch.with_data(out)


class _ColorBalance(Element):
    """The playbin colorbalance interface (gst_play_set_color_balance,
    gstplay.c; channel values normalized to [0,1] with 0.5 neutral).
    Math follows the standard videobalance equations: luma
    y' = ((y_norm - 0.5) * contrast + 0.5 + brightness), chroma rotated
    by hue*pi and scaled by saturation around the 128 midpoint.  Supports
    luma/chroma formats (planar y/u/v dicts, AYUV, GRAY8).

    Luma is a map of the byte: its 256 values are taken once a window
    on the host, as the JAX package's compiled window rounds them (XLA
    folds the division by 219 into a product with float64(1/219) and
    contracts three `a*b + c` into FMAs: fma(fma(fma(y - 16, 1/219,
    -0.5), contrast, 0.5) + brightness, 219, 16), numerics.fma64), and
    looked up on the device.  Chroma is float64 plain ops on the device,
    each product and sum rounded on its own, with the hue's cos and sin
    times the saturation taken once a window on the host.  Every scalar
    comes from the float32 property values, so the card and the CPU take
    the same ones."""

    NAME = "play-color-balance"
    KIND = "filter"
    PROPERTIES = (
        Property("brightness", float, 0.5, 0.0, 1.0),
        Property("contrast", float, 0.5, 0.0, 1.0),
        Property("hue", float, 0.5, 0.0, 1.0),
        Property("saturation", float, 0.5, 0.0, 1.0),
    )

    SUPPORTED = ("AYUV", "GRAY8", "I420", "YV12", "Y444", "Y42B", "Y41B",
                 "NV12", "NV21")

    def dynamic_params(self):
        def f32(name):
            return float(np.float32(self.props[name]))

        b = (f32("brightness") - 0.5) * 2.0
        c = f32("contrast") * 2.0
        r = 1.0 / 219.0
        luma = [min(max(round(fma64(fma64(fma64(y - 16.0, r, -0.5), c, 0.5)
                                    + b, 219.0, 16.0)), 0), 255)
                for y in range(256)]
        s = f32("saturation") * 2.0
        hrad = (f32("hue") - 0.5) * 2.0 * math.pi
        out = {k: torch.full((), v, dtype=torch.float64, device=self.device)
               for k, v in (("cu", math.cos(hrad) * s),
                            ("su", math.sin(hrad) * s))}
        out["luma"] = torch.tensor(luma, dtype=torch.uint8,
                                   device=self.device)
        return out

    def _y(self, y, params):
        return params["luma"][y.to(torch.int32)]

    def _uv(self, u, v, params):
        du = u.to(torch.float64) - 128.0
        dv = v.to(torch.float64) - 128.0
        cu, su = params["cu"], params["su"]
        nu = (du * cu).sub_(dv * su).add_(128.0)
        nv = (du * su).add_(dv * cu).add_(128.0)
        return (nu.round_().clamp_(0, 255).to(torch.uint8),
                nv.round_().clamp_(0, 255).to(torch.uint8))

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        fmt = self.in_spec.format
        if isinstance(data, dict):
            out = dict(data)
            out["y"] = self._y(data["y"], params)
            if "u" in data and "v" in data:
                out["u"], out["v"] = self._uv(data["u"], data["v"], params)
            elif "uv" in data:
                u = data["uv"][..., 0::2] if fmt == "NV12" \
                    else data["uv"][..., 1::2]
                v = data["uv"][..., 1::2] if fmt == "NV12" \
                    else data["uv"][..., 0::2]
                nu, nv = self._uv(u, v, params)
                uv = torch.stack([nu, nv] if fmt == "NV12" else [nv, nu],
                                 dim=-1).reshape(data["uv"].shape)
                out["uv"] = uv
            return state, batch.with_data(out)
        if fmt == "AYUV":
            y = self._y(data[..., 1], params)
            u, v = self._uv(data[..., 2], data[..., 3], params)
            out = torch.stack([data[..., 0], y, u, v], dim=-1)
            return state, batch.with_data(out)
        # GRAY8
        return state, batch.with_data(self._y(data, params))


def _map_batch(fn, b: FrameBatch) -> FrameBatch:
    """fn over every array of a host FrameBatch (data, pts, flags, valid,
    word, word_base, trim), as the JAX package maps its pytree."""
    return FrameBatch(**{f.name: map_tensors(fn, getattr(b, f.name))
                         for f in dataclasses.fields(b)})


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Track:
    kind: str                             # 'video' | 'audio'
    index: int                            # per-kind index
    nodes: List[Node]                     # the component's nodes
    leaf: Node
    volume: Optional[_PlayVolume] = None  # audio gain stage
    balance: Optional[_ColorBalance] = None


class Play:
    """GstPlay analog.  Construct with a Pipeline / launch string (direct
    graph use) or empty + set_uri() (the reference's uri flow).  `device`
    ("cuda" or "cpu") binds every pipeline Play builds; a Pipeline given
    here must already be on it."""

    def __init__(self, pipeline=None, window: int = 8,
                 realtime: bool = True,
                 on_frame: Optional[Callable] = None,
                 n_frames: Optional[int] = None,
                 on_subtitle: Optional[Callable] = None,
                 prefetch: bool = True, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(pipeline, str):
            pipeline = parse_launch(pipeline, device=self.device)
        elif pipeline is not None and pipeline.device != self.device:
            raise ValueError(f"the pipeline is on {pipeline.device}, Play "
                             f"on {self.device}")
        self.pipeline: Optional[Pipeline] = pipeline
        self.window = window
        self.realtime = realtime
        #: double-buffered playback (VERDICT r4 weak #7 / SURVEY §2.6's
        #: async host feed): window N+1 computes on a producer thread
        #: while window N's frames dispatch to the callbacks.  Forward
        #: rates only; seeks/track switches invalidate in-flight windows
        #: by generation.
        self.prefetch = prefetch
        self._gen = 0
        self._compute_idx = 0
        self.on_frame = on_frame
        self.on_subtitle = on_subtitle
        self.n_frames = n_frames
        self.state = PlayState.STOPPED
        self.message_bus = Bus()          # gst_play_get_message_bus
        self._uri: Optional[str] = None
        self._suburi: Optional[str] = None
        self._sub_cues: List[dict] = []
        self._sub_dispatched: set = set()
        self._rate = 1.0
        self._volume = 1.0
        self._mute = False
        self._av_offset = 0               # ns, gst_play_set_audio_video_offset
        self._sub_offset = 0              # gst_play_set_subtitle_video_offset
        self._multiview_mode = "none"
        self._multiview_flags = 0
        self._vis_name: Optional[str] = None
        self._vis_enabled = False
        self._vis_node: Optional[Node] = None
        self._config = {"user-agent": "GstPlay <gstbad-tpu>",
                        "position-update-interval": 100,   # ms
                        "seek-accurate": False}
        self._position_ns = 0
        self._frame_idx = 0               # next primary-stream frame
        self._last_pos_post = None
        self._is_eos = False
        self._tracks: List[_Track] = []
        self._current: Dict[str, Optional[int]] = {
            "video": None, "audio": None, "subtitle": None}
        self._enabled = {"video": True, "audio": True, "subtitle": True}
        self._prepared = False
        self._run_p: Optional[Pipeline] = None
        self._sources_dirty = False
        self._last_video: Optional[Tuple[MediaSpec, Any]] = None
        self._video_dims: Optional[Tuple[int, int]] = None
        self._lock = threading.RLock()
        #: the CUDA stream the worker and the prefetch producer queue
        #: their work on: the current one where play() was called
        self._stream = None
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stop = threading.Event()

    # -- uri handling (gstplay.c PROP_URI / gst_play_set_uri) ---------------
    @classmethod
    def from_uri(cls, uri: str, **kw) -> "Play":
        """Direct-construction path: unlike set_uri()+play() (which turns
        failures into error messages, the gst_play flow), this raises."""
        p = cls(**kw)
        p._uri = uri
        p._build_from_uri(uri)
        p._post("uri-loaded", uri=uri)
        return p

    def set_uri(self, uri: str) -> None:
        """gstplay.c:600-616 PROP_URI: resets suburi and stops current
        playback; resolution is deferred to play() — an invalid URI posts
        an error message there (test_play_error_invalid_uri flow)."""
        if self.state != PlayState.STOPPED:
            self.stop()
        self._uri = uri
        self._suburi = None
        self._sub_cues = []
        self.pipeline = None
        self._prepared = False
        self._run_p = None
        self._tracks = []

    def get_uri(self) -> Optional[str]:
        return self._uri

    def _build_from_uri(self, uri: str) -> None:
        if uri.startswith("testbin://"):
            from gstbad_tpu_torch.session.testbin import testbin_launch
            self.pipeline = parse_launch(testbin_launch(uri),
                                         device=self.device)
            return
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        if "://" in path:
            raise ValueError(f"unsupported uri scheme {uri!r}")
        if path.endswith(".y4m"):
            from gstbad_tpu_torch.io import y4m
            spec, planes = y4m.read_y4m(path)
            p = parse_launch(
                f"appsrc name=src format={spec.format} width={spec.width} "
                f"height={spec.height} framerate={spec.framerate.numerator}"
                f"/{spec.framerate.denominator} ! fakevideosink",
                device=self.device)
            p.get_by_name("src").push_frames(planes)
            if self.n_frames is None:
                self.n_frames = next(iter(planes.values())).shape[0]
            self.pipeline = p
            return
        # typefind + decodebin fallback (r3): sniff the file and build
        # the matching real-decoder source
        import os
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        import gstbad_tpu_torch as gt
        from gstbad_tpu_torch.io import typefind
        with open(path, "rb") as f:
            data = f.read()
        mtype, src = typefind.make_source(data, path=path)
        sink = gt.make("fakeaudiosink" if mtype.startswith("audio/")
                       else "fakevideosink")
        self.pipeline = Pipeline([src, sink], device=self.device)
        self._container = mtype

    def _ensure_pipeline(self) -> bool:
        if self.pipeline is not None:
            return True
        if self._uri is None:
            self._post("error", reason="no uri set")
            return False
        try:
            self._build_from_uri(self._uri)
        except Exception as e:  # noqa: BLE001 - becomes the error message
            self._post("error", reason=str(e), uri=self._uri)
            return False
        self._post("uri-loaded", uri=self._uri)
        return True

    # -- preparation ---------------------------------------------------------
    def _components(self) -> List[List[Node]]:
        """Weakly-connected components of the pipeline DAG, in node
        declaration order (each = one elementary stream chain)."""
        nodes = self.pipeline.nodes
        parent: Dict[int, int] = {id(n): id(n) for n in nodes}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for n in nodes:
            for i in n.inputs:
                parent[find(id(i))] = find(id(n))
        groups: Dict[int, List[Node]] = {}
        for n in nodes:
            groups.setdefault(find(id(n)), []).append(n)
        return [groups[k] for k in
                sorted(groups, key=lambda k: min(
                    nodes.index(n) for n in groups[k]))]

    def _comp_leaf(self, comp: List[Node]) -> Node:
        consumed = {id(i) for n in self.pipeline.nodes for i in n.inputs}
        leaves = [n for n in comp if id(n) not in consumed]
        return leaves[0]

    def _insert_stage(self, comp: List[Node], leaf: Node,
                      element: Element) -> Node:
        """Insert a compute stage at the tail of a component: before a
        pure sink leaf, after a non-sink leaf (which makes the stage the
        new leaf)."""
        node = Node(element)
        if leaf.element.KIND == "sink":
            node.inputs = list(leaf.inputs)
            leaf.inputs = [node]
            self.pipeline.nodes.insert(self.pipeline.nodes.index(leaf),
                                       node)
        else:
            node.inputs = [leaf]
            self.pipeline.nodes.append(node)
        self.pipeline._order = None
        self.pipeline._step = None
        self.pipeline._states = None
        return node

    def _prepare(self) -> bool:
        with self._lock:
            if self._prepared:
                return True
            if not self._ensure_pipeline():
                return False
            try:
                self.pipeline.negotiate()
            except Exception as e:  # noqa: BLE001
                self._post("error", reason=str(e))
                return False
            # discover components, classify, insert volume stages
            self._tracks = []
            counts = {"video": 0, "audio": 0}
            for comp in self._components():
                leaf = self._comp_leaf(comp)
                spec = leaf.element.out_spec or leaf.element.in_spec
                kind = spec.kind if spec is not None else "video"
                if kind not in counts:
                    continue
                t = _Track(kind=kind, index=counts[kind], nodes=comp,
                           leaf=leaf)
                if kind == "audio":
                    vol = _PlayVolume(volume=self._volume, mute=self._mute)
                    t.volume = vol
                    vol_node = self._insert_stage(comp, leaf, vol)
                    comp.append(vol_node)
                    if leaf.element.KIND != "sink":
                        t.leaf = vol_node
                counts[kind] += 1
                self._tracks.append(t)
            if any(t.kind == "audio" for t in self._tracks):
                self.pipeline.negotiate()
            for kind in ("video", "audio"):
                if counts[kind] and self._current[kind] is None:
                    self._current[kind] = 0
            if self._sub_cues and self._current["subtitle"] is None:
                self._current["subtitle"] = 0
            self._prepared = True
            self._post("media-info-updated", media_info=self.media_info)
            dims = self._video_dimensions()
            if dims is not None:
                self._video_dims = dims
                self._post("video-dimensions-changed", width=dims[0],
                           height=dims[1])
            if self.duration is not None:
                self._post("duration-changed", duration=self.duration)
            self._rebuild_active()
            return True

    def _video_dimensions(self) -> Optional[Tuple[int, int]]:
        t = self._selected_track("video")
        if t is None:
            return None
        spec = t.leaf.element.out_spec
        return (spec.width, spec.height) if spec else None

    def _selected_track(self, kind: str) -> Optional[_Track]:
        if not self._enabled[kind] or self._current[kind] is None:
            return None
        for t in self._tracks:
            if t.kind == kind and t.index == self._current[kind]:
                return t
        return None

    def _rebuild_active(self) -> None:
        """Build the run pipeline from the selected+enabled components —
        unselected streams cost no compute (playbin's unselected pads
        don't decode)."""
        with self._lock:
            active: List[Node] = []
            known = set()
            for t in self._tracks:
                if t.kind in ("video", "audio"):
                    known.update(id(n) for n in t.nodes)
                    sel = self._selected_track(t.kind)
                    if sel is t:
                        active.extend(t.nodes)
            # components of other kinds always run
            for n in self.pipeline.nodes:
                if id(n) not in known and n is not self._vis_node:
                    active.append(n)
            # visualization tee off the selected audio tail
            self._vis_node = None
            audio = self._selected_track("audio")
            if (self._vis_name and self._vis_enabled and audio is not None
                    and self._selected_track("video") is None):
                import gstbad_tpu_torch as gt
                vis = gt.make(self._vis_name)
                node = Node(vis, name="play-vis")
                tail = audio.leaf
                if tail.element.KIND == "sink":
                    tail = tail.inputs[0]
                node.inputs = [tail]
                active.append(node)
                self._vis_node = node
            if not active:
                self._run_p = None
                return
            p = Pipeline(nodes=active, device=self.device)
            p.bus = self.pipeline.bus
            self._run_p = p
            self._sources_dirty = True
            self._compute_idx = self._frame_idx
            self._gen += 1

    # -- media info (gstplay-media-info.h getters) ---------------------------
    @property
    def media_info(self) -> Optional[MediaInfo]:
        """gst_play_get_media_info."""
        if not self._prepared and not self._prepare():
            return None
        video, audio = [], []
        seekable = True
        for t in self._tracks:
            spec = t.leaf.element.out_spec
            if t.kind == "video" and spec is not None:
                fr = spec.framerate or Fraction(30, 1)
                video.append(VideoInfo(
                    index=t.index, stream_type="video", caps=spec,
                    codec=spec.format, width=spec.width,
                    height=spec.height,
                    framerate=(fr.numerator, fr.denominator)))
            elif t.kind == "audio" and spec is not None:
                audio.append(AudioInfo(
                    index=t.index, stream_type="audio", caps=spec,
                    codec=spec.format, channels=spec.channels,
                    sample_rate=spec.rate))
            for n in t.nodes:
                if n.element.KIND == "host-source":
                    seekable = False
        subs = [SubtitleInfo(index=0, stream_type="subtitle",
                             language=None)] if self._sub_cues else []
        return MediaInfo(
            uri=self._uri, duration=self.duration, seekable=seekable,
            container_format=getattr(self, "_container", None),
            video_streams=video, audio_streams=audio,
            subtitle_streams=subs)

    def get_current_video_track(self) -> Optional[VideoInfo]:
        info = self.media_info
        t = self._selected_track("video")
        if info is None or t is None:
            return None
        return info.video_streams[t.index]

    def get_current_audio_track(self) -> Optional[AudioInfo]:
        info = self.media_info
        t = self._selected_track("audio")
        if info is None or t is None:
            return None
        return info.audio_streams[t.index]

    def get_current_subtitle_track(self) -> Optional[SubtitleInfo]:
        if (not self._enabled["subtitle"]
                or self._current["subtitle"] is None
                or not self._sub_cues):
            return None
        return SubtitleInfo(index=0, stream_type="subtitle")

    # -- track selection (gst_play_set_*_track[_enabled]) --------------------
    def _set_track(self, kind: str, index: int) -> bool:
        if not self._prepare():
            return False
        with self._lock:
            if kind == "subtitle":
                ok = index == 0 and bool(self._sub_cues)
                if ok:
                    self._current["subtitle"] = 0
                return ok
            if not any(t.kind == kind and t.index == index
                       for t in self._tracks):
                return False
            if self._current[kind] != index:
                self._current[kind] = index
                self._rebuild_active()
                self._post("media-info-updated",
                           media_info=self.media_info)
            return True

    def set_video_track(self, index: int) -> bool:
        return self._set_track("video", index)

    def set_audio_track(self, index: int) -> bool:
        return self._set_track("audio", index)

    def set_subtitle_track(self, index: int) -> bool:
        return self._set_track("subtitle", index)

    def _set_enabled(self, kind: str, enabled: bool) -> None:
        self._prepare()
        with self._lock:
            if self._enabled[kind] != enabled:
                self._enabled[kind] = enabled
                if kind != "subtitle":
                    self._rebuild_active()

    def set_video_track_enabled(self, enabled: bool) -> None:
        self._set_enabled("video", enabled)

    def set_audio_track_enabled(self, enabled: bool) -> None:
        self._set_enabled("audio", enabled)

    def set_subtitle_track_enabled(self, enabled: bool) -> None:
        self._set_enabled("subtitle", enabled)

    # -- subtitles (gst_play_set_subtitle_uri; suburi subparse path) ---------
    def set_subtitle_uri(self, uri: str) -> bool:
        """gstplay.c:540-570 set_suburi: playback position and state are
        preserved; an unreadable/invalid file posts a WARNING and leaves
        playback running (test_play_error_invalid_external_suburi)."""
        from gstbad_tpu_torch.io.subtitles import parse_srt
        path = uri[len("file://"):] if uri.startswith("file://") else uri
        try:
            with open(path, "rb") as f:
                cues = parse_srt(f.read())
        except Exception as e:  # noqa: BLE001 - becomes the warning
            self._post("warning", reason=f"suburi failed: {e}", uri=uri)
            return False
        with self._lock:
            self._suburi = uri
            self._sub_cues = cues
            self._sub_dispatched = set()
            self._current["subtitle"] = 0
        if self._prepared:
            self._post("media-info-updated", media_info=self.media_info)
        return True

    def get_subtitle_uri(self) -> Optional[str]:
        return self._suburi

    # -- volume / mute --------------------------------------------------------
    def set_volume(self, volume: float) -> None:
        """gstplay.c PROP_VOLUME -> every audio chain's gain stage
        (dynamic param: applies next window, no recompile)."""
        with self._lock:
            self._volume = float(volume)
            for t in self._tracks:
                if t.volume is not None:
                    t.volume.set_property("volume", self._volume)
        self._post("volume-changed", volume=self._volume)

    def get_volume(self) -> float:
        return self._volume

    def set_mute(self, mute: bool) -> None:
        with self._lock:
            self._mute = bool(mute)
            for t in self._tracks:
                if t.volume is not None:
                    t.volume.set_property("mute", self._mute)
        self._post("mute-changed", muted=self._mute)

    def get_mute(self) -> bool:
        return self._mute

    # -- rate (gst_play_set_rate, gstplay.c:2999 + 574-628) -------------------
    def set_rate(self, rate: float) -> None:
        if rate == 0.0:
            raise ValueError("rate must be non-zero (gstplay.c:3004)")
        with self._lock:
            old = self._rate
            self._rate = float(rate)
            if (old < 0) != (rate < 0):
                self._sources_dirty = True
                self._compute_idx = self._frame_idx
                self._gen += 1
            self._is_eos = False
        # the reference implements rate via an internal seek -> seek-done
        self._post("seek-done", position=self._position_ns)

    def get_rate(self) -> float:
        return self._rate

    @property
    def rate(self) -> float:
        return self._rate

    # -- av offsets ------------------------------------------------------------
    def set_audio_video_offset(self, offset_ns: int) -> None:
        """playbin av-offset: positive delays audio pts at dispatch."""
        self._av_offset = int(offset_ns)

    def get_audio_video_offset(self) -> int:
        return self._av_offset

    def set_subtitle_video_offset(self, offset_ns: int) -> None:
        self._sub_offset = int(offset_ns)

    def get_subtitle_video_offset(self) -> int:
        return self._sub_offset

    # -- multiview (plumb-only: no 3D presentation path exists here) ----------
    def set_multiview_mode(self, mode: str) -> None:
        self._multiview_mode = mode

    def get_multiview_mode(self) -> str:
        return self._multiview_mode

    def set_multiview_flags(self, flags: int) -> None:
        self._multiview_flags = int(flags)

    def get_multiview_flags(self) -> int:
        return self._multiview_flags

    # -- visualization (gst_play_set_visualization; playbin vis) --------------
    def set_visualization(self, name: Optional[str]) -> bool:
        import gstbad_tpu_torch as gt
        if name is not None:
            try:
                gt.make(name)
            except KeyError:
                return False
        with self._lock:
            self._vis_name = name
            if self._prepared:
                self._rebuild_active()
        return True

    def set_visualization_enabled(self, enabled: bool) -> None:
        with self._lock:
            self._vis_enabled = bool(enabled)
            if self._prepared:
                self._rebuild_active()

    def get_current_visualization(self) -> Optional[str]:
        return self._vis_name if self._vis_enabled else None

    # -- color balance (gst_play_{has,set,get}_color_balance) ----------------
    def has_color_balance(self) -> bool:
        if not self._prepare():
            return False
        t = self._selected_track("video")
        if t is None:
            return False
        spec = t.leaf.element.out_spec
        return spec is not None and spec.format in _ColorBalance.SUPPORTED

    def set_color_balance(self, channel: str, value: float) -> None:
        """channel in brightness|contrast|hue|saturation, value in [0,1]
        (gstplay.c normalizes onto the colorbalance channel range)."""
        if not self.has_color_balance():
            return
        with self._lock:
            t = self._selected_track("video")
            if t.balance is None:
                t.balance = _ColorBalance()
                bal_node = self._insert_stage(t.nodes, t.leaf, t.balance)
                t.nodes.append(bal_node)
                if t.leaf.element.KIND != "sink":
                    t.leaf = bal_node
                self.pipeline.negotiate()
                self._rebuild_active()
            t.balance.set_property(channel, float(value))

    def get_color_balance(self, channel: str) -> float:
        t = self._selected_track("video")
        if t is None or t.balance is None:
            return 0.5                     # neutral midpoint
        return t.balance.get_property(channel)

    # -- config (gst_play_set_config / gst_play_config_*) ---------------------
    def set_config(self, **config) -> bool:
        """Fails while not stopped (gstplay.c gst_play_set_config)."""
        if self.state != PlayState.STOPPED:
            return False
        for k, v in config.items():
            self._config[k.replace("_", "-")] = v
        return True

    def get_config(self) -> Dict[str, Any]:
        return dict(self._config)

    # -- snapshot (gst_play_get_video_snapshot) -------------------------------
    def get_video_snapshot(self, fmt: str = "native"):
        """Last dispatched video frame; fmt='native' returns (spec, array),
        other formats run it through videoconvert."""
        if self._last_video is None:
            return None
        spec, frame = self._last_video
        if fmt in ("native", spec.format):
            return spec, frame
        import gstbad_tpu_torch as gt
        conv = gt.make("videoconvert", format=fmt)
        conv.device = self.device
        conv.set_info(spec)
        data = map_tensors(
            lambda v: torch.from_numpy(np.ascontiguousarray(v)[None])
            .to(self.device), frame)
        _, out, _ = conv(FrameBatch.make(data))
        arr = out.to_numpy().data
        one = ({k: v[0] for k, v in arr.items()} if isinstance(arr, dict)
               else arr[0])
        return conv.out_spec, one

    def get_pipeline(self) -> Optional[Pipeline]:
        return self.pipeline

    @property
    def bus(self):
        return self.pipeline.bus if self.pipeline is not None \
            else self.message_bus

    # -- messages --------------------------------------------------------------
    def _post(self, name: str, **fields) -> None:
        assert name in PLAY_MESSAGES, name
        self.message_bus.post(Message("play", name, self._position_ns,
                                      fields))

    def _change_state(self, state: PlayState) -> None:
        if self.state != state:
            self.state = state
            self._post("state-changed", state=state)

    # -- state machine ---------------------------------------------------------
    def play(self) -> None:
        if self.state == PlayState.PLAYING:
            return
        if not self._prepare():
            self._change_state(PlayState.STOPPED)
            return
        if self._is_eos:
            # play after EOS restarts from 0 (gst_play_play_internal's
            # is_eos -> seek(0) path)
            with self._lock:
                self._frame_idx = 0
                self._compute_idx = 0
                self._gen += 1
                self._position_ns = 0
                self._sub_dispatched = set()
                self._sources_dirty = True
                self._is_eos = False
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
        self._change_state(PlayState.PLAYING)
        self._wake.set()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def pause(self) -> None:
        if self.state == PlayState.PLAYING:
            self._change_state(PlayState.PAUSED)
            self._wake.clear()
        elif self.state == PlayState.STOPPED:
            # preroll path: pause from stopped prepares the media
            if self._prepare():
                self._change_state(PlayState.PAUSED)

    def stop(self) -> None:
        self._change_state(PlayState.STOPPED)
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        with self._lock:
            self._position_ns = 0
            self._frame_idx = 0
            self._compute_idx = 0
            self._gen += 1
            self._last_pos_post = None
            self._sub_dispatched = set()
            self._sources_dirty = True
            self._is_eos = False

    # -- seeking ----------------------------------------------------------------
    def seek(self, position_ns: int) -> None:
        """gstplay.c:2906-2977 seek_internal: FLUSH always; ACCURATE per
        config seek-accurate (accurate = nearest frame; keyframe mode
        floors to the latest sync point <= position — identical for
        all-keyframe generated sources except at the rounding boundary);
        rate != 1 adds TRICKMODE.  Posts seek-done when applied."""
        if not self._prepare():
            return
        info = self.media_info
        if info is not None and not info.seekable:
            self._post("warning", reason="media is not seekable")
            return
        dur = self._primary_dur()
        position_ns = max(0, int(position_ns))
        if self._config.get("seek-accurate"):
            idx = int(round(position_ns / dur))
        else:
            idx = position_ns // dur
        with self._lock:
            self._frame_idx = idx
            self._compute_idx = idx
            self._gen += 1                 # drop in-flight prefetches
            self._position_ns = idx * dur
            self._sources_dirty = True
            self._is_eos = False
            self._sub_dispatched = set()
            if self._run_p is not None and self._run_p._states is not None:
                # flush: stateful elements restart (FLUSH_STOP analog)
                self._run_p._states = None
        self._post("seek-done", position=self._position_ns)

    @property
    def position(self) -> int:
        """gst_play_get_position (ns)."""
        return self._position_ns

    @property
    def duration(self) -> Optional[int]:
        """gst_play_get_duration (ns; None = GST_CLOCK_TIME_NONE)."""
        if self.n_frames is None:
            return None
        return self.n_frames * self._primary_dur()

    def get_position(self) -> int:
        return self._position_ns

    def get_duration(self) -> Optional[int]:
        return self.duration

    # -- worker -----------------------------------------------------------------
    def _primary_track(self) -> Optional[_Track]:
        return (self._selected_track("video")
                or self._selected_track("audio")
                or (self._tracks[0] if self._tracks else None))

    def _primary_dur(self) -> int:
        t = self._primary_track()
        if t is None:
            return NSEC // 30
        spec = t.leaf.element.out_spec
        if spec is None:
            return NSEC // 30
        if spec.kind == "video":
            return spec.frame_duration_ns
        # audio: block duration from the source's samplesperbuffer
        spb = 1024
        for n in t.nodes:
            spb = n.element.props.get("samplesperbuffer", spb) or spb
        return int(NSEC * spb / spec.rate)

    def _clock(self):
        """Pacing clock: a clockselect element in the graph wins
        (gstclockselect.c), else the monotonic default."""
        for n in getattr(self.pipeline, "nodes", []):
            if getattr(n.element, "NAME", "") == "clockselect":
                return n.element.clock()
        return time.monotonic

    def _apply_position(self, frame_idx: Optional[int] = None) -> None:
        """Reposition generator-source counters to a frame index
        (flush-seek / backward-rate / track-rebuild path)."""
        p = self._run_p
        if p._step is None or self.window != p._window:
            p.compile(self.window)
        if p._states is None:
            p._states = p.init_states(self.window)
        if frame_idx is None:
            frame_idx = self._frame_idx
        pos_ns = frame_idx * self._primary_dur()
        for i, n in enumerate(p._order):
            el = n.element
            if el.KIND != "source":
                continue
            st = p._states[i]
            if getattr(st, "ndim", None) != 0:
                continue                  # not a plain counter source
            spec = el.out_spec
            if spec.kind == "video":
                idx = int(round(pos_ns / spec.frame_duration_ns))
                p._states[i] = torch.full((), idx, dtype=st.dtype,
                                          device=st.device)
            elif spec.kind == "audio":
                spb = el.props.get("samplesperbuffer", 1024)
                blk = int(round(pos_ns * spec.rate / (spb * NSEC)))
                p._states[i] = torch.full((), blk * spb, dtype=st.dtype,
                                          device=st.device)
        self._sources_dirty = False

    def _dispatch(self, outs, reverse: bool,
                  limit: Optional[int] = None) -> int:
        """Route leaf batches: apply av-offset to audio pts, reverse for
        negative rates (keeping only the first `limit` source frames —
        the partial window at the segment start), keep the video
        snapshot.  Returns the number of primary-track frames
        dispatched."""
        p = self._run_p
        leaves = p._leaves()
        if isinstance(outs, list):
            outs = {0: outs}
        primary = self._primary_track()
        n_primary = 0
        for li, batches in outs.items():
            leaf = leaves[li]
            spec = leaf.element.out_spec
            kind = spec.kind if spec is not None else "video"
            owner = None
            for t in self._tracks:
                if any(n is leaf for n in t.nodes):
                    owner = t
                    break
            for b in batches:
                if limit is not None and b.batch > limit:
                    nb = b.batch
                    b = _map_batch(lambda x: x[:limit]
                                   if x.ndim >= 1 and x.shape[0] == nb
                                   else x, b)
                if reverse:
                    b = _map_batch(lambda x: np.flip(x, 0)
                                   if x.ndim >= 1 else x, b)
                if kind == "audio" and self._av_offset:
                    b = b.replace(pts=b.pts + self._av_offset)
                if kind == "video" and b.batch:
                    d = b.data
                    frame = ({k: v[-1] for k, v in d.items()}
                             if isinstance(d, dict) else d[-1])
                    self._last_video = (spec, frame)
                if self.on_frame is not None:
                    for i in range(b.batch):
                        self.on_frame(b, i)
                if owner is primary and b.batch:
                    n_primary += b.batch
        return n_primary

    def _dispatch_subtitles(self, t0: int, t1: int) -> None:
        if (not self._sub_cues or not self._enabled["subtitle"]
                or self._current["subtitle"] is None):
            return
        lo, hi = (t0, t1) if t0 <= t1 else (t1, t0)
        for ci, cue in enumerate(self._sub_cues):
            s = cue["start"] + self._sub_offset
            e = cue["end"] + self._sub_offset
            if s < hi and e > lo and ci not in self._sub_dispatched:
                self._sub_dispatched.add(ci)
                if self.on_subtitle is not None:
                    self.on_subtitle(cue["text"], cue)

    def _maybe_post_position(self) -> None:
        interval_ms = self._config.get("position-update-interval", 100)
        if not interval_ms:
            return
        interval = interval_ms * 1_000_000
        if (self._last_pos_post is None
                or abs(self._position_ns - self._last_pos_post)
                >= interval):
            self._last_pos_post = self._position_ns
            self._post("position-updated", position=self._position_ns)

    def _finish_eos(self) -> None:
        """eos_cb (gstplay.c:1046-1061): final tick, END_OF_STREAM,
        state -> STOPPED."""
        self._post("position-updated", position=self._position_ns)
        self._post("end-of-stream")
        self._is_eos = True
        self._change_state(PlayState.STOPPED)

    def _step_window(self) -> bool:
        """One window of playback.  Returns False on EOS/stop."""
        with self._lock:
            p = self._run_p
            if p is None:
                return True               # everything disabled: idle
            dur = self._primary_dur()
            rate = self._rate
            window = self.window
            if rate < 0:
                if self._frame_idx < 0:
                    self._finish_eos()
                    return False
                f0 = max(0, self._frame_idx - window + 1)
                self._apply_position(f0)
            else:
                f0 = self._frame_idx
                if (self.n_frames is not None
                        and f0 >= self.n_frames):
                    self._finish_eos()
                    return False
                if self._sources_dirty:
                    self._apply_position(f0)
            try:
                outs = p.run(n_frames=window, window=window)
            except Exception as e:  # noqa: BLE001 - becomes the message
                self._post("error", reason=str(e))
                self._change_state(PlayState.STOPPED)
                return False
            t0 = self._position_ns
            n_done = self._dispatch(
                outs, reverse=rate < 0,
                limit=(self._frame_idx - f0 + 1) if rate < 0 else None)
            if rate < 0:
                self._frame_idx = f0 - 1
                self._compute_idx = self._frame_idx
                self._position_ns = max(0, f0 - 1) * dur
                self._dispatch_subtitles(t0, self._position_ns)
                self._maybe_post_position()
                if f0 == 0:
                    self._finish_eos()
                    return False
            else:
                if n_done == 0 and self._has_host_source():
                    # host sources drained -> EOS
                    self._position_ns = self._frame_idx * dur
                    self._finish_eos()
                    return False
                self._frame_idx = f0 + (n_done or window)
                self._compute_idx = self._frame_idx
                self._position_ns = self._frame_idx * dur
                self._dispatch_subtitles(t0, self._position_ns)
                self._maybe_post_position()
                if (self.n_frames is not None
                        and self._frame_idx >= self.n_frames):
                    self._position_ns = min(self._position_ns,
                                            self.n_frames * dur)
                    self._finish_eos()
                    return False
            return True

    def _has_host_source(self) -> bool:
        return any(n.element.KIND == "host-source"
                   for n in self._run_p.nodes)

    # -- double-buffered prefetch (VERDICT r4 weak #7: overlap window
    # production with callback consumption, SURVEY §2.6's async feed) --
    def _compute_forward(self):
        """Produce one forward window on the producer thread.  Returns
        (generation, payload): payload None = idle, "eos" = stream end,
        ("error", msg), or (f0, outs)."""
        with self._lock:
            gen = self._gen
            p = self._run_p
            if p is None or self._rate < 0:
                return gen, None
            if (self.n_frames is not None
                    and self._compute_idx >= self.n_frames):
                return gen, "eos"
            f0 = self._compute_idx
            try:
                with self._on_stream():
                    if self._sources_dirty:
                        self._apply_position(f0)
                    outs = p.run(n_frames=self.window, window=self.window)
            except Exception as e:  # noqa: BLE001 - becomes the message
                return gen, ("error", str(e))
            self._compute_idx = f0 + self.window
            return gen, (f0, outs)

    def _dispatch_forward(self, f0: int, outs) -> bool:
        """Dispatch one computed forward window; False on EOS."""
        with self._lock:
            dur = self._primary_dur()
            t0 = self._position_ns
            n_done = self._dispatch(outs, reverse=False)
            if n_done == 0 and self._has_host_source():
                self._position_ns = self._frame_idx * dur
                self._finish_eos()
                return False
            self._frame_idx = f0 + (n_done or self.window)
            self._position_ns = self._frame_idx * dur
            self._dispatch_subtitles(t0, self._position_ns)
            self._maybe_post_position()
            if (self.n_frames is not None
                    and self._frame_idx >= self.n_frames):
                self._position_ns = min(self._position_ns,
                                        self.n_frames * dur)
                self._finish_eos()
                return False
            return True

    def _on_stream(self):
        """The stream play() was called on, made current in this thread
        (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _loop(self) -> None:
        """The worker thread: an exception that escapes a window (a
        callback's, a position update's) posts `error` and stops playback,
        as a failed window does."""
        try:
            with self._on_stream():
                self._play_windows()
        except Exception as e:  # noqa: BLE001 - becomes the message
            self._post("error", reason=str(e))
            self._change_state(PlayState.STOPPED)

    def _play_windows(self) -> None:
        from concurrent.futures import ThreadPoolExecutor
        clock = self._clock()
        pool = ThreadPoolExecutor(1, thread_name_prefix="play-prefetch") \
            if self.prefetch else None
        fut = None
        try:
            while not self._stop.is_set():
                if self.state != PlayState.PLAYING:
                    if fut is not None:
                        fut.result()       # drain; gen guard drops it
                        fut = None
                    # park until play() (the JAX package's worker spins
                    # here after end-of-stream: its wake stays set)
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                t0 = clock()
                use_prefetch = (pool is not None and self._rate >= 0
                                and self._run_p is not None)
                if not use_prefetch:
                    if fut is not None:
                        fut.result()
                        fut = None
                    if not self._step_window():
                        continue           # EOS/stop: park for play()
                else:
                    if fut is None:
                        fut = pool.submit(self._compute_forward)
                    gen, payload = fut.result()
                    fut = None
                    if gen != self._gen:
                        continue           # seek/track switch: stale
                    if payload is None:
                        time.sleep(0.01)
                        continue
                    if payload == "eos":
                        with self._lock:
                            self._finish_eos()
                        continue
                    if payload[0] == "error":
                        self._post("error", reason=payload[1])
                        self._change_state(PlayState.STOPPED)
                        continue
                    f0, outs = payload
                    # prefetch the NEXT window before dispatching this
                    # one — the device computes while callbacks run
                    fut = pool.submit(self._compute_forward)
                    if not self._dispatch_forward(f0, outs):
                        continue           # EOS: park for play()
                if self.realtime:
                    budget = (self.window * self._primary_dur()
                              / (NSEC * max(abs(self._rate), 1e-6)))
                    elapsed = clock() - t0
                    if elapsed < budget:
                        time.sleep(min(budget - elapsed, 1.0))
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
