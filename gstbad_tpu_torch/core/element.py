"""Element protocol — the GstElement/GstVideoFilter analog.

The reference's universal element pattern (SURVEY.md section 1; canonical
example gst/gaudieffects/gstgaussblur.c) maps onto this protocol:

  GObject properties with ranges/defaults  -> Property descriptors
  static pad templates / caps negotiation  -> accepted-format sets + set_info
  set_info (cache strides, alloc scratch)  -> set_info (precompute tables)
  transform_frame (per-buffer hot loop)    -> process(params, state, batch),
                                              a function of tensors on the
                                              pipeline's device
  GST_PARAM_CONTROLLABLE + sync_values     -> dynamic params passed as
                                              tensors (optionally per-frame)
  element messages on the bus              -> `messages` dict returned from
                                              process, drained by the runner
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.core.frame import FrameBatch, same_layout
from gstbad_tpu_torch.core.spec import MediaSpec, SpecError, VideoFormat, \
    fixate_format, require

_DTYPES = {float: torch.float32, int: torch.int32, bool: torch.bool}


@dataclasses.dataclass
class Property:
    """A GObject-property analog.

    static=True properties participate in table/shape precomputation and
    changing them retriggers set_info (like a caps renegotiation); dynamic
    ones are fed into the step as tensors each window (the
    GST_PARAM_CONTROLLABLE analog).
    """

    name: str
    type: type
    default: Any
    min: Any = None
    max: Any = None
    controllable: bool = False
    static: bool = False
    doc: str = ""

    def coerce(self, value):
        if self.type is bool and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes", "on")
        elif self.type in (int, float):
            value = self.type(float(value)) if isinstance(value, str) else self.type(value)
        elif self.type is str:
            value = str(value)
        if self.min is not None and value < self.min:
            raise ValueError(f"{self.name}={value} below minimum {self.min}")
        if self.max is not None and value > self.max:
            raise ValueError(f"{self.name}={value} above maximum {self.max}")
        return value


class Element:
    """Base element. Subclasses define NAME, PROPERTIES, and the hooks below.

    `device` is where prepare() puts its tables and dynamic_params() its
    tensors; the Pipeline sets it on every element it holds.

    Host-side hooks the Pipeline calls where an element defines them:
      KIND = "host-source": pull_window(window) -> FrameBatch on
        self.device, or None at the end of the stream (a TimeoutError is a
        stall: the run ends and posts a `stall` message);
      HOST = True: host_process(np_batch, bus) receives the valid frames
        of this element's own node on the host after every window;
      close(): release host resources (Pipeline.close);
      save_position() / restore_position(pos): a host source's stream
        position for checkpoints (Pipeline.save_checkpoint)."""

    NAME: str = ""
    KIND: str = "filter"  # 'filter' | 'source' | 'host-source' | 'sink'
    HOST: bool = False
    PROPERTIES: Sequence[Property] = ()

    def __init__(self, **props):
        self._propspecs = {p.name: p for p in self.PROPERTIES}
        self.props: Dict[str, Any] = {p.name: p.default for p in self.PROPERTIES}
        self.in_spec: Optional[MediaSpec] = None
        self.out_spec: Optional[MediaSpec] = None
        self.device = torch.device("cpu")
        self._controls: Dict[str, Any] = {}
        for k, v in props.items():
            self.set_property(k, v)

    # -- properties -------------------------------------------------------
    def set_property(self, name: str, value) -> None:
        key = name.replace("_", "-")
        if key not in self._propspecs:
            raise KeyError(f"{self.NAME}: no property {name!r} "
                           f"(has {sorted(self._propspecs)})")
        self.props[key] = self._propspecs[key].coerce(value)
        if self.in_spec is not None and self._propspecs[key].static:
            self.set_info(self.in_spec)  # re-prepare, like needs_remap

    def get_property(self, name: str):
        return self.props[name.replace("_", "-")]

    # -- property automation (GST_PARAM_CONTROLLABLE analog) ---------------
    def set_control(self, name: str, fn) -> None:
        """Bind a keyframed curve fn(pts_ns: np.ndarray[B]) -> values to a
        controllable property; evaluated per window against stream time
        (the gst_object_sync_values analog, gstgaussblur.c:217-226)."""
        key = name.replace("_", "-")
        spec = self._propspecs.get(key)
        if spec is None:
            raise KeyError(f"{self.NAME}: no property {name!r}")
        if not spec.controllable:
            raise ValueError(f"{self.NAME}: {key} is not controllable")
        self._controls[key] = fn

    def params_for_pts(self, pts) -> Dict[str, Any]:
        """dynamic_params with controlled props expanded to [B] tensors."""
        out = self.dynamic_params()
        for key, fn in self._controls.items():
            spec = self._propspecs[key]
            vals = np.asarray(fn(np.asarray(pts)))
            vals = [spec.coerce(v) for v in vals.tolist()]
            if spec.type in _DTYPES:
                out[key] = torch.tensor(vals, dtype=_DTYPES[spec.type],
                                        device=self.device)
        return out

    # -- negotiation -------------------------------------------------------
    def set_info(self, in_spec: MediaSpec) -> MediaSpec:
        """Fixate the output spec for `in_spec` and precompute tables.

        Default: in-place element (out spec == in spec).
        """
        self.in_spec = in_spec
        self.out_spec = self.negotiate(in_spec)
        self.prepare()
        return self.out_spec

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        return in_spec

    def prepare(self) -> None:
        """Precompute tables (LUTs, warp maps, kernels) on self.device."""

    # -- runtime -----------------------------------------------------------
    def init_state(self, batch: int):
        """Initial carry (field queues, delay lines, score rings)."""
        return ()

    def dynamic_params(self) -> Dict[str, Any]:
        """Current values of the dynamic (non-static) properties as 0-d
        tensors on self.device (float32 / int32 / bool).

        These are the arguments fed to the step each window; the
        per-frame controllable-curve path expands scalars to [B] tensors.
        """
        out = {}
        for p in self.PROPERTIES:
            # str dynamic props are not supported; mark them static instead
            if p.static or p.type not in _DTYPES:
                continue
            out[p.name] = torch.full((), self.props[p.name],
                                     dtype=_DTYPES[p.type],
                                     device=self.device)
        return out

    def process(self, params: Dict[str, Any], state, batch: FrameBatch):
        """Per-window function. Returns (state, batch) or
        (state, batch, messages) where messages is a dict of per-frame
        tensors.

        An element that holds frames back (fieldanalysis) also defines
        drain(state) -> (state, FrameBatch or None), which
        Pipeline.send_eos calls to flush them.
        """
        raise NotImplementedError

    # -- LUT-chain fusion hook ----------------------------------------------
    def byte_map(self, params):
        """If this element's whole action on packed-4 video is a per-channel
        byte map, return it as [*, 4, 256] int32 (leading * = per-frame
        controllable tables); else None.  The Pipeline composes adjacent
        byte-map elements' tables (256-entry math, free) and applies ONE
        lookup pass for the whole run."""
        return None

    # -- table-state fusion hooks (core/tablefuse.py) ------------------------
    # These let the Pipeline track values symbolically as table[index] and
    # collapse whole chains of per-pixel elements into 256-entry table math.

    @property
    def FUSES(self) -> bool:
        """True when this element overrides any table-fusion hook (cheap
        static gate so the Pipeline doesn't probe every element)."""
        cls = type(self)
        return (cls.byte_map is not Element.byte_map
                or cls.table_head is not Element.table_head
                or cls.word_map is not Element.word_map
                or cls.index_stencil is not Element.index_stencil
                or cls.table_tail is not Element.table_tail)

    def byte_map_kinds(self):
        """Structural per-channel kinds for byte_map's tables: 'map' (real
        table), 'zero' (channel forced to 0 — the word filters' rebuilt fill
        byte), 'id' (identity/passthrough — skip the lookup entirely)."""
        return ("map",) * 4

    def table_head(self, params):
        """If this element maps each pixel to table[index(pixel)] for a
        derived 8-bit index (the coloreffects luma presets), return
        (index, byte_specs): index is a tablefuse.LinearIndex (callable on
        a word tensor -> int32 idx in [0, 256)); byte_specs = 4 x (kind,
        table) with kind from tablefuse.{IDX,SRC,CONST} ('src', None) =
        byte passes through."""
        return None

    def word_map(self, params):
        """If this element is a pure per-pixel function on the packed u32
        word (cross-channel allowed — exclusion, chromahold, videoconvert),
        return fn(word_i32) -> word_i32 valid on ANY tensor shape.  The
        fusion pass evaluates fn on 256-entry tables when possible."""
        return None

    def index_stencil(self, params):
        """If this element only MOVES whole pixels by comparing a scalar key
        of each pixel (dilate's luminance propagation), return
        (key_fn, move_fn): key_fn({c: (kind, table)}) -> [*, 256] int32 key
        table; move_fn(idx_plane, key_plane, params) -> new idx_plane.
        move_fn must use keys only for ORDER comparisons (the pass may
        replace them with ranks)."""
        return None

    def table_tail(self, params, state, chain, batch):
        """If this element can consume a TableChain directly (positional
        final selects like zebrastripe), return (new_state, out_data);
        else None and the chain is materialized for process()."""
        return None

    # -- mesh shard rules (core/pipeline.py, parallel/mesh.py) --------------
    # True when process() maps each frame's pixels (or samples) on their
    # own and keeps its state: a sink that passes its batch on, a host
    # source that hands on the window it was given
    ELEMENTWISE: bool = False

    def packs_words(self) -> bool:
        """True when this element fuses and takes packed 4-byte video
        words, the table-fusion kinds' input."""
        spec = self.in_spec
        return (self.FUSES and spec is not None and spec.kind == "video"
                and spec.format in VideoFormat.PACKED_RGB4
                + (VideoFormat.AYUV,))

    def shard_rule(self, params):
        """How a mesh-sharded step runs this element: ("shard", 0) on each
        shard alone, ("halo", r) on each shard with r rows of its sp
        neighbours on each side and the result cropped to the shard's own
        rows, or ("gather", 0) on the whole window gathered onto the mesh's
        first device (exact, and counted).

        Per-shard elements read the shard's position from
        FrameBatch.shard (or a chain's src_batch.shard) where their output
        depends on it, and return the window's new state from every shard.
        The default: ELEMENTWISE elements and the table-fusion kinds on
        packed 4-byte words run per shard, everything else gathers.  A
        stencil's reach is its own: an element with an index_stencil
        declares its halo in its own shard_rule (dilate), else it
        gathers."""
        if self.ELEMENTWISE:
            return "shard", 0
        if not self.packs_words() or self.index_stencil(params) is not None:
            return "gather", 0
        if (self.byte_map(params) is not None
                or self.table_head(params) is not None
                or self.word_map(params) is not None):
            return "shard", 0
        return "gather", 0

    # -- live rebuild (runtime graph edits / static-property changes) -------
    def carry_state(self, old_state, window: int):
        """Carry a live state across a pipeline rebuild (an insertbin-style
        graph edit or set_static_property).  Kept as it is when its
        containers, tensor shapes and dtypes still match a fresh
        init_state; otherwise delegated to migrate_state."""
        if same_layout(self.init_state(window), old_state):
            return old_state
        return self.migrate_state(old_state, window)

    def migrate_state(self, old_state, window: int):
        """Shape-changing state migration hook; default starts fresh."""
        return self.init_state(window)

    # convenience for tests / direct use
    def __call__(self, batch: FrameBatch, state=None):
        if self.in_spec is None:
            raise SpecError(f"{self.NAME}: set_info() not called")
        if state is None:
            state = self.init_state(batch.batch)
        out = self.process(self.dynamic_params(), state, batch)
        if len(out) == 2:
            state, batch = out
            return state, batch, {}
        return out

    def __repr__(self):
        ps = " ".join(f"{k}={v}" for k, v in self.props.items())
        return f"<{self.NAME} {ps}>"


class VideoFilter(Element):
    """Element restricted to a set of packed video formats (GstVideoFilter)."""

    FORMATS: Sequence[str] = ()

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "video", f"{self.NAME}: needs video input")
        return fixate_format(in_spec, tuple(self.FORMATS), self.NAME)


class AudioFilter(Element):
    """Element restricted to a set of sample formats and, optionally, a
    channel-count range (GstAudioFilter)."""

    FORMATS: Sequence[str] = ()
    CHANNELS: Optional[Tuple[int, int]] = None  # (min, max) or None

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        require(in_spec.kind == "audio", f"{self.NAME}: needs audio input")
        spec = fixate_format(in_spec, tuple(self.FORMATS), self.NAME)
        if self.CHANNELS is not None:
            lo, hi = self.CHANNELS
            require(lo <= spec.channels <= hi,
                    f"{self.NAME}: channels {spec.channels} not in "
                    f"[{lo},{hi}]")
        return spec
