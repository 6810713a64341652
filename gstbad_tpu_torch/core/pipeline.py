"""Pipeline — composition and execution of element graphs.

The reference schedules one streaming thread per element chain and moves
buffers through pad push (SURVEY.md section 3.1).  Here a pipeline is a DAG
of elements whose `process` functions compose into ONE window function
over tensors on the pipeline's device; table fusion (core/tablefuse.py)
collapses runs of per-pixel elements so the 10-element headline graph is
one fused kernel per window.  Branching (tee) and N-input aggregation are
plain fan-out/fan-in in the DAG.

`parse_launch` maps gst-launch-1.0 syntax onto this composition, including
named elements and branch links:

    parse_launch("videotestsrc ! tee name=t  t. ! burn ! fakesink  "
                 "t. ! dodge ! fakesink", device="cuda")
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Bus, Message
from gstbad_tpu_torch.core.element import Element
from gstbad_tpu_torch.core.frame import FrameBatch, tensors_from_numpy
from gstbad_tpu_torch.core.registry import make
from gstbad_tpu_torch.core.spec import MediaSpec, SpecError


def resolve_device(device) -> torch.device:
    """The device a pipeline runs on.  A CUDA request without a card
    raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           "device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev} (cpu or cuda)")
    return dev


class Node:
    def __init__(self, element: Element, name: Optional[str] = None):
        self.element = element
        self.name = name
        self.inputs: List["Node"] = []
        self.spec: Optional[MediaSpec] = None

    def __repr__(self):
        return f"<node {self.name or self.element.NAME}>"


class Pipeline:
    """An element DAG bound to one device.  `device` is "cuda" (the
    default) or "cpu"; a CUDA request without a card raises."""

    def __init__(self, elements: Sequence[Element] = (),
                 nodes: Optional[List[Node]] = None, device="cuda"):
        if nodes is None:
            if not elements:
                raise ValueError("empty pipeline")
            nodes = []
            prev = None
            for el in elements:
                n = Node(el)
                if prev is not None:
                    n.inputs.append(prev)
                nodes.append(n)
                prev = n
        self.device = resolve_device(device)
        for n in nodes:
            n.element.device = self.device
        self.nodes = nodes
        self.bus = Bus()
        self._step = None
        self._states = None
        self._window = None
        self._in_spec: Optional[MediaSpec] = None
        self._order: Optional[List[Node]] = None
        self._tap_route: Dict[str, int] = {}

    # -- convenience views --------------------------------------------------
    @property
    def elements(self) -> List[Element]:
        return [n.element for n in self.nodes]

    @property
    def specs(self) -> List[MediaSpec]:
        return [n.spec for n in (self._order or self.nodes)]

    def get_by_name(self, name: str) -> Element:
        for n in self.nodes:
            if n.name == name:
                return n.element
        raise KeyError(name)

    # -- graph structure -----------------------------------------------------
    def _toposort(self) -> List[Node]:
        order: List[Node] = []
        seen: Dict[int, int] = {}

        def visit(n: Node):
            state = seen.get(id(n), 0)
            if state == 1:
                raise SpecError("pipeline graph has a cycle")
            if state == 2:
                return
            seen[id(n)] = 1
            for i in n.inputs:
                visit(i)
            seen[id(n)] = 2
            order.append(n)

        for n in self.nodes:
            visit(n)
        return order

    def _leaves(self) -> List[Node]:
        consumed = {id(i) for n in self.nodes for i in n.inputs}
        return [n for n in self.nodes if id(n) not in consumed]

    # -- negotiation ---------------------------------------------------------
    def negotiate(self, in_spec: Optional[MediaSpec] = None) -> MediaSpec:
        """Spec fixation in topological order (caps negotiation analog)."""
        self._in_spec = in_spec
        self._order = self._toposort()
        for n in self._order:
            el = n.element
            if el.KIND == "source":
                n.spec = el.set_info(in_spec or MediaSpec())
            elif not n.inputs:
                if in_spec is None:
                    raise SpecError(
                        f"{el.NAME}: no source and no input spec")
                n.spec = el.set_info(in_spec)
            elif len(n.inputs) == 1:
                n.spec = el.set_info(n.inputs[0].spec)
            else:
                n.spec = el.set_info([i.spec for i in n.inputs])
        return self._leaves()[-1].spec

    @property
    def out_spec(self) -> MediaSpec:
        return self._leaves()[-1].spec

    # -- the window step -----------------------------------------------------
    def compile(self, window: int, in_spec: Optional[MediaSpec] = None,
                taps: Sequence[str] = (), fuse_luts: bool = True):
        """Build the window function over the whole DAG.

        step(params, states, in_batch_or_None)
            -> (states, leaf_batches, messages)

        The step runs eagerly on the pipeline's device (there is no trace
        or compile); the name and signature match the JAX package.

        taps: element/node names whose intermediate output batches should be
        materialized (SURVEY.md §7 hard-part 5 — fusion vs verifiability);
        they are appended to leaf_batches.  Retrieve them with
        `taps_of(leaf_batches)` -> {name: FrameBatch}.
        """
        if self._order is None or (in_spec is not None):
            self.negotiate(in_spec)
        self._window = window
        order = self._order
        leaves = self._leaves()
        leaf_index = {id(n): i for i, n in enumerate(leaves)}

        # debug taps: materialize named nodes' outputs as extra leaf slots
        def node_named(name: str) -> Node:
            for n in order:
                if n.name == name or n.element.NAME == name:
                    return n
            raise KeyError(f"tap: no element named {name!r}")

        tap_nodes = [node_named(t) for t in taps]
        tap_extra: List[Node] = []
        self._tap_route = {}
        for t, n in zip(taps, tap_nodes):
            if id(n) in leaf_index:
                self._tap_route[t] = leaf_index[id(n)]
            else:
                if n not in tap_extra:
                    tap_extra.append(n)
                self._tap_route[t] = len(leaves) + tap_extra.index(n)

        # Table-state fusion (core/tablefuse.py, Element.byte_map/word_map/
        # table_head/index_stencil/table_tail): runs of per-pixel elements
        # get their work COMPOSED into 256-entry table math instead of each
        # traversing the frame.  A run extends only through nodes whose
        # sole consumer is the next run member and that nothing else
        # observes (leaves, taps); everything else flushes.
        consumers: Dict[int, List[Node]] = {}
        for n in order:
            for i in n.inputs:
                consumers.setdefault(id(i), []).append(n)
        protected = {id(n) for n in leaves} | {id(n) for n in tap_nodes}

        def step(params: List[Dict[str, Any]], states: List[Any],
                 in_batch: Optional[FrameBatch]):
            from gstbad_tpu_torch.core import tablefuse

            new_states = list(states)
            messages: Dict[str, Dict[str, Any]] = {}
            values: Dict[int, FrameBatch] = {}
            # id(node) -> TableChain whose symbolic value is node's output
            chains: Dict[int, tablefuse.TableChain] = {}

            def flush(nid: int) -> None:
                chain = chains.pop(nid)
                if len(chain.members) == 1 and not chain._time_invariant():
                    # a lone fused node keeps its own (cheaper) process —
                    # EXCEPT when the chain is time-invariant: the
                    # one-frame-then-broadcast materialization beats any
                    # per-frame process (static source + static tables)
                    si, el = chain.members[0]
                    new_states[si], val = el.process(params[si], states[si],
                                                     chain.src_batch)
                else:
                    val = chain.materialize()
                values[nid] = val

            def value_of(node: Node) -> FrameBatch:
                if id(node) in chains:
                    flush(id(node))
                return values[id(node)]

            def try_absorb(chain, el, p) -> bool:
                bm = el.byte_map(p)
                if bm is not None:
                    chain.absorb_byte_map(bm, el.byte_map_kinds())
                    return True
                head = el.table_head(p)
                if head is not None and chain.absorb_head(*head):
                    return True
                wm = el.word_map(p)
                if wm is not None and chain.absorb_word_map(wm):
                    return True
                st = el.index_stencil(p)
                if st is not None and chain.absorb_index_stencil(
                        st[0], st[1], p, st[2] if len(st) > 2 else None):
                    return True
                return False

            for si, n in enumerate(order):
                el = n.element
                if fuse_luts and len(n.inputs) == 1 and el.KIND != "source":
                    inp = n.inputs[0]
                    chain = None
                    popped_live = False
                    if (id(inp) in chains and id(inp) not in protected
                            and consumers.get(id(inp)) == [n]):
                        chain = chains.pop(id(inp))
                        popped_live = True
                    elif el.FUSES:
                        chain = tablefuse.start_chain(value_of(inp))
                    if chain is not None:
                        tail = el.table_tail(params[si], states[si], chain,
                                             chain.src_batch)
                        if tail is not None:
                            new_states[si], data = tail
                            # a tail may return a full FrameBatch (to keep
                            # a word attached for the sink)
                            values[id(n)] = (
                                data if isinstance(data, FrameBatch)
                                else chain.src_batch.with_data(data))
                            continue
                        if try_absorb(chain, el, params[si]):
                            chain.members.append((si, el))
                            new_states[si] = states[si]
                            chains[id(n)] = chain
                            continue
                        if popped_live:
                            chains[id(inp)] = chain
                            flush(id(inp))
                if el.KIND == "source":
                    out = el.generate(params[si], states[si], window)
                else:
                    if not n.inputs:
                        batch = in_batch
                    elif len(n.inputs) == 1:
                        batch = value_of(n.inputs[0])
                    else:
                        batch = [value_of(i) for i in n.inputs]
                    out = el.process(params[si], states[si], batch)
                if len(out) == 3:
                    st, val, msgs = out
                    for name, fields in msgs.items():
                        messages[f"{el.NAME}:{name}"] = fields
                else:
                    st, val = out
                new_states[si] = st
                values[id(n)] = val
            leaf_out = ([value_of(n) for n in leaves]
                        + [value_of(n) for n in tap_extra])
            return new_states, leaf_out, messages

        self._step = step
        if self._states is None:
            self._states = [n.element.init_state(window) for n in order]
        return step

    def taps_of(self, leaf_batches) -> Dict[str, FrameBatch]:
        """Extract tapped intermediates from a step's leaf_batches."""
        return {name: leaf_batches[i] for name, i in self._tap_route.items()}

    def init_states(self, window: int):
        order = self._order or self._toposort()
        return [n.element.init_state(window) for n in order]

    def params(self) -> List[Dict[str, Any]]:
        order = self._order or self._toposort()
        return [n.element.dynamic_params() for n in order]

    def load_states(self, states) -> None:
        """Resume from carried states given as numpy values (e.g. a JAX
        pipeline's step states after np.asarray), one entry per element
        in topological order."""
        self._states = tensors_from_numpy(states, self.device)

    # -- host runner ----------------------------------------------------------
    def run(self, n_frames: int = 0, inputs: Optional[FrameBatch] = None,
            window: Optional[int] = None):
        """Drive the pipeline; returns the valid output frames per window
        as host (numpy) batches: a list for a single-leaf graph, else
        {leaf_index: [batches]}.

        Invalid (masked-out) frames are compacted away host-side between
        windows, the analog of GST_BASE_TRANSFORM_FLOW_DROPPED.
        """
        if inputs is not None:
            window = window or inputs.batch
        window = window or self._window or n_frames
        if not window:
            raise ValueError("run() needs a window size (or inputs/n_frames)")
        if self._step is None or window != self._window:
            self.compile(window)
        order = self._order
        states = self._states
        params = self.params()
        leaves = self._leaves()
        outs: Dict[int, List[FrameBatch]] = {i: [] for i in
                                             range(len(leaves))}

        def window_iter():
            if inputs is not None:
                for i in range(0, inputs.batch, window):
                    yield _slice_batch(inputs, i, i + window)
            else:
                for _ in range(-(-n_frames // window)):
                    yield None

        has_controls = any(n.element._controls for n in order)
        src_spec = order[0].spec
        dur = (src_spec.frame_duration_ns if src_spec
               and src_spec.kind == "video" else int(1e9 / 30))
        frame_counter = 0
        for w in window_iter():
            if has_controls:
                # stream-time sync (gst_object_sync_values analog)
                if w is not None:
                    pts = w.pts.cpu().numpy()
                else:
                    pts = (frame_counter
                           + np.arange(window, dtype=np.int64)) * dur
                params = [n.element.params_for_pts(pts)
                          if n.element._controls
                          else n.element.dynamic_params() for n in order]
                frame_counter += window
            states, leaf_batches, messages = self._step(params, states, w)
            self._drain_messages(leaf_batches[len(leaves) - 1], messages)
            for li in range(len(leaves)):
                np_batch = _host_batch(leaf_batches[li])
                if np_batch is not None:
                    outs[li].append(np_batch)
        self._states = states
        if len(leaves) == 1:
            return outs[0]
        return outs

    def _drain_messages(self, batch: FrameBatch, messages) -> None:
        if not messages:
            return
        pts = batch.pts.cpu().numpy()
        for key, fields in messages.items():
            el_name, struct = key.split(":", 1)
            np_fields = {k: v.cpu().numpy() for k, v in fields.items()}
            emit = np_fields.pop("_emit", None)
            msg_pts = np_fields.pop("_pts", None)
            n = next(iter(np_fields.values())).shape[0] if np_fields else 0
            for b in range(n):
                if emit is not None and not emit[b]:
                    continue
                p = int(msg_pts[b]) if msg_pts is not None else (
                    int(pts[b]) if b < pts.shape[0] else 0)
                self.bus.post(Message(el_name, struct, p,
                                      {k: v[b].item() if v[b].ndim == 0
                                       else v[b] for k, v in
                                       np_fields.items()}))

    def __repr__(self):
        return " ! ".join(e.NAME for e in self.elements)


def _slice_batch(batch: FrameBatch, lo: int, hi: int) -> FrameBatch:
    def cut(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: v[lo:hi] for k, v in x.items()}
        return x[lo:hi]
    return FrameBatch(data=cut(batch.data), pts=cut(batch.pts),
                      flags=cut(batch.flags), valid=cut(batch.valid),
                      word=cut(batch.word), word_base=batch.word_base)


def _host_batch(batch: FrameBatch) -> Optional[FrameBatch]:
    """A leaf batch on the host with its invalid frames dropped (None when
    none is valid).  A word-keeping sink (fakesink over a packed word)
    returns the int32 word; the byte view is restored here (a free numpy
    view of the same bytes)."""
    np_batch = batch.to_numpy()
    d = np_batch.data
    if (np_batch.word is not None and not isinstance(d, dict)
            and d.dtype == np.int32 and d.ndim == 3
            and d.shape == np_batch.word.shape):
        np_batch = np_batch.replace(
            data=np.ascontiguousarray(d).view(np.uint8)
            .reshape(d.shape + (4,)), word=None, word_base=None)
    mask = np.asarray(np_batch.valid)
    if mask.all():
        return np_batch
    if not mask.any():
        return None

    def keep(x):
        if isinstance(x, dict):
            return {k: keep(v) for k, v in x.items()}
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == mask.shape[0]:
            return x[mask]
        return x

    return FrameBatch(data=keep(np_batch.data), pts=keep(np_batch.pts),
                      flags=keep(np_batch.flags), valid=keep(np_batch.valid),
                      word=keep(np_batch.word),
                      word_base=np_batch.word_base)


def parse_launch(description: str, device="cuda") -> Pipeline:
    """Parse a gst-launch-1.0 style description into a Pipeline DAG on
    `device` ("cuda" or "cpu"; a CUDA request without a card raises).

    Grammar subset: `element prop=value ... ! next ...`; whitespace between
    chains starts a new chain; `element name=foo` names a node; `foo.` at a
    chain start continues from node foo (tee-style fan-out), and `! foo.`
    links the current chain INTO node foo as an additional input (aggregator
    fan-in).  `video/x-raw,...` caps segments constrain the upstream element.
    """
    tokens = shlex.split(description)

    # tokenize into (segment_tokens, linked_from_prev)
    segments: List[Tuple[List[str], bool]] = []
    cur: List[str] = []
    pending_linked = False
    for tok in tokens:
        if tok == "!":
            if cur:
                segments.append((cur, pending_linked))
                cur = []
            pending_linked = True
            continue
        if cur:
            if "=" in tok and not tok.startswith(("video/", "audio/")):
                cur.append(tok)  # a property of the current element
                continue
            segments.append((cur, pending_linked))  # new chain starts
            cur = []
            pending_linked = False
        cur.append(tok)
    if cur:
        segments.append((cur, pending_linked))

    nodes: List[Node] = []
    named: Dict[str, Node] = {}
    pending_links: List[Tuple[Node, str]] = []  # forward fan-in refs
    prev: Optional[Node] = None

    for seg_tokens, linked in segments:
        head = seg_tokens[0]
        if head.endswith(".") and len(head) > 1:
            name = head[:-1]
            if linked:
                # `! foo.` — fan the current chain INTO node foo
                if prev is None:
                    raise ValueError(f"dangling link into {head!r}")
                if name in named:
                    named[name].inputs.append(prev)
                else:
                    pending_links.append((prev, name))
                prev = None
            else:
                # `foo. ! ...` — continue a new chain from node foo
                if name not in named:
                    raise ValueError(f"unknown element ref {head!r}")
                prev = named[name]
            continue
        if head.startswith(("video/", "audio/")):
            if prev is None:
                raise ValueError("capsfilter with no upstream element")
            _apply_capsfilter(prev.element, head)
            continue
        props = {}
        name = None
        for t in seg_tokens[1:]:
            k, v = t.split("=", 1)
            if k == "name":
                name = v
            else:
                props[k] = v
        node = Node(make(head, **props), name)
        if linked:
            if prev is None:
                raise ValueError(f"dangling link into {head!r}")
            node.inputs.append(prev)
        nodes.append(node)
        if name:
            named[name] = node
        prev = node

    pend: Dict[str, List[Node]] = {}
    for src, name in pending_links:
        if name not in named:
            raise ValueError(f"unresolved element ref {name!r}.")
        pend.setdefault(name, []).append(src)
    for name, srcs in pend.items():
        # links made before the element's declaration keep their order and
        # precede later ones (first link = first sink pad)
        named[name].inputs = srcs + named[name].inputs
    return Pipeline(nodes=nodes, device=device)


def _apply_capsfilter(el: Element, seg: str) -> None:
    """Apply `video/x-raw,key=value,...` constraints to an element."""
    media, _, rest = seg.partition(",")
    for part in rest.split(",") if rest else []:
        k, _, v = part.partition("=")
        k, v = k.strip(), v.strip()
        if k in ("format",) and "format" in el.props:
            el.set_property("format", v)
        if k in ("width", "height", "rate", "channels") and k in el.props:
            el.set_property(k, int(v))
        if k == "framerate" and "framerate" in el.props:
            el.set_property("framerate", v)
