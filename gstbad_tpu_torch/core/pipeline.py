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

import pickle
import shlex
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Bus, Message
from gstbad_tpu_torch.core.element import Element
from gstbad_tpu_torch.core.frame import FrameBatch, map_tensors, \
    tensors_from_numpy
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


def _split_trimmed(nb: FrameBatch) -> List[FrameBatch]:
    """Apply FrameBatch.trim on the host (the gst_audio_buffer_clip cut):
    blocks with head/tail trims split out as their own shorter batches;
    untrimmed runs stay stacked.  PTS are the element's responsibility
    (the gating element already stamps the clipped-buffer PTS)."""
    tr = nb.trim
    if tr is None:
        return [nb]
    data = nb.data
    if isinstance(data, dict) or data.ndim < 2 or not tr.any():
        return [nb.replace(trim=None)]
    b, s = data.shape[0], data.shape[1]
    out: List[FrameBatch] = []
    i = 0
    while i < b:
        if tr[i].any():
            h, t = int(tr[i, 0]), int(tr[i, 1])
            h = min(max(h, 0), s)
            t = min(max(t, 0), s - h)
            if s - h - t > 0:
                out.append(FrameBatch(
                    data=data[i:i + 1, h:s - t], pts=nb.pts[i:i + 1],
                    flags=nb.flags[i:i + 1], valid=nb.valid[i:i + 1]))
            i += 1
        else:
            j = i
            while j < b and not tr[j].any():
                j += 1
            out.append(FrameBatch(
                data=data[i:j], pts=nb.pts[i:j], flags=nb.flags[i:j],
                valid=nb.valid[i:j]))
            i = j
    return out


def _try_absorb(chain, el: Element, p) -> bool:
    """Fold element `el` with params `p` into table chain `chain`
    (core/tablefuse.py): a byte map, a head, a word map or an index
    stencil."""
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


def _unpack_out(n: "Node", out, messages: Dict[str, Any]) -> tuple:
    """(state, value) of node n's process() or generate() output (state,
    value[, messages]); its messages go into `messages`, keyed
    "element:message"."""
    if len(out) == 3:
        st, val, msgs = out
        for name, fields in msgs.items():
            messages[f"{n.element.NAME}:{name}"] = fields
        return st, val
    st, val = out
    return st, val


class _Walk:
    """One walk of a window step over the graph: the nodes' values, the
    open table chains (id(node) -> TableChain whose symbolic value is the
    node's output), the carried states the walk set and its messages.
    The step walks the window once; a mesh-sharded step walks each shard
    (parallel/step.py), whose walks keep their values in their own band
    (keep) and start chains with a halo of rows (start)."""

    def __init__(self, params, states, consumers, protected):
        self.params = params
        self.states = states
        self.new_states = list(states)
        self.messages: Dict[str, Dict[str, Any]] = {}
        self.values: Dict[int, FrameBatch] = {}
        self.chains: Dict[int, Any] = {}
        self.consumers = consumers
        self.protected = protected

    def keep(self, val, src):
        """The value to store for a node computed from batch `src`."""
        return val

    def start(self, n: "Node", batch: FrameBatch) -> FrameBatch:
        """The batch a new table chain at node n starts from."""
        return batch

    def flush(self, nid: int) -> None:
        chain = self.chains.pop(nid)
        if len(chain.members) == 1 and not chain._time_invariant():
            # a lone fused node keeps its own (cheaper) process — EXCEPT
            # when the chain is time-invariant: the one-frame-then-broadcast
            # materialization beats any per-frame process (static source +
            # static tables)
            si, el = chain.members[0]
            self.new_states[si], val = el.process(
                self.params[si], self.states[si], chain.src_batch)
        else:
            val = chain.materialize()
        self.values[nid] = self.keep(val, chain.src_batch)

    def value_of(self, node: "Node") -> FrameBatch:
        if id(node) in self.chains:
            self.flush(id(node))
        return self.values[id(node)]

    def live(self, n: "Node") -> bool:
        """True when node n continues its input's open chain."""
        inp = n.inputs[0]
        return (id(inp) in self.chains and id(inp) not in self.protected
                and self.consumers.get(id(inp)) == [n])

    def fuse(self, si: int, n: "Node", el: Element) -> bool:
        """Table-state fusion (core/tablefuse.py) for node n with one
        input: True when a tail or an absorption set its value."""
        from gstbad_tpu_torch.core import tablefuse

        inp = n.inputs[0]
        chain = None
        popped_live = False
        if self.live(n):
            chain = self.chains.pop(id(inp))
            popped_live = True
        elif el.FUSES:
            chain = tablefuse.start_chain(self.start(n, self.value_of(inp)))
        if chain is None:
            return False
        tail = el.table_tail(self.params[si], self.states[si], chain,
                             chain.src_batch)
        if tail is not None:
            self.new_states[si], data = tail
            # a tail may return a full FrameBatch (to keep a word attached
            # for the sink)
            val = (data if isinstance(data, FrameBatch)
                   else chain.src_batch.with_data(data))
            self.values[id(n)] = self.keep(val, chain.src_batch)
            return True
        if _try_absorb(chain, el, self.params[si]):
            chain.members.append((si, el))
            self.new_states[si] = self.states[si]
            self.chains[id(n)] = chain
            return True
        if popped_live:
            self.chains[id(inp)] = chain
            self.flush(id(inp))
        return False

    def set_out(self, si: int, n: "Node", out, src=None) -> None:
        """Store process()'s or generate()'s (state, value[, messages])."""
        self.new_states[si], val = _unpack_out(n, out, self.messages)
        self.values[id(n)] = self.keep(val, src)


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
        self._host_route: List[Tuple[Element, int]] = []
        self._mesh = None
        # per node, under a mesh: {"shard": runs on one shard, "halo":
        # shards given their neighbours' rows, "gather": windows gathered
        # for the node, "split": windows it produced whole and split}
        self.shard_counts: Dict[str, Dict[str, int]] = {}

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
        if in_spec is not None:
            self._in_spec = in_spec
        self._order = self._toposort()
        for n in self._order:
            el = n.element
            if el.KIND in ("source", "host-source"):
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
                taps: Sequence[str] = (), fuse_luts: bool = True,
                mesh=None):
        """Build the window function over the whole DAG.

        step(params, states, in_batch_or_None)
            -> (states, leaf_batches, messages)

        The step runs eagerly on the pipeline's device (there is no trace
        or compile); the name and signature match the JAX package.

        mesh: a parallel.mesh.Mesh whose first device is the pipeline's.
        The step then takes a ShardedBatch (a FrameBatch is placed on the
        mesh, and a source graph takes None: its sources generate the
        window, which is split), runs each node by its shard rule
        (Element.shard_rule; counted in `shard_counts`) and returns each
        leaf as a ShardedBatch; the states stay on the first device.

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

        # HOST elements (host_process sinks and taps) receive the batch
        # flowing through THEIR node, not every leaf's (a tee fan-out must
        # not feed branch A's frames to branch B's filesink).  Host nodes
        # that are leaves reuse the leaf output; mid-graph host nodes get
        # their node value appended after the leaves.
        host_nodes = [n for n in order if n.element.HOST]
        extra_nodes = [n for n in host_nodes if id(n) not in leaf_index]
        self._host_route = [
            (n.element, leaf_index[id(n)] if id(n) in leaf_index
             else len(leaves) + extra_nodes.index(n)) for n in host_nodes]

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
            elif n in extra_nodes:
                self._tap_route[t] = len(leaves) + extra_nodes.index(n)
            else:
                if n not in tap_extra:
                    tap_extra.append(n)
                self._tap_route[t] = (len(leaves) + len(extra_nodes)
                                      + tap_extra.index(n))

        # Table-state fusion (core/tablefuse.py, Element.byte_map/word_map/
        # table_head/index_stencil/table_tail): runs of per-pixel elements
        # get their work COMPOSED into 256-entry table math instead of each
        # traversing the frame.  A run extends only through nodes whose
        # sole consumer is the next run member and that nothing else
        # observes (leaves, host nodes, taps); everything else flushes.
        consumers: Dict[int, List[Node]] = {}
        for n in order:
            for i in n.inputs:
                consumers.setdefault(id(i), []).append(n)
        protected = ({id(n) for n in leaves} | {id(n) for n in extra_nodes}
                     | {id(n) for n in tap_nodes})

        def step(params: List[Dict[str, Any]], states: List[Any],
                 in_batch: Optional[FrameBatch]):
            walk = _Walk(params, states, consumers, protected)
            feed_idx = 0
            for si, n in enumerate(order):
                el = n.element
                if (fuse_luts and len(n.inputs) == 1 and el.KIND != "source"
                        and walk.fuse(si, n, el)):
                    continue
                if el.KIND == "source":
                    out = el.generate(params[si], states[si], window)
                else:
                    if not n.inputs:
                        # several host sources feed as a list, one entry
                        # per input-less node in traversal order (run()'s
                        # pull order); a single batch broadcasts
                        if isinstance(in_batch, (list, tuple)):
                            batch = in_batch[feed_idx]
                            feed_idx += 1
                        else:
                            batch = in_batch
                    elif len(n.inputs) == 1:
                        batch = walk.value_of(n.inputs[0])
                    else:
                        batch = [walk.value_of(i) for i in n.inputs]
                    out = el.process(params[si], states[si], batch)
                walk.set_out(si, n, out)
            leaf_out = ([walk.value_of(n) for n in leaves]
                        + [walk.value_of(n) for n in extra_nodes]
                        + [walk.value_of(n) for n in tap_extra])
            return walk.new_states, leaf_out, walk.messages

        if mesh is not None:
            from gstbad_tpu_torch.parallel.step import sharded_step
            step = sharded_step(self, mesh, window, order, consumers,
                                protected, fuse_luts,
                                leaves + extra_nodes + tap_extra)
        self._mesh = mesh
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
    def pull_inputs(self, window: int):
        """One window from each host source of the negotiated pipeline,
        pulled in topological order as run() pulls them: a FrameBatch, a list of them for several
        sources, or None once a source is exhausted.  A pull that times
        out raises TimeoutError."""
        ws = [n.element.pull_window(window) for n in self._order
              if n.element.KIND == "host-source"]
        if not ws:
            raise ValueError("the pipeline has no host source")
        if any(x is None for x in ws):
            return None
        return ws if len(ws) > 1 else ws[0]

    def run(self, n_frames: int = 0, inputs: Optional[FrameBatch] = None,
            window: Optional[int] = None):
        """Drive the pipeline; returns the valid output frames per window
        as host (numpy) batches: a list for a single-leaf graph, else
        {leaf_index: [batches]}.

        Invalid (masked-out) frames are compacted away host-side between
        windows, the analog of GST_BASE_TRANSFORM_FLOW_DROPPED; trimmed
        audio blocks are cut there too (FrameBatch.trim).  Every HOST
        element then sees its own node's frames.
        """
        if inputs is not None:
            window = window or inputs.batch
        window = window or self._window or n_frames
        if not window:
            raise ValueError("run() needs a window size (or inputs/n_frames)")
        if self._step is None or window != self._window:
            self.compile(window, mesh=self._mesh)
        order = self._order
        states = self._states
        params = self.params()
        leaves = self._leaves()
        outs: Dict[int, List[FrameBatch]] = {i: [] for i in
                                             range(len(leaves))}

        # Windows are pulled LAZILY and interleaved with execution, so a
        # host source's backpressure applies end to end (no unbounded
        # pre-pull) and output is emitted incrementally.  A pull timeout
        # is a recoverable stall: output already processed is kept, a
        # warning is posted, and the run ends cleanly.
        def window_iter():
            if inputs is not None:
                for i in range(0, inputs.batch, window):
                    yield _slice_batch(inputs, i, i + window)
                return
            if any(n.element.KIND == "host-source" for n in order):
                while True:
                    try:
                        ws = self.pull_inputs(window)
                    except TimeoutError as e:
                        self.bus.post(Message(
                            "pipeline", "stall", 0,
                            {"reason": f"source pull timed out: {e}"}))
                        return
                    if ws is None:
                        return
                    yield ws
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
                    first = w[0] if isinstance(w, (list, tuple)) else w
                    pts = first.pts.cpu().numpy()
                else:
                    pts = (frame_counter
                           + np.arange(window, dtype=np.int64)) * dur
                params = [n.element.params_for_pts(pts)
                          if n.element._controls
                          else n.element.dynamic_params() for n in order]
                frame_counter += window
            states, leaf_batches, messages = self._step(params, states, w)
            self._drain_messages(leaf_batches[len(leaves) - 1], messages)
            host: Dict[int, List[FrameBatch]] = {}

            def compacted(oi: int) -> List[FrameBatch]:
                if oi not in host:
                    host[oi] = _host_batches(leaf_batches[oi])
                return host[oi]

            for li in range(len(leaves)):
                outs[li].extend(compacted(li))
            # each HOST element sees only its own node's stream
            for el, oi in self._host_route:
                for np_batch in compacted(oi):
                    el.host_process(np_batch, self.bus)
        self._states = states
        if len(leaves) == 1:
            return outs[0]
        return outs

    def send_eos(self) -> Dict[str, List[FrameBatch]]:
        """EOS analog: drain the elements that hold queued frames (the
        fieldanalysis flush path, gstfieldanalysis.c:744-781) through their
        optional `drain(state) -> (state, FrameBatch or None)` hook.

        Returns the drained frames as host batches per element name.  The
        drained frames also go to the HOST elements downstream of the
        drained node (and to no other: a tee branch's flush must not reach
        the other branch); other downstream elements do not re-process
        them (as for an analyzer in tail position)."""
        drained: Dict[str, List[FrameBatch]] = {}
        if self._states is None:
            return drained
        order = self._order or self._toposort()
        children: Dict[int, List[Node]] = {}
        for n in order:
            for i in n.inputs:
                children.setdefault(id(i), []).append(n)

        def downstream_hosts(node: Node) -> List[Element]:
            out, stack, seen = [], [node], set()
            while stack:
                cur = stack.pop()
                for ch in children.get(id(cur), []):
                    if id(ch) in seen:
                        continue
                    seen.add(id(ch))
                    if ch.element.HOST:
                        out.append(ch.element)
                    stack.append(ch)
            return out

        for idx, n in enumerate(order):
            el = n.element
            if not hasattr(el, "drain"):
                continue
            st, batch = el.drain(self._states[idx])
            self._states[idx] = st
            if batch is not None:
                np_batch = batch.to_numpy()
                for h in downstream_hosts(n):
                    h.host_process(np_batch, self.bus)
                drained.setdefault(el.NAME, []).append(np_batch)
        return drained

    def close(self) -> None:
        """Tear down to NULL (gst_element_set_state(NULL) analog): every
        element with a close() hook flushes and releases its host
        resources (file sinks write their files)."""
        for n in self.nodes:
            if hasattr(n.element, "close"):
                n.element.close()

    # -- runtime graph editing (insertbin analog) ------------------------------
    # gst-libs/gst/insertbin/gstinsertbin.c exposes insert_before/after and
    # remove on a RUNNING bin.  Here an edit mutates the DAG, renegotiates
    # and rebuilds the step on the next run, with live element states
    # carried across by node identity (Element.carry_state handles shape
    # changes).  The same path makes STATIC properties settable live
    # (set_static_property).

    def _node_named(self, name: str) -> Node:
        for n in self.nodes:
            if n.name == name or n.element.NAME == name:
                return n
        raise KeyError(f"no element named {name!r}")

    def _snapshot_states(self) -> Dict[int, Any]:
        if self._states is None or self._order is None:
            return {}
        return {id(n): s for n, s in zip(self._order, self._states)}

    def _rebuild(self, saved: Dict[int, Any]) -> None:
        for n in self.nodes:
            n.element.device = self.device
        self._step = None
        self._order = None
        self.negotiate(self._in_spec)
        if saved and self._window:
            self._states = [
                n.element.carry_state(saved[id(n)], self._window)
                if id(n) in saved else n.element.init_state(self._window)
                for n in self._order]
        else:
            self._states = None

    def insert_after(self, name: str, element: Element,
                     new_name: Optional[str] = None) -> None:
        """Insert `element` after node `name`; every consumer of that node
        (all tee branches) is rerouted through the new element."""
        saved = self._snapshot_states()
        anchor = self._node_named(name)
        node = Node(element, new_name)
        node.inputs.append(anchor)
        for n in self.nodes:
            n.inputs = [node if i is anchor else i for i in n.inputs]
        self.nodes.insert(self.nodes.index(anchor) + 1, node)
        self._rebuild(saved)

    def insert_before(self, name: str, element: Element,
                      new_name: Optional[str] = None) -> None:
        """Insert `element` on every input edge of node `name` (the linear
        chain's single edge in the common case)."""
        saved = self._snapshot_states()
        anchor = self._node_named(name)
        node = Node(element, new_name)
        node.inputs = list(anchor.inputs)
        anchor.inputs = [node]
        self.nodes.insert(self.nodes.index(anchor), node)
        self._rebuild(saved)

    def remove(self, name: str) -> Element:
        """Remove node `name`, splicing its (single) input to its
        consumers; its carried state is dropped, everyone else's kept."""
        saved = self._snapshot_states()
        node = self._node_named(name)
        if len(node.inputs) > 1:
            raise SpecError(
                f"remove({name!r}): aggregation points cannot be spliced "
                "out (insertbin handles linear segments)")
        repl = node.inputs[0] if node.inputs else None
        for n in self.nodes:
            if node in n.inputs:
                n.inputs = [x for x in
                            (repl if i is node else i for i in n.inputs)
                            if x is not None]
        self.nodes.remove(node)
        saved.pop(id(node), None)
        self._rebuild(saved)
        return node.element

    def set_static_property(self, name: str, prop: str, value) -> None:
        """Change a STATIC (table- or shape-baked) property on a running
        pipeline: renegotiate and rebuild, carrying every element's state
        across (shape-affected states go through migrate_state)."""
        saved = self._snapshot_states()
        self._node_named(name).element.set_property(prop, value)
        self._rebuild(saved)

    # -- checkpoint/resume ----------------------------------------------------
    # Element state is an explicit carry, so a checkpoint is the carry plus
    # the host sources' stream positions.
    def save_checkpoint(self, path) -> None:
        """Pickle the carried states (tensors as numpy arrays, other
        leaves as they are), the window and the host sources' positions."""
        if self._states is None:
            raise SpecError("nothing to checkpoint; run a window first")
        states_np = map_tensors(
            lambda t: t.detach().cpu().numpy()
            if isinstance(t, torch.Tensor) else t, self._states)
        # host-source stream positions (frame indices) via the
        # save_position hook, so a resume does not replay the input; live
        # sources have no position and are named instead
        positions = {i: n.element.save_position()
                     for i, n in enumerate(self.nodes)
                     if hasattr(n.element, "save_position")}
        unresumable = [n.element.NAME for n in self.nodes
                       if n.element.KIND == "host-source"
                       and not hasattr(n.element, "save_position")]
        with open(path, "wb") as f:
            pickle.dump({"states": states_np, "window": self._window,
                         "positions": positions,
                         "unresumable_sources": unresumable}, f)

    def load_checkpoint(self, path) -> None:
        """Resume from save_checkpoint's file: every array leaf goes back
        to this pipeline's device as a tensor, other leaves stay as they
        are; host sources take back their positions."""
        with open(path, "rb") as f:
            ck = pickle.load(f)
        if self._order is None:
            self.negotiate()
        self._states = map_tensors(
            lambda a: torch.from_numpy(np.array(a)).to(self.device),
            ck["states"])
        for i, v in ck.get("positions", {}).items():
            self.nodes[i].element.restore_position(v)
        for name in ck.get("unresumable_sources", ()):
            self.bus.post(Message(
                "pipeline", "resume-warning", 0,
                {"reason": f"{name} is a live source; its stream resumes "
                           "from the current producer position"}))

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
                      word=cut(batch.word), word_base=batch.word_base,
                      trim=cut(batch.trim))


def _host_batches(batch: FrameBatch) -> List[FrameBatch]:
    """A leaf batch on the host with its invalid frames dropped and its
    trimmed blocks cut (_split_trimmed): no batch when none is valid.  A
    word-keeping sink (fakesink over a packed word) returns the int32
    word; the byte view is restored here (a free numpy view of the same
    bytes)."""
    np_batch = batch.to_numpy()
    d = np_batch.data
    if (np_batch.word is not None and not isinstance(d, dict)
            and d.dtype == np.int32 and d.ndim == 3
            and d.shape == np_batch.word.shape):
        np_batch = np_batch.replace(
            data=np.ascontiguousarray(d).view(np.uint8)
            .reshape(d.shape + (4,)), word=None, word_base=None)
    mask = np.asarray(np_batch.valid)
    if not mask.any():
        return []
    if not mask.all():
        def keep(x):
            if isinstance(x, dict):
                return {k: keep(v) for k, v in x.items()}
            if getattr(x, "ndim", 0) >= 1 and x.shape[0] == mask.shape[0]:
                return x[mask]
            return x

        np_batch = FrameBatch(
            data=keep(np_batch.data), pts=keep(np_batch.pts),
            flags=keep(np_batch.flags), valid=keep(np_batch.valid),
            word=keep(np_batch.word), word_base=np_batch.word_base,
            trim=keep(np_batch.trim))
    return _split_trimmed(np_batch)


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
