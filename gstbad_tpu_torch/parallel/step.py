"""The mesh-sharded window step (Pipeline.compile(..., mesh=)).

Each node runs by its shard rule (Element.shard_rule):

  shard   once on each shard: the table-fusion kinds on packed words
          (byte maps, heads, word maps: each shard's chain runs its own
          kernel), and elements declared ELEMENTWISE;
  halo    once on each shard with r rows of its sp neighbours attached
          above and below, the result cropped to the shard's band: word
          stencils (dilate, and K1 that runs it inside zebrastripe's
          tail) and gaussianblur (K3).  A table chain takes at its start
          the sum of the radii of the stencils its run can absorb, so two
          stencils in one chain are covered; at the frame's top and bottom
          there is nothing to attach, which is the unsharded border;
  gather  once on the whole window, gathered onto the mesh's first
          device, then split again: temporal state, warps, resamplers,
          audio scans, data-dependent emission and every element that
          declares nothing.  The node computes what the unsharded step
          computes, so its value is exact.

Sources generate the whole window (their frames carry their window
index) and it is split.  Pipeline.shard_counts counts each rule's runs per
node.  Under torch.distributed each process walks its own shards and a
gather takes every process's rows (parallel/multihost.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from gstbad_tpu_torch.core.frame import FrameBatch, map_tensors
from gstbad_tpu_torch.core.pipeline import _Walk, _unpack_out
from gstbad_tpu_torch.parallel import mesh as meshes


def _move(tree, dev: torch.device):
    return map_tensors(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                       else t, tree)


class _ShardWalk(_Walk):
    """The walk of one shard: its values hold its own band; chains and
    halo-rule nodes take their neighbours' rows (walks[d][s'])."""

    def __init__(self, params, states, consumers, protected, run, d, s,
                 device):
        super().__init__(params, states, consumers, protected)
        self.run = run
        self.d, self.s = d, s
        self.device = device

    def keep(self, val, src):
        if val.shard is None and src is not None:
            val = val.replace(shard=src.shard)
        return meshes.crop(val)

    def halo(self, n, row, r: int) -> FrameBatch:
        """This shard's batch of its sp `row` with r rows of the
        neighbours' attached (counted against node n)."""
        out = meshes.with_halo(row, self.s, r, self.device)
        if out is not row[self.s]:
            self.run.count(n, "halo")
        return out

    def row_of(self, inp) -> list:
        """Node inp's values on this shard's sp row."""
        return [w.value_of(inp) for w in self.run.walks[self.d]]

    def start(self, n, batch):
        r = self.run.chain_halo[id(n)]
        if r == 0:
            return batch
        return self.halo(n, self.row_of(n.inputs[0]), r)


class _Run:
    """The state of one sharded step call."""

    def __init__(self, plan, params, states, in_batch):
        self.plan = plan
        mesh = plan.mesh
        self.chain_halo = plan.chain_halo
        self.walks: List[List[_ShardWalk]] = []
        self.new_states = list(states)
        self.messages: Dict[str, Dict[str, Any]] = {}
        self.feeds = self._feeds(in_batch)
        for d, row in enumerate(mesh.devices):
            self.walks.append([_ShardWalk(
                plan.shard_params(params, d, dev),
                plan.shard_states(states, dev), plan.consumers,
                plan.protected, self, d, s, dev)
                for s, dev in enumerate(row)])
        self.flat = [w for row in self.walks for w in row]

    def _feeds(self, in_batch) -> list:
        if in_batch is None:
            return []
        batches = (list(in_batch) if isinstance(in_batch, (list, tuple))
                   else [in_batch])
        return [b if isinstance(b, meshes.ShardedBatch)
                else meshes.split(b, self.plan.mesh, strict=True)
                for b in batches]

    def count(self, n, what: str) -> None:
        self.plan.counts[self.plan.keys[id(n)]][what] += 1

    def sharded(self, n) -> meshes.ShardedBatch:
        return meshes.ShardedBatch(
            [[w.value_of(n) for w in row] for row in self.walks],
            self.plan.mesh)

    def put(self, n, whole: FrameBatch) -> None:
        """Split a whole-window value of node n onto the walks (an axis
        that does not divide stays whole, as JAX's `_sh` drops it)."""
        sb = meshes.split(whole, self.plan.mesh, strict=False)
        for row, wrow in zip(sb.shards, self.walks):
            for fb, w in zip(row, wrow):
                w.values[id(n)] = fb

    def whole(self, si, n, out) -> None:
        """Record a whole-window node's (state, value[, messages])."""
        self.new_states[si], val = _unpack_out(n, out, self.messages)
        self.put(n, val)


class ShardPlan:
    """What a sharded step needs of the pipeline, fixed at compile."""

    def __init__(self, pipeline, mesh, window, order, consumers, protected,
                 fuse_luts):
        self.home = meshes.resolve(pipeline.device)
        if mesh.first != self.home:
            raise ValueError(f"the mesh's first device {mesh.first} is not "
                             f"the pipeline's {pipeline.device}")
        self.mesh = mesh
        self.window = window
        self.order = order
        self.consumers = consumers
        self.protected = protected
        self.fuse_luts = fuse_luts
        self.rules = [n.element.shard_rule(n.element.dynamic_params())
                      for n in order]
        names = [n.name or n.element.NAME for n in order]
        # a node's counts go under its name, numbered where names repeat
        self.keys = {id(n): (name if names.count(name) == 1
                             else f"{name}#{names[:i].count(name)}")
                     for i, (n, name) in enumerate(zip(order, names))}
        self.counts = {k: {"shard": 0, "halo": 0, "gather": 0, "split": 0}
                       for k in self.keys.values()}
        pipeline.shard_counts = self.counts
        rule_of = {id(n): r for n, r in zip(order, self.rules)}
        # the rows a table chain started at node n takes from its
        # neighbours: the radii of the stencils its run can absorb
        self.chain_halo = {}
        for n in order:
            r, cur = 0, n
            while True:
                kind, radius = rule_of[id(cur)]
                if not cur.element.FUSES or kind == "gather":
                    break
                r += radius if kind == "halo" else 0
                nxt = consumers.get(id(cur), [])
                if (id(cur) in protected or len(nxt) != 1
                        or len(nxt[0].inputs) != 1):
                    break
                cur = nxt[0]
            self.chain_halo[id(n)] = r
        self._replicas: Dict[Any, Any] = {}

    def element(self, el, dev):
        """The element, or its copy on another device: prepare() rebuilds
        its tables there, and every other tensor the copy holds in its
        attributes (their dicts, lists and tuples) is moved there."""
        if dev == self.home:
            return el
        key = (id(el), dev)
        if key not in self._replicas:
            import copy
            rep = copy.copy(el)
            rep.device = dev
            rep.prepare()
            vars(rep).update(_move(vars(rep), dev))
            self._replicas[key] = rep
        return self._replicas[key]

    def shard_params(self, params, d: int, dev):
        """Each element's params on `dev`, the per-frame ones (controlled
        properties, [window]) cut to dp row d's frames."""
        mesh = self.mesh
        b = self.window
        split = mesh.dp > 1 and b % mesh.dp == 0
        bd = b // mesh.dp if split else b
        lo = (mesh.rank * mesh.local_dp + d) * bd if split else 0

        def cut(t):
            return t[lo:lo + bd] if t.ndim and t.shape[0] == b else t

        out = []
        for n, p in zip(self.order, params):
            if split and n.element._controls:
                p = map_tensors(cut, p)
            out.append(_move(p, dev) if dev != mesh.first else p)
        return out

    def shard_states(self, states, dev):
        if dev == self.mesh.first:
            return states
        return [_move(st, dev) for st in states]


def sharded_step(pipeline, mesh, window, order, consumers, protected,
                 fuse_luts, outs):
    """The step of Pipeline.compile under `mesh`; `outs` are the nodes
    whose values it returns (leaves, host nodes, taps), as ShardedBatches."""
    plan = ShardPlan(pipeline, mesh, window, order, consumers, protected,
                     fuse_luts)

    def step(params, states, in_batch):
        run = _Run(plan, params, states, in_batch)
        per_shard = []
        feed_idx = 0
        for si, n in enumerate(order):
            el = n.element
            rule, radius = plan.rules[si]
            if el.KIND == "source":
                # the window's frames carry their window index: the whole
                # window, split
                run.whole(si, n, el.generate(params[si], states[si],
                                             window))
                run.count(n, "split")
                continue
            feed = None
            if not n.inputs:
                # several host sources feed as a list, one entry per
                # input-less node in traversal order; one batch broadcasts
                if len(run.feeds) > 1:
                    feed = run.feeds[feed_idx]
                    feed_idx += 1
                elif run.feeds:
                    feed = run.feeds[0]
                else:
                    rule = "gather"
            if rule == "gather":
                if not n.inputs:
                    batch = None if feed is None else feed.gather()
                elif len(n.inputs) == 1:
                    batch = run.sharded(n.inputs[0]).gather()
                else:
                    batch = [run.sharded(i).gather() for i in n.inputs]
                run.whole(si, n, el.process(params[si], states[si], batch))
                run.count(n, "gather")
                continue
            per_shard.append(si)
            fusable = plan.fuse_luts and len(n.inputs) == 1
            if n.inputs and not (fusable and run.flat[0].live(n)):
                # halos read the neighbours' inputs: materialize them all
                for w in run.flat:
                    for i in n.inputs:
                        w.value_of(i)
            pending = []
            for w in run.flat:
                wel = plan.element(el, w.device)
                if fusable and w.fuse(si, n, wel):
                    run.count(n, "shard")
                else:
                    pending.append((w, wel))
            for w, wel in pending:
                if len(n.inputs) <= 1:
                    row = (feed.shards[w.d] if feed is not None
                           else w.row_of(n.inputs[0]))
                    batch = (w.halo(n, row, radius) if rule == "halo"
                             else row[w.s])
                else:
                    batch = [w.value_of(i) for i in n.inputs]
                out = wel.process(w.params[si], w.states[si], batch)
                if len(out) == 3 and out[2]:
                    raise ValueError(f"{el.NAME}: a per-shard element "
                                     "posts messages; give it the gather "
                                     "rule")
                w.set_out(si, n, out[:2],
                          src=batch if isinstance(batch, FrameBatch)
                          else None)
                run.count(n, "shard")
        leaf_out = [run.sharded(n) for n in outs]
        # per-shard nodes return the window's state from every shard:
        # shard (0, 0)'s, on the first device
        for si in per_shard:
            run.new_states[si] = run.walks[0][0].new_states[si]
        return run.new_states, leaf_out, run.messages

    return step
