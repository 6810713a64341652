"""Tracing/profiling — the GstTracer analog (SURVEY.md section 5.1).

The reference instruments via fpsdisplaysink counters and per-element debug
categories; here a PipelineTracer wraps Pipeline.run with per-call wall
timers and message counters, profile_elements attributes step time to
each element, and trace_to() wraps a block in a torch.profiler trace (the
GST_DEBUG_BIN_TO_DOT analog is repr(pipeline)).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class PipelineTracer:
    """Wraps a Pipeline: records per-run wall time, frames, messages.

    usage:
        tracer = PipelineTracer(pipeline)
        pipeline.run(...)
        print(tracer.report())
    """

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.window_times: List[float] = []
        self.frames = 0
        self._install()

    def _install(self):
        orig_run = self.pipeline.run

        def run(*a, **kw):
            # run() returns host batches, so the device is done at return
            t_outer = time.perf_counter()
            out = orig_run(*a, **kw)
            self.window_times.append(time.perf_counter() - t_outer)
            batches = out if isinstance(out, list) else out.get(0, [])
            self.frames += sum(b.batch for b in batches)
            return out

        self.pipeline.run = run

    @property
    def total_time(self) -> float:
        return sum(self.window_times)

    @property
    def fps(self) -> float:
        return self.frames / self.total_time if self.total_time else 0.0

    def report(self) -> Dict[str, float]:
        return {
            "graph": repr(self.pipeline),
            "frames": self.frames,
            "wall_s": round(self.total_time, 4),
            "fps": round(self.fps, 2),
            "messages": len(self.pipeline.bus.messages),
        }

    def profile_elements(self, window: int = 4, reps: int = 3
                         ) -> Dict[str, float]:
        """Per-element cost attribution inside the window step (SURVEY.md
        §7 hard-part 5): build each topological prefix of the graph as its
        own step (its last node a leaf, so fusion stops there) and report
        the marginal milliseconds each element adds, with `_total_ms` the
        whole step's.  A step's time is the mean of `reps` steps after one
        warm-up step: CUDA events on the card, the host clock on the CPU.
        Marginals can go slightly negative on noisy hosts or when fusion
        absorbs an element; they are clamped at 0.  Source-driven graphs
        only (a host source needs real input windows)."""
        p = self.pipeline
        if p._order is None:
            p.negotiate()
        order = p._order
        if any(n.element.KIND == "host-source" for n in order):
            raise ValueError("profile_elements needs a source-driven graph")
        params = p.params()
        cuda = p.device.type == "cuda"
        times = []
        for i in range(len(order)):
            # topological order puts every input of a prefix node inside
            # the prefix
            sub = type(p)(nodes=order[:i + 1], device=p.device)
            sub._order = order[:i + 1]
            step = sub.compile(window)
            sub_params = params[:i + 1]
            states = sub.init_states(window)
            step(sub_params, states, None)
            if cuda:
                torch.cuda.synchronize(p.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    step(sub_params, states, None)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / reps)
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    step(sub_params, states, None)
                times.append((time.perf_counter() - t0) / reps)
        report = {}
        prev = 0.0
        for node, t in zip(order, times):
            name = node.name or node.element.NAME
            report[name] = round(max(t - prev, 0.0) * 1000, 4)
            prev = t
        report["_total_ms"] = round(times[-1] * 1000, 4)
        return report


@contextlib.contextmanager
def trace_to(logdir: Optional[str]):
    """torch.profiler trace scope writing `logdir`/trace.json (a Chrome
    trace; no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
