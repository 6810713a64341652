"""Harness — the GstHarness analog for single-element tests.

The reference test pattern (tests/check/elements/interlace.c:26-49):
instantiate by name, set src caps, push crafted buffers, assert on pulled
buffers.  Same shape here, with numpy in and out; the element runs on
`device` ("cuda", the default, or "cpu"; a CUDA request without a card
raises).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Bus
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.pipeline import Pipeline
from gstbad_tpu_torch.core.registry import make
from gstbad_tpu_torch.core.spec import MediaSpec


class Harness:
    def __init__(self, element_or_name, device="cuda", **props):
        if isinstance(element_or_name, str):
            self.element = make(element_or_name, **props)
        else:
            self.element = element_or_name
        self.pipeline = Pipeline([self.element], device=device)
        self.in_spec: Optional[MediaSpec] = None
        self._pts = 0

    @property
    def bus(self) -> Bus:
        return self.pipeline.bus

    def set_src_spec(self, spec: MediaSpec) -> MediaSpec:
        self.in_spec = spec
        return self.pipeline.negotiate(spec)

    def push(self, data, pts=None, flags=None) -> List[FrameBatch]:
        """Push a window of frames (numpy), pull the produced frames."""
        dev = self.pipeline.device

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        data = ({k: upload(v) for k, v in data.items()}
                if isinstance(data, dict) else upload(data))
        b = (next(iter(data.values())) if isinstance(data, dict)
             else data).shape[0]
        if pts is None:
            dur = (self.in_spec.frame_duration_ns if self.in_spec
                   else int(1e9 / 30))
            pts = np.arange(self._pts, self._pts + b) * dur
            self._pts += b
        batch = FrameBatch.make(
            data, pts=upload(np.asarray(pts, np.int64)),
            flags=None if flags is None
            else upload(np.asarray(flags, np.int32)))
        return self.pipeline.run(inputs=batch)

    def push_pull(self, data, **kw) -> np.ndarray:
        """Push one window, return the concatenated output data array."""
        outs = self.push(data, **kw)
        if not outs:
            return np.zeros((0,))
        return np.concatenate([o.data for o in outs], axis=0)
