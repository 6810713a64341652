"""FrameBatch — the buffer analog: a window of media frames as tensors.

The reference moves one GstBuffer at a time between streaming threads; here a
window of W frames moves through one pipeline step.  Buffer metadata (PTS,
video field flags — GST_VIDEO_BUFFER_FLAG_* as used by gst/ivtc/gstivtc.c:
519-534 and gst/fieldanalysis) rides along as int tensors, and a validity
mask replaces data-dependent buffer dropping (GST_BASE_TRANSFORM_FLOW_DROPPED)
so shapes stay static across windows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Array = Any


@dataclasses.dataclass
class FrameBatch:
    """A batch/window of frames.

    data: uint8 [B, H, W, C] for packed video; {plane: tensor} for planar.
    pts:  int64 [B] nanoseconds.
    flags: int32 [B] bitmask of gstbad_tpu.core.frame.FLAG_* values.
    valid: bool [B]; frames with valid=False are dropped by the runner.
    """

    data: Union[Array, Dict[str, Array]]
    pts: Array
    flags: Array
    valid: Array
    # optional int32 [B, H, W] view of `data` for 4-byte packed video (byte
    # c of the word == data[..., c]).  On the card the two share memory
    # (pointops.pack32/unpack32 are dtype views), so the word is free; a
    # word-keeping sink (fakesink) returns it and Pipeline.run restores the
    # byte view on the host.  Any with_data() drops it.
    word: Optional[Array] = None
    # optional [1, H, W] int32 BROADCAST base of `word`: producers whose
    # frame is static across the window (videotestsrc non-animated
    # patterns) attach the single source frame, so table fusion computes
    # one frame (tablefuse._time_invariant) and the fused chain kernel
    # (ops/chainfuse.py) reads it instead of B copies.  Like `word`, any
    # with_data() drops it.
    word_base: Optional[Array] = None

    @staticmethod
    def make(data, pts=None, flags=None, valid=None) -> "FrameBatch":
        first = next(iter(data.values())) if isinstance(data, dict) else data
        b, dev = first.shape[0], first.device
        if pts is None:
            pts = torch.zeros((b,), dtype=torch.int64, device=dev)
        if flags is None:
            flags = torch.zeros((b,), dtype=torch.int32, device=dev)
        if valid is None:
            valid = torch.ones((b,), dtype=torch.bool, device=dev)
        return FrameBatch(data=data, pts=pts, flags=flags, valid=valid)

    @property
    def batch(self) -> int:
        if isinstance(self.data, dict):
            return next(iter(self.data.values())).shape[0]
        return self.data.shape[0]

    def with_data(self, data) -> "FrameBatch":
        return dataclasses.replace(self, data=data, word=None,
                                   word_base=None)

    def replace(self, **kw) -> "FrameBatch":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> "FrameBatch":
        """Host copy of every field (one device->host copy per distinct
        tensor: a fakesink batch's data IS its word)."""
        seen: Dict[int, np.ndarray] = {}

        def conv(x):
            if x is None:
                return None
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if id(x) not in seen:
                seen[id(x)] = x.detach().cpu().numpy()
            return seen[id(x)]

        return FrameBatch(data=conv(self.data), pts=conv(self.pts),
                          flags=conv(self.flags), valid=conv(self.valid),
                          word=conv(self.word),
                          word_base=conv(self.word_base))


def pts_ramp(batch: int, spec, start_ns: int = 0,
             device="cpu") -> torch.Tensor:
    """PTS values for `batch` consecutive frames of `spec`."""
    dur = spec.frame_duration_ns
    return (torch.arange(batch, dtype=torch.int64, device=device) * dur
            + start_ns)


def tensors_from_numpy(tree, device):
    """Carry host values into tensors on `device`: numpy arrays and
    scalars (a JAX pipeline's params()/init_states()/step states after
    np.asarray) nested in dicts, lists and tuples.  Dtypes are kept, so
    int64 counters stay int64 and a run can resume from another
    runtime's state."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)
