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

# Video buffer flags (the values of gstbad_tpu.core.frame; semantics mirror
# GST_VIDEO_BUFFER_FLAG_*)
FLAG_INTERLACED = 1 << 0
FLAG_TFF = 1 << 1
FLAG_RFF = 1 << 2
FLAG_ONEFIELD = 1 << 3
FLAG_GAP = 1 << 4
FLAG_DISCONT = 1 << 5  # GST_BUFFER_FLAG_DISCONT analog
# composed field markers for interlace-mode=alternate streams, mirroring
# GStreamer's TOP_FIELD = TFF|ONEFIELD / BOTTOM_FIELD = ONEFIELD composition
FLAG_TOP_FIELD = FLAG_TFF | FLAG_ONEFIELD
FLAG_BOTTOM_FIELD = FLAG_ONEFIELD

Array = Any


@dataclasses.dataclass(frozen=True)
class ShardPos:
    """Where a mesh shard's batch lies in its window (parallel/mesh.py):
    frames [frame0, frame0 + its batch) of the window's `window` frames,
    and band `part` of `parts` equal row bands of each frame leaf (the
    tensors of 3 or more dims), with `above` and `below` rows of the
    neighbouring bands attached (a halo, packed video only)."""

    frame0: int
    window: int
    part: int = 0
    parts: int = 1
    above: int = 0
    below: int = 0

    def row0(self, rows: int) -> int:
        """The frame row of row 0 of a leaf that holds `rows` rows, halo
        included."""
        return self.part * (rows - self.above - self.below) - self.above


@dataclasses.dataclass
class FrameBatch:
    """A batch/window of frames.

    data: uint8 [B, H, W, C] for packed video; {plane: tensor} for planar.
    pts:  int64 [B] nanoseconds.
    flags: int32 [B] bitmask of the FLAG_* values above.
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
    # optional [B, 2] int32 (head, tail) samples logically REMOVED from
    # audio blocks — the gst_audio_buffer_clip analog for static shapes.
    # Gating elements (avwait, audiosegmentclip) set it on boundary
    # blocks; the runner slices it away on the host when compacting, so
    # sinks and run() callers observe the sample-exact clipped stream.
    # with_data() keeps it only while the sample axis is unchanged;
    # elements that re-chunk must translate or drop it themselves.
    trim: Optional[Array] = None
    # the position of a mesh shard in its window (ShardPos), None for a
    # whole window; with_data() and replace() keep it
    shard: Optional[ShardPos] = None

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
        trim = self.trim
        if trim is not None and (isinstance(data, dict)
                                 or isinstance(self.data, dict)
                                 or data.shape != self.data.shape):
            trim = None
        return dataclasses.replace(self, data=data, word=None,
                                   word_base=None, trim=trim)

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
                          word_base=conv(self.word_base),
                          trim=conv(self.trim), shard=self.shard)


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


_TORCH_DTYPES = {np.dtype(k): v for k, v in (
    (np.uint8, torch.uint8), (np.int8, torch.int8),
    (np.uint16, torch.uint16), (np.int16, torch.int16),
    (np.int32, torch.int32), (np.int64, torch.int64),
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.bool_, torch.bool))}


def upload_frames(device, frames, pts, flags, valid) -> FrameBatch:
    """A FrameBatch on `device` from host frames: `frames` is a list of
    per-frame numpy arrays (or of {plane: array} dicts), stacked straight
    into one host buffer with the pts (int64), flags (int32) and valid
    (bool) arrays, which goes to the device in ONE copy; the fields are
    views of it there."""
    first = frames[0]
    keys = sorted(first) if isinstance(first, dict) else [None]
    b = len(frames)
    parts = [(np.dtype(np.int64), (b,)), (np.dtype(np.int32), (b,)),
             (np.dtype(np.bool_), (b,))]
    for k in keys:
        f = first[k] if k is not None else first
        parts.append((f.dtype, (b,) + f.shape))
    offsets, off = [], 0
    for dt, shape in parts:
        off = -(-off // 8) * 8      # every field 8-byte aligned
        offsets.append(off)
        off += dt.itemsize * int(np.prod(shape))
    buf = np.empty(off, np.uint8)

    def host_view(i):
        dt, shape = parts[i]
        n = dt.itemsize * int(np.prod(shape))
        return buf[offsets[i]:offsets[i] + n].view(dt).reshape(shape)

    host_view(0)[:] = pts
    host_view(1)[:] = flags
    host_view(2)[:] = valid
    for j, k in enumerate(keys):
        np.stack([f[k] if k is not None else f for f in frames],
                 out=host_view(3 + j))
    dev_buf = torch.from_numpy(buf).to(device)

    def dev_view(i):
        dt, shape = parts[i]
        n = dt.itemsize * int(np.prod(shape))
        t = dev_buf[offsets[i]:offsets[i] + n]
        return t.view(_TORCH_DTYPES[dt]).reshape(shape)

    planes = [dev_view(3 + j) for j in range(len(keys))]
    data = dict(zip(keys, planes)) if keys != [None] else planes[0]
    return FrameBatch(data=data, pts=dev_view(0), flags=dev_view(1),
                      valid=dev_view(2))


def map_tensors(fn, tree):
    """`tree` with fn applied to every tensor or numpy array leaf of its
    dicts, lists and tuples; any other leaf (a Python number, None) is
    kept as it is."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def same_layout(a, b) -> bool:
    """True when trees a and b have the same containers (dict keys, list
    and tuple lengths), tensors of the same shapes and dtypes at the same
    places, and leaves of the same Python types elsewhere."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_layout(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_layout(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype)
    return type(a) is type(b)


def to_host(*tensors) -> list:
    """numpy copies of small tensors (per-frame pts, flags, metrics),
    taken with one wait for the device: the copies of CUDA tensors go into
    pinned buffers on the current stream, which is then synchronised once.
    The window elements whose decisions run on the host (interlace,
    fieldanalysis, ivtc) read their inputs through this."""
    out = []
    stream = None
    for t in tensors:
        if t.device.type == "cpu":
            out.append(t)
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        stream = torch.cuda.current_stream(t.device)
        out.append(buf)
    if stream is not None:
        stream.synchronize()
    return [t.numpy() for t in out]


def to_device(device, *arrays) -> list:
    """Tensors on `device` from host values (numpy arrays or scalars, each
    given as (value, dtype) or as an array), queued without waiting for the
    device: a CUDA copy goes from pinned memory on the current stream, so
    it does not wait for the work already queued there.  The counterpart
    of to_host for the plans and states those elements send back."""
    device = torch.device(device)
    out = []
    for a in arrays:
        if isinstance(a, tuple):
            a = np.asarray(a[0], dtype=a[1])
        t = torch.from_numpy(np.array(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out
