"""chopmydata (gst/debugutils/gstchopmydata.c) — random byte re-chunker.

The reference element splices an arbitrary byte stream into buffers of
random size in [min-size, max-size] quantized to step-size
(get_next_size, gstchopmydata.c:256-273), flushing [min-size]-granular
tails at EOS (gstchopmydata.c:302-312).  Its job is fuzzing the buffer
boundaries seen by downstream parsers.

In the fused-window TPU graph, buffer boundaries inside a window are the
batch axis with static shapes, so variable-size chunks live at the host
byte layer: this ChopMyData feeds the byte-stream surfaces
(videoparse/audioparse `push_bytes`, io/gdp packet streams).  RNG is
numpy's PCG64, not GLib's Mersenne twister — sequences differ from the
reference for equal seeds; the size distribution matches.
A copy of the JAX package's io/chop.py: only its imports differ.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

DEFAULT_MAX_SIZE = 4096  # gstchopmydata.c:69-71
DEFAULT_MIN_SIZE = 1
DEFAULT_STEP_SIZE = 1


class ChopMyData:
    def __init__(self, min_size: int = DEFAULT_MIN_SIZE,
                 max_size: int = DEFAULT_MAX_SIZE,
                 step_size: int = DEFAULT_STEP_SIZE, seed: int = 0):
        if not (1 <= min_size <= max_size) or step_size < 1:
            raise ValueError("chopmydata: need 1 <= min <= max, step >= 1")
        self.min_size = min_size
        self.max_size = max_size
        self.step_size = step_size
        self._rng = np.random.default_rng(seed)
        self._buf = bytearray()
        self._next_size: Optional[int] = None

    def _get_next_size(self) -> int:
        # gstchopmydata.c:256-273 integer math exactly
        begin = (self.min_size + self.step_size - 1) // self.step_size
        end = (self.max_size + self.step_size) // self.step_size
        if begin >= end:
            return begin * self.step_size
        return int(self._rng.integers(begin, end)) * self.step_size

    def push(self, data: bytes) -> List[bytes]:
        """Feed bytes; returns zero or more chopped output buffers."""
        self._buf += data
        out = []
        if self._next_size is None:
            self._next_size = self._get_next_size()
        while len(self._buf) >= self._next_size:
            out.append(bytes(self._buf[:self._next_size]))
            del self._buf[:self._next_size]
            self._next_size = self._get_next_size()
        return out

    def flush(self) -> List[bytes]:
        """EOS drain: emit min-size-granular chunks, drop the residue
        (gstchopmydata.c:302-312 incl. the adapter_clear)."""
        out = []
        while len(self._buf) >= self.min_size:
            out.append(bytes(self._buf[:self.min_size]))
            del self._buf[:self.min_size]
        self._buf.clear()
        return out
