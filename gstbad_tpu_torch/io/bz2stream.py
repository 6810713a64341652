"""bz2enc / bz2dec (ext/bz2/gstbz2enc.c, gstbz2dec.c) stream codecs.

CPython's bz2 module links the same libbz2 the reference wraps, so
these produce byte-identical streams: Bz2Enc mirrors gstbz2enc.c —
BZ2_bzCompressInit with `block_size` (DEFAULT_BLOCK_SIZE 6, range
1-9), BZ_RUN per input buffer emitting `buffer_size`-granular chunks
(DEFAULT_BUFFER_SIZE 1024), BZ_FINISH at EOS; Bz2Dec mirrors
gstbz2dec.c's streaming decompress with its `first_buffer_size` /
`buffer_size` chunking.
A copy of the JAX package's io/bz2stream.py: only its imports differ.
"""

from __future__ import annotations

import bz2 as _bz2
from typing import Iterator, List

DEFAULT_BLOCK_SIZE = 6       # gstbz2enc.c:37
DEFAULT_BUFFER_SIZE = 1024   # gstbz2enc.c:38


class Bz2Enc:
    def __init__(self, block_size: int = DEFAULT_BLOCK_SIZE,
                 buffer_size: int = DEFAULT_BUFFER_SIZE):
        if not 1 <= block_size <= 9:
            raise ValueError("bz2enc: block-size must be 1-9")
        self._c = _bz2.BZ2Compressor(block_size)
        self._buffer_size = buffer_size
        self._pending = b""

    def _chunks(self, final: bool = False) -> List[bytes]:
        out = []
        while len(self._pending) >= self._buffer_size:
            out.append(self._pending[:self._buffer_size])
            self._pending = self._pending[self._buffer_size:]
        if final and self._pending:
            out.append(self._pending)
            self._pending = b""
        return out

    def push(self, data: bytes) -> List[bytes]:
        """One input buffer -> zero or more buffer_size output
        chunks (BZ_RUN)."""
        self._pending += self._c.compress(bytes(data))
        return self._chunks()

    def finish(self) -> List[bytes]:
        """EOS -> the remaining chunks (BZ_FINISH)."""
        self._pending += self._c.flush()
        return self._chunks(final=True)


class Bz2Dec:
    def __init__(self, first_buffer_size: int = 1024,
                 buffer_size: int = DEFAULT_BUFFER_SIZE):
        self._d = _bz2.BZ2Decompressor()
        self._first = first_buffer_size
        self._buffer_size = buffer_size
        self._emitted_first = False
        self._pending = b""

    def push(self, data: bytes) -> List[bytes]:
        self._pending += self._d.decompress(bytes(data))
        out = []
        while True:
            size = self._first if not self._emitted_first \
                else self._buffer_size
            if len(self._pending) < size:
                break
            out.append(self._pending[:size])
            self._pending = self._pending[size:]
            self._emitted_first = True
        return out

    def finish(self) -> List[bytes]:
        if self._pending:
            out = [self._pending]
            self._pending = b""
            self._emitted_first = True
            return out
        return []

    @property
    def eos(self) -> bool:
        return self._d.eof


def compress(data: bytes, block_size: int = DEFAULT_BLOCK_SIZE
             ) -> bytes:
    return _bz2.compress(data, block_size)


def decompress(data: bytes) -> bytes:
    return _bz2.decompress(data)
