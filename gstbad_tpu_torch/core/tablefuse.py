"""Table-state fusion — the whole-graph LUT/pointwise fusion pass.

The reference runs each element as its own per-pixel loop over the frame
(one streaming thread per element, SURVEY.md §3.1).  This pass runs a
small abstract interpretation over the element chain: the value flowing
between elements is tracked symbolically as

    out_byte[c] = table_c[index_c]          (a TableChain)

where index_c is either a shared 8-bit index plane (`idx` — e.g. the BT.709
luma that gstcoloreffects.c:509-541 routes its preset LUTs through), the
c-th byte of the chain's source word, or nothing (a per-frame constant).

Fusion rules (each implemented against an Element hook):

  byte_map        per-channel byte LUT       -> compose onto the tables
                                                (256-entry math, free)
  table_head      LUT over a derived index   -> start the shared idx plane
  word_map        pointwise cross-channel fn -> when every byte shares idx,
                                                evaluate the function ON THE
                                                256 TABLE ENTRIES instead of
                                                the W*H*B pixels
  index_stencil   word-moving neighborhood   -> run the stencil on the 8-bit
                  op (dilate copies whole       index plane, comparing via a
                  pixels by luminance)          rank table of the mapped words
  table_tail      positional final select    -> compose as an xor-select on
                  (zebrastripe)                 the materialized word

A chain like sepia ! solarize ! chromium ! dodge ! burn ! exclusion !
dilate ! chromahold ! videoconvert ! zebrastripe executes as ONE
index-plane stencil plus one whole-word lookup per pixel (the fused-tail
kernel ops/chainfuse.py, or ops/lut.apply_word_table without a tail) —
bit-exactly: evaluating a pure per-pixel function on the 256 reachable
values is exactly equal to evaluating it on every pixel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.ops import lut
from gstbad_tpu_torch.ops.pointops import byte_of, pack32, unpack32

IDX = "idx"      # byte c = table[idx-plane]
SRC = "src"      # byte c = table[byte c of src word]  (table None = identity)
CONST = "const"  # byte c = per-frame scalar value


@dataclasses.dataclass(frozen=True)
class LinearIndex:
    """A chain head's 8-bit index as a linear function of the word's bytes:
    idx = (sum_c (byte_c << pre_shift) * weights[c]) >> post_shift.

    Coloreffects' BT.709 luma on BGRx is weights (19, 183, 54, 0) by byte
    position with shifts (8, 16).  The fused-tail kernel takes these six
    integers in place of a traced function; the constructor checks that
    every intermediate fits in int32 and every index lies in [0, 256)."""

    weights: Tuple[int, int, int, int]
    pre_shift: int
    post_shift: int

    def __post_init__(self):
        if (len(self.weights) != 4 or min(self.weights) < 0
                or not 0 <= self.pre_shift <= 23
                or not 0 <= self.post_shift <= 31):
            raise ValueError(f"bad LinearIndex {self}")
        top = (255 << self.pre_shift) * sum(self.weights)
        if top >= 1 << 31 or top >> self.post_shift >= 256:
            raise ValueError(f"LinearIndex {self} leaves int32 or [0, 256)")

    def __call__(self, word: torch.Tensor) -> torch.Tensor:
        out = None
        for c, w in enumerate(self.weights):
            if w:
                term = (byte_of(word, c) << self.pre_shift) * w
                out = term if out is None else out + term
        if out is None:
            return torch.zeros(word.shape, dtype=torch.int32,
                               device=word.device)
        return out >> self.post_shift


def _lead(v, ndim):
    """Broadcast a per-frame [B] scalar against an ndim-dim plane/table."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim)) if v.ndim else v


class TableChain:
    """The symbolic value for a run of fusable elements.

    src_batch carries the chain input (metadata + the word plane for SRC
    bytes); members lists (state_index, element) so a single-member chain
    can fall back to the element's own (cheaper) process().
    """

    def __init__(self, src_batch: FrameBatch, src_word: torch.Tensor):
        self.src_batch = src_batch
        self.src_word = src_word          # [B, H, W] int32 packed pixels
        # [1, H, W] broadcast base of src_word when the producer attached
        # one (FrameBatch.word_base) — the fused chain kernel reads it
        # instead of the broadcast
        self.src_word_base: Optional[torch.Tensor] = None
        # the head's index; the idx plane index_fn(src_word) is computed
        # when first read (see idx): a fused tail that reads the source
        # words itself never needs it, and eager torch drops no dead work
        self.index_fn: Optional[LinearIndex] = None
        self._idx: Optional[torch.Tensor] = None
        self.bytes_: List[Tuple[str, Any]] = [(SRC, None)] * 4
        # a word-moving stencil held SYMBOLICALLY until someone needs the
        # moved index plane — a fused tail (zebrastripe) can then run the
        # stencil inside one kernel instead of via tensor shifts
        self.pending_stencil = None       # (key_fn, move_fn, params, tag)
        self.stencil_applied = False      # idx no longer index_fn(src)
        self.members: List[Tuple[int, Any]] = []

    @property
    def idx(self) -> Optional[torch.Tensor]:
        """The shared [B, H, W] int32 index plane in [0, 256), or None."""
        if self._idx is None and self.index_fn is not None:
            self._idx = self.index_fn(self.src_word).to(torch.int32)
        return self._idx

    @idx.setter
    def idx(self, value: Optional[torch.Tensor]) -> None:
        self._idx = value

    def has_idx(self) -> bool:
        return self._idx is not None or self.index_fn is not None

    # -- predicates ---------------------------------------------------------
    def pristine(self) -> bool:
        return not self.has_idx() and all(
            k == SRC and t is None for k, t in self.bytes_)

    def single_indexed(self) -> bool:
        """True when every byte is a function of the shared idx plane."""
        return self.has_idx() and all(
            k in (IDX, CONST) for k, t in self.bytes_)

    # -- fusion rules -------------------------------------------------------
    def absorb_byte_map(self, tables: torch.Tensor, kinds) -> None:
        """Compose a per-channel byte map [*, 4, 256] (Element.byte_map)."""
        for c in range(4):
            bk = kinds[c]
            if bk == "id":
                continue
            if bk == "zero":
                self.bytes_[c] = (CONST, tables.new_zeros((), dtype=torch.int32))
                continue
            t_new = tables[..., c, :].to(torch.int32)
            kind, t = self.bytes_[c]
            if kind == CONST:
                # one dynamic entry of the new table (a 1-element gather)
                ii = t.to(torch.int32)
                lead = torch.broadcast_shapes(ii.shape, t_new.shape[:-1])
                t_b = t_new.expand(lead + (256,))
                ii_b = ii.reshape(ii.shape + (1,) * (len(lead) - ii.ndim + 1)
                                  ).expand(lead + (1,))
                self.bytes_[c] = (CONST, torch.gather(
                    t_b, -1, ii_b.long())[..., 0])
            elif t is None:
                self.bytes_[c] = (kind, t_new)
            else:
                t_b, n_b = torch.broadcast_tensors(t.to(torch.int32), t_new)
                self.bytes_[c] = (kind, torch.gather(n_b, -1, t_b.long()))

    def absorb_head(self, index_fn: LinearIndex, byte_specs) -> bool:
        """Start the shared index plane (only on a pristine chain)."""
        if not self.pristine():
            return False
        self.index_fn = index_fn
        self.bytes_ = [(k, None if t is None else t.to(torch.int32))
                       for k, t in byte_specs]
        return True

    def word_table(self) -> torch.Tensor:
        """The full mapped word as a [*, 256] int32 table (single_indexed)."""
        out = None
        for c, (kind, t) in enumerate(self.bytes_):
            if kind == CONST:
                v = (t if t.ndim == 0 else t[..., None]).to(torch.int32)
                w = v.expand(v.shape[:-1] + (256,))
            else:
                w = t.to(torch.int32)
            w = (w & 255) << (8 * c) if c else (w & 255)
            out = w if out is None else out | w
        return out

    def absorb_word_map(self, fn) -> bool:
        """Evaluate a pure per-pixel word function on the 256 table entries
        — or, on a time-invariant chain (static broadcast source, static
        tables), on the ONE [1, H, W] base frame: the chain restarts from
        the mapped base, so cross-channel ops (exclusion) that cannot ride
        a single index plane still cost 1/B of the window."""
        if self.single_indexed():
            new_t = fn(self.word_table())
            self.bytes_ = [(IDX, (new_t >> (8 * c)) & 255
                            if c else new_t & 255) for c in range(4)]
            return True
        if self._time_invariant():
            idx_b = (None if not self.has_idx()
                     else self.index_fn(self.src_word_base).to(torch.int32))
            base = fn(self._materialize_core(self.src_word_base, idx_b))
            word = base.expand(self.src_word.shape)
            self.src_word_base = base
            self.src_word = word
            self.src_batch = self.src_batch.with_data(
                unpack32(word)).replace(word=word, word_base=base)
            self.idx = None
            self.index_fn = None
            self.bytes_ = [(SRC, None)] * 4
            return True
        return False

    def rank_plane(self, key_table: torch.Tensor) -> torch.Tensor:
        """Order-preserving u8 rank of a [*, 256] int32 key table, looked up
        over the idx plane.  rank(a) > rank(b) <=> key(a) > key(b) (ties map
        to equal ranks), so stencils that only COMPARE keys (dilate's
        luminance) run off one 8-bit lookup."""
        rank = self.rank_table(key_table)
        if rank.ndim == 1:
            return lut.apply_word_table(self.idx, rank)
        return lut.lookup(self.idx, rank)

    @staticmethod
    def rank_table(key_table: torch.Tensor) -> torch.Tensor:
        k = key_table.to(torch.int32)
        if k.shape[-1] == 1:
            k = k.expand(k.shape[:-1] + (256,))
        return (k[..., None, :] < k[..., :, None]).sum(-1, dtype=torch.int32)

    def absorb_index_stencil(self, key_fn, move_fn, params,
                             tag=None) -> bool:
        """Absorb a word-moving stencil on the index plane: key_fn builds
        the comparison key per table entry (snapshotted NOW — later table
        edits must not change the stencil's keys), move_fn permutes the idx
        plane using only ORDER comparisons on the looked-up keys.  The move
        itself is deferred (pending_stencil) so a fused tail can run it
        inside one kernel."""
        if not self.single_indexed():
            return False
        self.resolve_stencil()  # two stencils in a row: run the first
        key_t = key_fn({c: (kind, t) for c, (kind, t)
                        in enumerate(self.bytes_)})
        self.pending_stencil = (key_t, move_fn, params, tag)
        return True

    def resolve_stencil(self) -> None:
        """Apply a deferred stencil to the idx plane (the unfused path)."""
        if self.pending_stencil is None:
            return
        key_t, move_fn, params, _tag = self.pending_stencil
        self.pending_stencil = None
        self.idx = move_fn(self.idx, self.rank_plane(key_t), params)
        self.stencil_applied = True       # idx != index_fn(src) now

    # -- materialization ----------------------------------------------------
    def _time_invariant(self) -> bool:
        """True when the whole chain output is identical for every frame
        of the window: the source attached a [1, H, W] broadcast base
        (static videotestsrc pattern), no stencil is pending, and no
        table carries a per-frame leading dim (controllable curves).
        Materialization then computes ONE frame and broadcasts."""
        if (self.src_word_base is None or self.pending_stencil is not None
                or self.stencil_applied):
            return False
        for k, t in self.bytes_:
            if t is None:
                continue
            if (k == CONST and t.ndim > 0) or (k != CONST and t.ndim > 1):
                return False
        return True

    def materialize_word(self) -> torch.Tensor:
        self.resolve_stencil()
        if self._time_invariant():
            word1 = self._materialize_core(
                self.src_word_base,
                None if not self.has_idx()
                else self.index_fn(self.src_word_base).to(torch.int32))
            return word1.expand(self.src_word.shape)
        return self._materialize_core(self.src_word, self.idx)

    def _materialize_core(self, src_word, idx) -> torch.Tensor:
        if self.single_indexed() and all(
                t.ndim == (1 if k == IDX else 0) for k, t in self.bytes_):
            # every byte rides the shared idx with per-run tables: ONE
            # whole-word lookup (kernel K2 on the card)
            return lut.apply_word_table(idx, self.word_table())
        out = None
        for c, (kind, t) in enumerate(self.bytes_):
            if kind == CONST:
                b = _lead(t.to(torch.int32), src_word.ndim
                          ).expand(src_word.shape)
            elif kind == SRC:
                b = byte_of(src_word, c)
                if t is not None:
                    b = lut.lookup(b, t) & 255
            else:
                b = lut.lookup(idx, t) & 255
            w = (b & 255) << (8 * c) if c else (b & 255)
            out = w if out is None else out | w
        return out

    def materialize(self) -> FrameBatch:
        word = self.materialize_word()
        # keep the word attached: a word-keeping sink (fakesink) then
        # hands it to the runner without the byte view
        return self.src_batch.with_data(unpack32(word)).replace(word=word)


def start_chain(batch: FrameBatch) -> Optional[TableChain]:
    """A chain needs a packed 4-byte word image ([B, H, W, 4] u8).  A
    producer-attached word (FrameBatch.word) is used as is, and its
    broadcast base (FrameBatch.word_base) with it."""
    data = batch.data
    if (isinstance(data, dict) or getattr(data, "ndim", 0) != 4
            or data.shape[-1] != 4 or data.dtype != torch.uint8):
        return None
    if batch.word is not None and batch.word.shape == data.shape[:-1]:
        chain = TableChain(batch, batch.word.to(torch.int32))
        wb = batch.word_base
        if (wb is not None and wb.shape[0] == 1
                and wb.shape[1:] == data.shape[1:-1]):
            chain.src_word_base = wb.to(torch.int32)
        return chain
    return TableChain(batch, pack32(data))
