"""Device mesh: dp over a window's frames, sp over each frame's rows.

The reference parallelizes by running each element on its own streaming
thread; frames stay sequential.  Here, as in the JAX package's
parallel/mesh.py, the window's frame axis is the parallel axis: a window
of B frames splits over the mesh's `dp` axis and each frame's rows over
its `sp` axis.  A mesh is a grid of torch devices, and a device may
repeat: `[cpu] * 8` runs eight logical shards on the host, `[cuda:0] * 4`
four on one card, and one entry per card where there are several.

A window placed on the mesh is a ShardedBatch: the dp x sp grid of
FrameBatch shards, each on its device and knowing its frame range and its
row band (FrameBatch.shard, a ShardPos).  Pipeline.compile(..., mesh=)
runs each element on the shards by its shard rule (Element.shard_rule):
alone, with a halo of neighbouring rows, or on the gathered window.

Under torch.distributed (parallel/multihost.py) the mesh holds this
process's devices, and its dp axis spans every process: process r holds
dp rows r * dp .. (r + 1) * dp - 1 of the global grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from gstbad_tpu_torch.core.frame import FrameBatch, ShardPos
from gstbad_tpu_torch.ops.pointops import pack32, unpack32

_META = ("pts", "flags", "valid", "trim")


@dataclasses.dataclass
class Mesh:
    """A (dp, sp) grid of this process's devices; `processes` processes
    of `rank`s 0.. share the dp axis (1 without torch.distributed)."""

    devices: List[List[torch.device]]
    processes: int = 1
    rank: int = 0

    @property
    def dp(self) -> int:
        """The global dp size: every process's dp rows."""
        return len(self.devices) * self.processes

    @property
    def sp(self) -> int:
        return len(self.devices[0])

    @property
    def local_dp(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def axis_names(self):
        return ("dp", "sp")

    @property
    def first(self) -> torch.device:
        """The device of shard (0, 0): states and gathered windows live
        there."""
        return self.devices[0][0]


def resolve(device) -> torch.device:
    """A mesh device with its index ("cuda" is the current card); a
    CUDA device torch does not see raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev} requested but torch "
                               "sees no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {dev} requested but torch "
                               f"sees {torch.cuda.device_count()} CUDA "
                               "devices")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev} (cpu or cuda)")
    return dev


def _distributed():
    """(world size, rank) of an initialized torch.distributed group, else
    (1, 0); torch.distributed is imported only here."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(dp: int = 0, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh of this process's devices; dp=0 means "all
    remaining devices".  `devices` may repeat a device; the default is
    every visible CUDA device, and a missing one raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve(d) for d in devices]
    n = len(devices)
    if dp == 0:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    processes, rank = _distributed()
    grid = [devices[i * sp:(i + 1) * sp] for i in range(dp)]
    return Mesh(grid, processes, rank)


# -- leaves -------------------------------------------------------------------

def _row_leaves(batch: FrameBatch) -> List[torch.Tensor]:
    """The leaves a row split cuts: data tensors of 3 or more dims, the
    word and its broadcast base."""
    data = batch.data
    leaves = list(data.values()) if isinstance(data, dict) else [data]
    out = [x for x in leaves if x.ndim >= 3]
    out += [x for x in (batch.word, batch.word_base) if x is not None]
    return out


def _indivisible(axis: int, shape, n: int, name: str) -> ValueError:
    return ValueError(
        f"a mesh {name} axis of {n} shards dimension {axis} of a leaf of "
        f"shape {tuple(shape)}: its size {shape[axis]} should be divisible "
        f"by {n}")


def _layout(batch: FrameBatch, mesh: Mesh, strict: bool,
            local: bool = False):
    """(frames split over dp, rows split over sp) for a window on `mesh`
    (local: `batch` is this process's part of the window, split over its
    own dp rows).  strict: an axis that does not divide raises ValueError,
    as JAX's device_put of a NamedSharding does; otherwise it is not
    split, and its shards hold it whole (the JAX pipeline's `_sh` drops
    the axis)."""
    b = batch.batch
    dp = mesh.local_dp if local else mesh.dp
    frames = local or dp > 1
    if frames and b % dp:
        if strict:
            first = batch.data if not isinstance(batch.data, dict) else \
                next(iter(batch.data.values()))
            raise _indivisible(0, first.shape, dp, "dp")
        frames = False
    rows = mesh.sp > 1
    if rows:
        for x in _row_leaves(batch):
            if x.shape[1] % mesh.sp:
                if strict:
                    raise _indivisible(1, x.shape, mesh.sp, "sp")
                rows = False
                break
    return frames, rows


def _band(x: torch.Tensor, part: int, parts: int) -> torch.Tensor:
    n = x.shape[1] // parts
    return x[:, part * n:(part + 1) * n]


def _place(batch: FrameBatch, lo: int, hi: int, part: int, parts: int,
           device: torch.device, pos: ShardPos) -> FrameBatch:
    """Frames [lo, hi) and row band `part` of `parts` of `batch` on
    `device`.  A word that is a view of the data stays a view of the
    shard's data."""

    def cut(x, rows=True):
        if x is None:
            return None
        y = x[lo:hi]
        if rows and parts > 1 and y.ndim >= 3:
            y = _band(y, part, parts)
        return y.to(device)

    data = batch.data
    if isinstance(data, dict):
        new_data = {k: cut(v) for k, v in data.items()}
    else:
        new_data = cut(data)
    word = batch.word
    if word is not None:
        if word is data:
            word = new_data
        elif (not isinstance(data, dict) and data.dtype == torch.uint8
              and data.shape[-1] == 4 and data.shape[:-1] == word.shape):
            word = pack32(new_data)
        else:
            word = cut(word)
    base = batch.word_base
    if base is not None:
        if parts > 1:
            base = _band(base, part, parts)
        base = base.to(device)
        if word is not None and word.stride(0) == 0:
            # a broadcast word and its bytes stay views of the base
            word = base.expand(word.shape)
            new_data = unpack32(word)
    meta = {k: cut(getattr(batch, k), rows=False) for k in _META}
    return batch.replace(data=new_data, word=word, word_base=base,
                         shard=pos, **meta)


def split(batch: FrameBatch, mesh: Mesh, strict: bool = True,
          local: bool = False) -> "ShardedBatch":
    """A window placed on `mesh` (this process's shards).  Under
    torch.distributed every process holds the whole window and keeps its
    own dp rows; local: `batch` holds only this process's frames
    (parallel/multihost.py feed_window)."""
    frames, rows = _layout(batch, mesh, strict, local)
    b = batch.batch
    window = b * mesh.processes if local else b
    bd = window // mesh.dp if frames else b
    parts = mesh.sp if rows else 1
    grid = []
    for d, row in enumerate(mesh.devices):
        gd = mesh.rank * mesh.local_dp + d if frames else 0
        lo = (d if local else gd) * bd
        grid.append([_place(batch, lo, lo + bd, s if rows else 0, parts,
                            dev, ShardPos(gd * bd, window, s if rows else 0,
                                          parts))
                     for s, dev in enumerate(row)])
    return ShardedBatch(grid, mesh)


def shard_batch(batch: FrameBatch, mesh: Mesh) -> "ShardedBatch":
    """Place a FrameBatch on the mesh: frames over dp, rows over sp (the
    data leaves of 3 or more dims; pts, flags and valid over dp only).  An
    axis that does not divide raises ValueError."""
    return split(batch, mesh, strict=True)


class ShardedBatch:
    """A window on a mesh: shards[d][s] is the FrameBatch of this
    process's dp row d and sp column s, on mesh.devices[d][s]."""

    def __init__(self, shards: List[List[FrameBatch]], mesh: Mesh):
        self.shards = shards
        self.mesh = mesh

    @property
    def pos(self) -> ShardPos:
        return self.shards[0][0].shard

    @property
    def frames_split(self) -> bool:
        return self.shards[0][0].batch < self.pos.window

    @property
    def rows_split(self) -> bool:
        return self.pos.parts > 1

    @property
    def batch(self) -> int:
        return self.pos.window

    @property
    def n_shards(self) -> int:
        """The shards of this process that hold distinct parts of the
        window."""
        return ((self.mesh.local_dp if self.frames_split else 1)
                * (self.mesh.sp if self.rows_split else 1))

    def spec(self, x_ndim: int):
        """The placement of a leaf of `x_ndim` dims, as a JAX
        PartitionSpec's axes: "dp" over frames, "sp" over rows, None."""
        return placement(x_ndim, self.frames_split, self.rows_split)

    def _meta(self, name: str):
        return _gather_frames(self, lambda fb: getattr(fb, name), rows=False)

    @property
    def pts(self) -> torch.Tensor:
        return self._meta("pts")

    @property
    def flags(self) -> torch.Tensor:
        return self._meta("flags")

    @property
    def valid(self) -> torch.Tensor:
        return self._meta("valid")

    def gather(self) -> FrameBatch:
        """The whole window as one FrameBatch on the mesh's first device
        (under torch.distributed every process takes part and gets it)."""
        first = self.shards[0][0]
        data = first.data
        if isinstance(data, dict):
            new_data = {k: _gather_frames(
                self, lambda fb, k=k: fb.data[k]) for k in data}
        else:
            new_data = _gather_frames(self, lambda fb: fb.data)
        word = first.word
        if word is not None:
            if word is data:
                word = new_data
            elif (not isinstance(data, dict) and data.dtype == torch.uint8
                  and data.shape[-1] == 4):
                word = pack32(new_data)
            else:
                word = _gather_frames(self, lambda fb: fb.word)
        base = first.word_base
        if base is not None:
            base = _cat_rows(self, 0, lambda fb: fb.word_base)
        meta = {k: (self._meta(k) if getattr(first, k) is not None
                    else None) for k in _META}
        return first.replace(data=new_data, word=word, word_base=base,
                             shard=None, **meta)

    def to_numpy(self) -> FrameBatch:
        return self.gather().to_numpy()


def placement(ndim: int, frames: bool = True, rows: bool = True):
    """The mesh axes of a leaf of `ndim` dims: frames over dp, and for 3
    or more dims rows over sp (parallel/mesh.py of the JAX package,
    `_data_spec`)."""
    if ndim >= 3:
        return (("dp" if frames else None), ("sp" if rows else None)) + (
            None,) * (ndim - 2)
    if ndim >= 1:
        return ("dp" if frames else None,) + (None,) * (ndim - 1)
    return ()


def _cat_rows(sb: ShardedBatch, d: int, get) -> torch.Tensor:
    """Leaf `get` of dp row d, its sp bands joined on the first device."""
    first = sb.mesh.first
    xs = [get(fb) for fb in sb.shards[d]]
    if not sb.rows_split or xs[0].ndim < 3:
        return xs[0].to(first)
    return torch.cat([x.to(first) for x in xs], dim=1)


def _gather_frames(sb: ShardedBatch, get, rows: bool = True
                   ) -> torch.Tensor:
    """Leaf `get` of the whole window on the first device: each dp row's
    bands joined, then the dp rows, then (under torch.distributed) every
    process's rows."""
    first = sb.mesh.first
    if rows:
        parts = [_cat_rows(sb, d, get) for d in range(sb.mesh.local_dp)]
    else:
        parts = [get(row[0]).to(first) for row in sb.shards]
    if not sb.frames_split:
        return parts[0]
    local = torch.cat(parts, dim=0)
    if sb.mesh.processes == 1:
        return local
    from gstbad_tpu_torch.parallel.multihost import all_gather_frames
    return all_gather_frames(local)


def shard_spatial(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Split a single frame's rows (axis 1) over the whole mesh (the sp
    view): one band per device of this process, in dp-major order.  Rows
    that do not divide raise ValueError."""
    devs = [dev for row in mesh.devices for dev in row]
    n = len(devs)
    if x.ndim < 2 or x.shape[1] % n:
        raise _indivisible(1, x.shape, n, "dp x sp")
    return [_band(x, i, n).to(dev) for i, dev in enumerate(devs)]


def pipeline_shardings(mesh: Mesh, example: FrameBatch) -> FrameBatch:
    """The placement plan shard_batch gives each leaf of `example`: a
    FrameBatch whose fields hold each leaf's mesh axes (placement())."""
    frames, rows = _layout(example, mesh, strict=False)

    def spec(x):
        return None if x is None else placement(x.ndim, frames, rows)

    data = example.data
    data = ({k: spec(v) for k, v in data.items()}
            if isinstance(data, dict) else spec(data))
    return FrameBatch(data=data, pts=spec(example.pts),
                      flags=spec(example.flags), valid=spec(example.valid),
                      word=spec(example.word),
                      word_base=(None if example.word_base is None
                                 else (None, "sp" if rows else None, None)),
                      trim=spec(example.trim))


# -- the halo rule ------------------------------------------------------------

def with_halo(row: Sequence[FrameBatch], s: int, r: int,
              device: torch.device) -> FrameBatch:
    """Shard s of an sp row of packed-video shards, with up to r rows of
    the bands above and below it attached (fewer at the frame's top and
    bottom), on `device`.  The shards hold their own bands only."""
    fb = row[s]
    pos = fb.shard
    if pos is None or pos.parts == 1 or r == 0:
        return fb
    if isinstance(fb.data, dict):
        raise ValueError("a row halo needs packed video, not planes")
    own = fb.data.shape[1]
    height = own * pos.parts
    lo = max(0, s * own - r)
    hi = min(height, (s + 1) * own + r)

    def rows_of(get):
        pieces = []
        for j in range(lo // own, (hi - 1) // own + 1):
            a = max(lo, j * own) - j * own
            b = min(hi, (j + 1) * own) - j * own
            pieces.append(get(row[j])[:, a:b].to(device))
        return torch.cat(pieces, dim=1)

    b = fb.batch
    if fb.word_base is not None and fb.word is not None \
            and fb.word.stride(0) == 0:
        base = rows_of(lambda x: x.word_base)
        word = base.expand((b,) + base.shape[1:])
        data = unpack32(word)
    elif fb.word is not None:
        base = None
        word = rows_of(lambda x: x.word)
        data = word if fb.word is fb.data else unpack32(word)
    else:
        base, word = None, None
        data = rows_of(lambda x: x.data)
    return fb.replace(data=data, word=word, word_base=base,
                      shard=dataclasses.replace(pos, above=s * own - lo,
                                                below=hi - (s + 1) * own))


def crop(fb: FrameBatch) -> FrameBatch:
    """A shard's batch cut back to its own band when it carries a halo."""
    pos = fb.shard
    if pos is None or (pos.above == 0 and pos.below == 0):
        return fb
    a = pos.above

    def cut(x):
        if x is None or x.ndim < 3:
            return x
        return x[:, a:x.shape[1] - pos.below]

    data = fb.data
    if isinstance(data, dict):
        new_data = {k: cut(v) for k, v in data.items()}
    else:
        new_data = cut(data)
    word = fb.word
    word = new_data if word is data else cut(word)
    return fb.replace(data=new_data, word=word, word_base=cut(fb.word_base),
                      shard=dataclasses.replace(pos, above=0, below=0))
