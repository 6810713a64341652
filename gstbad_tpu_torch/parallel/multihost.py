"""Multi-process frame feed: the data plane beside io/ipcpipeline.py's
control plane (SURVEY.md section 2.6: "multi-host feed is DCN host
transfers of (tensor, MediaSpec, pts) tuples").

In a torch.distributed job each process holds its slice of a window (its
capture cards' streams).  `feed_window` places this process's slice on
its own shards of the mesh, whose dp axis spans every process: the
global window is B_local x world_size frames, process r's at frames
r * B_local .. (r + 1) * B_local - 1.  A step's gather rule then
assembles the window with dist.all_gather (gloo for CPU tensors, NCCL
where each process owns a card).  A single process degrades to
shard_batch, so the same call works everywhere.  torch.distributed is
imported only here, when it is called.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.parallel.mesh import (Mesh, ShardedBatch, shard_batch,
                                            split)


def all_gather_frames(local: torch.Tensor) -> torch.Tensor:
    """Every process's `local` [B_local, ...] joined along frames in rank
    order.  The tensors travel as bytes, so any dtype works on gloo."""
    import torch.distributed as dist
    world = dist.get_world_size()
    flat = local.contiguous().reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(bufs, flat)
    return torch.cat([b.view(local.dtype).reshape(local.shape)
                      for b in bufs], dim=0)


def feed_window(mesh: Mesh, local_data, local_pts=None,
                kind: str = "video") -> ShardedBatch:
    """This process's slice of a window, placed on its shards of `mesh`.

    local_data: numpy [B_local, ...] (or {plane: ...}); every process
    calls this with its own slice.  The global window is
    B_local * world_size frames along dp.  `kind` is the JAX signature's
    and places nothing differently."""
    dev = mesh.first

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    if isinstance(local_data, dict):
        data = {k: put(v) for k, v in local_data.items()}
        b_local = next(iter(local_data.values())).shape[0]
    else:
        data = put(local_data)
        b_local = local_data.shape[0]
    if local_pts is None:
        local_pts = np.zeros(b_local, np.int64)
    batch = FrameBatch.make(data, pts=put(np.asarray(local_pts, np.int64)))
    if mesh.processes == 1:
        return shard_batch(batch, mesh)
    import torch.distributed as dist
    # on the mesh's device: NCCL gathers CUDA tensors only
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(mesh.processes)]
    dist.all_gather(sizes, torch.tensor([b_local], dtype=torch.int64,
                                        device=dev))
    if len({int(s) for s in sizes}) != 1:
        raise ValueError(f"feed_window: processes hold "
                         f"{[int(s) for s in sizes]} frames; each must hold "
                         "the same")
    return split(batch, mesh, strict=True, local=True)
