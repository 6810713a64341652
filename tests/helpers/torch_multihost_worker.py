"""Two-process torch.distributed worker (tests/test_torch_multihost.py):
the port's counterpart of tests/helpers/multihost_worker.py.

Each process holds a dp 4 x sp 1 mesh of CPU shards; over gloo the pair
forms one mesh of 8 dp rows.  Process 0 drives the port's ipcpipeline
control plane (a window-descriptor event, a state change and a small
metadata buffer) to process 1; then both place their 4 frames with
parallel.multihost.feed_window and run burn ! solarize ! chromahold ! fakesink
over the global window (every node per shard), then videoconvert
format=GRAY8 ! videodiff ! fakesink (both nodes by the gather rule, over
dist.all_gather).  Each process writes the digests of its output shards
and of the gathered window for the parent test.

Usage: torch_multihost_worker.py <pid> <port> <outdir> <ipc_name>
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import gstbad_tpu_torch as gtt  # noqa: E402
from gstbad_tpu_torch.core.frame import FrameBatch  # noqa: E402
from gstbad_tpu_torch.core.spec import MediaSpec  # noqa: E402
from gstbad_tpu_torch.io.ipcpipeline import (  # noqa: E402
    IpcMaster, IpcSlave, STATE_CHANGE_SUCCESS)
from gstbad_tpu_torch.parallel import feed_window, make_mesh  # noqa: E402

pid, port, outdir, ipc_name = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
H, W, B_LOCAL = 16, 128, 4

dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=pid)


def digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.int32:
        a = a.view(np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()


# -- control plane: io/ipcpipeline.py typed chunks over the shm rings ------
window_info = {}
if pid == 0:
    master = IpcMaster(ipc_name, slot_size=1 << 20, n_slots=4)
    dist.barrier()                      # the rings exist
    master.send_event({"type": "window", "pts0": 0, "window": 2 * B_LOCAL})
    assert master.set_state("playing",
                            timeout_ms=60000) == STATE_CHANGE_SUCCESS
    meta = FrameBatch.make(torch.zeros((1, 4), dtype=torch.uint8))
    master.push_buffer(meta, MediaSpec(kind="bytes", format="window-desc"))
else:
    dist.barrier()
    slave = IpcSlave(ipc_name, on_event=lambda e: window_info.update(e))
    got = slave.pull_buffer(60000)
    assert got is not None, "control buffer never arrived"
    assert window_info.get("type") == "window", window_info
    assert slave.state == "playing"

# -- data plane: the global window on the mesh ------------------------------
mesh = make_mesh(dp=4, sp=1, devices=[torch.device("cpu")] * 4)
assert mesh.dp == 8 and (mesh.processes, mesh.rank) == (2, pid)
rng = np.random.default_rng(100 + pid)
local = rng.integers(0, 256, (B_LOCAL, H, W, 4), dtype=np.uint8)
local_pts = (pid * B_LOCAL + np.arange(B_LOCAL, dtype=np.int64)) * 33_000_000
batch = feed_window(mesh, local, local_pts)
assert batch.batch == 2 * B_LOCAL and batch.n_shards == 4

spec = MediaSpec(kind="video", format="BGRx", width=W, height=H)
p = gtt.parse_launch("burn ! solarize ! chromahold ! fakesink",
                     device="cpu")
p.negotiate(spec)
step = p.compile(2 * B_LOCAL, mesh=mesh)
_, leaf, _ = step(p.params(), p.init_states(2 * B_LOCAL), batch)
shards = {str(fb.shard.frame0): digest(fb.data)
          for row in leaf[-1].shards for fb in row}
assert all(c["gather"] == 0 for c in p.shard_counts.values())

q = gtt.parse_launch("videoconvert format=GRAY8 ! videodiff ! fakesink",
                     device="cpu")
q.negotiate(spec)
step = q.compile(2 * B_LOCAL, mesh=mesh)
_, leaf, _ = step(q.params(), q.init_states(2 * B_LOCAL), batch)
whole = leaf[-1].gather()
assert q.shard_counts["videodiff"]["gather"] == 1

with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
    json.dump({"shards": shards, "n_shards": mesh.dp * mesh.sp,
               "gathered": digest(whole.data.numpy()),
               "pts": whole.pts.tolist(),
               "window_info": window_info if pid else None}, f)

if pid == 0:
    master.send_eos()
    master.close()
else:
    slave.close()
dist.destroy_process_group()
print(f"worker {pid} done", flush=True)
