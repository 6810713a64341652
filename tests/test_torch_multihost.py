"""A real two-process torch.distributed run of the port (gloo on the
CPU): tests/test_multihost_2proc.py's flow.  The ipcpipeline control plane
crosses the process boundary, feed_window places each process's 4 frames
on a mesh of 8 dp rows, and the per-shard digests of burn ! solarize !
chromahold (every node per shard) and the gathered videodiff window (the
gather rule over dist.all_gather) equal the single-process port's and the
JAX package's unsharded output."""

import hashlib
import json
import os
import socket
import subprocess
import sys
import uuid

import numpy as np
import torch

H, W, B_LOCAL = 16, 128, 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _digest(a) -> str:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype in (np.int32, np.uint32):
        a = a.view(np.uint8)
    return hashlib.sha256(a.tobytes()).hexdigest()


def _unsharded(frames):
    """(per-frame digests of burn ! solarize ! chromahold, the digest of
    videoconvert format=GRAY8 ! videodiff) for the port and the JAX
    package, each unsharded on the whole window."""
    import jax.numpy as jnp
    import gstbad_tpu as gt
    import gstbad_tpu_torch as gtt
    from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
    from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.core.spec import MediaSpec
    out = {}
    for desc in ("burn ! solarize ! chromahold ! fakesink",
                 "videoconvert format=GRAY8 ! videodiff ! fakesink"):
        p = gtt.parse_launch(desc, device="cpu")
        p.negotiate(MediaSpec(kind="video", format="BGRx", width=W,
                              height=H))
        step = p.compile(2 * B_LOCAL)
        _, leaf, _ = step(p.params(), p.init_states(2 * B_LOCAL),
                          FrameBatch.make(torch.as_tensor(frames)))
        port = leaf[-1].data.numpy()
        j = gt.parse_launch(desc)
        j.negotiate(JMediaSpec(kind="video", format="BGRx", width=W,
                               height=H))
        jstep = j.compile(2 * B_LOCAL, jit=True, donate_state=False)
        _, jleaf, _ = jstep(j.params(), j.init_states(2 * B_LOCAL),
                            JFrameBatch.make(jnp.asarray(frames)))
        ref = np.asarray(jleaf[-1].data)
        np.testing.assert_array_equal(
            np.ascontiguousarray(port).view(np.uint8),
            np.ascontiguousarray(ref).view(np.uint8))
        out[desc] = port
    return out


def test_two_process_gloo_feed_window(tmp_path):
    helper = os.path.join(ROOT, "tests", "helpers",
                          "torch_multihost_worker.py")
    port = _free_port()
    ipc_name = f"gstbad-tmh-{uuid.uuid4().hex[:8]}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, helper, str(i), str(port), str(tmp_path),
         ipc_name], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for pr in procs:
            so, se = pr.communicate(timeout=120)
            outs.append((pr.returncode, so, se))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for suffix in (".down", ".up"):
            path = f"/dev/shm/{ipc_name}{suffix}"
            if os.path.exists(path):
                os.unlink(path)
    for i, (rc, so, se) in enumerate(outs):
        assert rc == 0, f"proc {i} failed:\n{so}\n{se}"

    frames = np.concatenate([
        np.random.default_rng(100 + pid).integers(
            0, 256, (B_LOCAL, H, W, 4), dtype=np.uint8)
        for pid in range(2)])
    want = _unsharded(frames)
    point = want["burn ! solarize ! chromahold ! fakesink"]
    diff = want["videoconvert format=GRAY8 ! videodiff ! fakesink"]
    shards = {}
    for pid in range(2):
        with open(tmp_path / f"proc{pid}.json") as f:
            rec = json.load(f)
        assert rec["n_shards"] == 8
        shards.update(rec["shards"])
        # the gather rule gave both processes the whole window
        assert rec["gathered"] == _digest(diff)
        assert rec["pts"] == list(np.arange(8) * 33_000_000)
        if pid == 1:
            assert rec["window_info"]["type"] == "window"
    assert sorted(int(k) for k in shards) == list(range(8))
    for start, d in shards.items():
        assert d == _digest(point[int(start):int(start) + 1])
