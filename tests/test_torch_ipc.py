"""The port's shared-memory ring (io/shm.py over csrc/shmring.cpp) and
ipcpipeline (io/ipcpipeline.py) against the JAX package's: the same bytes
through both, both ends in one process as in tests/test_transport.py.
Every ring takes a unique name and is unlinked at teardown."""

import os
import threading
import uuid

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.io import ipcpipeline as jipc
from gstbad_tpu.io import shm as jshm
from gstbad_tpu_torch.io import ipcpipeline as tipc
from gstbad_tpu_torch.io import shm as tshm


@pytest.fixture
def name():
    """A ring name of its own; fails the test if a ring of it outlives
    the test."""
    n = f"gstbad-tt-{uuid.uuid4().hex[:10]}"
    yield n
    left = [p for p in (n, f"{n}.down", f"{n}.up")
            if os.path.exists(f"/dev/shm/{p}")]
    for p in left:
        os.unlink(f"/dev/shm/{p}")
    assert not left, f"rings left behind: {left}"


def _frames(host_batches):
    return np.concatenate([np.asarray(b.data) for b in host_batches])


def test_shmring_roundtrip_and_interop(rng, name):
    """Payloads of 10 B to 100 kB round trip through the port's ring, and
    the JAX package's ring reads what the port's writes (one layout)."""
    payloads = [rng.integers(0, 256, (n,), dtype=np.uint8).tobytes()
                for n in (10, 1000, 100000)]
    ring = tshm.ShmRing.create(name, 1 << 20, 4)
    try:
        other = tshm.ShmRing.open(name)
        for b in payloads:
            ring.write(b)
        assert [other.read(1000) for _ in payloads] == payloads
        for b in payloads:
            ring.write(b)
        jring = jshm.ShmRing.open(name)
        assert [jring.read(1000) for _ in payloads] == payloads
        ring.eos()
        assert other.read(1000) is None and jring.read(1000) is None
        with pytest.raises(TimeoutError):
            tshm.ShmRing.create(f"{name}.t", 64, 2).read(10)
        other.close()
        jring.close()
    finally:
        ring.close()
        if os.path.exists(f"/dev/shm/{name}.t"):
            os.unlink(f"/dev/shm/{name}.t")
        for s in ("free", "fill"):
            if os.path.exists(f"/dev/shm/sem.{name}.t.{s}"):
                os.unlink(f"/dev/shm/sem.{name}.t.{s}")
    assert tshm._so_path().startswith(os.path.join(
        os.path.dirname(gtt.__file__), "_build"))


def _packets(name, n):
    """The raw packets a sink left in ring `name` (its EOS ends them)."""
    ring = tshm.ShmRing.open(name)
    out = []
    while True:
        blob = ring.read(2000)
        if blob is None:
            break
        out.append(blob)
    ring.close()
    assert len(out) == n
    return out


def test_shmsink_writes_the_jax_packets(rng, name):
    """appsrc ! shmsink: the port writes the GDP packets the JAX package
    writes, byte for byte."""
    frames = rng.integers(0, 256, (4, 16, 24, 4), dtype=np.uint8)
    blobs = {}
    for pkg, launch in (("jax", gt.parse_launch),
                        ("torch", lambda d: gtt.parse_launch(d,
                                                             device="cpu"))):
        ring = f"{name}-{pkg}"
        p = launch("appsrc width=24 height=16 format=BGRx "
                   f"! shmsink socket-path={ring} shm-size=1048576")
        p.negotiate()
        p.elements[0].push_frames(frames)
        p.run(window=2)
        sink = p.elements[-1]
        sink.eos()
        try:
            blobs[pkg] = _packets(ring, 2)
        finally:
            sink._ring.close()
    assert blobs["torch"] == blobs["jax"]


def test_shm_pipeline_both_packages(rng, name):
    """appsrc ! shmsink then shmsrc ! burn ! fakesink, as in
    tests/test_transport.py, through each package: the same frames."""
    frames = rng.integers(0, 256, (4, 16, 24, 4), dtype=np.uint8)
    got = {}
    for pkg, launch in (("jax", gt.parse_launch),
                        ("torch", lambda d: gtt.parse_launch(d,
                                                             device="cpu"))):
        ring = f"{name}-{pkg}"
        p1 = launch("appsrc width=24 height=16 format=BGRx "
                    f"! shmsink socket-path={ring} shm-size=1048576")
        p1.negotiate()
        p1.elements[0].push_frames(frames)
        p1.run(window=2)
        p1.elements[-1].eos()
        try:
            p2 = launch(f"shmsrc socket-path={ring} timeout-ms=2000 "
                        "! burn ! fakesink")
            got[pkg] = _frames(p2.run(window=2))
            p2.elements[0]._ring.close()
        finally:
            p1.elements[-1]._ring.close()
    from gstbad_tpu.golden.gaudieffects import burn
    assert got["torch"].shape == (4, 16, 24, 4)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    for i in range(4):
        np.testing.assert_array_equal(got["torch"][i], burn(frames[i]))


def test_ipcpipeline_state_query_message_forwarding(rng, name):
    """The control plane (protocol.txt chunk types 1/2/6/7/8/9): the
    port's master forwards state changes and queries, its slave acks and
    answers, the slave's messages reach the master; then buffers."""
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat
    master = tipc.IpcMaster(name, slot_size=1 << 20, n_slots=4)
    seen = {"states": [], "events": []}

    def slave_main():
        slave = tipc.IpcSlave(
            name,
            on_state=lambda t: (seen["states"].append(t),
                                tipc.STATE_CHANGE_SUCCESS)[1],
            on_query=lambda q: {"result": True, "position": 42}
            if q["type"] == "position" else {"result": False},
            on_event=lambda e: seen["events"].append(e["type"]))
        slave.post_message({"name": "slave-ready"})
        n, datas = 0, []
        while True:
            got = slave.pull_buffer(5000)
            if got is None:
                break
            datas.append(got[0].data.numpy())
            n += got[0].batch
        slave.post_message({"name": "slave-done", "frames": n})
        seen["frames"], seen["data"] = n, datas
        slave.close()

    t = threading.Thread(target=slave_main, daemon=True)
    t.start()
    try:
        assert master.set_state("playing") == tipc.STATE_CHANGE_SUCCESS
        assert master.query({"type": "position"}) == {"result": True,
                                                      "position": 42}
        assert master.query({"type": "duration"}) == {"result": False}
        frames = rng.integers(0, 256, (3, 8, 8, 4), np.uint8)
        spec = MediaSpec(kind="video", format=VideoFormat.BGRx, width=8,
                         height=8)
        master.push_buffer(FrameBatch.make(torch.as_tensor(frames)), spec)
        master.send_eos()
        t.join(timeout=10)
        assert not t.is_alive() and seen["frames"] == 3
        np.testing.assert_array_equal(seen["data"][0], frames)
        assert seen["states"] == ["playing"]
        assert seen["events"] == ["eos"]
        names = [m.get("name") for m in master.poll_messages(timeout_ms=200)]
        assert "slave-ready" in names and "slave-done" in names
    finally:
        master.close()


def test_ipcpipeline_across_packages(rng, name):
    """The port's master drives the JAX package's slave: the same chunks
    on the same rings (state change, query, a buffer, EOS)."""
    from gstbad_tpu_torch.core.frame import FrameBatch
    from gstbad_tpu_torch.core.spec import MediaSpec
    master = tipc.IpcMaster(name, slot_size=1 << 20, n_slots=4)
    seen = {}

    def slave_main():
        slave = jipc.IpcSlave(name, on_query=lambda q: {"result": True,
                                                        "position": 7})
        got = slave.pull_buffer(5000)
        seen["data"] = np.asarray(got[0].data)
        seen["state"] = slave.state
        seen["eos"] = slave.pull_buffer(5000) is None
        slave.close()

    t = threading.Thread(target=slave_main, daemon=True)
    t.start()
    try:
        assert master.set_state("paused") == jipc.STATE_CHANGE_SUCCESS
        assert master.query({"type": "position"})["position"] == 7
        frames = rng.integers(0, 256, (2, 4, 6, 4), np.uint8)
        master.push_buffer(FrameBatch.make(torch.as_tensor(frames)),
                           MediaSpec(kind="video", format="BGRx", width=6,
                                     height=4))
        master.send_eos()
        t.join(timeout=10)
        assert not t.is_alive()
        np.testing.assert_array_equal(seen["data"], frames)
        assert seen["state"] == "paused" and seen["eos"]
    finally:
        master.close()


def test_ipcpipeline_elements_both_packages(rng, name):
    """ipcpipelinesink ! (rings) ! ipcpipelinesrc ! solarize through each
    package, both ends in one process: the same frames."""
    frames = rng.integers(0, 256, (4, 8, 12, 4), np.uint8)
    got = {}
    for pkg, launch in (("jax", gt.parse_launch),
                        ("torch", lambda d: gtt.parse_launch(d,
                                                             device="cpu"))):
        prefix = f"{name}-{pkg}"
        p1 = launch("appsrc width=12 height=8 format=BGRx "
                    f"! ipcpipelinesink name-prefix={prefix} "
                    "shm-size=1048576")
        p1.negotiate()
        p1.elements[0].push_frames(frames)
        p1.run(window=2)
        sink = p1.elements[-1]
        sink.eos()
        try:
            p2 = launch(f"ipcpipelinesrc name-prefix={prefix} "
                        "timeout-ms=3000 ! solarize ! fakesink")
            got[pkg] = _frames(p2.run(window=2))
            p2.elements[0].slave.close()
        finally:
            sink.master.close()
    from gstbad_tpu.golden.gaudieffects import solarize
    assert got["torch"].shape == (4, 8, 12, 4)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    for i in range(4):
        np.testing.assert_array_equal(got["torch"][i], solarize(frames[i]))


def test_transport_elements_registered_and_checked():
    names = set(gtt.element_names())
    assert {"shmsink", "shmsrc", "ipcpipelinesink",
            "ipcpipelinesrc"} <= names
    p = gtt.parse_launch("appsrc width=8 height=8 format=BGRx ! shmsink "
                         "shm-size=4 num-slots=8", device="cpu")
    with pytest.raises(ValueError, match="num-slots"):
        p.negotiate()
