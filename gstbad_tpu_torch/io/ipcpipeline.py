"""ipcpipeline analog (sys/ipcpipeline/) — cross-process pipeline split
with full control-plane forwarding.

The reference splits one logical pipeline across processes over an fd
socket: ipcpipelinesink (master end) serializes every buffer, event, query
and STATE CHANGE as typed chunks; ipcpipelinesrc (slave end) replays them
and acks carry GstFlowReturn / state-change results back upstream
(sys/ipcpipeline/protocol.txt:1-60; chunk types 7/8 are state change /
state lost).

Here the transport is the shared-memory ring (io/shm.py over
csrc/shmring.cpp), one ring per direction:
  <name>.down : master -> slave   (buffers, events, queries, state changes)
  <name>.up   : slave  -> master  (acks, query results, messages)
The ring's semaphore counts already provide the reference's
per-buffer-ack backpressure, so buffer chunks are not individually acked;
state changes and queries are synchronous RPCs with request-id-matched
acks, exactly the protocol's request/reply discipline.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.io import gdp
from gstbad_tpu_torch.io.shm import ShmRing

STATE_CHANGE_SUCCESS = 1  # GstStateChangeReturn analog
STATE_CHANGE_FAILURE = 0


class IpcMaster:
    """The ipcpipelinesink endpoint: owns both rings."""

    def __init__(self, name: str, slot_size: int = 64 * 1024 * 1024,
                 n_slots: int = 8):
        self.down = ShmRing.create(f"{name}.down", slot_size, n_slots)
        self.up = ShmRing.create(f"{name}.up", 1 << 20, n_slots)
        self._req = 0
        self._stash = []  # out-of-band chunks read while awaiting an ack
        self._lock = threading.Lock()

    def _next_req(self) -> int:
        self._req += 1
        return self._req

    def push_buffer(self, batch: FrameBatch, spec: MediaSpec) -> None:
        self.down.write(gdp.pack_chunk(gdp.CHUNK_BUFFER, self._next_req(),
                                       gdp.pay(batch, spec)))

    def send_event(self, event: dict) -> None:
        self.down.write(gdp.pack_json_chunk(gdp.CHUNK_EVENT,
                                            self._next_req(), event))

    def send_eos(self) -> None:
        self.send_event({"type": "eos"})
        self.down.eos()

    def _rpc(self, ctype: int, obj: dict, timeout_ms: int):
        """Send a chunk and block for its request-id-matched reply,
        stashing interleaved messages for poll_messages."""
        with self._lock:
            req = self._next_req()
            self.down.write(gdp.pack_json_chunk(ctype, req, obj))
            while True:
                blob = self.up.read(timeout_ms)
                if blob is None:
                    raise EOFError("ipcpipeline: slave closed during rpc")
                rtype, rreq, payload = gdp.unpack_chunk(blob)
                if rreq == req and rtype in (gdp.CHUNK_ACK,
                                             gdp.CHUNK_QUERY_RESULT):
                    return gdp.unpack_json(payload)
                self._stash.append((rtype, rreq, payload))

    def set_state(self, target: str, timeout_ms: int = 10000) -> int:
        """Forward a state change (chunk type 7); returns the
        GstStateChangeReturn-analog result from the slave's ack."""
        return self._rpc(gdp.CHUNK_STATE_CHANGE, {"target": target},
                         timeout_ms)["result"]

    def query(self, query: dict, timeout_ms: int = 10000) -> dict:
        """Forward a query (chunk type 6); returns the result structure."""
        return self._rpc(gdp.CHUNK_QUERY, query, timeout_ms)

    def poll_messages(self, bus=None, timeout_ms: int = 0) -> list:
        """Drain slave messages (chunk types 8/9/10).  With a bus, also
        posts them (the master-bus forwarding of the reference)."""
        out = []
        chunks, self._stash = self._stash, []
        while True:
            try:
                blob = self.up.read(timeout_ms)
            except TimeoutError:
                break
            if blob is None:
                break
            chunks.append(gdp.unpack_chunk(blob))
            timeout_ms = 0
        for ctype, _req, payload in chunks:
            if ctype in (gdp.CHUNK_MESSAGE, gdp.CHUNK_ERROR_MESSAGE,
                         gdp.CHUNK_STATE_LOST):
                msg = gdp.unpack_json(payload)
                msg["_chunk"] = ctype
                out.append(msg)
                if bus is not None:
                    bus.post(Message("ipcpipelinesink",
                                     msg.get("name", "ipc-message"), 0, msg))
        return out

    def close(self):
        self.down.close()
        self.up.close()


class IpcSlave:
    """The ipcpipelinesrc endpoint: serves the control plane and yields
    buffers.  Handlers run on the caller's pull thread (the slave
    pipeline's streaming thread analog)."""

    def __init__(self, name: str,
                 on_state: Optional[Callable[[str], int]] = None,
                 on_query: Optional[Callable[[dict], dict]] = None,
                 on_event: Optional[Callable[[dict], None]] = None):
        self.down = ShmRing.open(f"{name}.down")
        self.up = ShmRing.open(f"{name}.up")
        self.on_state = on_state or (lambda target: STATE_CHANGE_SUCCESS)
        self.on_query = on_query or (lambda q: {"result": False})
        self.on_event = on_event or (lambda e: None)
        self.state = "null"
        self.eos = False

    def post_message(self, msg: dict, error: bool = False) -> None:
        """Slave bus -> master bus (chunk type 9/10)."""
        self.up.write(gdp.pack_json_chunk(
            gdp.CHUNK_ERROR_MESSAGE if error else gdp.CHUNK_MESSAGE, 0, msg))

    def post_state_lost(self) -> None:
        self.up.write(gdp.pack_json_chunk(gdp.CHUNK_STATE_LOST, 0,
                                          {"state": self.state}))

    def pull_buffer(self, timeout_ms: int = 5000, device="cpu"):
        """Serve control chunks until the next buffer (or EOS -> None): a
        (FrameBatch on `device`, MediaSpec) pair."""
        while True:
            blob = self.down.read(timeout_ms)
            if blob is None:
                self.eos = True
                return None
            ctype, req, payload = gdp.unpack_chunk(blob)
            if ctype == gdp.CHUNK_BUFFER:
                return gdp.depay(payload, device)
            if ctype == gdp.CHUNK_STATE_CHANGE:
                target = gdp.unpack_json(payload)["target"]
                result = self.on_state(target)
                if result != STATE_CHANGE_FAILURE:
                    self.state = target
                self.up.write(gdp.pack_json_chunk(
                    gdp.CHUNK_ACK, req, {"result": result}))
            elif ctype == gdp.CHUNK_QUERY:
                res = self.on_query(gdp.unpack_json(payload))
                self.up.write(gdp.pack_json_chunk(
                    gdp.CHUNK_QUERY_RESULT, req, res))
            elif ctype in (gdp.CHUNK_EVENT, gdp.CHUNK_SINK_MESSAGE_EVENT):
                ev = gdp.unpack_json(payload)
                self.on_event(ev)
                if ev.get("type") == "eos":
                    self.eos = True
                    return None
            # unknown chunks are skipped, like the reference's default case

    def close(self):
        self.down.close()
        self.up.close()


@register
class IpcPipelineSink(Element):
    """ipcpipelinesink: master half of a cross-process pipeline.  Buffers
    flow through host_process; `.master` exposes set_state/query/
    poll_messages for the session layer (the reference forwards these
    transparently from the master pipeline's state machine)."""

    NAME = "ipcpipelinesink"
    KIND = "sink"
    HOST = True
    ELEMENTWISE = True
    PROPERTIES = (
        Property("name-prefix", str, "gstbad-ipc", static=True),
        Property("shm-size", int, 64 * 1024 * 1024, static=True),
        Property("num-slots", int, 8, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.master: Optional[IpcMaster] = None

    def prepare(self):
        if self.master is None:
            # shm-size = total area (reference shmsink semantics,
            # gstshmsink.c:402-405); per-slot share below
            slot = self.props["shm-size"] // self.props["num-slots"]
            if slot <= 0:
                raise ValueError("shm-size smaller than num-slots")
            self.master = IpcMaster(self.props["name-prefix"],
                                    slot, self.props["num-slots"])

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        self.master.push_buffer(np_batch, self.out_spec)
        if bus is not None:
            self.master.poll_messages(bus)

    def eos(self) -> None:
        if self.master:
            self.master.send_eos()


@register
class IpcPipelineSrc(Element):
    """ipcpipelinesrc: slave half.  State changes and queries from the
    master are served on the pull thread; defaults ack SUCCESS and answer
    position queries from the last seen PTS."""

    NAME = "ipcpipelinesrc"
    KIND = "host-source"
    ELEMENTWISE = True
    PROPERTIES = (
        Property("name-prefix", str, "gstbad-ipc", static=True),
        Property("timeout-ms", int, 10000, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.slave: Optional[IpcSlave] = None
        self._pending = None
        self._spec = None
        self._last_pts = 0

    def _default_query(self, q: dict) -> dict:
        if q.get("type") == "position":
            return {"result": True, "position": self._last_pts}
        return {"result": False}

    def negotiate(self, in_spec):
        if self.slave is None:
            self.slave = IpcSlave(self.props["name-prefix"],
                                  on_query=self._default_query)
        got = self.slave.pull_buffer(self.props["timeout-ms"], self.device)
        if got is None:
            raise EOFError("ipcpipelinesrc: EOS before first buffer")
        self._pending, self._spec = got
        return self._spec

    def pull_window(self, window: int) -> Optional[FrameBatch]:
        if self._pending is not None:
            batch, self._pending = self._pending, None
        else:
            got = self.slave.pull_buffer(self.props["timeout-ms"],
                                         self.device)
            if got is None:
                return None
            batch = got[0]
        pts = batch.pts.cpu().numpy()
        if pts.size:
            self._last_pts = int(pts[-1])
        return batch

    def process(self, params, state, batch):
        return state, batch
