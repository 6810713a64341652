"""Observability elements — fpsdisplaysink, videocodectestsink, debugspy
(gst/debugutils/) and netsim (gst/netsim/)."""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.ops import netsim as netsim_ops


def frame_bytes(data, i: int) -> bytes:
    """The bytes of frame i of host data: planar planes in sorted key
    order, packed frames as they are (the flow log and checksum order)."""
    if isinstance(data, dict):
        return b"".join(np.ascontiguousarray(data[k][i]).tobytes()
                        for k in sorted(data))
    return np.ascontiguousarray(data[i]).tobytes()


@register
class FpsDisplaySink(Element):
    """fpsdisplaysink (gst/debugutils/fpsdisplaysink.c:80-91): rendered/
    dropped counts and min/max/avg fps, posted as `fps-measurements`."""

    NAME = "fpsdisplaysink"
    KIND = "sink"
    HOST = True
    PROPERTIES = (Property("fps-update-interval", int, 500),)  # ms

    def __init__(self, **props):
        super().__init__(**props)
        self.frames_rendered = 0
        self.frames_dropped = 0
        self._t0 = None
        self._last_update = None
        self._last_frames = 0
        self.min_fps = float("inf")
        self.max_fps = 0.0

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = self._last_update = now
        self.frames_rendered += np_batch.batch
        interval = self.props["fps-update-interval"] / 1000.0
        if now - self._last_update >= interval:
            fps = ((self.frames_rendered - self._last_frames)
                   / (now - self._last_update))
            self.min_fps = min(self.min_fps, fps)
            self.max_fps = max(self.max_fps, fps)
            self._last_update = now
            self._last_frames = self.frames_rendered
            if bus is not None:
                elapsed = now - self._t0
                bus.post(Message(self.NAME, "fps-measurements",
                                 int(np_batch.pts[-1]),
                                 {"fps": fps,
                                  "drop-rate": 0.0,
                                  "avg-fps": self.frames_rendered / elapsed
                                  if elapsed else 0.0}))

    @property
    def average_fps(self):
        elapsed = time.monotonic() - self._t0 if self._t0 else 0
        return self.frames_rendered / elapsed if elapsed else 0.0


@register
class VideoCodecTestSink(Element):
    """videocodectestsink (gstvideocodectestsink.c:33-46,193-230): per-frame
    and whole-stream MD5 conformance checksums posted as `conformance`
    messages."""

    NAME = "videocodectestsink"
    KIND = "sink"
    HOST = True

    def __init__(self, **props):
        super().__init__(**props)
        self._stream_md5 = hashlib.md5()
        self.frame_checksums = []

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        for i in range(np_batch.batch):
            blob = frame_bytes(np_batch.data, i)
            digest = hashlib.md5(blob).hexdigest()
            self._stream_md5.update(blob)
            self.frame_checksums.append(digest)
            if bus is not None:
                bus.post(Message(self.NAME, "conformance",
                                 int(np_batch.pts[i]),
                                 {"checksum": digest}))

    @property
    def stream_checksum(self) -> str:
        return self._stream_md5.hexdigest()


@register
class DebugSpy(Element):
    """debugspy: posts a buffer-info message per frame (PTS, flags,
    checksum-free)."""

    NAME = "debugspy"
    PROPERTIES = (Property("silent", bool, False),)

    def process(self, params, state, batch: FrameBatch):
        msgs = {"buffer-info": {
            "_emit": (~params["silent"]).expand(batch.batch),
            "flags": batch.flags,
        }}
        return state, batch, msgs


@register
class NetSim(Element):
    """netsim (gst/netsim/gstnetsim.c): network fault injection — token
    bucket, drop-packets counter, drop/duplicate probability, delay with
    uniform/normal/gamma distributions, allow-reordering.

    Chain order matches the reference chain fn (gstnetsim.c:476-501):
    token bucket -> drop-packets -> drop-probability -> duplicate -> delay.
    Dropping uses the validity mask; duplicates emit a second gated slot,
    so the output window has 2B frames: the originals, then the
    duplicates.  The bucket and the counter walk the window in int64
    (ops/netsim.py netsim_bucket: a hand-written kernel on the card).

    Documented divergences (dataflow semantics on a batch machine):
    - delay applies to PTS rather than wall-clock transmission (the
      observable effect on a dataflow graph); allow-reordering=false
      enforces a monotone output-PTS floor (the reference's
      last_ready_time+1 rule, gstnetsim.c:371-373).
    - the token bucket meters stream time (PTS deltas) instead of the
      pipeline wall clock (gstnetsim.c:404-421) — deterministic and
      equivalent for a realtime stream.
    - distributions are sampled from a torch.Generator on the element's
      device seeded by `seed` (its state is carried), not GLib's Mersenne
      twister nor the JAX package's PRNG, so sequences differ for equal
      seeds; the distribution shapes match (normal: mu=(lo+hi)/2 with 95%
      CI at [lo,hi], gstnetsim.c:277-285; gamma: shape 1.25 scaled so
      P(x < hi-lo) = 0.95, gstnetsim.c:318-327)."""

    NAME = "netsim"
    GAMMA_SHAPE, GAMMA_R95 = 1.25, 3.4640381  # gstnetsim.c:323-325
    PROPERTIES = (
        Property("drop-probability", float, 0.0, 0.0, 1.0),
        Property("duplicate-probability", float, 0.0, 0.0, 1.0),
        Property("delay-probability", float, 0.0, 0.0, 1.0),
        Property("min-delay", int, 200),   # ms, DEFAULT_MIN_DELAY
        Property("max-delay", int, 400),   # ms, DEFAULT_MAX_DELAY
        Property("delay-distribution", str, "uniform", static=True),
        Property("drop-packets", int, 0, 0, None, static=True),
        Property("max-kbps", int, -1, -1, None),
        Property("max-bucket-size", int, -1, -1, None),  # Kb
        Property("allow-reordering", bool, True, static=True),
        Property("max-delay-ns", int, 0),  # legacy: uniform [0,ns) PTS shift
        Property("seed", int, 0, static=True),
    )
    _FLOOR = -(2 ** 62)

    def prepare(self) -> None:
        if self.props["delay-distribution"] not in ("uniform", "normal",
                                                    "gamma"):
            raise ValueError("netsim: unknown delay-distribution "
                             f"{self.props['delay-distribution']!r}")
        self._gen = torch.Generator(device=self.device)

    def init_state(self, batch: int):
        mbs = self.props["max-bucket-size"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.props["seed"])

        def i64(*v):
            return torch.tensor(v, dtype=torch.int64, device=self.device)
        # setting max-bucket-size starts the bucket full
        # (gstnetsim.c:538-540)
        return {"rng": gen.get_state(),
                "carry": i64(mbs * 1000 if mbs > 0 else 0, -1,
                             self.props["drop-packets"]),
                "last_ready": i64(self._FLOOR)[0]}

    def _delay_ms(self, shape, params, gen):
        """One delay draw per slot, in ms (float64)."""
        dev = self.device
        lo = params["min-delay"].to(torch.float64)
        hi = params["max-delay"].to(torch.float64)
        dist = self.props["delay-distribution"]
        if dist == "uniform":
            # g_rand_int_range(min, max+1), gstnetsim.c:244-247
            u = torch.rand(shape, generator=gen, dtype=torch.float64,
                           device=dev)
            d = torch.floor(u * (hi - lo + 1.0)) + lo
        elif dist == "normal":
            mu = (hi + lo) / 2.0
            sigma = (hi - lo) / (2 * 1.96)
            d = torch.round(torch.randn(shape, generator=gen,
                                        dtype=torch.float64, device=dev)
                            * sigma + mu)
        else:
            scale = (hi - lo) / self.GAMMA_R95
            d = torch.round(netsim_ops.gamma(shape, self.GAMMA_SHAPE, gen,
                                             dev) * scale + lo)
        return d.clamp(min=0.0)  # gstnetsim.c:363-364

    @staticmethod
    def _frame_bits(batch: FrameBatch) -> int:
        """A frame's data bits: every data plane's bytes (the JAX package's
        tree_leaves(batch.data))."""
        planes = (batch.data.values() if isinstance(batch.data, dict)
                  else [batch.data])
        b = batch.batch
        return sum(t.numel() // b * t.element_size() for t in planes) * 8

    def process(self, params, state, batch: FrameBatch):
        b = batch.batch
        dev = self.device
        keep, carry = netsim_ops.netsim_bucket(
            batch.pts, batch.valid, self._frame_bits(batch),
            params["max-kbps"], params["max-bucket-size"], state["carry"])

        # probabilistic drop / duplicate / delay
        gen = self._gen
        gen.set_state(state["rng"].cpu())

        def uniform(dtype=torch.float32):
            return torch.rand(b, generator=gen, dtype=dtype, device=dev)
        drop = uniform() < params["drop-probability"]
        dup = uniform() < params["duplicate-probability"]
        delayed = uniform() < params["delay-probability"]
        delay_ns = (self._delay_ms((b, 2), params, gen)
                    * 1_000_000).to(torch.int64)
        legacy = (uniform(torch.float64)
                  * params["max-delay-ns"].to(torch.float64)
                  ).to(torch.int64)
        rng = gen.get_state()
        # original and its duplicate get independent delay draws
        # (both pushes go through delay_buffer, gstnetsim.c:494-496)
        zero = torch.zeros_like(batch.pts)
        pts0 = batch.pts + torch.where(delayed, delay_ns[:, 0], zero) + legacy
        pts1 = batch.pts + torch.where(delayed, delay_ns[:, 1], zero) + legacy

        valid0 = keep & ~drop
        valid1 = valid0 & dup
        pts = torch.cat([pts0, pts1])
        valid = torch.cat([valid0, valid1])
        last_ready = state["last_ready"]
        if not self.props["allow-reordering"]:
            # monotone ready-time floor over emitted packets
            low = torch.full_like(pts, self._FLOOR)
            floor = torch.cummax(torch.where(valid, pts, low), 0)[0]
            floor = torch.maximum(floor, last_ready)
            pts = torch.where(valid & (pts < floor), floor + 1, pts)
            last_ready = torch.maximum(
                torch.where(valid, pts, low).max(), last_ready)

        def dup2(x):
            if x.ndim >= 1 and x.shape[0] == b:
                return torch.cat([x, x])
            return x

        data = ({k: dup2(v) for k, v in batch.data.items()}
                if isinstance(batch.data, dict) else dup2(batch.data))
        out = FrameBatch(data=data, pts=pts,
                         flags=torch.cat([batch.flags, batch.flags]),
                         valid=valid)
        return {"rng": rng, "carry": carry, "last_ready": last_ready}, out
