"""audiobuffersplit (gst/audiobuffersplit/): exact-duration re-chunker.

Each window re-chunks its B*S samples plus the carried remainder into
fixed-size output blocks, with a validity mask for the partial tail
(gstaudiobuffersplit.c:99-155), the GstAudioStreamAlign discont/resync
timeline and the gapless silence/drop path (:543-625), as the JAX
package does.  Every decision is tensor arithmetic on the device: the
positions the window writes are index tensors, so nothing waits for the
host.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from gstbad_tpu_torch.core.element import AudioFilter, Property
from gstbad_tpu_torch.core.frame import FLAG_DISCONT, FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import AudioFormat, MediaSpec

_DTYPES = {AudioFormat.S16: torch.int16, AudioFormat.S32: torch.int32,
           AudioFormat.F32: torch.float32, AudioFormat.F64: torch.float64}


@register
class AudioBufferSplit(AudioFilter):
    NAME = "audiobuffersplit"
    FORMATS = AudioFormat.ALL
    PROPERTIES = (
        Property("output-buffer-duration", str, "1/50", static=True,
                 doc="seconds, as a fraction (default 20 ms)"),
        # a timestamp drift beyond alignment-threshold sustained for
        # discont-wait resyncs the output timeline to the input pts
        Property("alignment-threshold", int, 40_000_000),   # ns, 40 ms
        Property("discont-wait", int, 1_000_000_000),       # ns, 1 s
        Property("strict-buffer-size", bool, False, static=True),
        # gapless: a discont inserts silence (bounded by max-silence-time,
        # also the window's static silence budget) or drops samples
        Property("gapless", bool, False, static=True),
        Property("max-silence-time", int, 0, static=True),  # ns
    )

    def negotiate(self, in_spec: MediaSpec) -> MediaSpec:
        frac = Fraction(self.props["output-buffer-duration"])
        self._out_samples = int(in_spec.rate * frac)
        if self._out_samples < 1:
            raise ValueError("output-buffer-duration too small")
        return in_spec

    def _sil_budget(self) -> int:
        if not self.props["gapless"]:
            return 0
        return int(self.props["max-silence-time"] * self.in_spec.rate
                   // 1_000_000_000)

    def init_state(self, batch: int):
        dev = self.device

        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=dev)

        st = {"rem": torch.zeros((self._out_samples, self.in_spec.channels),
                                 dtype=_DTYPES[self.in_spec.format],
                                 device=dev),
              "rem_fill": torch.zeros((), dtype=torch.int32, device=dev),
              "next_pts": i64(0),
              "have_pts": torch.zeros((), dtype=torch.bool, device=dev),
              "next_in_pts": i64(0),
              "misaligned_since": i64(-1)}
        if self.props["gapless"]:
            st["drop_pending"] = i64(0)
        return st

    def process(self, params, state, batch: FrameBatch):
        b, s, c = batch.data.shape
        dev = batch.data.device
        so = self._out_samples
        rate = self.in_spec.rate
        n_in = b * s
        n_out = (n_in + so + self._sil_budget()) // so
        flat = batch.data.reshape(n_in, c)
        buf = torch.zeros((n_out * so + so, c), dtype=flat.dtype, device=dev)
        buf[:so] = state["rem"]
        ar_in = torch.arange(n_in, device=dev)
        in_pts = batch.pts[0]
        if self.props["gapless"]:
            explicit = (batch.flags[0] & FLAG_DISCONT) != 0
            gap = in_pts - state["next_in_pts"]
            trigger = state["have_pts"] & (
                explicit | (gap.abs() > params["alignment-threshold"]))
            fwd, back = trigger & (gap > 0), trigger & (gap < 0)
            sil_n = torch.where(fwd, gap * rate // 1_000_000_000, 0)
            sil_time = sil_n * 1_000_000_000 // rate
            # a gap beyond max-silence-time is not filled: it falls
            # through to the discont/resync path, as in the reference
            do_sil = fwd & (sil_time <= self.props["max-silence-time"])
            sil_n = torch.where(do_sil, torch.clamp(
                sil_n, max=self._sil_budget()), 0)
            new_drop = torch.where(back, (-gap) * rate // 1_000_000_000, 0)
            total_drop = state["drop_pending"] + new_drop
            drop_used = torch.clamp(total_drop, max=n_in)
            drop_pending = total_drop - drop_used
            handled = do_sil | back
            flat_eff = flat[(ar_in + drop_used) % n_in]   # roll by -drop
            pos = state["rem_fill"] + sil_n.to(torch.int32)
            buf[pos + ar_in] = flat_eff
            fill = (pos + n_in - drop_used).to(torch.int32)
        else:
            handled = torch.zeros((), dtype=torch.bool, device=dev)
            drop_pending = None
            buf[state["rem_fill"] + ar_in] = flat
            fill = state["rem_fill"] + n_in
        n_full = torch.div(fill, so, rounding_mode="floor")
        blocks = buf[:n_out * so].reshape(n_out, so, c)
        valid = torch.arange(n_out, device=dev) < n_full
        tail_start = n_full * so
        rem_fill = fill - tail_start
        ar_so = torch.arange(so, device=dev)
        rem = torch.where((ar_so < rem_fill)[:, None],
                          buf[torch.clamp(tail_start + ar_so,
                                          max=buf.shape[0] - 1)],
                          torch.zeros((), dtype=flat.dtype, device=dev))
        # the output timeline: continuous from the first input pts; a
        # drift beyond alignment-threshold sustained past discont-wait
        # resyncs it to the input pts (GstAudioStreamAlign)
        drift = (in_pts - state["next_in_pts"]).abs()
        misaligned = state["have_pts"] & (
            drift > params["alignment-threshold"])
        since = torch.where(misaligned,
                            torch.where(state["misaligned_since"] >= 0,
                                        state["misaligned_since"], in_pts),
                            -1)
        resync = misaligned & (since >= 0) & (
            in_pts - since >= params["discont-wait"]) & ~handled
        since = torch.where(handled, -1, since)
        base = torch.where(resync, in_pts, state["next_pts"])
        since = torch.where(resync, -1, since)
        first_pts = torch.where(state["have_pts"], base, in_pts)
        dur = int(round(1e9 * so / rate))
        pts = first_pts + torch.arange(n_out, dtype=torch.int64,
                                       device=dev) * dur
        next_pts = first_pts + n_full.to(torch.int64) * dur
        in_dur = (n_in * 1_000_000_000) // rate
        # the expected input position follows the aligned timeline; only
        # a resync (or the stream's start) re-anchors it to the input pts
        next_in = torch.where(resync | handled | ~state["have_pts"],
                              in_pts + in_dur, state["next_in_pts"] + in_dur)
        new_state = {"rem": rem, "rem_fill": rem_fill.to(torch.int32),
                     "next_pts": next_pts,
                     "have_pts": torch.ones((), dtype=torch.bool,
                                            device=dev),
                     "next_in_pts": next_in, "misaligned_since": since}
        if drop_pending is not None:
            new_state["drop_pending"] = drop_pending
        flags = torch.zeros(n_out, dtype=torch.int32, device=dev)
        flags[0] = torch.where(resync, FLAG_DISCONT, 0)
        return new_state, FrameBatch(data=blocks, pts=pts, flags=flags,
                                     valid=valid)
