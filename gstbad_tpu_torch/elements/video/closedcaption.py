"""Closed-caption elements (ext/closedcaption/): cccombiner, ccextractor,
line21encoder, line21decoder, ccconverter and ceaccoverlay, the torch
form of gstbad_tpu/elements/video/closedcaption.py.

Caption bytes travel as a `"cc"` plane of planar video batches: [B, 6] u8
in the CEA-608 S334-1A layout (two triplets: field byte with 0x80 =
field 1 and a 5-bit line offset, then two data bytes).

line21encoder renders both fields' waveforms (ops/line21.py) into luma
rows 21/22 (height 525) or 1/2 (486); line21decoder probes the first 40
rows for two consecutive caption lines.  ccconverter converts between
raw pairs, S334-1A triplets, cc_data and CDP packets; its walk runs on
the host in both modes, over a window's caption bytes after one download
of a few hundred bytes, with its counters in int64 and int32 as the JAX
package's x64 code keeps them: a loop of per-frame torch ops on the card
would cost thousands of launches a window.  ceaccoverlay decodes
CEA-708 on the host (io/cea708.py) and blends the snapshots active in
the window with H4 (ops/overlay.py), uploaded on demand as
dvbsuboverlay's sets are.
"""

from __future__ import annotations

import dataclasses
import fractions

import numpy as np
import torch

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import VideoFormat, require
from gstbad_tpu_torch.elements.video.overlay import blend_timed
from gstbad_tpu_torch.ops import line21 as l21ops
from gstbad_tpu_torch.ops import overlay as ovops

MAX_LINE_PROBES = 40     # gstline21dec.c:230
_I32_MIN = -2 ** 31      # what an XLA gather fills an out-of-range index with


def _vbi_row(height: int) -> int:
    """Field-1 waveform row (gstline21enc.c:517-520)."""
    return 21 if height == 525 else 1


@register
class CcCombiner(Element):
    """cccombiner (gstcccombiner.c): attach a caption stream's bytes to
    the video frames.  Inputs: [video (planar), captions ([B, 6] u8
    S334-1A)]; the output video gains the "cc" plane."""

    NAME = "cccombiner"
    N_INPUTS = 2

    def negotiate(self, in_spec):
        require(isinstance(in_spec, list) and len(in_spec) == 2,
                "cccombiner: needs (video, captions) inputs")
        video, _cap = in_spec
        require(video.kind == "video", "cccombiner: first input is video")
        self._planar = video.format in (VideoFormat.I420, "I420")
        require(self._planar or isinstance(video.format, str),
                "cccombiner: video input required")
        return video

    def process(self, params, state, batches):
        video, caps = batches
        cc = caps.data
        if cc.dim() == 3:            # [B, 2, 3] triplets -> [B, 6]
            cc = cc.reshape(cc.shape[0], -1)
        require(isinstance(video.data, dict),
                "cccombiner: planar video required (use videoconvert "
                "format=I420)")
        return state, video.with_data({**video.data,
                                       "cc": cc.to(torch.uint8)})


@register
class CcExtractor(Element):
    """ccextractor (gstccextractor.c): the caption bytes post as per-frame
    `cc-data` messages; remove-caption-meta drops the "cc" plane."""

    NAME = "ccextractor"
    PROPERTIES = (
        Property("remove-caption-meta", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video", "ccextractor: needs video")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        if not isinstance(batch.data, dict) or "cc" not in batch.data:
            return state, batch
        cc = batch.data["cc"]
        msgs = {"cc-data": {"data": cc,
                            "_emit": torch.ones(batch.batch,
                                                dtype=torch.bool,
                                                device=cc.device)}}
        out = batch
        if self.props["remove-caption-meta"]:
            out = batch.with_data(
                {k: v for k, v in batch.data.items() if k != "cc"})
        return state, out, msgs


@register
class Line21Encoder(Element):
    """line21encoder (gstline21enc.c)."""

    NAME = "line21encoder"
    PROPERTIES = (
        Property("remove-caption-meta", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "line21encoder: needs I420 (use videoconvert)")
        require(in_spec.width == 720,
                "line21encoder: only 720 pixel wide formats are supported"
                " (gstline21enc.c:49)")
        require(in_spec.height in (525, 486),
                "line21encoder: height must be 525 or 486")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        data = batch.data
        b = batch.batch
        dev = data["y"].device
        pad = torch.full((b, 2), 0x80, dtype=torch.int32, device=dev)
        if "cc" in data:
            cc = data["cc"].to(torch.int32)            # [B, 6] S334-1A
            f1_sel = ((cc[:, 0] & 0x80) != 0)[:, None]
            t1 = cc[:, 1:3]
            t2_is_f1 = ((cc[:, 3] & 0x80) != 0)[:, None]
            t2 = cc[:, 4:6]
            f1 = torch.where(f1_sel, t1, torch.where(t2_is_f1, t2, pad))
            f2 = torch.where(~t2_is_f1, t2, torch.where(~f1_sel, t1, pad))
        else:
            f1 = f2 = pad
        wave1 = l21ops.encode_lines(f1.to(torch.uint8))
        wave2 = l21ops.encode_lines(f2.to(torch.uint8))
        row = _vbi_row(self.out_spec.height)
        y = data["y"].clone()
        y[:, row, :] = wave1
        y[:, row + 1, :] = wave2
        out = {**data, "y": y}
        if self.props["remove-caption-meta"]:
            out.pop("cc", None)
        return state, batch.with_data(out)


@register
class Line21Decoder(Element):
    """line21decoder (gstline21dec.c)."""

    NAME = "line21decoder"
    PROPERTIES = (
        Property("mode", str, "add", static=True,
                 doc="disabled | add | drop | replace "
                     "(gstline21dec.c:76-101)"),
        Property("ntsc-only", bool, False, static=True),
    )

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.I420,
                "line21decoder: needs I420 (use videoconvert)")
        self._compatible = in_spec.width == 720 and in_spec.height >= 200
        if self.props["ntsc-only"]:
            self._compatible &= in_spec.height in (525, 486)
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        mode = self.props["mode"]
        has_meta = isinstance(batch.data, dict) and "cc" in batch.data
        if (not self._compatible or mode == "disabled"
                or (mode == "drop" and has_meta)):
            return state, batch
        y = batch.data["y"]
        b, h, _ = y.shape
        dev = y.device
        n = min(MAX_LINE_PROBES, h - 1)
        found, pairs = l21ops.decode_lines(y[:, :n + 1, :])
        both = found[:, :n] & found[:, 1:n + 1]        # consecutive pair
        hit = both.any(1)
        off = torch.argmax(both.to(torch.int32), 1)
        rows = torch.arange(b, device=dev)
        f1 = pairs[rows, off].to(torch.int32)
        f2 = pairs[rows, off + 1].to(torch.int32)
        off = off.to(torch.int32)
        # S334-1A bytes with the line-offset fields (gstline21dec.c:550)
        base1 = 9 if h == 525 else (5 if h == 625 else 0)
        base2 = 272 if h == 525 else (318 if h == 625 else 0)
        zero = torch.zeros_like(off)
        o1 = torch.where(off > base1, off - base1, zero) & 0x1F
        o2 = torch.where(off > base2, off - base2, zero) & 0x1F
        cc = torch.stack([0x80 | o1, f1[:, 0], f1[:, 1], o2, f2[:, 0],
                          f2[:, 1]], 1).to(torch.uint8)
        blank = torch.tensor([0x80, 0x80, 0x80, 0x00, 0x80, 0x80],
                             dtype=torch.uint8, device=dev).expand(b, 6)
        cc = torch.where(hit[:, None], cc, blank)
        out = dict(batch.data)
        if not (has_meta and mode == "add"):       # add keeps the meta
            out["cc"] = cc
        msgs = {"line21": {"cc": cc, "_emit": hit}}
        return state, batch.with_data(out), msgs


# -- ccconverter's host walk --------------------------------------------------

def _pack(sel, cols, size):
    """Order-preserving pack of the selected rows of cols (k arrays) into
    a flat [size] buffer: the scatter of the JAX package's
    _xr_pack_pairs/_xr_pack_trips, its out-of-range writes dropped and
    the unselected rows' writes at size.. cut.  -> (buf, nbytes)."""
    k = len(cols)
    buf = np.zeros(size + k, np.int64)
    pos = 0
    for r in np.flatnonzero(sel):
        for j in range(k):
            if k * pos + j < size + k:
                buf[k * pos + j] = cols[j][r]
        pos += 1
    return buf[:size], k * int(np.count_nonzero(sel))


def _concat(a, alen, b, blen, size):
    i = np.arange(size)
    av = a[np.clip(i, 0, a.shape[0] - 1)]
    bv = b[np.clip(i - alen, 0, b.shape[0] - 1)]
    return (np.where(i < alen, av, np.where(i < alen + blen, bv, 0)),
            alen + blen)


def _tail(buf, off, n, size):
    i = np.arange(size)
    v = buf[np.clip(i + off, 0, buf.shape[0] - 1)]
    return np.where(i < n, v, 0)


def _take(a, i):
    """a[i], or the gather's fill value where i is past the end."""
    return int(a[i]) if 0 <= i < a.shape[0] else _I32_MIN


def _i32(x):
    return int(np.int64(x).astype(np.int32))


@register
class CcConverter(Element):
    """ccconverter (gstccconverter.c): convert the caption representation
    between raw CEA-608 pairs, S334-1A triplets, CEA-708 cc_data and CDP
    packets, picked by input-type/output-type.  CDP packets carry the
    running cdp_hdr_sequence_cntr as element state and the additive
    checksum (gstccconverter.c:1137-1152); timecode sections are skipped
    on input and never written.  With output-framerate the
    cross-framerate engine (io/ccconv.py is its byte-level spec) turns
    each input frame into up to `slots` output frames, the ones not
    emitted invalid."""

    NAME = "ccconverter"
    PROPERTIES = (
        Property("input-type", str, "s334-1a", static=True,
                 doc="raw | s334-1a | cc-data | cdp"),
        Property("output-type", str, "cdp", static=True),
        Property("output-framerate", str, "", static=True,
                 doc="N/D target rate: the cross-framerate engine.  "
                     "Needs CDP on at least one side "
                     "(gstccconverter.c:131-270) and a standalone [B, W] "
                     "caption stream"),
    )

    def _fps(self):
        from gstbad_tpu_torch.io.cea608 import CDP_FPS_TABLE
        fr = self.out_spec.framerate
        key = (fr.numerator, fr.denominator)
        require(key in CDP_FPS_TABLE,
                f"ccconverter: no CDP framerate entry for {fr} "
                "(gstccconverter.c:483-492)")
        return CDP_FPS_TABLE[key]

    def negotiate(self, in_spec):
        for p in ("input-type", "output-type"):
            require(self.props[p] in ("raw", "s334-1a", "cc-data", "cdp"),
                    f"ccconverter: bad {p} {self.props[p]!r}")
        self._xr = False
        of = self.props["output-framerate"]
        if of:
            from gstbad_tpu_torch.io.ccconv import FPS_ENTRIES
            it, ot = self.props["input-type"], self.props["output-type"]
            num, den = ([int(x) for x in of.split("/")] if "/" in of
                        else [int(of), 1])
            infr = in_spec.framerate
            self._in_fps = (infr.numerator, infr.denominator)
            self._out_fps = (num, den)
            if self._in_fps == self._out_fps:
                return in_spec           # nothing to convert
            require(it == "cdp" or ot == "cdp",
                    "ccconverter: framerate conversion needs CDP on one "
                    "side (gstccconverter.c:131-270)")
            in_e = FPS_ENTRIES.get(self._in_fps)
            out_e = FPS_ENTRIES.get(self._out_fps)
            require(it != "cdp" or in_e is not None,
                    f"ccconverter: {infr} is not a CDP framerate")
            require(ot != "cdp" or out_e is not None,
                    f"ccconverter: {of} is not a CDP framerate")
            self._in_e = in_e or out_e
            self._out_e = out_e or in_e
            ratio = fractions.Fraction(num, den) / fractions.Fraction(
                *self._in_fps)
            # equal max_cc_count entries convert 1:1 (no generate loop)
            self._slots = 1 if self._in_e[1] == self._out_e[1] \
                else int(np.ceil(ratio)) + 1
            self._xr = True
            return dataclasses.replace(
                in_spec, framerate=fractions.Fraction(num, den))
        return in_spec

    def init_state(self, window: int):
        dev = self.device
        i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                     device=dev)
        if getattr(self, "_xr", False):
            return {
                "seq": i32(0),
                "inf": torch.tensor(0, dtype=torch.int64, device=dev),
                "outf": torch.tensor(1, dtype=torch.int64, device=dev),
                "sc_ccp": torch.zeros(384, dtype=torch.int32, device=dev),
                "sc_ccp_len": i32(0),
                "sc_c1": torch.zeros(64, dtype=torch.int32, device=dev),
                "sc_c1_len": i32(0),
                "sc_c2": torch.zeros(64, dtype=torch.int32, device=dev),
                "sc_c2_len": i32(0),
            }
        return i32(0)      # cdp_hdr_sequence_cntr

    # -- the fixed-2-triplet transforms, on the host --------------------

    @staticmethod
    def _to_s334(cc, kind):
        b = cc.shape[0]
        if kind == "s334-1a":
            return cc
        if kind == "raw":                    # field-1 pairs
            n = cc.shape[1] // 2
            out = np.zeros((b, 3 * n), np.int64)
            out[:, 0::3] = 0x80
            out[:, 1::3] = cc[:, 0:2 * n:2]
            out[:, 2::3] = cc[:, 1:2 * n:2]
            return out
        if kind == "cc-data":
            n = cc.shape[1] // 3
            trips = cc[:, :3 * n].reshape(b, n, 3)
        else:
            # cdp: the cc_data section starts at 9, or 14 after a
            # timecode section, per frame
            base = np.where((cc[:, 4] & 0x80) != 0, 14, 9)
            idx = base[:, None] + np.arange(6)[None, :]
            trips = np.where(idx < cc.shape[1],
                             np.take_along_axis(
                                 cc, np.minimum(idx, cc.shape[1] - 1), 1),
                             _I32_MIN).reshape(b, 2, 3)
        hdr = trips[..., 0]
        valid = (hdr & 0x04) == 0x04
        typ = hdr & 0x03
        keep = (valid & (typ <= 1))[..., None]
        out = np.stack([np.where(valid & (typ == 0), 0x80, 0x00),
                        *np.moveaxis(np.where(keep, trips[..., 1:], 0x80),
                                     -1, 0)], -1)
        return out.reshape(b, -1)

    def _from_s334(self, s334, kind, seq):
        b = s334.shape[0]
        n = s334.shape[1] // 3
        if kind == "s334-1a":
            return s334, seq
        s334 = s334[:, :3 * n]
        f1 = (s334[:, 0::3] & 0x80) != 0
        if kind == "raw":
            # field-1 pairs only; other slots pad 0x80 (fixed shape)
            out = np.full((b, 2 * n), 0x80, np.int64)
            out[:, 0::2] = np.where(f1, s334[:, 1::3], 0x80)
            out[:, 1::2] = np.where(f1, s334[:, 2::3], 0x80)
            return out, seq
        ccd = s334.copy()
        ccd[:, 0::3] = np.where(f1, 0xFC, 0xFD)
        if kind == "cc-data":
            return ccd, seq
        fps_idx, max_cc = self._fps()
        length = 11 + 2 + 3 * max_cc
        seqs = (seq + np.arange(b)) & 0xFFFF
        out = np.zeros((b, length), np.int64)
        out[:, 0], out[:, 1], out[:, 2], out[:, 3] = 0x96, 0x69, length, \
            fps_idx
        out[:, 4] = 0x02 | 0x40 | 0x01
        out[:, 5], out[:, 6] = seqs >> 8, seqs & 0xFF
        out[:, 7], out[:, 8] = 0x72, 0xE0 | max_cc
        out[:, 9:9 + 3 * n] = ccd
        out[:, 9 + 3 * n:9 + 3 * max_cc] = np.tile(
            np.asarray([0xFA, 0x00, 0x00]), max(max_cc - n, 0))[None, :]
        out[:, -4] = 0x74
        out[:, -3], out[:, -2] = seqs >> 8, seqs & 0xFF
        out[:, -1] = (256 - (out.sum(1) & 0xFF)) & 0xFF
        return out, _i32(seq + b)

    # -- the cross-framerate engine (io/ccconv.py's walk) ----------------

    def _xr_parse_input(self, cc):
        """One frame's bytes [W] -> (ccp, lccp, c1, l1, c2, l2), the
        convert_* input halves (gstccconverter.c:1476-1930)."""
        it = self.props["input-type"]
        in_max608 = self._in_e[3]
        in_maxcc = self._in_e[1]
        W = cc.shape[0]
        zero64 = np.zeros(64, np.int64)
        zero384 = np.zeros(384, np.int64)
        if it == "raw":
            n = min(W - W % 2, 2 * in_max608)
            c1 = zero64.copy()
            c1[:n] = cc[:n]
            return zero384, 0, c1, n, zero64, 0
        if it == "s334-1a":
            n = min(W // 3, in_max608)
            trips = cc[:3 * n].reshape(n, 3)
            f1 = (trips[:, 0] & 0x80) != 0
            c1, l1 = _pack(f1, (trips[:, 1], trips[:, 2]), 64)
            c2, l2 = _pack(~f1, (trips[:, 1], trips[:, 2]), 64)
            return zero384, 0, c1, l1, c2, l2
        if it == "cdp":
            flags = int(cc[4])
            tc = (flags & 0x80) != 0
            base = 14 if tc else 9
            cnt_raw = _take(cc, base - 1)
            ok = (cc[0] == 0x96 and cc[1] == 0x69 and (flags & 0x40) != 0
                  and _take(cc, base - 2) == 0x72
                  and (cnt_raw & 0xE0) == 0xE0
                  and (not tc or cc[7] == 0x71))
            ncc = cnt_raw & 0x1F if ok else 0
            nmax = 31
            idx = base + np.arange(3 * nmax)
            raw = cc[np.clip(idx, 0, W - 1)]
            raw = np.where(np.arange(3 * nmax) < 3 * ncc, raw, 0)
            trips = raw.reshape(nmax, 3)
            tripmask = np.arange(nmax) < ncc
        else:                                    # cc-data
            nmax = W // 3
            trips = cc[:3 * nmax].reshape(nmax, 3)
            tripmask = np.ones(nmax, bool)
        # compact_cc_data: the valid triplets in order, then truncated
        valid = tripmask & ((trips[:, 0] & 0x04) == 0x04)
        cbuf, clen = _pack(valid, (trips[:, 0], trips[:, 1], trips[:, 2]),
                           3 * nmax)
        clen = min(clen, 3 * in_maxcc)
        ctr = cbuf.reshape(nmax, 3)
        cmask = np.arange(nmax) < clen // 3
        # cc_data_extract_cea608: the leading 608 run
        typ = ctr[:, 0] & 0x03
        is608 = (typ <= 1) & cmask
        prefix = np.cumprod(is608.astype(np.int64)).astype(bool)
        c1, l1 = _pack(prefix & (typ == 0), (ctr[:, 1], ctr[:, 2]), 64)
        c2, l2 = _pack(prefix & (typ == 1), (ctr[:, 1], ctr[:, 2]), 64)
        # over the limit: the dead-else truncation (io/ccconv.py)
        if (l1 + l2) // 2 > in_max608:
            l1, l2 = min(l1, 2 * in_max608), 0
        ccp, lccp = _pack(cmask & ~prefix,
                          (ctr[:, 0], ctr[:, 1], ctr[:, 2]), 384)
        return ccp, lccp, c1, l1, c2, l2

    def _xr_combine_and_emit(self, ccp, lccp, c1, l1, c2, l2, seq):
        """combine_cc_data and the writer of the output type ->
        (out bytes, seq')."""
        ot = self.props["output-type"]
        out_max608 = self._out_e[3]
        out_maxcc = self._out_e[1]
        if ot == "raw":
            k = np.arange(2 * out_max608)
            return np.where(k < l1, c1[np.clip(k, 0, 63)], 0x80), seq
        n1, n2 = l1 // 2, l2 // 2
        total1, total2 = n1, n2
        if ot == "cdp":
            for i in range(out_max608):
                if i >= n1 + n2:
                    if i > n1 // 2:
                        total1 += 1
                    else:
                        total2 += 1
        ccw = 3 * out_maxcc
        cc = np.zeros(ccw + 3, np.int64)

        def put(i, vals):
            for j, v in enumerate(vals):
                if i + j < ccw + 3:
                    cc[i + j] = v

        for j in range(out_max608):
            p1 = j < total1
            pos1 = 3 * (min(j, total1) + min(j, total2))
            pos2 = pos1 + 3 * int(p1)
            if j < n1:
                t1 = (0xFC, c1[min(2 * j, 63)], c1[min(2 * j + 1, 63)])
            else:
                t1 = (0xF8, 0x80, 0x80)
            put(pos1 if p1 else ccw, t1)
            if j < n2:
                t2 = (0xFD, c2[min(2 * j, 63)], c2[min(2 * j + 1, 63)])
            else:
                t2 = (0xF9, 0x80, 0x80)
            put(pos2 if j < total2 else ccw, t2)
        base = 3 * (total1 + total2)
        k = np.arange(ccw)
        ccpv = ccp[np.clip(k - base, 0, 383)]
        cc = np.where((k >= base) & (k - base < lccp), ccpv, cc[:ccw])
        used = base + lccp
        padpat = np.where((k - used) % 3 == 0, 0xFA, 0)
        if ot == "cdp":
            cc = np.where(k >= used, padpat, cc)
            length = 13 + ccw
            out = np.zeros(length, np.int64)
            s = seq & 0xFFFF
            out[:9] = (0x96, 0x69, length, self._out_e[0], 0x02 | 0x40 | 0x01,
                       s >> 8, s & 0xFF, 0x72, 0xE0 | out_maxcc)
            out[9:9 + ccw] = cc
            out[length - 4:length - 1] = (0x74, s >> 8, s & 0xFF)
            out[length - 1] = (256 - (out.sum() & 0xFF)) & 0xFF
            return out, _i32(seq + 1)
        if ot == "s334-1a":
            cc[0::3] = np.where(cc[0::3] == 0xFC, 0x80, 0)
            return np.where(k >= used, 0x80, cc), seq
        # cc-data: padded with invalid 0xFA triplets (fixed-width frames)
        return np.where(k >= used, padpat, cc), seq

    def _xr_slot(self, st, parsed, first, gate):
        """One transform() call (slot 0 takes the input) -> (out, emit,
        state')."""
        it, ot = self.props["input-type"], self.props["output-type"]
        want_ccp = it in ("cc-data", "cdp") and ot in ("cc-data", "cdp")
        want_c2 = it != "raw" and ot != "raw"
        in_n, in_d = self._in_fps
        out_n, out_d = self._out_fps
        ccp_in, lccp_in, c1_in, l1_in, c2_in, l2_in = parsed
        take_in = first and gate
        lccp_in = lccp_in if take_in and want_ccp else 0
        l1_in = l1_in if take_in else 0
        l2_in = l2_in if take_in and want_c2 else 0

        inf = st["inf"] + int(take_in)
        outf = st["outf"]
        a = inf * in_d * out_n
        b = outf * out_d * in_n
        cmp_pre = st["inf"] * in_d * out_n - b
        run = gate and (first or cmp_pre >= 0)

        ccp_w, lccp = _concat(st["sc_ccp"], st["sc_ccp_len"], ccp_in,
                              lccp_in, 384)
        c1_w, l1 = _concat(st["sc_c1"], st["sc_c1_len"], c1_in, l1_in, 64)
        c2_w, l2 = _concat(st["sc_c2"], st["sc_c2_len"], c2_in, l2_in, 64)
        if not want_ccp:
            lccp = 0
        if not want_c2:
            l2 = 0

        if self._in_e[1] == self._out_e[1]:
            # equal max_cc_count: 1:1, no buffering (fit_and_scale's
            # first branch; counters pinned)
            emit = run
            le_ccp, le_1, le_2 = lccp, l1, l2
            sccp_n, sc1_n, sc2_n = ccp_w, c1_w, c2_w
            lsccp = lsc1 = lsc2 = 0
            inf_out = outf_out = 0
        else:
            emit = run and a >= b
            if run and a == b:
                inf, outf = 0, 0
            extra_ccp = max(0, lccp - 3 * self._out_e[2])
            ccp_off = lccp - extra_ccp
            extra_1 = max(0, l1 - 2 * self._out_e[3])
            c1_off = l1 - extra_1
            # the field-2 split ("prefers field1")
            extra_2 = l2 if extra_1 > 0 else max(
                0, l1 + l2 - 2 * self._out_e[3])
            c2_off = l2 - extra_2
            if not want_ccp:
                extra_ccp = 0
            if not want_c2:
                extra_2 = 0
            overflow = extra_ccp > 0 or extra_1 > 0 or extra_2 > 0
            # emit=False stores everything; emit with overflow stores the
            # tails; emit without clears the scratch
            if emit:
                lsccp, lsc1, lsc2 = ((extra_ccp, extra_1, extra_2)
                                     if overflow else (0, 0, 0))
                offs = (ccp_off, c1_off, c2_off)
                le_ccp, le_1, le_2 = ccp_off, c1_off, c2_off
            else:
                lsccp, lsc1, lsc2 = lccp, l1, l2
                offs = (0, 0, 0)
                le_ccp = le_1 = le_2 = 0
            sccp_n = _tail(ccp_w, offs[0], lsccp, 384)
            sc1_n = _tail(c1_w, offs[1], lsc1, 64)
            sc2_n = _tail(c2_w, offs[2], lsc2, 64)
            inf_out = inf
            outf_out = outf + int(emit)

        out, seq_n = self._xr_combine_and_emit(
            ccp_w, le_ccp, c1_w, le_1, c2_w, le_2, st["seq"])
        if run:
            st = {"seq": seq_n if emit else st["seq"],
                  "inf": inf_out, "outf": outf_out,
                  "sc_ccp": sccp_n, "sc_ccp_len": _i32(lsccp),
                  "sc_c1": sc1_n, "sc_c1_len": _i32(lsc1),
                  "sc_c2": sc2_n, "sc_c2_len": _i32(lsc2)}
        return out, emit, st

    def _xr_process(self, state, batch: FrameBatch):
        require(not isinstance(batch.data, dict),
                "ccconverter: cross-framerate mode needs a standalone "
                "[B, W] caption stream")
        dev = batch.data.device
        cc = batch.data.cpu().numpy().astype(np.int64)
        valid = batch.valid.cpu().numpy()
        pts = batch.pts.cpu().numpy()
        st = {k: (v.cpu().numpy().astype(np.int64) if v.dim()
                  else int(v.item())) for k, v in state.items()}
        outs, emits, opts = [], [], []
        for f in range(cc.shape[0]):
            parsed = self._xr_parse_input(cc[f])
            for slot in range(self._slots):
                out, emit, st = self._xr_slot(st, parsed, slot == 0,
                                              bool(valid[f]))
                outs.append(out & 0xFF)
                emits.append(emit)
                opts.append(pts[f])
        new_state = {k: torch.tensor(
            v, dtype=state[k].dtype, device=dev) for k, v in st.items()}
        return new_state, FrameBatch.make(
            torch.from_numpy(np.stack(outs).astype(np.uint8)).to(dev),
            pts=torch.tensor(np.asarray(opts, np.int64), device=dev),
            valid=torch.tensor(np.asarray(emits, bool), device=dev))

    def process(self, params, state, batch: FrameBatch):
        if getattr(self, "_xr", False):
            return self._xr_process(state, batch)
        is_dict = isinstance(batch.data, dict)
        cc_t = batch.data["cc"] if is_dict else batch.data
        s334 = self._to_s334(cc_t.cpu().numpy().astype(np.int64),
                             self.props["input-type"])
        out, seq = self._from_s334(s334, self.props["output-type"],
                                   int(state.item()))
        out = torch.from_numpy((out & 0xFF).astype(np.uint8)).to(cc_t.device)
        state = torch.tensor(seq, dtype=torch.int32, device=cc_t.device)
        if is_dict:
            return state, batch.with_data({**batch.data, "cc": out})
        return state, batch.with_data(out)


@register
class CeaCcOverlay(Element):
    """ceaccoverlay (ext/closedcaption/gstceaccoverlay.c): decode CEA-708
    DTVCC captions (io/cea708.py) and blend the caption windows onto AYUV
    video by (D*(256-a) + S*a) >> 8 where a > 0, the video alpha kept.

    Captions arrive with push_cc(data, pts_ns, kind): kind "cc-data",
    "cdp" (unwrapped as extract_ccdata_from_cdp does) or "s334-1a"
    (608-only payloads render nothing).  Each feed that completes DTVCC
    windows snapshots an overlay shown from its pts until the next
    snapshot.  face=pango (the default where the library loads) runs the
    reference's render path (io/cea708.render_overlay_pango); face=fixed
    the bitmap face."""

    NAME = "ceaccoverlay"
    PROPERTIES = (
        Property("silent", bool, False, static=True),
        Property("service-number", int, 1, 1, 63, static=True),
        Property("face", str, "auto", static=True,
                 doc="auto | pango | fixed"),
        Property("window-h-pos", str, "center", static=True,
                 doc="left | center | right | auto (the reference's "
                     "auto reads an never-assigned h_anchor — quirk "
                     "kept)"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        from gstbad_tpu_torch.io.cea708 import Cea708Decoder
        self._decoder = Cea708Decoder(int(self.props["service-number"]))
        self._snapshots = []      # (pts_ns, overlay [H, W, 4] AYUV)
        self._pending = []        # raw (pts, cc_data) feeds
        self._slots = None

    def push_cc(self, data: bytes, pts_ns: int = 0,
                kind: str = "cc-data") -> None:
        from gstbad_tpu_torch.io import cea608
        if kind == "cdp":
            data, _fps = cea608.cdp_to_cc_data(bytes(data))
        elif kind == "s334-1a":
            data = cea608.s334_to_cc_data(bytes(data))
        elif kind != "cc-data":
            raise ValueError(f"ceaccoverlay: unknown kind {kind!r}")
        self._pending.append((int(pts_ns), bytes(data)))

    def negotiate(self, in_spec):
        require(in_spec.kind == "video"
                and in_spec.format == VideoFormat.AYUV,
                "ceaccoverlay: needs AYUV video (use videoconvert)")
        return in_spec

    def _render_snapshots(self, width: int, height: int):
        from gstbad_tpu_torch.io import cea708
        face = self.props.get("face", "auto")
        if face == "pango" and not cea708.pango_available():
            raise ValueError("ceaccoverlay: face=pango but "
                             "pango/pangocairo is not available")
        use_pango = face in ("auto", "pango") and cea708.pango_available()
        self._face = "pango" if use_pango else "fixed"
        out = []
        for pts, data in sorted(self._pending, key=lambda t: t[0]):
            if self._decoder.feed_cc_data(data):
                if use_pango:
                    canvas = cea708.render_overlay_pango(
                        self._decoder, width, height,
                        window_h_pos=self.props["window-h-pos"])
                else:
                    canvas = cea708.render_overlay(self._decoder,
                                                   width, height)
                out.append((pts, canvas))
        return out

    def process(self, params, state, batch: FrameBatch):
        if self.props["silent"] or not self._pending:
            return state, batch
        _, h, w, _ = batch.data.shape
        if not self._snapshots:
            self._snapshots = self._render_snapshots(w, h)
        if self._slots is None:
            self._slots = ovops.OverlaySlots(batch.data.device, (h, w, 4))
        snaps = self._snapshots
        spans = [(i, pts, snaps[i + 1][0] if i + 1 < len(snaps) else None)
                 for i, (pts, _) in enumerate(snaps)]
        return state, blend_timed(self._slots, batch, spans,
                                  lambda i: snaps[i][1], "shr8_keep_alpha")
