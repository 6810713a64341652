"""Line-21 CEA-608 waveform synthesis and slicing in torch ops, the form
of gstbad_tpu/ops/line21.py (golden/line21.py is the spec;
ext/closedcaption/io-sim.c with gstline21enc.c/gstline21dec.c the
reference).

Encoding is a closed-form select per sample, so a window's caption lines
synthesize as one [N, 720] elementwise pass; decoding reads the 20 bit
midpoints (fixed indices) and thresholds them at each line's mid-range.
The sample tables are numpy float64 constants, computed as the JAX
module computes them.
"""

from __future__ import annotations

import numpy as np
import torch

from gstbad_tpu_torch.golden.line21 import (
    BIT_RATE, BLANK, D, H_OFFSET, Q1, Q2, SAMPLES_PER_LINE, SAMPLING_RATE,
    SIGNAL_HIGH, SIGNAL_MEAN, T1, T2, T3, bit_sample_index,
)

_T = H_OFFSET / SAMPLING_RATE + np.arange(SAMPLES_PER_LINE) / SAMPLING_RATE
_IN_CRI = (_T >= T1) & (_T < T2)
_CRI_VAL = np.clip((BLANK + (1.0 - np.cos(Q1 * (_T - T1))) * SIGNAL_MEAN)
                   .astype(np.int32), 0, 255)
_D0 = _T - T3
_BIT = np.where(_D0 < 0, 0, (_D0 * BIT_RATE).astype(np.int64)).astype(
    np.int32)
_DREM = _D0 - _BIT * D
_NEG = _D0 < 0
_RISE = np.clip((BLANK + (1.0 - np.cos(Q2 * _DREM)) * SIGNAL_MEAN)
                .astype(np.int32), 0, 255)
_FALL = np.clip((BLANK + (1.0 + np.cos(Q2 * _DREM)) * SIGNAL_MEAN)
                .astype(np.int32), 0, 255)
_NEAR_EDGE = np.abs(_DREM) < 0.120e-6
_HIGH = min(max(int(SIGNAL_HIGH), 0), 255)
_BIT_IDX = np.asarray([bit_sample_index(j) for j in range(20)], np.int64)
# the clock run-in's peaks and troughs that decode checks
_CRI_PROBES = [(int(round((T1 + (k + 0.5) * D) * SAMPLING_RATE - H_OFFSET)),
                int(round((T1 + (k + 1) * D) * SAMPLING_RATE - H_OFFSET)))
               for k in range(3)]


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def encode_lines(pairs: torch.Tensor) -> torch.Tensor:
    """[N, 2] u8 byte pairs -> [N, 720] u8 waveforms."""
    dev = pairs.device
    b0 = pairs[:, 0].to(torch.int32)
    b1 = pairs[:, 1].to(torch.int32)
    data = (b1 << 12) + (b0 << 4) + 8                  # [N]
    bit = _t(_BIT, dev)[None, :]                       # [1, S]
    seq = (data[:, None] >> bit) & 3
    cur = (data[:, None] >> (bit + 1)) & 1             # data & (2 << bit)
    edge = ((seq == 1) | (seq == 2)) & _t(_NEAR_EDGE, dev)[None, :]
    edge_val = torch.where(seq == 1, _t(_FALL, dev)[None, :],
                           _t(_RISE, dev)[None, :])
    high = torch.full((), _HIGH, dtype=torch.int32, device=dev)
    blank = torch.full((), BLANK, dtype=torch.int32, device=dev)
    flat = torch.where(cur == 1, high, blank)
    val = torch.where(_t(_NEG, dev)[None, :], blank,
                      torch.where(edge, edge_val, flat))
    val = torch.where(_t(_IN_CRI, dev)[None, :], _t(_CRI_VAL, dev)[None, :],
                      val)
    return val.to(torch.uint8)


def decode_lines(lines: torch.Tensor):
    """[..., 720] u8 -> (found [...], pairs [..., 2] u8)."""
    x = lines.to(torch.int32)
    lo = x.amin(-1)
    hi = x.amax(-1)
    thr = (lo + hi).to(torch.float32) / 2.0
    samp = x[..., _t(_BIT_IDX, x.device)]              # [..., 20]
    bits = samp > thr[..., None]
    cri_ok = torch.ones(lo.shape, dtype=torch.bool, device=x.device)
    for pk, tr in _CRI_PROBES:
        cri_ok = cri_ok & (x[..., pk] > thr) & (x[..., tr] <= thr)
    start_ok = (~bits[..., 0]) & (~bits[..., 1]) & (~bits[..., 2]) \
        & bits[..., 3]
    found = (hi - lo >= 30) & cri_ok & start_ok
    w = bits.to(torch.int32)
    b0 = sum(w[..., 4 + k] << k for k in range(8))
    b1 = sum(w[..., 12 + k] << k for k in range(8))
    pairs = torch.stack([b0, b1], -1).to(torch.uint8)
    return found, torch.where(found[..., None], pairs,
                              torch.zeros_like(pairs))
