"""(A copy of gstbad_tpu/golden/line21.py, numpy only.)

Golden line-21 CEA-608 VBI waveform (ext/closedcaption/io-sim.c
signal_closed_caption + the gstline21enc sampling setup).

Sampling parameters are the element's (gstline21enc.c:196-209): BT.601
13.5 MHz, 720 samples per line, horizontal offset 122 samples; levels are
io-sim.c's 525-line defaults (blank 5, black 16, white 235,
io-sim.c:883-885); bit rate 30000*525*32/1001 (io-sim.c:619).

Quirks transcribed exactly: the flat stretch of bit slot k renders data
bit k+1 (`data & (2 << bit)`, io-sim.c:133), edges are 240 ns raised
cosines gated on |d| < 120 ns of the slot START with the (bit, bit+1)
pair selecting rise/fall, samples before t3 fall through the C's
double->unsigned garbage to the blank level, and stores truncate toward
zero then saturate.
"""

from __future__ import annotations

import math

import numpy as np

SAMPLING_RATE = 13.5e6
SAMPLES_PER_LINE = 720
H_OFFSET = 122
BLANK = 5
WHITE = 235
BIT_RATE = 30000.0 * 525 * 32 / 1001
D = 1.0 / BIT_RATE

T0 = 10.5e-6                 # CRI start half amplitude (EIA 608-B)
T1 = T0 - 0.25 * D           # CRI start, blanking level
T2 = T1 + 7 * D              # CRI 7 cycles
T3 = T0 + 6.5 * D - 120e-9   # first start bit left edge - rise time
Q1 = math.pi * BIT_RATE * 2
Q2 = math.pi / 120e-9
SIGNAL_MEAN = (WHITE - BLANK) * 0.25          # 25 IRE
SIGNAL_HIGH = BLANK + (WHITE - BLANK) * 0.5


def parity_byte(v: int) -> int:
    """7-bit value -> byte with EIA-608 odd parity in bit 7."""
    v &= 0x7F
    ones = bin(v).count("1")
    return v | (0 if ones & 1 else 0x80)


def encode_line(b0: int, b1: int) -> np.ndarray:
    """One CC line waveform [720] u8 for the two field bytes (parity
    included in the bytes, as sliced->data carries them)."""
    data = (b1 << 12) + (b0 << 4) + 8
    out = np.empty(SAMPLES_PER_LINE, np.uint8)
    t = H_OFFSET / SAMPLING_RATE
    for i in range(SAMPLES_PER_LINE):
        if T1 <= t < T2:
            v = BLANK + (1.0 - math.cos(Q1 * (t - T1))) * SIGNAL_MEAN
            out[i] = min(max(int(v), 0), 255)
        else:
            d = t - T3
            if d < 0:
                out[i] = BLANK      # C double->unsigned fallthrough
            else:
                bit = int(d * BIT_RATE)
                seq = (data >> min(bit, 31)) & 3
                drem = d - bit * D
                if seq in (1, 2) and abs(drem) < 0.120e-6:
                    if seq == 1:
                        level = BLANK + (1.0 + math.cos(Q2 * drem)) \
                            * SIGNAL_MEAN
                    else:
                        level = BLANK + (1.0 - math.cos(Q2 * drem)) \
                            * SIGNAL_MEAN
                    out[i] = min(max(int(level), 0), 255)
                elif data & (2 << min(bit, 31)):
                    out[i] = min(max(int(SIGNAL_HIGH), 0), 255)
                else:
                    out[i] = BLANK
        t += 1.0 / SAMPLING_RATE
    return out


def bit_sample_index(j: int) -> int:
    """Sample index of the flat middle of data bit j (bit j renders in
    slot j-1 per the io-sim quirk)."""
    t = T3 + (j - 0.5) * D
    return int(round(t * SAMPLING_RATE - H_OFFSET))


def decode_line(line: np.ndarray):
    """(found, (b0, b1)) from one [720] u8 line.

    Deterministic slicer: threshold at the line's mid-range, verify the
    CRI oscillation (3 peak + 3 trough probes) and the 0001 start-bit
    pattern, then sample the 16 data-bit midpoints.  zvbi's adaptive
    bit_slicer internals are not reproduced (documented divergence) —
    round trip against the encoder is bit-exact."""
    line = np.asarray(line, np.int32)
    lo, hi = int(line.min()), int(line.max())
    if hi - lo < 30:
        return False, (0, 0)
    thr = (lo + hi) / 2.0
    # CRI probes: peaks at t1 + (k + .5)/bit_rate, troughs at t1 + k/D
    for k in range(3):
        pk = int(round((T1 + (k + 0.5) * D) * SAMPLING_RATE - H_OFFSET))
        tr = int(round((T1 + (k + 1) * D) * SAMPLING_RATE - H_OFFSET))
        if line[pk] <= thr or line[tr] > thr:
            return False, (0, 0)
    bits = [int(line[bit_sample_index(j)] > thr) for j in range(20)]
    if bits[0] != 0 or bits[1] != 0 or bits[2] != 0 or bits[3] != 1:
        return False, (0, 0)
    b0 = sum(bits[4 + k] << k for k in range(8))
    b1 = sum(bits[12 + k] << k for k in range(8))
    return True, (b0, b1)
