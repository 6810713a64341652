"""Audio DSP (gstbad_tpu/ops/audio.py): the audiomixmatrix paths, the
freeverb reverb, the removesilence VAD power recurrence, and audio
breadth's ops: the first-order and biquad IIRs as associative scans, the
webrtcdsp chain (STFT, noise suppression, gain, echo cancellation), the
phase vocoder and resampler, the ADPCM codecs and the scopes' filter.

freeverb's sample-serial feedback (8 parallel combs and 4 series
allpasses per side, gstfreeverb.c:288-330) runs at 32 kHz and above as
plain torch ops in two forms, both exact rewrites of the serial loop up to
float32 reassociation (within 2e-6 of the serial C, the JAX package's own
gate): a whole-window form for windows at least as long as the longest
delay line, whose only serial part is a walk over blocks of the shortest
comb delay, and a 128-sample block walk for shorter windows.  Below 32 kHz,
as in the JAX package, it runs the serial loop itself: the hand-written
CUDA kernel `freeverb_scan` (csrc/freeverb_kernels.cu) on the card, its
plain per-sample version on the CPU.

The VAD power recurrence has two hand-written CUDA kernels
(csrc/vad_kernels.cu): `vad_powers_serial`, the port of the TPU kernel,
and `vad_powers_bracket`, which runs every block from the two extreme
powers at once.  CPU tensors take their plain versions.

The ADPCM walks (csrc/adpcm_kernels.cu) and the scopes' filter
(csrc/scope_kernels.cu) are hand-written CUDA kernels beside plain walks,
as freeverb_scan is: each replaces an XLA scan, not a TPU kernel.  Where
the JAX package's compiled window contracts `a*b + c` into an FMA, the
port rounds once too (fma32, fma64), so those paths stay bit exact.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from gstbad_tpu_torch.core.frame import to_device
from gstbad_tpu_torch.ops import fft
from gstbad_tpu_torch.ops.numerics import f32, fma32, fma64, full_fp32, \
    true_div
from gstbad_tpu_torch.ops.scan import associative_scan

# ---------------------------------------------------------------------------
# audiomixmatrix
# ---------------------------------------------------------------------------


def mix_f32(x, matrix):
    """F32 path (gstaudiomixmatrix.c:436-457): float32 accumulation over
    the inputs in channel order, one multiply and one add per term.
    x: [..., S, in] float32, matrix float64 [out, in] -> [..., S, out]."""
    acc = torch.zeros(x.shape[:-1] + (matrix.shape[0],), dtype=torch.float32,
                      device=x.device)
    m32 = matrix.to(torch.float32)
    for i in range(matrix.shape[1]):
        acc = acc + x[..., i:i + 1] * m32[:, i]
    return acc


def mix_f64(x, matrix):
    """F64 path: float64 accumulation in channel order."""
    x = x.to(torch.float64)
    acc = torch.zeros(x.shape[:-1] + (matrix.shape[0],), dtype=torch.float64,
                      device=x.device)
    for i in range(matrix.shape[1]):
        acc = acc + x[..., i:i + 1] * matrix[:, i]
    return acc


def mix_s16(x, conv, shift: int):
    """S16 fixed-point path (gstaudiomixmatrix.c:480-501) with C int32
    wraparound; conv int32 [out, in]."""
    prod = (x.to(torch.int64)[..., None, :]
            * conv.to(torch.int64)[None, :, :]).to(torch.int32)
    acc = prod.to(torch.int64).sum(dim=-1).to(torch.int32)
    return (acc >> shift).to(torch.int16)


def mix_s32(x, conv, shift: int):
    """S32 path (gstaudiomixmatrix.c:504-525); int64 wrapping
    accumulation; conv int64 [out, in]."""
    prod = x.to(torch.int64)[..., None, :] * conv[None, :, :]
    return (prod.sum(dim=-1) >> shift).to(torch.int32)


def channelmix_s16(x, ll, lr, rl, rr):
    """audiochannelmix (gstaudiochannelmix.c:222-251): float64 gains,
    round half to even, clamp."""
    left = x[..., 0].to(torch.float64)
    right = x[..., 1].to(torch.float64)
    nl = torch.round(ll * left + rl * right).clamp(-32768, 32767)
    nr = torch.round(lr * left + rr * right).clamp(-32768, 32767)
    return torch.stack([nl, nr], dim=-1).to(torch.int16)


# ---------------------------------------------------------------------------
# freeverb
# ---------------------------------------------------------------------------

DC_OFFSET = np.float32(1e-8)
COMB_L = np.array([1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617])
ALLPASS_L = np.array([556, 441, 341, 225])
STEREOSPREAD = 23
BLOCK = 128          # the short-window walk's block (every delay >= 225)
FIR_W = 128          # taps of the banded filterstore solve
FIR_DAMP_MAX = 0.71  # damp1^FIR_W <= 1e-19 at or below this


def freeverb_sizes(rate: int) -> Dict[str, np.ndarray]:
    srf = rate / 44100.0
    return {
        "combL": (COMB_L * srf).astype(np.int32),
        "combR": ((COMB_L + STEREOSPREAD) * srf).astype(np.int32),
        "apL": (ALLPASS_L * srf).astype(np.int32),
        "apR": ((ALLPASS_L + STEREOSPREAD) * srf).astype(np.int32),
    }


def freeverb_init_state(rate: int, device="cpu"):
    s = freeverb_sizes(rate)
    cmax = int(max(s["combL"].max(), s["combR"].max()))
    amax = int(max(s["apL"].max(), s["apR"].max()))

    def dc(shape):
        return torch.full(shape, float(DC_OFFSET), dtype=torch.float32,
                          device=device)

    return {
        "combL_buf": dc((8, cmax)), "combR_buf": dc((8, cmax)),
        "apL_buf": dc((4, amax)), "apR_buf": dc((4, amax)),
        "storeL": torch.zeros(8, dtype=torch.float32, device=device),
        "storeR": torch.zeros(8, dtype=torch.float32, device=device),
        "t": torch.zeros((), dtype=torch.int32, device=device),
    }


def freeverb_process(state, x, params, rate: int, mono: bool):
    """Reverb over one window.  x: [N] (mono) or [N, 2] float32 ->
    (state, [N, 2] float32).

    params: 0-d float32 tensors feedback, damp1, damp2, wet1, wet2, dry,
    gain (gst_freeverb_set_property, gstfreeverb.c:536-570)."""
    if rate < 32000:
        return freeverb_scan(state, x, params, rate, mono)
    sizes = freeverb_sizes(rate)
    dmax = int(max(sizes["combR"].max(), sizes["apR"].max()))
    with full_fp32():
        if x.shape[0] >= dmax:
            return _freeverb_process_fused(state, x, params, sizes, mono)
        return _freeverb_process_blocked(state, x, params, sizes, mono)


def _inputs(x, params, mono):
    """(in1l, in1r, in2l, in2r): the comb inputs and the dry signal."""
    gain = params["gain"]
    if mono:
        in1 = (2.0 * x + DC_OFFSET) * gain
        return in1, in1, x, x
    in2l, in2r = x[..., 0], x[..., 1]
    return (in2l + DC_OFFSET) * gain, (in2r + DC_OFFSET) * gain, in2l, in2r


def _damp_powers(damp1, n: int):
    """[1, damp1, damp1^2, ...] of length n, a float32 running product."""
    return torch.cat([torch.ones(1, dtype=torch.float32,
                                 device=damp1.device),
                      torch.cumprod(damp1.expand(n - 1), dim=0)])


def _filterstore_matrix(damp1, damp2, n: int, band):
    """The filterstore solve of one n-sample block as a matrix:
    store[j] = sum_m v[m] * M[m, j] + damp1^(j+1) * store[-1], with
    M[m, j] = damp2 * damp1^(j-m) for 0 <= j - m < band, else 0.
    Returns (M [n, n], damp1^(j+1) [n])."""
    p = _damp_powers(damp1, n)
    lag = (torch.arange(n, device=p.device)[None, :]
           - torch.arange(n, device=p.device)[:, None])
    m = torch.where((lag >= 0) & (lag < band), damp2 * p[lag.clamp(min=0)],
                    0.0)
    return m, damp1 * p


def _ring_pos(d, t0, length: int):
    """Ring positions (t0 + s) mod d of the taps s < length at time t0
    (a 0-d tensor): [length] for an int d, [rows, length] for d an int64
    [rows] tensor of ring lengths."""
    s = torch.arange(length, device=t0.device) + t0.to(torch.int64)
    if isinstance(d, int):
        return torch.remainder(s, d)
    return torch.remainder(s[None, :], d[:, None])


def _ring_store(line, d: int, t_end, tail):
    """line with its first d entries replaced by the ring holding `tail`,
    the last d values written before time t_end: tail[m] lives at
    position (t_end - d + m) mod d."""
    return torch.cat([tail[_ring_pos(d, -t_end, d)], line[d:]])


def _decimated_allpass(x, head, d: int):
    """w[t] = x[t] + 0.5 * w[t - d] with w[t - d] = head[t] for t < d: the
    allpass buffer recurrence decimates into d first-order recurrences
    over blocks of d samples, solved as a log-depth scan.  Every factor is
    a power of 0.5, so every product is exact.  Returns w [N]."""
    n = x.shape[0]
    k2 = -(-n // d)
    w = torch.nn.functional.pad(x, (0, k2 * d - n)).reshape(k2, d)
    shift = 1
    while shift < k2:
        w = torch.cat([w[:shift],
                       torch.add(w[shift:], w[:-shift], alpha=0.5 ** shift)])
        shift *= 2
    pw = torch.cumprod(torch.full((k2,), 0.5, dtype=torch.float32,
                                  device=x.device), dim=0)
    return (w + pw[:, None] * head[None, :]).reshape(k2 * d)


def _freeverb_process_fused(state, x, params, sizes, mono):
    """Whole-window reverb (gstbad_tpu/ops/audio.py:329-497).

    Combs: filterstore[t] = damp1*filterstore[t-1]
    + damp2*(in[t-D] + feedback*filterstore[t-D]).  In blocks of B = min(D)
    samples every lag-D read lands in one of the two blocks before, so the
    serial part is a walk over K = ceil(N/B) blocks of four ops on [16, B]:
    one gather of the lag-D history, the feedback add, the block's lag-1
    solve as ONE product with a [B, B] matrix (the 128-tap banded FIR of
    the damp1 powers for damp1 <= FIR_DAMP_MAX, the full triangular power
    matrix above, chosen on the device as the JAX package's lax.cond
    does), and the carried store's term.

    Allpasses: buf[t] = x[t] + 0.5*buf[t-D] has no lag-1 term, so each
    runs as a decimated log-depth scan (_decimated_allpass)."""
    d16 = np.concatenate([sizes["combL"], sizes["combR"]]).astype(np.int64)
    b = int(d16.min())
    n = int(x.shape[0])
    k = -(-n // b)
    np_len = k * b
    dev = x.device
    feedback = params["feedback"]
    damp1, damp2 = params["damp1"], params["damp2"]
    t0 = state["t"]
    in1l, in1r, in2l, in2r = _inputs(x, params, mono)

    bufs = torch.cat([state["combL_buf"], state["combR_buf"]])
    store0 = torch.cat([state["storeL"], state["storeR"]])
    # flat offsets of row i's lag-D_i window in two consecutive blocks of
    # the filterstore history below
    col = 2 * b - d16[:, None] + np.arange(b)[None, :]
    d_t, lag_idx = to_device(dev, d16, (col // b) * 16 * b
                             + np.arange(16)[:, None] * b + col % b)
    side = (torch.arange(16, device=dev) >= 8).long()[:, None]

    # v_base[i, s]: the comb tap ignoring in-window feedback (the carried
    # ring for s < D_i, the delayed input after); feedback joins only once
    # the tap falls inside the window
    s_idx = torch.arange(np_len, device=dev)
    in_ring = s_idx[None, :] < d_t[:, None]
    head_pos = _ring_pos(d_t, t0, np_len) * in_ring
    inp = torch.stack([torch.nn.functional.pad(v, (0, np_len - n))
                       for v in (in1l, in1r)])
    delayed = inp[side, (s_idx[None, :] - d_t[:, None]).clamp(min=0)]
    v_base = torch.where(in_ring, torch.gather(bufs, 1, head_pos), delayed)
    fb = torch.where(in_ring, 0.0, feedback)
    v_xs = v_base.reshape(16, k, b).transpose(0, 1).contiguous()
    fb_xs = fb.reshape(16, k, b).transpose(0, 1).contiguous()

    band = torch.where(damp1 <= FIR_DAMP_MAX, min(FIR_W, b), b)
    mat, p_next = _filterstore_matrix(damp1, damp2, b, band)

    # st[k + 2] is block k's filterstore; st[0:2] the history before the
    # window (zeros, but the carried store at the very end)
    st = torch.zeros((k + 2, 16, b), dtype=torch.float32, device=dev)
    st[1, :, b - 1] = store0
    v = torch.empty((k, 16, b), dtype=torch.float32, device=dev)
    flat = st.view(-1)
    for kb in range(k):
        hist = torch.take(flat[kb * 16 * b:], lag_idx)
        torch.addcmul(v_xs[kb], fb_xs[kb], hist, out=v[kb])
        torch.mm(v[kb], mat, out=st[kb + 2])
        st[kb + 2].addcmul_(st[kb + 1, :, b - 1:], p_next)
    v = v.transpose(0, 1).reshape(16, np_len)
    store_full = st[2:].transpose(0, 1).reshape(16, np_len)
    outl = v[:8].sum(dim=0)[:n]
    outr = v[8:].sum(dim=0)[:n]

    # comb rings: w[s] = in1[s] + feedback*store[s], the last D_i kept;
    # ring position p of row i holds w at n - D_i + ((p - t_end) mod D_i)
    t_end = t0 + n
    cmax = bufs.shape[1]
    keep = torch.arange(cmax, device=dev)[None, :] < d_t[:, None]
    src = n - d_t[:, None] + _ring_pos(d_t, -t_end, cmax)
    tail = inp[side, src] + feedback * torch.gather(store_full, 1, src)
    new_bufs = torch.where(keep, tail, bufs)

    ap_out, new_ap = [], []
    for abuf, ds, sig in ((state["apL_buf"], sizes["apL"], outl),
                          (state["apR_buf"], sizes["apR"], outr)):
        lines = []
        for i in range(4):
            d = int(ds[i])
            head = abuf[i][_ring_pos(d, t0, d)]
            w = _decimated_allpass(sig, head, d)
            lines.append(_ring_store(abuf[i], d, t_end, w[n - d:n]))
            sig = torch.cat([head, w])[:n] - sig
        ap_out.append(sig)
        new_ap.append(torch.stack(lines))
    outl = ap_out[0] - DC_OFFSET
    outr = ap_out[1] - DC_OFFSET
    yl = outl * params["wet1"] + outr * params["wet2"] + in2l * params["dry"]
    yr = outr * params["wet1"] + outl * params["wet2"] + in2r * params["dry"]
    new_state = {"combL_buf": new_bufs[:8], "combR_buf": new_bufs[8:],
                 "apL_buf": new_ap[0], "apR_buf": new_ap[1],
                 "storeL": store_full[:8, n - 1].clone(),
                 "storeR": store_full[8:, n - 1].clone(),
                 "t": t_end}
    return new_state, torch.stack([yl, yr], dim=-1)


def _freeverb_process_blocked(state, x, params, sizes, mono):
    """Short-window reverb (gstbad_tpu/ops/audio.py:221-272): a walk over
    128-sample blocks.  No delay is shorter than 225 samples, so within a
    block no tap reads a value written in the same block: the taps are one
    gather from the rings as they were before the block, and the combs'
    lag-1 filterstore solve is one product with the [128, 128] damp1-power
    matrix."""
    (d16,) = to_device(x.device, np.concatenate(
        [sizes["combL"], sizes["combR"]]).astype(np.int64))
    feedback = params["feedback"]
    n = int(x.shape[0])
    in1l, in1r, in2l, in2r = _inputs(x, params, mono)
    mat, p_next = _filterstore_matrix(params["damp1"], params["damp2"],
                                      BLOCK, BLOCK)
    bufs = torch.cat([state["combL_buf"], state["combR_buf"]])
    store = torch.cat([state["storeL"], state["storeR"]])
    ap = {side: state[f"ap{side}_buf"].clone() for side in "LR"}
    t = state["t"]
    outs = []
    for lo in range(0, n, BLOCK):
        nv = min(BLOCK, n - lo)
        idx = _ring_pos(d16, t, BLOCK)
        tmp = torch.gather(bufs, 1, idx)
        stores = tmp @ mat + store[:, None] * p_next
        inp = torch.cat([in1l[lo:lo + nv].expand(8, nv),
                         in1r[lo:lo + nv].expand(8, nv)])
        bufs = bufs.scatter(1, idx[:, :nv], inp + stores[:, :nv] * feedback)
        store = stores[:, nv - 1]
        side_out = {"L": tmp[:8, :nv].sum(dim=0), "R": tmp[8:, :nv].sum(dim=0)}
        for side in "LR":
            sig = side_out[side]
            for i, d in enumerate(sizes[f"ap{side}"]):
                pos = _ring_pos(int(d), t, nv)
                bufout = ap[side][i, pos]
                ap[side][i, pos] = sig + bufout * 0.5
                sig = bufout - sig
            side_out[side] = sig - DC_OFFSET
        outl, outr = side_out["L"], side_out["R"]
        yl = (outl * params["wet1"] + outr * params["wet2"]
              + in2l[lo:lo + nv] * params["dry"])
        yr = (outr * params["wet1"] + outl * params["wet2"]
              + in2r[lo:lo + nv] * params["dry"])
        outs.append(torch.stack([yl, yr], dim=-1))
        t = t + nv
    new_state = {"combL_buf": bufs[:8], "combR_buf": bufs[8:],
                 "apL_buf": ap["L"], "apR_buf": ap["R"],
                 "storeL": store[:8].clone(), "storeR": store[8:].clone(),
                 "t": t}
    return new_state, torch.cat(outs)


# the order of freeverb_scan's packed coefficients
FREEVERB_PARAMS = ("feedback", "damp1", "damp2", "wet1", "wet2", "dry",
                   "gain")


def _scan_sizes(rate: int):
    sizes = freeverb_sizes(rate)
    if min(int(v.min()) for v in sizes.values()) < 1:
        raise ValueError(f"freeverb: {rate} Hz leaves a delay line shorter "
                         "than one sample")
    return sizes


def freeverb_scan_plain(state, x, params, rate: int, mono: bool):
    """The plain form of freeverb_scan: the C's per-sample loop
    (gstbad_tpu/ops/audio.py:_freeverb_process_scan) as a Python loop over
    the samples, on x's device.  Each step reads and writes the 16 combs'
    and then each allpass stage's two rings with one gather and one
    scatter (flat ring indices computed before the loop); every product
    and sum is its own op, in the C's order (the 8 taps summed one by
    one).  The comb inputs and the wet/dry mix, elementwise, run before
    and after the loop."""
    sizes = _scan_sizes(rate)
    dev = x.device
    n = int(x.shape[0])
    t0 = int(state["t"])
    in1l, in1r, in2l, in2r = _inputs(x, params, mono)
    inp = torch.cat([in1l.expand(8, n), in1r.expand(8, n)]).T.contiguous()
    bufs = torch.cat([state["combL_buf"], state["combR_buf"]]).clone()
    ap = torch.stack([state["apL_buf"], state["apR_buf"]]).clone()
    store = torch.cat([state["storeL"], state["storeR"]]).clone()
    # flat indices of each sample's ring positions (t0 + s) mod D
    steps = np.arange(t0, t0 + n, dtype=np.int64)[:, None]
    d16 = np.concatenate([sizes["combL"], sizes["combR"]]).astype(np.int64)
    a8 = np.stack([sizes["apL"], sizes["apR"]], axis=1).astype(np.int64)
    comb_idx, ap_idx = to_device(
        dev, np.arange(16) * bufs.shape[1] + steps % d16,
        ((np.arange(2) * 4)[None, :] + np.arange(4)[:, None]) * ap.shape[2]
        + steps[:, :, None] % a8[None])
    comb_flat, ap_flat = bufs.view(-1), ap.view(-1)
    feedback, damp1, damp2 = (params[k] for k in ("feedback", "damp1",
                                                  "damp2"))
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    for s, ci, ai, xin in zip(range(n), comb_idx.unbind(0),
                              ap_idx.unbind(0), inp.unbind(0)):
        tmp = comb_flat.take(ci)
        store = tmp * damp2 + store * damp1
        comb_flat.put_(ci, xin + store * feedback)
        taps = tmp.view(2, 8).T.unbind(0)
        sig = taps[0]
        for tap in taps[1:]:
            sig = sig + tap
        for stage in ai.unbind(0):
            bufout = ap_flat.take(stage)
            ap_flat.put_(stage, sig + bufout * 0.5)
            sig = bufout - sig
        out[s] = sig
    outl = out[:, 0] - DC_OFFSET
    outr = out[:, 1] - DC_OFFSET
    yl = outl * params["wet1"] + outr * params["wet2"] + in2l * params["dry"]
    yr = outr * params["wet1"] + outl * params["wet2"] + in2r * params["dry"]
    new_state = {"combL_buf": bufs[:8], "combR_buf": bufs[8:],
                 "apL_buf": ap[0], "apR_buf": ap[1],
                 "storeL": store[:8], "storeR": store[8:],
                 "t": state["t"] + n}
    return new_state, torch.stack([yl, yr], dim=-1)


FV_MAX_CHUNK = 256   # freeverb_scan's longest chunk (csrc kMaxChunk)
FV_HIST = 2048       # a comb's history in the kernel (csrc kHist)


@functools.lru_cache(maxsize=None)
def freeverb_chunk(rate: int) -> int:
    """freeverb_scan's chunk at `rate`: at most FV_MAX_CHUNK samples and
    at most half the shortest comb, so that each comb tap of the chunk
    after the walk's (its own value D >= 2K samples before) was written a
    chunk earlier; a multiple of the walker's 16-step trip where that
    leaves one.  Raises ValueError where a ring is shorter than a sample
    or the longest comb and a chunk pass the kernel's history."""
    sizes = _scan_sizes(rate)
    dmin = int(min(sizes["combL"].min(), sizes["combR"].min()))
    dmax = int(max(sizes["combL"].max(), sizes["combR"].max()))
    k = min(FV_MAX_CHUNK, dmin // 2)
    k = k - k % 16 if k >= 16 else k
    if dmax + k > FV_HIST:
        raise ValueError(f"freeverb_scan: at {rate} Hz the longest comb "
                         f"({dmax}) does not fit the kernel's history")
    return k


def freeverb_scan(state, x, params, rate: int, mono: bool):
    """freeverb's per-sample walk over one window, the form the reverb
    takes below 32 kHz: x [N] (mono) or [N, 2] float32 -> (state,
    [N, 2] float32), in the C's operation order.

    Not a TPU kernel: it replaces the XLA lax.scan
    gstbad_tpu/ops/audio.py:_freeverb_process_scan.  CPU tensors take
    freeverb_scan_plain; CUDA tensors launch
    csrc/freeverb_kernels.cu:freeverb_scan_kernel or raise.  The state is
    not written: the kernel writes a new one."""
    _scan_sizes(rate)
    if x.device.type == "cpu":
        return freeverb_scan_plain(state, x, params, rate, mono)
    from gstbad_tpu_torch.ops import _cuda
    want = (x.shape[0],) if mono else (x.shape[0], 2)
    if x.dtype != torch.float32 or x.ndim != len(want) or x.shape != want:
        raise ValueError(f"freeverb_scan: x must be float32 "
                         f"{'[N]' if mono else '[N, 2]'}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    bufs = [state[k] for k in ("combL_buf", "combR_buf", "apL_buf",
                               "apR_buf", "storeL", "storeR")]
    rows = (8, 8, 4, 4)
    if any(b.dtype != torch.float32 or not b.is_contiguous() for b in bufs) \
            or state["t"].dtype != torch.int32 or state["t"].numel() != 1 \
            or bufs[0].shape != bufs[1].shape \
            or bufs[2].shape != bufs[3].shape \
            or any(b.ndim != 2 or b.shape[0] != r
                   for b, r in zip(bufs, rows)) \
            or any(b.shape != (8,) for b in bufs[4:]):
        raise ValueError("freeverb_scan: the state must be contiguous "
                         "float32 rings [8, cmax] and [4, amax], stores "
                         "[8] and one int32 t")
    x = x.contiguous()
    y = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    new = [torch.empty_like(b) for b in bufs]
    t_new = torch.empty_like(state["t"])
    prm = torch.stack([params[k].reshape(()) for k in FREEVERB_PARAMS]
                      ).to(torch.float32)
    _cuda.launch("gst_freeverb_scan", x, y, *bufs, state["t"], prm, *new,
                 t_new, x.shape[0], int(mono), rate, bufs[0].shape[1],
                 bufs[2].shape[1], freeverb_chunk(rate))
    freeverb_scan.launches += 1
    return dict(zip(("combL_buf", "combR_buf", "apL_buf", "apR_buf",
                     "storeL", "storeR", "t"), new + [t_new])), y


freeverb_scan.launches = 0


# ---------------------------------------------------------------------------
# removesilence VAD (vad_private.c)
# ---------------------------------------------------------------------------

VAD_POWER_ALPHA = 0x0800
VAD_RING = 256
VAD_B = 0xFFFF - VAD_POWER_ALPHA
VAD_P_MAX = 0xFFFFFFFF     # the bracket's upper start; powers stay below


def vad_squares(data):
    """The squared-sample term s = ((d*d) >> 14) & 0xFFFF, int64."""
    d = data.to(torch.int64)
    return ((d * d) >> 14) & 0xFFFF


def _check_vad_data(name, data):
    if data.dtype != torch.int16 or data.ndim != 2:
        raise ValueError(f"{name}: data must be int16 [nb, n], got "
                         f"{data.dtype} {tuple(data.shape)}")


def vad_powers_serial_plain(data, p0):
    """The plain form of vad_powers_serial: a Python loop over the
    samples (the recurrence of vad_private.c:117)."""
    nb = data.shape[0]
    p = int(p0)
    out = []
    for row in vad_squares(data).cpu().tolist():
        for s in row:
            p = VAD_POWER_ALPHA * s + ((VAD_B * p) >> 16)
        out.append(p)
    return torch.tensor(out, dtype=torch.int64,
                        device=data.device).reshape(nb)


def vad_powers_serial(data, p0):
    """Block-end powers of the serial truncating recurrence
    p' = 2048*s + ((63487*p) >> 16) over every sample of data [nb, n]
    int16, in order, from the power p0 (a 0-d int64 tensor in [0, 2^32)
    on data's device).  Returns int64 [nb].

    Replaces the TPU kernel gstbad_tpu/ops/audio.py:_vad_power_kernel.
    CPU tensors take vad_powers_serial_plain; CUDA tensors launch
    csrc/vad_kernels.cu:vad_serial_kernel or raise."""
    _check_vad_data("vad_powers_serial", data)
    if p0.dtype != torch.int64 or p0.numel() != 1:
        raise ValueError("vad_powers_serial: p0 must be one int64 value")
    if data.device.type == "cpu" and p0.device.type == "cpu":
        return vad_powers_serial_plain(data, p0)
    from gstbad_tpu_torch.ops import _cuda
    if not data.is_contiguous():
        raise ValueError("vad_powers_serial: data must be contiguous")
    nb, n = data.shape
    out = torch.empty(nb, dtype=torch.int64, device=data.device)
    if nb:
        _cuda.launch("gst_vad_powers_serial", data, p0, out, nb, n)
        vad_powers_serial.launches += 1
    return out


vad_powers_serial.launches = 0


def vad_powers_bracket_plain(data):
    """The plain form of vad_powers_bracket: the recurrence stepped over
    the samples on a [2, nb] int64 tensor of (low, high) powers."""
    sq = vad_squares(data)
    nb, n = data.shape
    p = torch.tensor([[0], [VAD_P_MAX]], dtype=torch.int64,
                     device=data.device).expand(2, nb)
    for j in range(n):
        p = VAD_POWER_ALPHA * sq[:, j] + ((VAD_B * p) >> 16)
    return p[0].contiguous(), p[1].contiguous()


def vad_powers_bracket(data):
    """Each block's power at its end when run from the two extreme powers,
    0 and 2^32 - 1: (lo_end, hi_end) int64 [nb] each, for data [nb, n]
    int16.

    The recurrence is monotone in p and a contraction (slope 1 - 2^-5), so
    a block whose two ends agree ends on that power whatever power it
    starts from: the blocks then need no serial chain across them
    (gstbad_tpu/ops/audio.py:_vad_powers_bracket, an XLA scan there).
    CPU tensors take vad_powers_bracket_plain; CUDA tensors launch
    csrc/vad_kernels.cu:vad_bracket_kernel or raise."""
    _check_vad_data("vad_powers_bracket", data)
    if data.device.type == "cpu":
        return vad_powers_bracket_plain(data)
    from gstbad_tpu_torch.ops import _cuda
    if not data.is_contiguous():
        raise ValueError("vad_powers_bracket: data must be contiguous")
    nb, n = data.shape
    lo = torch.empty(nb, dtype=torch.int64, device=data.device)
    hi = torch.empty(nb, dtype=torch.int64, device=data.device)
    if nb:
        _cuda.launch("gst_vad_powers_bracket", data, lo, hi, nb, n)
        vad_powers_bracket.launches += 1
    return lo, hi


vad_powers_bracket.launches = 0


def vad_init_state(device="cpu"):
    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return {"ring": torch.zeros(VAD_RING, dtype=torch.int16, device=device),
            "count": scalar(0, torch.int64),
            "power": scalar(0, torch.int64),
            "state": scalar(0, torch.int32),     # 0 silence, 1 voice
            "samples": scalar(0, torch.int64)}


def vad_zcr(ring, count, data):
    """The zero-crossing rate vad_update (vad_private.c:117-160) sees after
    each block of data [nb, n] int16: over the last min(count_b, 255)
    samples of the stream, the pairs of neighbours that differ in sign
    count +1 and the others -1.  The stream before the window is the ring
    (its sample at absolute index a sits at a & 255) and count the samples
    before the window.  Returns int64 [nb]."""
    nb, n = data.shape
    dev = data.device
    prior = ring[torch.remainder(count + torch.arange(VAD_RING, device=dev),
                                 VAD_RING)]
    stream = torch.cat([prior, data.reshape(-1)])
    neg = stream < 0
    contrib = torch.where(neg[1:] != neg[:-1], 1, -1)
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(contrib, dim=0)])
    # pairs (j, j+1) of stream positions with j in [end - entries, end - 1)
    end = VAD_RING + n * torch.arange(1, nb + 1, device=dev)
    entries = torch.clamp(count + end - VAD_RING, max=VAD_RING - 1)
    first = end - entries
    last = torch.maximum(end - 1, first)
    return csum[last] - csum[first]


def vad_hysteresis(raw, vstate: int, samples: int, n: int, hysteresis: int):
    """The voice/silence machine of vad_update over per-block raw frame
    types, on the host.  Returns (frame types, vstate, samples)."""
    types = np.zeros(len(raw), np.int32)
    for i, ft in enumerate(raw):
        ft = int(ft)
        if vstate != ft:
            if vstate == 1:      # voice to silence waits out the hysteresis
                samples += n
                if samples >= hysteresis:
                    vstate, samples = ft, 0
            else:
                vstate, samples = ft, 0
        else:
            samples = 0
        types[i] = vstate
    return types, vstate, samples


# ---------------------------------------------------------------------------
# first-order and biquad IIRs (bs2b, bpmdetect, webrtcdsp's high-pass)
# ---------------------------------------------------------------------------


def first_order_iir(d, c, y0):
    """y[n] = c * y[n-1] + d[n], y[-1] = y0, as the JAX package's
    associative scan over the affine maps y -> c*y + d.  d: [N, ...];
    c a number or 0-d tensor; y0 broadcastable to d[0] (a tensor, as the
    carried state is).  In float32 the compose's b2 + a2*b1 and the final
    b + a*y0 are contracted, as the JAX package's compiled scan does it
    (fma32); float64 takes plain products and sums."""
    cs = torch.as_tensor(c, dtype=d.dtype, device=d.device).expand(d.shape)
    fused = d.dtype == torch.float32

    def compose(left, right):
        (a1, b1), (a2, b2) = left, right
        return a1 * a2, fma32(a2, b1, b2) if fused else b2 + a2 * b1

    a, b = associative_scan(compose, (cs, d))
    if fused:
        return fma32(a, torch.as_tensor(y0).expand(a.shape), b)
    return b + a * y0


def bs2b_cross_feed(state, x, coef):
    """libbs2b cross_feed_d on a block x [N, 2] float64: lowpass of the
    opposite channel plus a high boost of the direct one, times gain.
    state {"lo", "hi", "asis"}: [2] float64 carries."""
    lo = first_order_iir(coef["a0_lo"] * x, coef["b1_lo"], state["lo"])
    x_prev = torch.cat([state["asis"][None, :], x[:-1]])
    hi = first_order_iir(coef["a0_hi"] * x + coef["a1_hi"] * x_prev,
                         coef["b1_hi"], state["hi"])
    out = (hi + lo.flip(1)) * coef["gain"]
    return {"lo": lo[-1], "hi": hi[-1], "asis": x[-1]}, out


def bs2b_coefficients(fcut: float, feed: float, rate: int, device="cpu"):
    """libbs2b init(): the filter design from (fcut Hz, feed dB*10,
    rate), in float64 on the host; 0-d float64 tensors on `device`."""
    level = float(feed) / 10.0
    gb_lo = level * -5.0 / 6.0 - 3.0
    gb_hi = level / 6.0 - 3.0
    g_lo = 10.0 ** (gb_lo / 20.0)
    g_hi = 1.0 - 10.0 ** (gb_hi / 20.0)
    fc_lo = float(fcut)
    fc_hi = fc_lo * 2.0 ** ((gb_lo - 20.0 * np.log10(g_hi)) / 12.0)
    x = np.exp(-2.0 * np.pi * fc_lo / rate)
    b1_lo, a0_lo = x, g_lo * (1.0 - x)
    x = np.exp(-2.0 * np.pi * fc_hi / rate)
    b1_hi, a0_hi, a1_hi = x, 1.0 - g_hi * (1.0 - x), -x
    gain = 1.0 / (1.0 - g_hi + g_lo)
    return {k: torch.tensor(float(v), dtype=torch.float64, device=device)
            for k, v in (("b1_lo", b1_lo), ("a0_lo", a0_lo),
                         ("b1_hi", b1_hi), ("a0_hi", a0_hi),
                         ("a1_hi", a1_hi), ("gain", gain))}


def biquad(x, b, a, state):
    """Direct-form-II-transposed biquad over axis 0 as the JAX package's
    associative scan over 2x2 affine maps.  x: [N, C] float32; b = (b0,
    b1, b2), a = (1, a1, a2) float64 numbers; state [2, C] float32 (s1,
    s2).  Returns (y float64, as the JAX package's float64 b0 makes it;
    new_state float32).  Each 2x2 product's two terms sum as XLA's CPU
    dot does: the second term contracted onto the first (fma32)."""
    b0, b1, b2 = b
    _, a1, a2 = a
    n = x.shape[0]
    mat = torch.tensor([[-a1, 1.0], [-a2, 0.0]], dtype=x.dtype,
                       device=x.device)
    bv = torch.tensor([b1 - a1 * b0, b2 - a2 * b0], dtype=x.dtype,
                      device=x.device)
    d = x[:, None, :] * bv[None, :, None]              # [N, 2, C]

    def matmul(m2, m1):   # [n, 2, 2] @ [n, 2, k]
        return fma32(m2[:, :, 1:2], m1[:, None, 1, :],
                      m2[:, :, 0:1] * m1[:, None, 0, :])

    def compose(left, right):
        (m1, v1), (m2, v2) = left, right
        return matmul(m2, m1), matmul(m2, v1) + v2

    ms, vs = associative_scan(compose, (mat.expand(n, 2, 2), d))
    s = matmul(ms, state.expand(n, 2, state.shape[-1])) + vs
    s_prev = torch.cat([state[None], s[:-1]])
    y = b0 * x.to(torch.float64) + s_prev[:, 0, :].to(torch.float64)
    return y, s[-1]


def butter_highpass(fc: float, rate: int):
    """2nd-order Butterworth highpass (bilinear transform), as numbers."""
    w = np.tan(np.pi * fc / rate)
    k = 1.0 / (1.0 + np.sqrt(2.0) * w + w * w)
    b = (k, -2.0 * k, k)
    a = (1.0, 2.0 * k * (w * w - 1.0), k * (1.0 - np.sqrt(2.0) * w + w * w))
    return tuple(float(v) for v in b), tuple(float(v) for v in a)


# ---------------------------------------------------------------------------
# webrtcdsp: STFT, noise suppression, gain control, echo cancellation
# ---------------------------------------------------------------------------


def _hann(frame: int, dtype, device):
    """0.5 - 0.5 cos(2 pi k / frame) with the argument in `dtype`; the
    cosine taken in float64 and rounded (numerics.f32 for float32)."""
    k = torch.arange(frame, dtype=dtype, device=device)
    arg = true_div((2.0 * np.pi) * k, frame)
    return 0.5 - 0.5 * torch.cos(arg.to(torch.float64)).to(dtype)


def stft_frames(x, tail, frame: int):
    """[N, C] signal + [hop, C] carried tail -> Hann analysis frames
    [N // hop, frame, C] at 50% overlap, and the new tail."""
    hop = frame // 2
    n = x.shape[0]
    buf = torch.cat([tail, x])
    f = n // hop
    idx = (torch.arange(f, device=x.device)[:, None] * hop
           + torch.arange(frame, device=x.device)[None, :])
    win = _hann(frame, x.dtype, x.device)
    return buf[idx] * win[None, :, None], buf[n:]


def ola(frames, acc):
    """Overlap-add [F, frame, C] -> ([F*hop, C], new acc [hop, C])."""
    f, frame, c = frames.shape
    hop = frame // 2
    first = frames[:, :hop, :].reshape(f * hop, c)
    second = frames[:, hop:, :].reshape(f * hop, c)
    out = first + torch.cat([acc, second[:-hop]])
    return out, second[-hop:]


NS_SIMULT = 3
NS_END_STARTUP = 200
NS_FACTOR = 40.0
NS_WIDTH = 0.01
NS_QUANTILE = 0.25
NS_LRT_TAVG = 0.50
NS_DD = 0.98
NS_PRIOR_UPDATE = 0.10
NS_GAMMA_NOISE = 0.90
NS_WIDTH_PRIOR = 4.0
NS_THRESH_LRT = 0.5
NS_THRESH_FLAT = 0.30
NS_THRESH_DIFF = 0.25
NS_WEIGHTS = (1.0, 0.0, 0.0)


def ns_init(bins: int, channels: int, device="cpu"):
    """Carried state of noise_suppress (per [bins, C] spectrum)."""
    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return {
        "lquantile": full((NS_SIMULT, bins, channels), 8.0),
        "density": full((NS_SIMULT, bins, channels), 0.3),
        "counter": (torch.arange(NS_SIMULT, dtype=torch.int32, device=device)
                    * (NS_END_STARTUP // NS_SIMULT)),
        "quantile": full((bins, channels), 0.0),
        "updates": torch.zeros((), dtype=torch.int32, device=device),
        "prev_magn": full((bins, channels), 1.0),
        "prev_gain": full((bins, channels), 1.0),
        "log_lrt_tavg": full((bins, channels), 0.0),
        "prior_speech": full((channels,), 0.5),
        "magn_avg_pause": full((bins, channels), 0.0),
    }


def _tanh(x):
    return f32(torch.tanh, x)


def noise_suppress(frames, st, g_min: float):
    """WebRTC-structure noise suppression over Hann frames [F, frame, C]
    float32 (the JAX package's noise_suppress): the spectra, magnitudes
    and the output transforms run batched over the window; the model
    tracking walks the frames in a loop, one set of ops per frame.
    Returns (frames out, new state)."""
    w_lrt, w_flat, w_diff = NS_WEIGHTS
    dev = frames.device
    nfr = frames.shape[1]
    specs = fft.rfft(frames, dim=1)
    magns = torch.abs(specs).to(torch.float32)
    lmagns = f32(torch.log, torch.clamp(magns, min=1e-10))

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    factor, half_width = const(NS_FACTOR), const(1.0 / (2.0 * NS_WIDTH))
    one = const(1.0)
    gains = []
    for magn, lmagn in zip(magns.unbind(0), lmagns.unbind(0)):
        counter = st["counter"] + 1
        cnt = counter.to(torch.float32)[:, None, None]
        delta = torch.where(st["density"] > 1.0, factor / st["density"],
                            factor)
        above = lmagn[None] > st["lquantile"]
        lq = st["lquantile"] + torch.where(
            above, NS_QUANTILE * delta / cnt,
            -(1.0 - NS_QUANTILE) * delta / cnt)
        dens = torch.where(
            torch.abs(lmagn[None] - lq) < NS_WIDTH,
            ((cnt - 1.0) * st["density"] + half_width) / cnt,
            st["density"])
        wrap = counter >= NS_END_STARTUP
        live_q = f32(torch.exp, lq[torch.argmax(counter)])
        carried = st["quantile"]
        noise_prev = torch.where(
            st["updates"] < NS_END_STARTUP, live_q,
            torch.where(wrap.any(), 0.5 * (carried + live_q), carried))
        noise_prev = torch.clamp(noise_prev, min=1e-10)
        counter = torch.where(wrap, 0, counter).to(torch.int32)
        lq = torch.where(wrap[:, None, None], lmagn[None].expand(lq.shape),
                         lq)
        dens = torch.where(wrap[:, None, None], 0.3, dens)

        np2 = torch.square(noise_prev)
        snr_post = torch.clamp(torch.square(magn) / np2 - 1.0, min=0.0)
        prev_est = (torch.square(st["prev_gain"])
                    * torch.square(st["prev_magn"]) / np2)
        snr_prior = NS_DD * prev_est + (1.0 - NS_DD) * snr_post
        lrt = (snr_post * snr_prior / (1.0 + snr_prior)
               - f32(torch.log1p, snr_prior))
        log_lrt = (st["log_lrt_tavg"]
                   + NS_LRT_TAVG * (lrt - st["log_lrt_tavg"]))
        feat_lrt = torch.mean(log_lrt, dim=0)
        flat = (f32(torch.exp, torch.mean(lmagn, dim=0))
                / torch.clamp(torch.mean(magn, dim=0), min=1e-10))
        pause = st["magn_avg_pause"]
        avg_m = torch.mean(magn, dim=0, keepdim=True)
        avg_p = torch.mean(pause, dim=0, keepdim=True)
        num = torch.sum((magn - avg_m) * (pause - avg_p), dim=0)
        den = torch.clamp(torch.sum(torch.square(pause - avg_p), dim=0),
                          min=1e-10)
        resid = (magn - avg_m) - (pause - avg_p) * (num / den)[None]
        diff = (torch.sum(torch.square(resid), dim=0)
                / torch.clamp(torch.sum(torch.square(avg_m))
                              * magn.shape[0], min=1e-10))
        ind0 = 0.5 * (_tanh(NS_WIDTH_PRIOR * (feat_lrt - NS_THRESH_LRT))
                      + 1.0)
        ind1 = 0.5 * (_tanh(2.0 * NS_WIDTH_PRIOR * (NS_THRESH_FLAT - flat))
                      + 1.0)
        ind2 = 0.5 * (_tanh(NS_WIDTH_PRIOR * (diff - NS_THRESH_DIFF))
                      + 1.0)
        ind = w_lrt * ind0 + w_flat * ind1 + w_diff * ind2
        prior = (st["prior_speech"]
                 + NS_PRIOR_UPDATE * (ind - st["prior_speech"]))
        gain_prior = (1.0 - prior) / (prior + 1e-4)
        p_speech = one / (1.0 + gain_prior[None]
                          * f32(torch.exp, -log_lrt))
        pause = torch.where((prior < 0.5)[None], pause + 0.1 * (magn - pause),
                            pause)
        noise = (NS_GAMMA_NOISE * noise_prev
                 + (1.0 - NS_GAMMA_NOISE)
                 * ((1.0 - p_speech) * magn + p_speech * noise_prev))
        gain = torch.clamp(snr_prior / (1.0 + snr_prior), min=g_min,
                           max=1.0)
        gains.append(gain)
        st = {"lquantile": lq, "density": dens, "counter": counter,
              "quantile": noise,
              "updates": torch.clamp(st["updates"] + 1, max=2 ** 30),
              "prev_magn": magn, "prev_gain": gain, "log_lrt_tavg": log_lrt,
              "prior_speech": prior, "magn_avg_pause": pause}
    if not gains:
        return frames, st
    out = fft.irfft(specs * torch.stack(gains), n=nfr, dim=1)
    return out.to(torch.float32), st


def agc_adaptive(levels_db, gain_db0, target_dbfs, max_gain_db,
                 rate_db: float = 0.5):
    """Adaptive-digital gain walk over the 10 ms frames' levels [F]
    (0-d float32 tensors for the start gain, target and cap).  Returns
    (final gain, gains [F])."""
    g = gain_db0
    gains = []
    for lvl in levels_db.unbind(0):
        desired = torch.clamp(-target_dbfs - lvl, min=0.0)
        desired = torch.minimum(desired, max_gain_db)
        g2 = g + torch.clamp(desired - g, -rate_db, rate_db)
        g = torch.where(lvl < -70.0, g, g2)
        gains.append(g)
    return g, torch.stack(gains)


AEC_MU = 0.5
AEC_LAMBDA = 0.92


def aec_init(frame: int, channels: int, partitions: int, device="cpu"):
    """Carried state of aec_cancel."""
    bins2 = frame + 1
    f32_, c64 = torch.float32, torch.complex64

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "W": z((partitions, bins2, channels), c64),
        "Xf": z((partitions, bins2, channels), c64),
        "far_prev": z((frame, channels), f32_),
        "d_prev": z((frame, channels), f32_),
        "e_prev": z((frame, channels), f32_),
        "sd": torch.full((bins2, channels), 1e2, dtype=f32_, device=device),
        "se": torch.full((bins2, channels), 1e2, dtype=f32_, device=device),
        "sx": torch.full((bins2, channels), 1e2, dtype=f32_, device=device),
        "sde": z((bins2, channels), c64),
        "sxd": z((bins2, channels), c64),
    }


def aec_cancel(near, far, st, overdrive: float, mu: float = AEC_MU):
    """Cancel `far`'s echo from `near` ([N, C] float32, N a multiple of
    the 10 ms block), as the JAX package's aec_cancel: a partitioned
    frequency-domain NLMS filter with the gradient constraint and the
    coherence suppressor.  The far end's and the near end's block spectra
    are taken for the whole window at once; the adaptation walks the
    blocks in a loop.  Returns (out [N, C], new state)."""
    n, c = near.shape
    frame = st["far_prev"].shape[0]
    nb = n // frame
    nfft = 2 * frame
    dev = near.device
    d_blocks = near.reshape(nb, frame, c).to(torch.float32)
    x_blocks = far.reshape(nb, frame, c).to(torch.float32)
    # the float32 constants and their complements, as float32 arithmetic
    # forms them
    lam = float(np.float32(AEC_LAMBDA))
    lam_c = float(np.float32(1.0) - np.float32(AEC_LAMBDA))
    mu = float(np.float32(mu))
    zpad = torch.zeros((frame, c), dtype=torch.float32, device=dev)
    # the spectra of [previous block, block] for the far and near ends
    x_prev = torch.cat([st["far_prev"][None], x_blocks[:-1]])
    d_prev = torch.cat([st["d_prev"][None], d_blocks[:-1]])
    xs = fft.rfft(torch.cat([x_prev, x_blocks], dim=1), dim=1)
    ds = fft.rfft(torch.cat([d_prev, d_blocks], dim=1), dim=1)
    far_acts = torch.mean(torch.square(x_blocks), dim=1) > 1.0   # [nb, C]
    W, Xf = st["W"], st["Xf"]
    e_prev = st["e_prev"]
    sd, se, sx, sde, sxd = (st[k] for k in ("sd", "se", "sx", "sde", "sxd"))
    outs = []
    for k in range(nb):
        d, X, D, far_act = d_blocks[k], xs[k], ds[k], far_acts[k]
        Xf = torch.cat([X[None], Xf[:-1]])
        yh = fft.irfft(torch.sum(W * Xf, dim=0), n=nfft,
                             dim=0)[frame:].to(torch.float32)
        e = d - yh
        E = fft.rfft(torch.cat([zpad, e]), dim=0)
        spow = torch.sum(torch.square(torch.abs(Xf)), dim=0)
        denom = spow + 1e-3 * torch.mean(spow) + 1e-6
        E = mu * E
        G = torch.complex(E.real / denom, E.imag / denom)
        Wn = W + torch.conj(Xf) * G[None]
        wt = fft.irfft(Wn, n=nfft, dim=1)
        wt[:, frame:, :] = 0.0
        Wn = fft.rfft(wt, dim=1)
        W = torch.where(far_act[None, None], Wn, W)
        Ew = fft.rfft(torch.cat([e_prev, e]), dim=0)
        lam_x = torch.where(far_act, lam, 0.5).to(torch.float32)[None]
        sd = lam * sd + lam_c * torch.square(torch.abs(D))
        se = lam * se + lam_c * torch.square(torch.abs(Ew))
        sx = lam_x * sx + (1.0 - lam_x) * torch.square(torch.abs(X))
        sde = lam * sde + lam_c * (torch.conj(D) * Ew)
        sxd = lam_x * sxd + (1.0 - lam_x) * (torch.conj(X) * D)
        cohde = torch.square(torch.abs(sde)) / (sd * se + 1e-10)
        cohxd = torch.square(torch.abs(sxd)) / (sx * sd + 1e-10)
        hnl = torch.clamp(torch.minimum(cohde, 1.0 - cohxd), 0.0, 1.0)
        fifo_act = torch.sum(spow, dim=0) > 1e-3
        hnl = torch.where(fifo_act[None], hnl, 1.0)
        if overdrive > 0.0:
            gain = f32(lambda v: torch.pow(v, overdrive),
                       torch.clamp(hnl, min=1e-6))
        else:
            gain = torch.ones_like(hnl)
        outs.append(Ew * gain)
        e_prev = e
    out = fft.irfft(torch.stack(outs), n=nfft, dim=1)[:, frame:]
    new = {"W": W, "Xf": Xf, "far_prev": x_blocks[-1], "d_prev": d_blocks[-1],
           "e_prev": e_prev, "sd": sd, "se": se, "sx": sx, "sde": sde,
           "sxd": sxd}
    return out.to(torch.float32).reshape(n, c), new


# ---------------------------------------------------------------------------
# pitch: the phase vocoder and the linear resampler
# ---------------------------------------------------------------------------


def pv_init_state(frame: int, ha: int, hs: int, channels: int,
                  device="cpu"):
    bins = frame // 2 + 1

    def z(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"in_tail": z((frame - ha, channels)),
            "prev_ph": z((bins, channels)), "synth_ph": z((bins, channels)),
            "ola": z((frame - hs, channels)),
            "primed": torch.zeros((), dtype=torch.bool, device=device)}


def phase_vocoder(x, state, frame: int, ha: int, hs: int):
    """Time-stretch x [N, C] float32 by hs/ha with a Hann phase vocoder
    (the JAX package's phase_vocoder): the frames' spectra and the
    synthesis transforms batch over the window, the synthesis phase is a
    walk over the frames (one add each, in order), and the overlap-add
    sums each output sample's frames in frame order.  The synthesis phase
    is never wrapped, so a phase an ulp apart stays apart in every later
    frame: the analysis phase is a float32 atan2 (jnp.angle's), and the
    wrap and each phase step round once, as the JAX package's compiled
    window contracts them into FMAs.  Returns (stretched [N // ha * hs, C],
    new state)."""
    n, c = x.shape
    dev = x.device
    f = n // ha
    buf = torch.cat([state["in_tail"], x])
    idx = (torch.arange(f, device=dev)[:, None] * ha
           + torch.arange(frame, device=dev)[None, :])
    k = torch.arange(frame, dtype=torch.float64, device=dev)
    win = (0.5 - 0.5 * torch.cos(true_div(2.0 * np.pi * k, frame))
           ).to(torch.float32)
    spec = fft.rfft(buf[idx] * win[None, :, None], dim=1)
    mag = torch.abs(spec).to(torch.float32)
    ph = torch.atan2(spec.imag, spec.real)
    bins = frame // 2 + 1
    omega = true_div(2.0 * np.pi * torch.arange(
        bins, dtype=torch.float64, device=dev), frame).to(
        torch.float32)[:, None]
    expected = omega * ha
    two_pi = torch.full((), 2.0 * np.pi, dtype=torch.float32, device=dev)
    prev = torch.cat([state["prev_ph"][None], ph[:-1]])
    dph = ph - prev - expected
    r = torch.round(dph / two_pi)
    dph = fma32(torch.full_like(r, -2.0 * np.pi), r, dph)
    # each step's float64 product is exact; adding it to the float32
    # phase in float64 and writing float32 rounds as fma32 does, in one op
    step = (omega + true_div(dph, ha)).to(torch.float64) * hs
    phases = torch.empty_like(ph)
    phases[0] = torch.where(state["primed"],
                            (state["synth_ph"] + step[0]).to(torch.float32),
                            ph[0])
    rows, steps = phases.unbind(0), step.unbind(0)
    for i in range(1, f):
        torch.add(rows[i - 1], steps[i], out=rows[i])
    re = torch.cos(phases.to(torch.float64)).to(torch.float32)
    im = torch.sin(phases.to(torch.float64)).to(torch.float32)
    out_frames = fft.irfft(torch.complex(mag * re, mag * im), n=frame,
                                 dim=1).to(torch.float32)
    out_frames = out_frames * win[None, :, None]
    norm = 0.375 * frame / hs
    total = f * hs + (frame - hs)
    # sample t sums frames first(t), first(t) + 1, ... in order, from 0
    t = torch.arange(total, device=dev)
    first = torch.clamp(torch.div(t - frame + hs, hs, rounding_mode="floor"),
                        min=0)
    out = torch.zeros((total, c), dtype=torch.float32, device=dev)
    flat = out_frames.reshape(f * frame, c)
    for j in range(-(-frame // hs)):
        i = first + j
        ok = (i < f) & (i * hs <= t)
        src = torch.where(ok, i * frame + t - i * hs, 0)
        out = out + torch.where(ok[:, None], flat[src], 0.0)
    out[: frame - hs] = out[: frame - hs] + state["ola"]
    stretched = true_div(out[: f * hs], norm)
    new = {"in_tail": buf[n:], "prev_ph": ph[-1], "synth_ph": phases[-1],
           "ola": out[f * hs:],
           "primed": torch.ones((), dtype=torch.bool, device=dev)}
    return stretched, new


def resample_linear(x, n_out: int):
    """[N, C] -> [n_out, C] linear resample spanning the whole input."""
    n = x.shape[0]
    k = torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5
    # the position's product and offset, and the first tap's product
    # onto the second's, contracted as the JAX package's compiled form
    pos = fma32(k, torch.full_like(k, n / n_out), torch.full_like(k, -0.5))
    pos = torch.clamp(pos, 0.0, n - 1.0)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    a = (pos - i0)[:, None]
    x0 = x[i0]
    return fma32(x0, (1.0 - a).expand(x0.shape), x[i1] * a)


# ---------------------------------------------------------------------------
# ADPCM (gst/adpcmdec/adpcmdec.c, gst/adpcmenc/adpcmenc.c): the per-sample
# walks, hand-written CUDA kernels on the card (csrc/adpcm_kernels.cu)
# ---------------------------------------------------------------------------

IMA_INDEX_ADJUST = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)
IMA_STEP_SIZE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)
MS_ADAPTATION = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                          768, 614, 512, 409, 307, 230, 230, 230], np.int32)
MS_COEFF1 = np.array([256, 512, 0, 192, 240, 460, 392], np.int32)
MS_COEFF2 = np.array([0, -256, 0, 64, 0, -208, -232], np.int32)


def _wrap16(v):
    """Two's-complement wrap of int32 values to int16's range."""
    return ((v + 32768) & 0xFFFF) - 32768


def _rd16s(b, off):
    return _wrap16(b[:, off] | (b[:, off + 1] << 8))


def _table(values, device):
    return torch.from_numpy(values.astype(np.int32)).to(device)


def _check_blocks(name, blocks, channels, header):
    if blocks.dtype != torch.uint8 or blocks.ndim != 2:
        raise ValueError(f"{name}: blocks must be uint8 [B, blocksize], got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    if channels not in (1, 2) or blocks.shape[1] < header * channels:
        raise ValueError(f"{name}: {channels} channels in blocks of "
                         f"{blocks.shape[1]} bytes")


def adpcm_ima_groups(blocksize: int, channels: int) -> int:
    """The whole 8-sample groups per channel of an IMA block."""
    return (blocksize - 4 * channels) // (4 * channels)


def adpcm_ima_decode_plain(blocks, channels: int):
    """The plain form of adpcm_ima_decode: the step-index walk and the
    clamped accumulation (adpcmdec.c:302-328) as a loop over the code
    positions, each step one set of ops over every (block, channel)."""
    b = blocks.to(torch.int32)
    dev = b.device
    nb, bsz = b.shape
    groups = adpcm_ima_groups(bsz, channels)
    hdr = b[:, :4 * channels].reshape(nb, channels, 4)
    s = _wrap16(hdr[..., 0] | (hdr[..., 1] << 8))
    si = torch.clamp(hdr[..., 2], max=88)
    body = b[:, 4 * channels:4 * channels + groups * 4 * channels].reshape(
        nb, groups, channels, 4)
    ch_bytes = body.permute(0, 2, 1, 3).reshape(nb, channels, groups * 4)
    codes = torch.stack([ch_bytes & 0x0F, (ch_bytes >> 4) & 0x0F],
                        dim=-1).reshape(nb, channels, groups * 8)
    step_tab, adj = _table(IMA_STEP_SIZE, dev), _table(IMA_INDEX_ADJUST, dev)
    out = [s]
    for code in codes.unbind(2):
        stepv = step_tab[si]
        diff = (2 * (code & 7) * stepv + stepv) >> 3
        diff = torch.where((code & 8) != 0, -diff, diff)
        s = torch.clamp(s + diff, -32768, 32767)
        si = torch.clamp(si + adj[code], 0, 88)
        out.append(s)
    return torch.stack(out, dim=1).to(torch.int16)


def adpcm_ima_decode(blocks, channels: int):
    """IMA/DVI ADPCM blocks uint8 [B, blocksize] -> int16 [B, 1 + 8G, C]
    (G = adpcm_ima_groups).

    Not a TPU kernel: it replaces the JAX package's lax.scan
    (gstbad_tpu/ops/audio.py:1442).  CPU tensors take
    adpcm_ima_decode_plain; CUDA tensors launch
    csrc/adpcm_kernels.cu:ima_decode_kernel (one thread per block and
    channel) or raise."""
    _check_blocks("adpcm_ima_decode", blocks, channels, 4)
    if blocks.device.type == "cpu":
        return adpcm_ima_decode_plain(blocks, channels)
    from gstbad_tpu_torch.ops import _cuda
    blocks = blocks.contiguous()
    nb, bsz = blocks.shape
    n = 1 + 8 * adpcm_ima_groups(bsz, channels)
    out = torch.empty((nb, n, channels), dtype=torch.int16,
                      device=blocks.device)
    if nb:
        _cuda.launch("gst_adpcm_ima_decode", blocks, out, nb, bsz, channels)
        adpcm_ima_decode.launches += 1
    return out


adpcm_ima_decode.launches = 0


def adpcm_ms_samples(blocksize: int, channels: int) -> int:
    """Samples per channel of a Microsoft ADPCM block."""
    return 2 + (blocksize - 7 * channels) * 2 // channels


def adpcm_ms_decode_plain(blocks, channels: int):
    """The plain form of adpcm_ms_decode (adpcmdec_decode_ms_block,
    adpcmdec.c:180-252): a loop over the code positions, each step one set
    of ops over every (block, channel).  The adapted delta wraps to 16
    bits before its floor of 16, as the C's gint16 does."""
    b = blocks.to(torch.int32)
    dev = b.device
    nb = b.shape[0]
    if channels == 1:
        pred = b[:, 0:1]
        delta = _rd16s(b, 1)[:, None]
        s1 = _rd16s(b, 3)[:, None]
        s2 = _rd16s(b, 5)[:, None]
        init = torch.stack([s2, s1], dim=1)               # [B, 2, 1]
        data_off = 7
    else:
        pred = b[:, 0:2]
        delta = torch.stack([_rd16s(b, 2), _rd16s(b, 4)], dim=1)
        s1 = torch.stack([_rd16s(b, 6), _rd16s(b, 8)], dim=1)
        s2 = torch.stack([_rd16s(b, 10), _rd16s(b, 12)], dim=1)
        init = torch.stack([s2, s1], dim=1)               # [B, 2, 2]
        data_off = 14
    # the JAX package's gather clamps a predictor index past the table
    pred = torch.clamp(pred, max=len(MS_COEFF1) - 1)
    coef1 = _table(MS_COEFF1, dev)[pred]
    coef2 = _table(MS_COEFF2, dev)[pred]
    adapt = _table(MS_ADAPTATION, dev)
    body = b[:, data_off:]
    codes = torch.stack([(body >> 4) & 0x0F, body & 0x0F],
                        dim=-1).reshape(nb, -1, channels)
    out = []
    for code in codes.unbind(1):
        nd = _wrap16((adapt[code] * delta) >> 8)
        signed = code - torch.where((code & 8) != 0, 16, 0)
        predict = (s1 * coef1 + s2 * coef2) >> 8
        cur = torch.clamp(signed * delta + predict, -32768, 32767)
        s1, s2, delta = cur, s1, torch.clamp(nd, min=16)
        out.append(cur)
    seq = (torch.stack(out, dim=1) if out else
           torch.zeros((nb, 0, channels), dtype=torch.int32, device=dev))
    return torch.cat([init, seq], dim=1).to(torch.int16)


def adpcm_ms_decode(blocks, channels: int):
    """Microsoft ADPCM blocks uint8 [B, blocksize] -> int16 [B,
    adpcm_ms_samples, C].

    Not a TPU kernel: it replaces the JAX package's lax.scan
    (gstbad_tpu/ops/audio.py:1485).  CPU tensors take
    adpcm_ms_decode_plain; CUDA tensors launch
    csrc/adpcm_kernels.cu:ms_decode_kernel (one thread per block and
    channel) or raise."""
    _check_blocks("adpcm_ms_decode", blocks, channels, 7)
    if blocks.device.type == "cpu":
        return adpcm_ms_decode_plain(blocks, channels)
    from gstbad_tpu_torch.ops import _cuda
    blocks = blocks.contiguous()
    nb, bsz = blocks.shape
    out = torch.empty((nb, adpcm_ms_samples(bsz, channels), channels),
                      dtype=torch.int16, device=blocks.device)
    if nb:
        _cuda.launch("gst_adpcm_ms_decode", blocks, out, nb, bsz, channels)
        adpcm_ms_decode.launches += 1
    return out


adpcm_ms_decode.launches = 0


def adpcm_ima_encode_plain(samples, step_index0):
    """The plain form of adpcm_ima_encode: adpcmenc's per-sample quantizer
    (the 3-bit magnitude search) as a loop over the window's samples in
    order, on host integers, one walk per channel.  prev resets to each
    block's first sample; the step index carries across blocks."""
    nb, n, c = samples.shape
    x = samples.detach().cpu().to(torch.int64).numpy().reshape(nb * n, c)
    codes = np.zeros((nb * n, c), np.int32)
    seen = np.zeros((nb * n, c), np.int32)
    final = np.zeros(c, np.int32)
    tab = IMA_STEP_SIZE.tolist()
    adj = IMA_INDEX_ADJUST.tolist()
    si0 = step_index0.detach().cpu().tolist()
    for ch in range(c):
        col = x[:, ch].tolist()
        prev, si = 0, int(si0[ch])
        code_col, seen_col = [0] * len(col), [0] * len(col)
        for i, s in enumerate(col):
            seen_col[i] = si
            if i % n == 0:
                prev = s
                continue
            diff = s - prev
            sign = diff < 0
            diff = -diff if sign else diff
            stepv = tab[min(max(si, 0), 88)]
            vpdiff = stepv >> 3
            code = 0
            for bit in (4, 2, 1):
                if diff >= stepv:
                    code |= bit
                    diff -= stepv
                    vpdiff += stepv
                stepv >>= 1
            if sign:
                code |= 8
                vpdiff = -vpdiff
            prev = min(max(prev + vpdiff, -32768), 32767)
            si = min(max(si + adj[code], 0), 88)
            code_col[i] = code
        codes[:, ch], seen[:, ch], final[ch] = code_col, seen_col, si
    dev = samples.device
    codes_t, seen_t, final_t = to_device(dev, codes, seen, final)
    return (codes_t.reshape(nb, n, c), seen_t.reshape(nb, n, c)[:, 0],
            final_t)


def adpcm_ima_encode(samples, step_index0):
    """int16 [B, n, C] -> (codes int32 [B, n, C] with codes[:, 0] 0 (the
    header slot), header step index int32 [B, C] (the carried index
    before each block's first step), step index int32 [C] after the
    window).

    Not a TPU kernel: it replaces the JAX package's lax.scan
    (gstbad_tpu/ops/audio.py:1532).  CPU tensors take
    adpcm_ima_encode_plain; CUDA tensors launch
    csrc/adpcm_kernels.cu:ima_encode_kernel (one thread per channel
    walks the window) or raise."""
    if samples.dtype != torch.int16 or samples.ndim != 3 \
            or step_index0.shape != (samples.shape[2],):
        raise ValueError(f"adpcm_ima_encode: samples int16 [B, n, C] and "
                         f"a step index [C], got {samples.dtype} "
                         f"{tuple(samples.shape)}, "
                         f"{tuple(step_index0.shape)}")
    if samples.device.type == "cpu":
        return adpcm_ima_encode_plain(samples, step_index0)
    from gstbad_tpu_torch.ops import _cuda
    nb, n, c = samples.shape
    samples = samples.contiguous()
    si0 = step_index0.to(torch.int32).contiguous()
    codes = torch.empty((nb, n, c), dtype=torch.int32, device=samples.device)
    header = torch.empty((nb, c), dtype=torch.int32, device=samples.device)
    final = torch.empty((c,), dtype=torch.int32, device=samples.device)
    _cuda.launch("gst_adpcm_ima_encode", samples, si0, codes, header, final,
                 nb, n, c)
    adpcm_ima_encode.launches += 1
    return codes, header, final


adpcm_ima_encode.launches = 0


# ---------------------------------------------------------------------------
# the scopes' two-stage resonant filter (gstwavescope.c:302-310,
# gstspacescope.c:263-283): a float64 walk over the samples, a
# hand-written CUDA kernel on the card (csrc/scope_kernels.cu)
# ---------------------------------------------------------------------------


SCOPE_SLOT = 512    # samples x channels of a chunk of the kernel's rings


def scope_chunk(c: int) -> int:
    """The samples of a chunk csrc/scope_kernels.cu walks for c channels
    (even, so that a chunk's taps start 16-byte aligned)."""
    return (SCOPE_SLOT // c) & ~1


def scope_filter_plain(state, x):
    """The plain form of scope_filter: the per-sample float64 filter as a
    loop over the samples on the host, one walk per channel.  The four
    updates `carry + value * constant` take one rounding (fma64), as the
    JAX package's compiled scan contracts them into FMAs; every other
    product and sum rounds on its own (Python floats contract nothing)."""
    n, c = x.shape
    xs = x.detach().cpu().to(torch.float64).numpy()
    st = state.detach().cpu().numpy().reshape(c, 6).copy()
    taps = np.zeros((n, 3, c), np.float64)
    for ch in range(c):
        f0, f1, f2, f3, f4, f5 = (float(v) for v in st[ch])
        col = xs[:, ch].tolist()
        t0, t1, t2 = [0.0] * n, [0.0] * n, [0.0] * n
        for i, inp in enumerate(col):
            f2 = inp - f1 * 2.0 - f0
            f1 = fma64(f2, 0.15, f1)
            f0 = fma64(f1, 0.15, f0)
            f5 = (f1 + f2) - f4 * 2.0 - f3
            f4 = fma64(f5, 0.45, f4)
            f3 = fma64(f4, 0.45, f3)
            t0[i], t1[i], t2[i] = f0, f3, f4 + f5
        taps[:, 0, ch], taps[:, 1, ch], taps[:, 2, ch] = t0, t1, t2
        st[ch] = (f0, f1, f2, f3, f4, f5)
    new_state, taps_t = to_device(x.device, st.reshape(-1), taps)
    return new_state, taps_t


def scope_filter(state, x):
    """The scopes' resonant filter over a window's samples: state float64
    [6C] (each channel's six carries in turn), x [N, C] (int32 sample
    values) -> (new state, taps float64 [N, 3, C]: the first stage's
    output, the second stage's, and the second stage's sum, per sample
    and channel).

    Not a TPU kernel: it replaces the JAX package's lax.scan
    (gstbad_tpu/elements/audio/visualizers.py:228 for wavescope, :381 for
    spacescope).  CPU tensors take scope_filter_plain; CUDA tensors launch
    csrc/scope_kernels.cu:scope_filter_kernel (one thread per channel
    walks, three warps move x and the taps through shared memory in
    chunks of scope_chunk(C) samples) or raise."""
    if x.ndim != 2 or state.dtype != torch.float64 \
            or state.shape != (6 * x.shape[1],):
        raise ValueError(f"scope_filter: state float64 [6C] and x [N, C], "
                         f"got {state.dtype} {tuple(state.shape)} and "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return scope_filter_plain(state, x)
    from gstbad_tpu_torch.ops import _cuda
    n, c = x.shape
    x = x.to(torch.int32).contiguous()
    state = state.contiguous()
    taps = torch.empty((n, 3, c), dtype=torch.float64, device=x.device)
    new_state = torch.empty_like(state)
    _cuda.launch("gst_scope_filter", state, x, taps, new_state, n, c)
    scope_filter.launches += 1
    return new_state, taps


scope_filter.launches = 0
