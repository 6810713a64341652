"""Audio DSP: the audiomixmatrix paths, the freeverb reverb and the
removesilence VAD power recurrence (gstbad_tpu/ops/audio.py).

freeverb's sample-serial feedback (8 parallel combs and 4 series
allpasses per side, gstfreeverb.c:288-330) runs as plain torch ops in two
forms, both exact rewrites of the serial loop up to float32 reassociation
(within 2e-6 of the serial C, the JAX package's own gate): a whole-window
form for windows at least as long as the longest delay line, whose only
serial part is a walk over blocks of the shortest comb delay, and a
128-sample block walk for shorter windows.

The VAD power recurrence is one hand-written CUDA kernel template
(csrc/vad_kernels.cu) with two entry points: `vad_powers_serial`, the port
of the TPU kernel, and `vad_powers_bracket`, which runs every block from
the two extreme powers at once.  CPU tensors take their plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from gstbad_tpu_torch.core.frame import to_device

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


@contextlib.contextmanager
def _full_fp32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside the block,
    whatever the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def freeverb_process(state, x, params, rate: int, mono: bool):
    """Reverb over one window.  x: [N] (mono) or [N, 2] float32 ->
    (state, [N, 2] float32).

    params: 0-d float32 tensors feedback, damp1, damp2, wet1, wet2, dry,
    gain (gst_freeverb_set_property, gstfreeverb.c:536-570)."""
    if rate < 32000:
        raise NotImplementedError(
            f"freeverb at {rate} Hz: the per-sample form the JAX package "
            "takes below 32 kHz is not ported to gstbad_tpu_torch yet "
            "(ROADMAP queue 1)")
    sizes = freeverb_sizes(rate)
    dmax = int(max(sizes["combR"].max(), sizes["apR"].max()))
    with _full_fp32_matmul():
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
    csrc/vad_kernels.cu:vad_power_kernel<true> or raise."""
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
    csrc/vad_kernels.cu:vad_power_kernel<false> or raise."""
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
