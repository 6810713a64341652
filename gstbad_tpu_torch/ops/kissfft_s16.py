"""Bit-exact kissfft FIXED_POINT=16 (the engine under gst_fft_s16), the
torch form of gstbad_tpu/ops/kissfft_s16.py.

  smul(a,b)    = (int32) a * b
  sround(x)    = (x + 2^14) >> 15                (arithmetic shift)
  C_MUL        = complex multiply with sround on each part
  DIVSCALAR(k) = sround(smul(x, 32767 // k))     (per-stage C_FIXDIV)
  HALF_OF(x)   = x >> 1
  twiddles[i]  = floor(.5 + 32767 * cos/sin(-2 pi i / n))

The recursion (kf_work) is an input permutation plus one stage per
factor: every butterfly of a stage shares its (p, m, fstride), so a stage
is one reshape to [..., segments, p, m] and a radix-p butterfly over the
whole batch.  All arithmetic is int32 (the 2*32767^2 + 2^14 worst case
fits), so the card and the CPU give the same spectra.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

FRACBITS = 15
SAMP_MAX = 32767


def kf_factor(n: int) -> list:
    """kissfft kf_factor: powers of 4 first, then 2, 3, odd primes."""
    out = []
    p = 4
    floor_sqrt = int(np.floor(np.sqrt(n)))
    while n > 1:
        while n % p:
            if p == 4:
                p = 2
            elif p == 2:
                p = 3
            else:
                p += 2
            if p > floor_sqrt:
                p = n
        n //= p
        out.append(p)
    return out


@lru_cache(maxsize=None)
def _plan(ncfft: int):
    """(factors, ms, fstrides, perm, twiddles r/i, super twiddles r/i) as
    numpy arrays."""
    factors = kf_factor(ncfft)
    ms = []
    sub = ncfft
    for p in factors:
        sub //= p
        ms.append(sub)
    fstrides = []
    f = 1
    for p in factors:
        fstrides.append(f)
        f *= p

    perm = np.zeros(ncfft, np.int64)

    def work(out_pos, in_idx, fstride, d):
        p, m = factors[d], ms[d]
        if m == 1:
            for q in range(p * m):
                perm[out_pos + q] = in_idx + q * fstride
        else:
            for q in range(p):
                work(out_pos + q * m, in_idx + q * fstride, fstride * p,
                     d + 1)

    work(0, 0, 1, 0)

    i = np.arange(ncfft, dtype=np.float64)
    phase = -2.0 * np.pi * i / ncfft
    tw_r = np.floor(0.5 + SAMP_MAX * np.cos(phase)).astype(np.int32)
    tw_i = np.floor(0.5 + SAMP_MAX * np.sin(phase)).astype(np.int32)

    k = np.arange(ncfft // 2, dtype=np.float64)
    sphase = -np.pi * ((k + 1) / ncfft + 0.5)
    stw_r = np.floor(0.5 + SAMP_MAX * np.cos(sphase)).astype(np.int32)
    stw_i = np.floor(0.5 + SAMP_MAX * np.sin(sphase)).astype(np.int32)
    return factors, ms, fstrides, perm, tw_r, tw_i, stw_r, stw_i


def _sround(x):
    return (x + (1 << (FRACBITS - 1))) >> FRACBITS


def _cmul(ar, ai, br, bi):
    return _sround(ar * br - ai * bi), _sround(ar * bi + ai * br)


def _fixdiv(r, i, k):
    s = SAMP_MAX // k
    return _sround(r * s), _sround(i * s)


def _bfly2(r, i, twr, twi):
    """r/i: [..., S, 2, m]; tw: [m] int32."""
    f0r, f0i = _fixdiv(r[..., 0, :], i[..., 0, :], 2)
    f1r, f1i = _fixdiv(r[..., 1, :], i[..., 1, :], 2)
    tr, ti = _cmul(f1r, f1i, twr, twi)
    return (torch.stack([f0r + tr, f0r - tr], dim=-2),
            torch.stack([f0i + ti, f0i - ti], dim=-2))


def _bfly4(r, i, tw1r, tw1i, tw2r, tw2i, tw3r, tw3i):
    f0r, f0i = _fixdiv(r[..., 0, :], i[..., 0, :], 4)
    f1r, f1i = _fixdiv(r[..., 1, :], i[..., 1, :], 4)
    f2r, f2i = _fixdiv(r[..., 2, :], i[..., 2, :], 4)
    f3r, f3i = _fixdiv(r[..., 3, :], i[..., 3, :], 4)
    s0r, s0i = _cmul(f1r, f1i, tw1r, tw1i)
    s1r, s1i = _cmul(f2r, f2i, tw2r, tw2i)
    s2r, s2i = _cmul(f3r, f3i, tw3r, tw3i)
    s5r, s5i = f0r - s1r, f0i - s1i
    f0r, f0i = f0r + s1r, f0i + s1i
    s3r, s3i = s0r + s2r, s0i + s2i
    s4r, s4i = s0r - s2r, s0i - s2i
    o2r, o2i = f0r - s3r, f0i - s3i
    o0r, o0i = f0r + s3r, f0i + s3i
    # the forward (st->inverse == 0) branch
    o1r, o1i = s5r + s4i, s5i - s4r
    o3r, o3i = s5r - s4i, s5i + s4r
    return (torch.stack([o0r, o1r, o2r, o3r], dim=-2),
            torch.stack([o0i, o1i, o2i, o3i], dim=-2))


def _bfly3(r, i, twr, twi, tw2r, tw2i, epi3_i: int):
    f0r, f0i = _fixdiv(r[..., 0, :], i[..., 0, :], 3)
    f1r, f1i = _fixdiv(r[..., 1, :], i[..., 1, :], 3)
    f2r, f2i = _fixdiv(r[..., 2, :], i[..., 2, :], 3)
    s1r, s1i = _cmul(f1r, f1i, twr, twi)
    s2r, s2i = _cmul(f2r, f2i, tw2r, tw2i)
    s3r, s3i = s1r + s2r, s1i + s2i
    s0r, s0i = s1r - s2r, s1i - s2i
    o1r = f0r - (s3r >> 1)
    o1i = f0i - (s3i >> 1)
    s0r = _sround(s0r * epi3_i)     # C_MULBYSCALAR(scratch[0], epi3.i)
    s0i = _sround(s0i * epi3_i)
    o0r, o0i = f0r + s3r, f0i + s3i
    o2r, o2i = o1r + s0i, o1i - s0r
    o1r, o1i = o1r - s0i, o1i + s0r
    return (torch.stack([o0r, o1r, o2r], dim=-2),
            torch.stack([o0i, o1i, o2i], dim=-2))


def _bfly5(r, i, tws, ya, yb):
    fs = [_fixdiv(r[..., q, :], i[..., q, :], 5) for q in range(5)]
    s0r, s0i = fs[0]
    m1 = _cmul(fs[1][0], fs[1][1], tws[0][0], tws[0][1])
    m2 = _cmul(fs[2][0], fs[2][1], tws[1][0], tws[1][1])
    m3 = _cmul(fs[3][0], fs[3][1], tws[2][0], tws[2][1])
    m4 = _cmul(fs[4][0], fs[4][1], tws[3][0], tws[3][1])
    s7r, s7i = m1[0] + m4[0], m1[1] + m4[1]
    s10r, s10i = m1[0] - m4[0], m1[1] - m4[1]
    s8r, s8i = m2[0] + m3[0], m2[1] + m3[1]
    s9r, s9i = m2[0] - m3[0], m2[1] - m3[1]
    o0r = s0r + s7r + s8r
    o0i = s0i + s7i + s8i
    yar, yai = ya
    ybr, ybi = yb
    s5r = s0r + _sround(s7r * yar) + _sround(s8r * ybr)
    s5i = s0i + _sround(s7i * yar) + _sround(s8i * ybr)
    s6r = _sround(s10i * yai) + _sround(s9i * ybi)
    s6i = -_sround(s10r * yai) - _sround(s9r * ybi)
    o1r, o1i = s5r - s6r, s5i - s6i
    o4r, o4i = s5r + s6r, s5i + s6i
    s11r = s0r + _sround(s7r * ybr) + _sround(s8r * yar)
    s11i = s0i + _sround(s7i * ybr) + _sround(s8i * yar)
    s12r = -_sround(s10i * ybi) + _sround(s9i * yai)
    s12i = _sround(s10r * ybi) - _sround(s9r * yai)
    o2r, o2i = s11r + s12r, s11i + s12i
    o3r, o3i = s11r - s12r, s11i - s12i
    return (torch.stack([o0r, o1r, o2r, o3r, o4r], dim=-2),
            torch.stack([o0i, o1i, o2i, o3i, o4i], dim=-2))


def kiss_fft_c(cr, ci, ncfft: int):
    """Complex fixed-point FFT: cr/ci int32 [..., ncfft] -> same."""
    factors, ms, fstrides, perm, tw_r, tw_i, _, _ = _plan(ncfft)
    dev = cr.device
    perm_t = torch.from_numpy(perm).to(dev)
    r = cr.to(torch.int32).index_select(-1, perm_t)
    i = ci.to(torch.int32).index_select(-1, perm_t)
    lead = r.shape[:-1]
    for d in range(len(factors) - 1, -1, -1):
        p, m, fstride = factors[d], ms[d], fstrides[d]
        seg = ncfft // (p * m)
        r = r.reshape(lead + (seg, p, m))
        i = i.reshape(lead + (seg, p, m))
        k = np.arange(m)

        def tw(mult):
            idx = mult * fstride * k
            return (torch.from_numpy(tw_r[idx].astype(np.int32)).to(dev),
                    torch.from_numpy(tw_i[idx].astype(np.int32)).to(dev))

        if p == 2:
            r, i = _bfly2(r, i, *tw(1))
        elif p == 4:
            r, i = _bfly4(r, i, *tw(1), *tw(2), *tw(3))
        elif p == 3:
            r, i = _bfly3(r, i, *tw(1), *tw(2), int(tw_i[fstride * m]))
        elif p == 5:
            ya = (int(tw_r[fstride * m]), int(tw_i[fstride * m]))
            yb = (int(tw_r[fstride * 2 * m]), int(tw_i[fstride * 2 * m]))
            r, i = _bfly5(r, i, [tw(q) for q in range(1, 5)], ya, yb)
        else:
            raise NotImplementedError(
                f"kissfft_s16: radix {p} butterfly not implemented "
                f"(nfft/2 = {ncfft})")
        r = r.reshape(lead + (ncfft,))
        i = i.reshape(lead + (ncfft,))
    return r, i


def kiss_fftr_s16(x, nfft: int):
    """Real fixed-point FFT (kiss_fftr): x int-valued [..., nfft] ->
    (r, i) int32 [..., nfft/2 + 1], gst_fft_s16_fft's engine."""
    ncfft = nfft // 2
    x = x.to(torch.int32)
    tr, ti = kiss_fft_c(x[..., 0::2], x[..., 1::2], ncfft)
    _, _, _, _, _, _, stw_r, stw_i = _plan(ncfft)
    dev = x.device

    tdc_r, tdc_i = _fixdiv(tr[..., 0], ti[..., 0], 2)
    k_np = np.arange(1, ncfft // 2 + 1)
    k = torch.from_numpy(k_np).to(dev)
    nk = torch.from_numpy(ncfft - k_np).to(dev)
    fpk_r, fpk_i = _fixdiv(tr.index_select(-1, k), ti.index_select(-1, k), 2)
    fpnk_r, fpnk_i = _fixdiv(tr.index_select(-1, nk),
                             -ti.index_select(-1, nk), 2)
    f1k_r, f1k_i = fpk_r + fpnk_r, fpk_i + fpnk_i
    f2k_r, f2k_i = fpk_r - fpnk_r, fpk_i - fpnk_i
    sr = torch.from_numpy(stw_r[k_np - 1].astype(np.int32)).to(dev)
    si = torch.from_numpy(stw_i[k_np - 1].astype(np.int32)).to(dev)
    tw_r2, tw_i2 = _cmul(f2k_r, f2k_i, sr, si)

    out_r = torch.zeros(tr.shape[:-1] + (ncfft + 1,), dtype=torch.int32,
                        device=dev)
    out_i = torch.zeros_like(out_r)
    out_r[..., 0] = tdc_r + tdc_i
    out_r[..., ncfft] = tdc_r - tdc_i
    out_r[..., k] = (f1k_r + tw_r2) >> 1
    out_i[..., k] = (f1k_i + tw_i2) >> 1
    out_r[..., nk] = (f1k_r - tw_r2) >> 1
    out_i[..., nk] = (tw_i2 - f1k_i) >> 1
    return out_r, out_i
