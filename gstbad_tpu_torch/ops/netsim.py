"""netsim's ops: the token bucket walk (H5, csrc/netsim_kernels.cu) and
the delay draws.

The bucket and the drop-packets counter carry from frame to frame, in
int64 (gstnetsim.c:404-421, :476-501); the JAX package walks them with a
lax.scan (gstbad_tpu/elements/observability.py:223-251).  As torch ops
that walk would be about 15 small launches a frame, so on the card one
hand-written kernel walks the window; on the CPU the plain walk below
does the same steps on host integers.

Every draw comes from a torch.Generator on the element's device.
torch's gamma sampler takes no generator, so gamma() samples by
Marsaglia and Tsang's method from that generator's normals and
uniforms.
"""

from __future__ import annotations

import math

import torch

NS = 1_000_000_000
_I64 = 1 << 64


def _wrap(v: int) -> int:
    """v as an int64 wraps it (XLA's and the kernel's arithmetic)."""
    return (v + (1 << 63)) % _I64 - (1 << 63)


def netsim_bucket_plain(pts, valid, frame_bits: int, kbps, mbs, carry):
    """The plain form of netsim_bucket: the JAX scan's steps as a loop
    over the window's frames on host integers (int64 wrapping, floor
    division).  Returns (keep bool [B], carry int64 [3]) on the inputs'
    device."""
    bucket, prev_time, dropn = (int(v) for v in carry.tolist())
    k, m = int(kbps), int(mbs)
    cap = _wrap(m * 1000)
    keep = []
    for p, v in zip(pts.tolist(), valid.tolist()):
        first = prev_time < 0
        elapsed = 0 if first else max(_wrap(p - prev_time), 0)
        unlimited_rate = k == -1
        tokens = (_wrap(cap - bucket) if unlimited_rate
                  else _wrap(_wrap(elapsed * k) * 1000) // NS)
        token_time = (0 if unlimited_rate or k <= 0
                      else _wrap(tokens * NS) // max(_wrap(k * 1000), 1))
        new_prev = p if first else _wrap(prev_time + token_time)
        nb = bucket if m == -1 else min(_wrap(bucket + tokens), cap)
        bucket_ok = m == -1 or frame_bits <= nb
        if bucket_ok and m != -1 and v:
            nb = _wrap(nb - frame_bits)
        counter_drop = v and bucket_ok and dropn > 0
        if counter_drop:
            dropn -= 1
        if v and m != -1:
            prev_time = new_prev
        if v:
            bucket = nb
        keep.append(bool(v and bucket_ok and not counter_drop))
    dev = pts.device
    return (torch.tensor(keep, dtype=torch.bool, device=dev),
            torch.tensor([bucket, prev_time, dropn], dtype=torch.int64,
                         device=dev))


def netsim_bucket(pts, valid, frame_bits: int, kbps, mbs, carry):
    """pts int64 [B], valid bool [B], a frame's bits, max-kbps and
    max-bucket-size (0-d int32), carry int64 [3] (the bucket's bits, the
    meter's previous time, the drop-packets counter) -> (keep bool [B],
    carry int64 [3]).

    Not a TPU kernel: it replaces the JAX package's lax.scan
    (gstbad_tpu/elements/observability.py:223).  CPU tensors take
    netsim_bucket_plain; CUDA tensors launch
    csrc/netsim_kernels.cu:netsim_bucket_kernel (one thread walks the
    window) or raise."""
    if pts.dtype != torch.int64 or pts.ndim != 1 \
            or valid.shape != pts.shape or carry.shape != (3,):
        raise ValueError(f"netsim_bucket: pts int64 [B], valid [B] and a "
                         f"carry [3], got {pts.dtype} {tuple(pts.shape)}, "
                         f"{tuple(valid.shape)}, {tuple(carry.shape)}")
    if pts.device.type == "cpu":
        return netsim_bucket_plain(pts, valid, frame_bits, kbps, mbs, carry)
    from gstbad_tpu_torch.ops import _cuda
    dev = pts.device
    pts = pts.contiguous()
    valid = valid.to(torch.bool).contiguous()
    kbps = torch.as_tensor(kbps, device=dev).to(torch.int32).reshape(1)
    mbs = torch.as_tensor(mbs, device=dev).to(torch.int32).reshape(1)
    carry = carry.to(torch.int64).contiguous()
    keep = torch.empty(pts.shape, dtype=torch.bool, device=dev)
    carry_out = torch.empty(3, dtype=torch.int64, device=dev)
    _cuda.launch("gst_netsim_bucket", pts, valid, kbps, mbs, carry, keep,
                 carry_out, int(frame_bits), pts.shape[0])
    netsim_bucket.launches += 1
    return keep, carry_out


netsim_bucket.launches = 0


def gamma(shape, alpha: float, generator, device, dtype=torch.float64):
    """Gamma(alpha, 1) draws for alpha >= 1 (Marsaglia and Tsang, ACM TOMS
    26(3), 2000): d = alpha - 1/3, c = 1/sqrt(9d); a normal x gives
    v = (1 + cx)^3, kept where v > 0 and log(u) < x^2/2 + d - dv + d log v
    for a uniform u; the draw is dv.  Candidates come four rounds at a
    time from `generator`; the first accepted one of each slot is taken,
    and the slots with none draw again."""
    if alpha < 1:
        raise ValueError("gamma: alpha must be at least 1")
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randn((4, todo.numel()), generator=generator,
                        dtype=dtype, device=device)
        u = torch.rand((4, todo.numel()), generator=generator, dtype=dtype,
                       device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp(min=1e-300)))
        first = ok.to(torch.int8).argmax(0)
        got = ok.any(0)
        draw = (d * v).gather(0, first[None])[0]
        out[todo[got]] = draw[got]
        todo = todo[~got]
    return out.reshape(shape)
