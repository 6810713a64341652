"""XLA's CPU scan orders in torch: lax.associative_scan (the IIRs of
ops/audio.py) and jnp.cumsum (the summed-area tables of ops/haar.py)."""

from __future__ import annotations

import torch


def associative_scan(fn, elems):
    """lax.associative_scan(fn, elems, axis=0) over a tuple of tensors, in
    its operation order: the pairwise reduction, the scan of the halves by
    recursion, the even elements from the odd ones, interleaved.  The same
    products and sums in the same order give the same float bits as the
    JAX package's scans."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[0:n - 1:2] for e in elems),
                                  tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd),
                  tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty_like(e)
        full[0::2] = torch.cat([e[:1], ev])
        full[1::2] = od
        out.append(full)
    return tuple(out)


def _sequential(x):
    """Running sum along axis 0, one float add at a time."""
    out = torch.empty_like(x)
    acc = x[0]
    out[0] = acc
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
        out[i] = acc
    return out


def cumsum(x, dim: int = 0, block: int = 16):
    """jnp.cumsum(x, axis=dim) in the float order of XLA's CPU code.  The
    cumsum is a reduce-window over the whole axis, which XLA rewrites for
    axes longer than 16: a sequential sum inside each block of 16, the
    blocks' totals summed the same way (recursively), and each block's
    running sums plus the sum of the blocks before it."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= block:
        return _sequential(x).movedim(0, dim)
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x.movedim(0, -1), (0, nb * block - n)
                                 ).movedim(-1, 0)
    blocks = xp.reshape((nb, block) + x.shape[1:]).movedim(1, 0)
    within = _sequential(blocks)                  # [block, nb, ...]
    inc = cumsum(within[-1], 0, block)
    before = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]])
    out = (within + before[None]).movedim(0, 1).reshape(xp.shape)[:n]
    return out.movedim(0, dim)
