"""ivtc reconstruction (gst/ivtc/gstivtc.c:340-490), batched over leading
frame axes.

reconstruct_single's edge-directed line doubling computes all five
direction filters for both orientations and selects per pixel.  These are
plain torch on every device: the JAX package has no kernel for them either.
"""

from __future__ import annotations

import torch

from gstbad_tpu_torch.ops.comb import interleave

_WEIGHTS = [(0, 0, 0, 16), (0, 0, 8, 8), (0, 4, 8, 4), (1, 7, 7, 1),
            (4, 8, 4, 0)]


def _shift(x, k):
    """x[..., i+k] with edge clamp (borders are overwritten by the plain
    average anyway)."""
    w = x.shape[-1]
    idx = (torch.arange(w, device=x.device) + k).clamp(0, w - 1)
    return x[..., idx]


def _filters(A, B):
    """All 5 reconstruct_line variants for orientation (A, B) ->
    [5, ..., W] int32."""
    outs = []
    for a, b, c, d in _WEIGHTS:
        acc = (_shift(A, -3) * a + _shift(A, -2) * b + _shift(A, -1) * c
               + A * d + B * d + _shift(B, 1) * c + _shift(B, 2) * b
               + _shift(B, 3) * a)
        outs.append((acc + 16) >> 5)
    return torch.stack(outs)


def interp_rows(l1, l2):
    """Edge-directed interpolation of the row between l1 (above) and l2
    (below); both [..., W] uint8 -> [..., W] uint8."""
    A = l1.to(torch.int32)
    B = l2.to(torch.int32)
    dx = (-_shift(A, -1) - _shift(B, -1) + _shift(A, 1) + _shift(B, 1)) * 2
    dy = (-_shift(A, -1) - 2 * A - _shift(A, 1)
          + _shift(B, -1) + 2 * B + _shift(B, 1))
    flip = dy < 0
    dy = torch.where(flip, -dy, dy)
    dx = torch.where(flip, -dx, dx)

    avg = (A + B + 1) >> 1
    neg = _filters(A, B)   # dx < 0 orientation (line1, line2)
    pos = _filters(B, A)   # dx >= 0 orientation (line2, line1)

    def pick(f, c1, c2, c3, c4):
        return torch.where(c1, f[0], torch.where(c2, f[1], torch.where(
            c3, f[2], torch.where(c4, f[3], f[4]))))

    v_neg = pick(neg, dx < -2 * dy, dx < -dy, 2 * dx < -dy, 3 * dx < -dy)
    v_pos = pick(pos, dx > 2 * dy, dx > dy, 2 * dx > dy, 3 * dx > dy)
    v = torch.where((dx == 0) & (dy == 0), avg,
                    torch.where(dx < 0, v_neg, v_pos))

    # MARGIN=3 borders: plain average (gstivtc.c:456-462)
    w = A.shape[-1]
    col = torch.arange(w, device=A.device)
    border = (col < 3) | (col >= w - 3)
    v = torch.where(border, avg, v)
    return v.clamp(0, 255).to(torch.uint8)


def _keep_rows(plane, parity):
    """[..., H, 1] bool: the rows of the kept field (parity 0 top, 1
    bottom; an int or an int tensor over the leading dims)."""
    h = plane.shape[-2]
    rows = torch.arange(h, device=plane.device)[:, None] % 2
    p = torch.as_tensor(parity, device=plane.device)
    p = p.reshape(p.shape + (1,) * (plane.ndim - p.ndim))
    return rows == p


def _mirror_and_edge(plane):
    """Rows j ^ 1 (clamped, as a JAX gather clamps an odd height's last
    row) and the [H, 1] mask of the first and last rows."""
    h = plane.shape[-2]
    swap = (torch.arange(h, device=plane.device) ^ 1).clamp(max=h - 1)
    mirrored = plane[..., swap, :]
    rows = torch.arange(h, device=plane.device)[:, None]
    return mirrored, (rows == 0) | (rows == h - 1)


def reconstruct_single_luma(frame, parity):
    """reconstruct_single luma plane (gstivtc.c:389-465).  frame [..., H, W]
    uint8, parity (0 top / 1 bottom) broadcast over the leading dims."""
    up = torch.cat([frame[..., :1, :], frame[..., :-1, :]], dim=-2)
    down = torch.cat([frame[..., 1:, :], frame[..., -1:, :]], dim=-2)
    interp = interp_rows(up, down)
    mirrored, edge = _mirror_and_edge(frame)
    return torch.where(_keep_rows(frame, parity), frame,
                       torch.where(edge, mirrored, interp))


def reconstruct_single_chroma(plane, parity):
    """reconstruct_single chroma: plain rounded average
    (gstivtc.c:467-490); batched like reconstruct_single_luma."""
    up = torch.cat([plane[..., :1, :], plane[..., :-1, :]],
                   dim=-2).to(torch.int32)
    down = torch.cat([plane[..., 1:, :], plane[..., -1:, :]],
                     dim=-2).to(torch.int32)
    avg = ((up + down + 1) >> 1).to(torch.uint8)
    mirrored, edge = _mirror_and_edge(plane)
    return torch.where(_keep_rows(plane, parity), plane,
                       torch.where(edge, mirrored, avg))


def weave(top, bottom):
    return interleave(top, bottom)
