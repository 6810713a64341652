"""Overlay compositing: H4 `overlay_blend`, one pass over a window of
frames that applies a table of overlay layers per frame, and its plain
torch version.

The subtitle, caption, QR, SVG and text renderers of the JAX package
(gstbad_tpu/elements/video/{overlay,closedcaption,qroverlay,assrender,
ttmlrender,rsvg}.py) each blend host-rendered overlays onto the window
with integer arithmetic, one whole-window pass per overlay.  Here the
overlays sit in a bank on the device, uploaded once; a [B, L] int32
table names the bank entry of each layer of each frame (-1 for none),
and the layers apply in the table's order, as the JAX loops apply their
sets.  The blend is one of MODES, each the formula of its element, on
non-negative integers, so the kernel and the plain version agree bit for
bit.  H4 is not a TPU kernel: none of these modules reaches
pl.pallas_call.

Geometry: `frames` is [B, H, W, C] u8 (C = 1 for one I420 plane, 3 or
4 for packed video).  The alpha plane and up to three source planes are
u8 views [K, Hs, Ws] of the bank (any strides, so a channel of a packed
bank or every other row and column of a plane is a view, not a copy);
a plane with shift 1 is read at (y >> 1, x >> 1), the A420 chroma's
repeat.  `chan[c]` names the source of destination channel c: 0-2 a
source plane, 3 the alpha plane itself, None for a channel left as it
is; `alpha_chan` is the channel that takes qroverlay's alpha rule."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# the blends, by the JAX element that defines each
MODES = {
    # suboverlay (overlay.py:26-35): (a*s + (255-a)*d + 127) // 255
    "div255_round": 0,
    # dvbsuboverlay, ceaccoverlay (overlay.py:149-158,
    # closedcaption.py:815-828): (d*(256-a) + s*a) >> 8
    "shr8_keep_alpha": 1,
    # dvdspu (overlay.py:213-220): ((255-a)*d + a*s) // 255
    "div255_keep_alpha": 2,
    # qroverlay, debugqroverlay, ttmlrender's bitmap face
    # (qroverlay.py:108-125, ttmlrender.py:103-108): (d*(256-a) + s*a)
    # >> 8, and on alpha_chan (d*(256-a) + 255*a) >> 8
    "shr8_rgb_alpha": 3,
    # cairo / pixman premultiplied OVER: ttmlrender's pango face,
    # rsvgoverlay (ttmlrender.py:93-101, rsvg.py:52-59):
    # min(s + ((t + (t >> 8)) >> 8), 255), t = d*(255-a) + 0x80
    "cairo_over": 4,
    # assrender (assrender.py:128-136): min(s + (255-a)*d // 255, 255)
    "premul_floor": 5,
}

Plane = Tuple[torch.Tensor, int]      # (u8 view [K, Hs, Ws], shift)


def _blend(mode: int, d, s, a):
    if mode == 0:
        return (a * s + (255 - a) * d + 127) // 255
    if mode in (1, 3):
        return (d * (256 - a) + s * a) >> 8
    if mode == 2:
        return ((255 - a) * d + a * s) // 255
    if mode == 4:
        t = d * (255 - a) + 0x80
        return torch.clamp(s + ((t + (t >> 8)) >> 8), max=255)
    return torch.clamp(s + (255 - a) * d // 255, max=255)


def _full(plane: Plane, h: int, w: int):
    view, shift = plane
    if shift:
        view = view.repeat_interleave(2, -2).repeat_interleave(2, -1)
    return view[:, :h, :w]


def _check(frames, alpha, planes, layers, chan, mode, alpha_chan):
    if frames.dtype != torch.uint8 or frames.dim() != 4 \
            or frames.shape[-1] not in (1, 3, 4):
        raise ValueError("overlay_blend: frames must be [B, H, W, C] u8 "
                         f"with C 1, 3 or 4, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    b, h, w, c = frames.shape
    if layers.dtype != torch.int32 or layers.dim() != 2 \
            or layers.shape[0] != b:
        raise ValueError("overlay_blend: layers must be [B, L] int32")
    if alpha.dtype != torch.uint8 or tuple(alpha.shape[1:]) != (h, w):
        raise ValueError(f"overlay_blend: alpha {tuple(alpha.shape)} is "
                         f"not [K, {h}, {w}] u8")
    if b > 65535 or h > 65535:
        raise ValueError("overlay_blend: at most 65535 frames and rows")
    if len(planes) > 3 or len(chan) != c:
        raise ValueError("overlay_blend: at most 3 source planes and one "
                         "chan entry per channel")
    for view, shift in planes:
        if view.dtype != torch.uint8 or view.shape[0] != alpha.shape[0] \
                or view.shape[1] << shift < h or view.shape[2] << shift < w:
            raise ValueError(f"overlay_blend: source plane "
                             f"{tuple(view.shape)} (shift {shift}) does not "
                             f"cover [{alpha.shape[0]}, {h}, {w}]")
    for j in chan:
        if j is not None and not (j == 3 or 0 <= j < len(planes)):
            raise ValueError(f"overlay_blend: bad source {j}")
    if mode not in MODES:
        raise ValueError(f"overlay_blend: unknown mode {mode!r}")
    if alpha_chan is not None and (mode != "shr8_rgb_alpha"
                                   or chan[alpha_chan] is not None):
        raise ValueError("overlay_blend: alpha_chan is shr8_rgb_alpha's, "
                         "on a channel with no source")


def overlay_blend_plain(frames, alpha, planes: Sequence[Plane], layers,
                        chan: Sequence[Optional[int]], mode: str,
                        alpha_chan: Optional[int] = None):
    """The layers of `layers` blended onto `frames` in order, each by the
    formula of `mode` (MODES) on int32: a new [B, H, W, C] u8 tensor."""
    _check(frames, alpha, planes, layers, chan, mode, alpha_chan)
    b, h, w, c = frames.shape
    m = MODES[mode]
    out = frames.to(torch.int32)
    full_a = _full((alpha, 0), h, w)
    full = [_full(p, h, w) for p in planes]
    for l in range(layers.shape[1]):
        k = layers[:, l].to(torch.int64)
        on = (k >= 0)[:, None, None]
        k = k.clamp(min=0)
        a = full_a[k].to(torch.int32)
        for ch in range(c):
            j = chan[ch]
            d = out[..., ch]
            if j is None:
                if ch != alpha_chan:
                    continue
                val = (d * (256 - a) + 255 * a) >> 8
            else:
                s = a if j == 3 else full[j][k].to(torch.int32)
                val = _blend(m, d, s, a)
            out[..., ch] = torch.where(on, val, d)
    return out.to(torch.uint8)


def launch_args(out, frames, alpha, planes, layers, chan, mode,
                alpha_chan):
    """The arguments of gst_overlay_blend (csrc/overlay_kernels.cu) after
    its name: the unused source planes repeat the alpha plane, and chan
    packs a byte a channel (0xFF for none)."""
    b, h, w, c = frames.shape
    args = []
    for i in range(3):
        view, shift = planes[i] if i < len(planes) else (alpha, 0)
        args.append((view, *view.stride(), shift))
    packed = 0
    for ch in range(4):
        j = chan[ch] if ch < c else None
        packed |= (0xFF if j is None else j) << (8 * ch)
    return (out, frames, layers, alpha, args[0][0], args[1][0], args[2][0],
            b, h, w, c, layers.shape[1], *alpha.stride(),
            *(v for a in args for v in a[1:]), packed,
            -1 if alpha_chan is None else alpha_chan, MODES[mode])


def overlay_blend(frames, alpha, planes: Sequence[Plane], layers,
                  chan: Sequence[Optional[int]], mode: str,
                  alpha_chan: Optional[int] = None):
    """overlay_blend_plain; on CUDA tensors the H4 kernel
    (csrc/overlay_kernels.cu), one launch for the whole window."""
    if frames.device.type == "cpu":
        return overlay_blend_plain(frames, alpha, planes, layers, chan,
                                   mode, alpha_chan)
    from gstbad_tpu_torch.ops import _cuda
    _check(frames, alpha, planes, layers, chan, mode, alpha_chan)
    frames = frames.contiguous()
    if frames.shape[-1] == 4 and frames.data_ptr() % 4:
        frames = frames.clone()      # the kernel reads 4-byte words
    layers = layers.contiguous()
    out = torch.empty_like(frames)
    _cuda.launch("gst_overlay_blend", *launch_args(
        out, frames, alpha, planes, layers, chan, mode, alpha_chan))
    overlay_blend.launches += 1
    return out


overlay_blend.launches = 0


class OverlaySlots:
    """A device bank of host-rendered overlays [S, H, W, C] u8, filled on
    demand: an overlay is uploaded once into a free slot, stays while the
    windows use it and frees its slot when a window does not (the bank
    grows when more are needed at once).  So a film's display sets never
    sit on the card together, only those of the current window."""

    def __init__(self, device, shape: Tuple[int, int, int]):
        self.device = torch.device(device)
        self.shape = tuple(shape)
        self.bank = torch.zeros((0, *self.shape), dtype=torch.uint8,
                                device=self.device)
        self.slot = {}        # key -> slot
        self.uploads = 0

    def place(self, keys, render) -> dict:
        """{key: slot} with every key of `keys` resident; render(key) ->
        numpy [H, W, C] u8 is called for the keys not resident yet."""
        keys = list(dict.fromkeys(keys))
        self.slot = {k: s for k, s in self.slot.items() if k in keys}
        missing = [k for k in keys if k not in self.slot]
        free = sorted(set(range(self.bank.shape[0]))
                      - set(self.slot.values()))
        if len(free) < len(missing):
            grow = len(missing) - len(free)
            self.bank = torch.cat([self.bank, torch.zeros(
                (grow, *self.shape), dtype=torch.uint8,
                device=self.device)])
            free += list(range(self.bank.shape[0] - grow,
                               self.bank.shape[0]))
        for k, s in zip(missing, free):
            self.bank[s].copy_(torch.from_numpy(render(k)))
            self.slot[k] = s
            self.uploads += 1
        return dict(self.slot)
