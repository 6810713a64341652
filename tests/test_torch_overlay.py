"""Parity of the port's subtitle overlays (suboverlay, dvbsuboverlay,
dvdspu, dvbsubenc) and of H4's plain version (ops/overlay.py) with the
JAX package on the CPU: frames, pts, valid and bus messages equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gstbad_tpu.elements.video import overlay as j_overlay
from gstbad_tpu.elements.video import rsvg as j_rsvg
from gstbad_tpu_torch.ops import overlay as t_overlay
from helpers.torch_overlay import (assert_same, data_of, run_both,
                                   run_launch_both, spec)
from test_dvbsub import object_seg, page_seg, pes, region_seg, rle4_line, \
    seg
from test_spu import make_spu_packet

SEC = 10 ** 9


def _jax_formula(mode, d, s, a):
    """One layer's blend of one channel as the JAX elements write it
    (int32 jnp arrays)."""
    if mode == "div255_round":                      # suboverlay
        return j_overlay._blend(d, s, a).astype(jnp.int32)
    if mode in ("shr8_keep_alpha", "shr8_rgb_alpha"):   # dvbsub, qr
        return (d * (256 - a) + s * a) >> 8
    if mode == "div255_keep_alpha":                 # dvdspu
        return ((255 - a) * d + a * s) // 255
    if mode == "premul_floor":                      # assrender
        return jnp.clip(s + (255 - a) * d // 255, 0, 255)
    raise AssertionError(mode)


def _jax_layers(frames, alpha, srcs, layers, chan, mode, alpha_chan):
    """The JAX elements' loop: each layer in turn over the running
    frames, where the layer is set."""
    out = jnp.asarray(frames).astype(jnp.int32)
    for l in range(layers.shape[1]):
        k = np.maximum(layers[:, l], 0)
        on = jnp.asarray(layers[:, l] >= 0)[:, None, None]
        a = jnp.asarray(alpha[k]).astype(jnp.int32)
        if mode == "cairo_over":                    # rsvgoverlay's over_u8
            for b in range(out.shape[0]):
                ov = np.zeros(out.shape[1:], np.uint8)
                for c, j in enumerate(chan):
                    ov[..., c] = alpha[k[b]] if j == 3 else srcs[j][k[b]]
                ia = chan.index(3)
                new = j_rsvg.over_u8(out[b], ov, ia)
                out = out.at[b].set(jnp.where(on[b, ..., None], new, out[b]))
            continue
        for c, j in enumerate(chan):
            d = out[..., c]
            if j is None:
                if c != alpha_chan:
                    continue
                new = (d * (256 - a) + 255 * a) >> 8   # qroverlay's alpha
            else:
                s = a if j == 3 else jnp.asarray(srcs[j][k]).astype(
                    jnp.int32)
                new = _jax_formula(mode, d, s, a)
            out = out.at[..., c].set(jnp.where(on, new, d))
    return np.asarray(out.astype(jnp.uint8))


@pytest.mark.parametrize("mode", sorted(t_overlay.MODES))
def test_blend_plain_equals_the_jax_formulas(mode):
    """H4's plain version against the JAX elements' formulas, every mode,
    at odd sizes, C = 3 and 4, 1-3 layers that overlap, -1 gaps."""
    rng = np.random.default_rng(sorted(t_overlay.MODES).index(mode))
    for c, (h, w), n_layers in ((4, (5, 7), 1), (3, (13, 17), 3),
                                (4, (9, 2), 2), (3, (1, 1), 3)):
        b, k = 6, 4
        frames = rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)
        bank = rng.integers(0, 256, (k, h, w, 4), dtype=np.uint8)
        bank[0, ..., 0] = 0                      # a fully clear entry
        bank[1, ..., 0] = 255                    # a fully opaque one
        if mode in ("cairo_over", "premul_floor"):   # premultiplied
            bank[..., 1:] = np.minimum(bank[..., 1:], bank[..., :1])
        layers = rng.integers(-1, k, (b, n_layers)).astype(np.int32)
        chan = [None, 0, 1, 2][:c] if c == 4 else [0, 1, 2]
        alpha_chan = None
        if mode == "shr8_rgb_alpha" and c == 4:
            alpha_chan = 0
        if mode == "cairo_over":
            chan = [3, 0, 1, 2][:c] if c == 4 else [0, 3, 1]
        srcs = [bank[..., i] for i in (1, 2, 3)]
        want = _jax_layers(frames, bank[..., 0], srcs, layers, chan, mode,
                           alpha_chan)
        t = torch.from_numpy(bank)
        got = t_overlay.overlay_blend(
            torch.from_numpy(frames), t[..., 0],
            [(t[..., i], 0) for i in (1, 2, 3)], torch.from_numpy(layers),
            chan, mode, alpha_chan).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{mode} {c} {h}x{w}")
        assert (got != frames).any()


def test_blend_shifted_and_strided_planes():
    """A plane read at (y >> 1, x >> 1) equals its repeat, and a strided
    view its copy: the A420 chroma and I420 alpha forms."""
    rng = np.random.default_rng(9)
    h, w = 7, 9
    frames = torch.from_numpy(rng.integers(0, 256, (2, h, w, 1),
                                           dtype=np.uint8))
    alpha = torch.from_numpy(rng.integers(0, 256, (2, 2 * h, 2 * w),
                                          dtype=np.uint8))
    small = torch.from_numpy(rng.integers(0, 256, (2, 4, 5),
                                          dtype=np.uint8))
    layers = torch.tensor([[1], [0]], dtype=torch.int32)
    got = t_overlay.overlay_blend(frames, alpha[:, ::2, ::2], [(small, 1)],
                                  layers, (0,), "div255_round")
    full = small.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w]
    want = t_overlay.overlay_blend(frames, alpha[:, ::2, ::2].contiguous(),
                                   [(full.contiguous(), 0)], layers, (0,),
                                   "div255_round")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_slots_upload_once_and_free():
    slots = t_overlay.OverlaySlots("cpu", (2, 3, 4))
    made = []

    def render(k):
        made.append(k)
        return np.full((2, 3, 4), k, np.uint8)

    s1 = slots.place([5, 7], render)
    s2 = slots.place([7, 9], render)             # 5 freed, 9 takes its slot
    assert made == [5, 7, 9] and s2[7] == s1[7] and s2[9] == s1[5]
    assert slots.bank.shape[0] == 2
    assert int(slots.bank[s2[9]].max()) == 9


@pytest.mark.parametrize("video,over,size", [
    ("AYUV", "AYUV", (13, 9)), ("AYUV", "A420", (12, 10)),
    ("I420", "AYUV", (15, 11)), ("I420", "A420", (13, 7))])
def test_suboverlay(video, over, size):
    w, h = size
    rng = np.random.default_rng(w * h)
    n = 6

    def frames(fmt):
        if fmt == "AYUV":
            return rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8)
        c = ((h + 1) // 2, (w + 1) // 2)
        planes = {"y": (h, w), "u": c, "v": c}
        if fmt == "A420":
            planes["a"] = (h, w)
        return {k: rng.integers(0, 256, (n,) + s, dtype=np.uint8)
                for k, s in planes.items()}

    vf, of = frames(video), frames(over)

    def feed(pkg, p):
        p.get_by_name("v").push_frames(vf)
        p.get_by_name("o").push_frames(of)

    res = run_launch_both(
        f"appsrc name=v format={video} width={w} height={h} ! s.  "
        f"appsrc name=o format={over} width={w} height={h} ! s.  "
        "suboverlay name=s ! fakesink", feed, window=4)
    assert_same(res)
    out = data_of(res)
    ref = vf["y"] if video == "I420" else vf
    assert (out["y"] if video == "I420" else out).shape == ref.shape
    assert ((out["y"] if video == "I420" else out) != ref).any()


def _two_region_set(t_out, shift=0):
    """A display set with a 4-bit and an 8-bit region, each with its own
    CLUT entries."""
    line4 = rle4_line([(4, 3), (6, 1), (1, 2)])
    from test_dvbsub import BitWriter
    bw = BitWriter()
    for colour in (77, 200, 9, 200, 77):
        bw.put(colour, 8)
    bw.put(0, 8)
    bw.put(0, 1)
    bw.put(0, 7)
    line8 = b"\x12" + bw.bytes()
    return pes(
        page_seg([(1, 40 + shift, 30), (2, 300, 200 + shift)],
                 time_out=t_out),
        region_seg(1, 11, 2, 4, clut_id=0, objects=[(7, 0, 0)]),
        region_seg(2, 5, 2, 8, clut_id=1, bg=9, objects=[(8, 0, 0)]),
        seg(0x12, bytes([0, 0, 3, 0x40 | 1, 180, 90, 60, 40,
                         1, 0x40 | 1, 120, 200, 30, 0])),
        seg(0x12, bytes([1, 0, 77, 0x20 | 1, 200, 20, 220, 0,
                         200, 0x20 | 1, 60, 150, 40, 100])),
        object_seg(7, b"\x11" + line4, b"\x11" + line4),
        object_seg(8, line8, line8),
        seg(0x80, b""))


@pytest.mark.parametrize("size,props", [((720, 576), {}),
                                        ((361, 289), {"max-page-timeout": 1})])
def test_dvbsuboverlay(size, props):
    """Three display sets (two regions each, 4- and 8-bit CLUTs, one set
    cleared early) over two windows: several active on one frame, shown,
    replaced, timed out and cleared as the JAX element does."""
    w, h = size
    pushes = [(_two_region_set(2), 0), (_two_region_set(5, 7), SEC // 3),
              (_two_region_set(1, 13), SEC // 2),
              (pes(page_seg([], time_out=1), seg(0x80, b"")), 3 * SEC)]

    def setup(pkg, els):
        for data, pts in pushes:
            els[0].push_pes(data, pts)

    rng = np.random.default_rng(w)
    windows = [(rng.integers(0, 256, (3, h, w, 4), dtype=np.uint8),
                [s * SEC // 10 for s in range(i, i + 3)]) for i in (0, 6)]
    windows.append((windows[0][0], [SEC // 2, 2 * SEC, 4 * SEC]))
    res = run_both([("dvbsuboverlay", props)], spec("AYUV", w, h), windows,
                   setup)
    assert_same(res)
    out = data_of(res)
    frames = np.concatenate([wd[0] for wd in windows])
    changed = (out != frames).any(axis=(1, 2, 3))
    assert changed[0] and not changed[-1]
    assert (out[..., 0] == frames[..., 0]).all()      # video alpha kept


def test_dvdspu():
    pkt = make_spu_packet(top=3, left=5, w=12, h=4)
    clut = np.zeros(16, np.uint32)
    clut[1], clut[2], clut[3] = 0x00AA4060, 0x00551020, 0x00111111
    hide = 90 * 1024 * SEC // 90000

    def setup(pkg, els):
        els[0].push_spu(pkt, pts_ns=0, clut=clut)
        els[0].push_spu(make_spu_packet(top=5, left=9, w=8, h=4),
                        pts_ns=SEC // 2)

    rng = np.random.default_rng(4)
    w, h = 33, 17
    windows = [(rng.integers(0, 256, (4, h, w, 4), dtype=np.uint8),
                [0, SEC // 2, hide - 1, hide + 1]),
               (rng.integers(0, 256, (2, h, w, 4), dtype=np.uint8),
                [hide + SEC // 2 - 1, hide + SEC // 2 + 1])]
    res = run_both([("dvdspu", {})], spec("AYUV", w, h), windows, setup)
    assert_same(res)
    out = data_of(res)
    frames = np.concatenate([wd[0] for wd in windows])
    assert (out[1] != frames[1]).any() and (out[-1] == frames[-1]).all()


def test_dvbsubenc_posts_the_same_packets():
    h, w = 40, 120
    imgs = np.zeros((6, h, w, 4), np.uint8)
    imgs[0, 10:30, 20:100] = [255, 235, 128, 128]
    imgs[2, 5:20, 30:80] = [255, 81, 90, 240]
    imgs[4, 2:38, 3:117] = np.random.default_rng(3).integers(
        0, 256, (36, 114, 4))
    dur = SEC // 25
    for props in ({}, {"ts-offset": 500, "max-colours": 4}):
        res = run_both([("dvbsubenc", props)],
                       spec("AYUV", w, h, rate=25),
                       [(imgs[:3], [i * dur for i in range(3)]),
                        (imgs[3:], [i * dur for i in range(3, 6)])])
        assert_same(res, min_messages=4)
        assert res["torch"][2][0].packets == res["jax"][2][0].packets
