"""interlace, fieldanalysis, ivtc and combdetect in the port against
gstbad_tpu, each element alone on the CPU, fed the same frames (made with
numpy from fixed seeds) with pts, flags and some invalid window slots:
data, pts, flags, valid, bus messages, the frames drained at EOS and the
carried states must be equal.

Tolerance: bit exact.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.frame import (FLAG_ONEFIELD, FLAG_RFF, FLAG_TFF,
                                         FrameBatch)
from gstbad_tpu_torch.core.spec import MediaSpec
from test_torch_parity import _messages, assert_same

torch.set_num_threads(1)   # parallel test workers share the cores

W, H = 66, 50          # ragged width, rows not a multiple of 16
FRAME_NS = 33333333    # 30/1


def make_frames(fmt, n, seed, w=W, h=H):
    """n frames of `fmt`: smooth moving gradients with a little noise (low
    comb scores, close metrics) mixed with pure noise frames."""
    rng = np.random.default_rng(seed)

    def plane(ph, pw, k):
        out = rng.integers(0, 256, (n, ph, pw), dtype=np.uint8)
        smooth = rng.random(n) < 0.7
        yy, xx = np.mgrid[:ph, :pw]
        for i in np.nonzero(smooth)[0]:
            base = (xx * 3 + yy * 2 + 5 * (i // 2) + k) % 256
            out[i] = np.clip(base + rng.integers(-2, 3, (ph, pw)), 0, 255)
        return out

    if fmt == "GRAY8":
        return plane(h, w, 0)
    if fmt == "I420":
        return {"y": plane(h, w, 0), "u": plane(h // 2, w // 2, 40),
                "v": plane(h // 2, w // 2, 90)}
    if fmt == "YUY2":
        return plane(h, 2 * w, 0)
    if fmt == "AYUV":
        return np.stack([plane(h, w, k) for k in (0, 1, 2, 3)], axis=-1)
    raise ValueError(fmt)


def run_element(desc, fmt, data, pts, flags, valid, window,
                mode="progressive", rate=Fraction(30, 1)):
    """Run `desc` with no source on the inputs in both packages (the port
    on the CPU).  Returns per package (run, messages), the drained frames
    and the final states as numpy."""
    out = {}
    w = (next(iter(data.values())) if isinstance(data, dict)
         else data).shape[2]
    w = w // 2 if fmt == "YUY2" else w
    h = (data["y"] if isinstance(data, dict) else data).shape[1]
    for key, pkg, spec_cls, fb_cls, conv, kw in (
            ("jax", gt, JMediaSpec, JFrameBatch, jnp.asarray, {}),
            ("torch", gtt, MediaSpec, FrameBatch, torch.from_numpy,
             {"device": "cpu"})):
        def tree(x, conv=conv):
            return ({k: conv(v.copy()) for k, v in x.items()}
                    if isinstance(x, dict) else conv(x.copy()))

        p = pkg.parse_launch(desc, **kw)
        p.negotiate(spec_cls(kind="video", format=fmt, width=w, height=h,
                             framerate=rate, interlace_mode=mode))
        p.compile(window)
        res = p.run(inputs=fb_cls.make(tree(data), pts=tree(pts),
                                       flags=tree(flags),
                                       valid=tree(valid)), window=window)
        drained = p.send_eos()
        states = [_numpy_tree(s) for s in p._states]
        out[key] = ((res, _messages(p.bus)), drained, states)
    return out["jax"], out["torch"]


def _numpy_tree(x):
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_tree(v) for v in x)
    return np.asarray(x)


def assert_states_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=path)


def assert_drained_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        for x, y in zip(a[name], b[name]):
            for f in ("pts", "flags", "valid"):
                np.testing.assert_array_equal(getattr(y, f),
                                              np.asarray(getattr(x, f)))
            if isinstance(x.data, dict):
                for k in x.data:
                    np.testing.assert_array_equal(y.data[k],
                                                  np.asarray(x.data[k]))
            else:
                np.testing.assert_array_equal(y.data, np.asarray(x.data))


def inputs(n, seed, invalid=(), rate_ns=FRAME_NS, flag_choices=(0,)):
    rng = np.random.default_rng(seed + 100)
    pts = np.arange(n, dtype=np.int64) * rate_ns
    valid = np.ones(n, bool)
    valid[list(invalid)] = False
    flags = rng.choice(np.asarray(flag_choices, np.int32), n).astype(np.int32)
    return pts, flags, valid


# -- interlace ----------------------------------------------------------------

@pytest.mark.parametrize("fmt,pattern,offset,extra", [
    ("GRAY8", "2:3", 0, ""),
    ("GRAY8", "2:3", 1, "top-field-first=true"),
    ("I420", "2:3", 0, "allow-rff=true"),
    ("I420", "2:2", 0, ""),
    ("GRAY8", "3:2-4", 3, "top-field-first=true"),
    ("I420", "2:3:3:2", 2, ""),
    ("YUY2", "2:3", 1, ""),
    ("AYUV", "3:3:4", 2, "allow-rff=true"),
    ("I420", "2:3", 1, "alternate=true"),
    ("GRAY8", "1:1", 0, "alternate=true top-field-first=true"),
])
def test_interlace_equals_jax(fmt, pattern, offset, extra):
    n = 13
    data = make_frames(fmt, n, 1, h=48 if "alternate" in extra else H)
    pts, flags, valid = inputs(n, 1, invalid=(5, 6))
    desc = (f"interlace pattern={pattern} pattern-offset={offset} {extra} "
            "! fakesink")
    (jr, jd, js), (tr, td, ts) = run_element(desc, fmt, data, pts, flags,
                                             valid, window=4)
    assert_same(jr, tr)
    assert_states_equal(js, ts)


# -- fieldanalysis ------------------------------------------------------------

@pytest.mark.parametrize("fmt,props", [
    ("GRAY8", ""),
    ("I420", ""),
    ("GRAY8", "field-metric=sad noise-floor=4"),
    ("I420", "field-metric=3-tap"),
    ("GRAY8", "frame-metric=windowed-comb block-width=8 block-height=8"),
])
def test_fieldanalysis_equals_jax(fmt, props):
    n = 14
    data = make_frames(fmt, n, 2)
    pts, flags, valid = inputs(n, 2, invalid=(0, 7, 8),
                               flag_choices=(0, FLAG_TFF, FLAG_RFF))
    (jr, jd, js), (tr, td, ts) = run_element(
        f"fieldanalysis {props} ! fakesink", fmt, data, pts, flags, valid,
        window=5, mode="mixed")
    assert_same(jr, tr)
    assert len(jr[1]) > 5            # bus messages were compared
    assert_drained_equal(jd, td)     # the held frame at EOS
    assert td["fieldanalysis"][0].data is not None
    assert_states_equal(js, ts)


# -- ivtc ---------------------------------------------------------------------

IVTC_CASES = [("GRAY8", 3), ("I420", 4), ("GRAY8", 5)]


def ivtc_inputs(fmt, seed, n=24):
    """Frames with every field flag mix, two invalid slots, and stamps
    that jump ahead now and then (which retires early fields)."""
    rng = np.random.default_rng(seed)
    pts, flags, valid = inputs(
        n, seed, invalid=(4, 11),
        flag_choices=(0, FLAG_TFF, FLAG_TFF | FLAG_RFF, FLAG_RFF,
                      FLAG_ONEFIELD, FLAG_TFF | FLAG_ONEFIELD))
    pts = pts + np.cumsum(rng.random(n) < 0.15) * 90_000_000
    return make_frames(fmt, n, seed), pts, flags, valid


@pytest.mark.parametrize("fmt,seed", IVTC_CASES)
def test_ivtc_equals_jax(fmt, seed):
    data, pts, flags, valid = ivtc_inputs(fmt, seed)
    (jr, jd, js), (tr, td, ts) = run_element(
        "ivtc ! fakesink", fmt, data, pts, flags, valid, window=6,
        mode="mixed")
    assert_same(jr, tr)
    # the ring's slots past `count` are never read: compare the live ones
    j_iv, t_iv = js[0], ts[0]
    count = int(j_iv["count"])
    assert int(t_iv["count"]) == count and count <= 8
    for k in ("parity", "ts"):
        np.testing.assert_array_equal(t_iv[k][:count], j_iv[k][:count])
    for k in j_iv["q"]:
        np.testing.assert_array_equal(t_iv["q"][k][:count],
                                      j_iv["q"][k][:count])
    for k in ("head", "current_ts"):
        np.testing.assert_array_equal(t_iv[k], j_iv[k])


def test_ivtc_takes_every_branch():
    """The inputs above reach weave forward, weave backward and the
    single-field rebuild (counted from the port's plan)."""
    from gstbad_tpu_torch.elements.video import ivtc as ivtc_el
    seen = set()
    plan = ivtc_el._emission_plan

    def spy(*a, **kw):
        out = plan(*a, **kw)
        seen.update(s[0] for s in out[0])
        return out

    ivtc_el._emission_plan = spy
    try:
        for fmt, seed in IVTC_CASES:
            data, pts, flags, valid = ivtc_inputs(fmt, seed)
            p = gtt.parse_launch("ivtc ! fakesink", device="cpu")
            tree = ({k: torch.from_numpy(v) for k, v in data.items()}
                    if isinstance(data, dict) else torch.from_numpy(data))
            p.negotiate(MediaSpec(kind="video", format=fmt, width=W,
                                  height=H, framerate=Fraction(30, 1)))
            p.run(inputs=FrameBatch.make(
                tree, pts=torch.from_numpy(pts),
                flags=torch.from_numpy(flags),
                valid=torch.from_numpy(valid)), window=6)
    finally:
        ivtc_el._emission_plan = plan
    assert seen == {ivtc_el.WEAVE_NEXT, ivtc_el.WEAVE_PREV, ivtc_el.SINGLE,
                    ivtc_el.NONE}


# -- combdetect ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["GRAY8", "I420"])
def test_combdetect_equals_jax(fmt):
    n = 10
    data = make_frames(fmt, n, 6)
    pts, flags, valid = inputs(n, 6, invalid=(3,))
    (jr, jd, js), (tr, td, ts) = run_element(
        "combdetect ! fakesink", fmt, data, pts, flags, valid, window=4)
    assert_same(jr, tr)
    assert_states_equal(js, ts)
