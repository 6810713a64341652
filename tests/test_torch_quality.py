"""The quality oracle in gstbad_tpu_torch against gstbad_tpu on the CPU:
compare (mem, max, ssim) and the iqa element's fields (ssim, dssim,
exceeded, output-map) on each format, the reference attached by
set_reference; compare also through the fan-in launch string
(tests/test_torch_dssim.py holds ops.dssim and iqa's launches).

Tolerances: compare's mem and max exact; its ssim and iqa's `ssim` field
within 1e-12 (float64 sums in another order).  iqa's dssim fields within
1e-5 absolute (see tests/test_torch_dssim.py).  iqa's output-map bytes
(the finest map rounded to 0-255) within 1, since a map value within 1e-5
of a rounding edge may round the other way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.ops import ssim as jssim
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import ssim as tssim
from test_torch_convert import make_frames

torch.set_num_threads(1)   # parallel test workers share the cores

B = 2


def _degrade(frames, rng, amount):
    def one(x):
        noise = rng.integers(-amount, amount + 1, x.shape)
        return np.clip(x.astype(int) + noise, 0, 255).astype(x.dtype)
    if isinstance(frames, dict):
        return {k: one(v) for k, v in frames.items()}
    return one(frames)


def run_element(name, props, fmt, w, h, data, ref):
    """Element `name` once in each package, the reference attached by
    set_reference; returns per package (output data, message fields)."""
    out = []
    for pkg, spec_cls, fb_cls, conv in (
            (gt, JMediaSpec, JFrameBatch, jnp.asarray),
            (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
        el = pkg.make(name, **props)
        el.set_info(spec_cls(kind="video", format=fmt, width=w, height=h))
        el.set_reference(ref)
        tree = ({k: conv(v.copy()) for k, v in data.items()}
                if isinstance(data, dict) else conv(data.copy()))
        _, batch, msgs = el.process(el.dynamic_params(), el.init_state(B),
                                    fb_cls.make(tree))
        (fields,) = msgs.values()
        fields = {k: np.asarray(v) for k, v in fields.items()}
        d = batch.data
        out.append(({k: np.asarray(v) for k, v in d.items()}
                    if isinstance(d, dict) else np.asarray(d), fields))
    return out


@pytest.mark.parametrize("method", ["mem", "max"])
@pytest.mark.parametrize("fmt", ["GRAY8", "I420", "BGRx"])
def test_compare_mem_and_max_exact(method, fmt):
    rng = np.random.default_rng(1)
    ref = make_frames(fmt, B, 16, 24, rng)
    data = _degrade(ref, rng, 9)
    if isinstance(data, dict):
        data["y"][0] = ref["y"][0]
        data["u"][0], data["v"][0] = ref["u"][0], ref["v"][0]
    else:
        data[0] = ref[0]            # frame 0 equal to its reference
    (jd, jf), (td, tf) = run_element("compare", {"method": method,
                                                 "threshold": 3.0},
                                     fmt, 24, 16, data, ref)
    assert sorted(tf) == sorted(jf) == ["delta", "passed"]
    for k in jf:
        assert tf[k].dtype == jf[k].dtype
        np.testing.assert_array_equal(tf[k], jf[k])


@pytest.mark.parametrize("fmt", ["GRAY8", "AYUV", "I420", "RGBA"])
def test_compare_ssim_within_1e_12(fmt):
    rng = np.random.default_rng(2)
    ref = make_frames(fmt, B, 40, 56, rng)
    data = _degrade(ref, rng, 20)
    (_, jf), (_, tf) = run_element("compare", {"method": "ssim",
                                               "threshold": 0.5,
                                               "upper": False},
                                   fmt, 56, 40, data, ref)
    np.testing.assert_allclose(tf["delta"], jf["delta"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tf["passed"], jf["passed"])
    w = tssim.ssim_weights(4, True), tssim.ssim_weights(3, False)
    assert w == (jssim.ssim_weights(4, True), jssim.ssim_weights(3, False))


@pytest.mark.parametrize("fmt,props", [
    ("AYUV", {}), ("GRAY8", {}), ("RGBx", {}), ("I420", {}),
    ("AYUV", {"do-dssim": False, "ssim-error-threshold": 0.001}),
    ("BGRA", {"ssim-error-threshold": 0.002, "output-map": True}),
    ("AYUV", {"output-map": True, "ssim-error-threshold": 0.05})])
def test_iqa_fields_and_map(fmt, props):
    """iqa's ssim within 1e-12, its dssim fields within 1e-5, exceeded
    equal; output-map writes the finest map into channel 1 (AYUV) or 0."""
    rng = np.random.default_rng(3)
    ref = make_frames(fmt, B, 48, 64, rng)
    data = _degrade(ref, rng, 12)
    (jd, jf), (td, tf) = run_element("iqa", props, fmt, 64, 48, data, ref)
    assert sorted(tf) == sorted(jf) == ["dssim", "dssim-pad-1", "exceeded",
                                        "ssim"]
    np.testing.assert_allclose(tf["ssim"], jf["ssim"], rtol=0, atol=1e-12)
    for k in ("dssim", "dssim-pad-1"):
        assert tf[k].dtype == jf[k].dtype
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tf["exceeded"], jf["exceeded"])
    if isinstance(jd, dict):
        for k in jd:
            np.testing.assert_array_equal(td[k], jd[k])
        return
    assert td.dtype == jd.dtype and td.shape == jd.shape
    diff = np.abs(td.astype(int) - jd.astype(int))
    assert diff.max() <= (1 if props.get("output-map") else 0)
    if props.get("output-map"):
        ch = 1 if fmt == "AYUV" else 0
        assert (td[..., ch] != data[..., ch]).any()


def _iqa_messages(pkg, desc, n_frames, window):
    kw = {"device": "cpu"} if pkg is gtt else {}
    p = pkg.parse_launch(desc, **kw)
    res = p.run(n_frames=n_frames, window=window)
    return res, [(m.element, m.name, m.pts, m.fields)
                 for m in p.bus.messages]


def assert_iqa_runs_close(desc, n_frames=4, window=2):
    (jres, jmsgs), (tres, tmsgs) = (_iqa_messages(pkg, desc, n_frames,
                                                  window) for pkg in (gt, gtt))
    assert len(tmsgs) == len(jmsgs) == n_frames
    for (je, jn, jp, jf), (te, tn, tp, tf) in zip(jmsgs, tmsgs):
        assert (te, tn, tp) == (je, jn, jp) and sorted(tf) == sorted(jf)
        assert abs(tf["ssim"] - jf["ssim"]) <= 1e-12
        assert tf["exceeded"] == jf["exceeded"]
        for k in tf:
            if k.startswith("dssim"):
                assert abs(tf[k] - jf[k]) <= 1e-5, k
    for a, b in zip(jres, tres):
        for f in ("pts", "flags", "valid"):
            np.testing.assert_array_equal(getattr(b, f),
                                          np.asarray(getattr(a, f)))
        diff = np.abs(b.data.astype(int) - np.asarray(a.data).astype(int))
        assert diff.max() <= (1 if "output-map=true" in desc else 0)
    return tmsgs


def test_compare_through_the_fan_in_launch():
    """compare's two-pad form: the first input is the reference."""
    desc = ("videotestsrc pattern=ball width=64 height=16 format=I420 "
            "name=s ! c.  s. ! smooth tolerance=300 ! c.  "
            "compare name=c method=max threshold=4 ! fakesink")
    (jres, jmsgs), (tres, tmsgs) = (_iqa_messages(pkg, desc, 4, 2)
                                    for pkg in (gt, gtt))
    assert tmsgs == jmsgs and len(tmsgs) == 4
    assert any(m[3]["delta"] > 0 for m in tmsgs)
