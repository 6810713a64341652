"""gstbad_tpu_torch elements against gstbad_tpu's: the other luma
layouts of zebrastripe, the word functions that table fusion evaluates on
256-entry tables, videotestsrc and fakesink on their own, and the element
properties and carried params.  Tolerance: bit exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.ops import pointops as jpointops
from gstbad_tpu_torch.core.frame import FrameBatch, tensors_from_numpy
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import pointops

torch.set_num_threads(1)   # parallel test workers share the cores

B, H, W = 4, 18, 40


def test_zebrastripe_on_gray_and_planar(rng):
    """zebrastripe's other luma layouts: GRAY8 and I420's y plane."""
    y = rng.integers(0, 256, (B, H, W), dtype=np.uint8)
    for fmt, data_np in (("GRAY8", y),
                         ("I420", {"y": y, "u": y[:, ::2, ::2].copy(),
                                   "v": y[:, 1::2, ::2].copy()})):
        outs = []
        for pkg, spec_cls, fb_cls, to_dev in (
                (gt, JMediaSpec, JFrameBatch, jnp.asarray),
                (gtt, MediaSpec, FrameBatch, torch.from_numpy)):
            el = pkg.make("zebrastripe", threshold=40)
            el.set_info(spec_cls(kind="video", format=fmt, width=W, height=H))
            data = ({k: to_dev(v.copy()) for k, v in data_np.items()}
                    if isinstance(data_np, dict) else to_dev(data_np.copy()))
            st, out = el.process(el.dynamic_params(), el.init_state(B),
                                 fb_cls.make(data))
            d = out.data
            outs.append(np.asarray(d["y"] if isinstance(d, dict) else d))
        np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("fn", ["exclusion", "chromahold", "to_ayuv",
                                "permute"])
def test_word_maps_on_words(rng, fn):
    """The word functions that fusion evaluates on 256-entry tables, on
    random words of any shape (a [B, 256] per-frame table here)."""
    words = rng.integers(-2**31, 2**31, (3, 256), dtype=np.int64
                         ).astype(np.int32)
    factor = np.array([1, 100, 175], np.int32)
    hue_args = [np.array(v, np.int32) for v in ([255, 10, 90], [0, 200, 90],
                                                [0, 30, 90])]
    tol = np.array([30, 0, 180], np.int32)
    jw, tw = jnp.asarray(words), torch.from_numpy(words)
    if fn == "exclusion":
        want = jpointops.exclusion_word(jw, jnp.asarray(factor), (2, 1, 0))
        got = pointops.exclusion_word(tw, torch.from_numpy(factor), (2, 1, 0))
    elif fn == "chromahold":
        jh = jpointops.rgb_to_hue(*(jnp.asarray(a) for a in hue_args))
        th = pointops.rgb_to_hue(*(torch.from_numpy(a) for a in hue_args))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        want = jpointops.chromahold_word(jw, jh, jnp.asarray(tol), (2, 1, 0))
        got = pointops.chromahold_word(tw, th, torch.from_numpy(tol),
                                       (2, 1, 0))
    elif fn == "to_ayuv":
        want = jpointops.rgb_word_to_ayuv_word(jw, (0, 1, 2, 3), True)
        got = pointops.rgb_word_to_ayuv_word(tw, (0, 1, 2, 3), True)
    else:
        want = jpointops.rgb_word_permute(jw, (1, 2, 3, 0), (3, 2, 1, 0),
                                          False)
        got = pointops.rgb_word_permute(tw, (1, 2, 3, 0), (3, 2, 1, 0),
                                        False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rgb_to_hue_all_targets():
    """gstchromahold.c's integer hue with C truncating division, over a
    grid of targets including the achromatic ones."""
    v = np.arange(0, 256, 15, dtype=np.int32)
    r, g, b = (a.ravel() for a in np.meshgrid(v, v, v))
    np.testing.assert_array_equal(
        pointops.rgb_to_hue(*(torch.from_numpy(a) for a in (r, g, b))
                            ).numpy(),
        np.asarray(jpointops.rgb_to_hue(*(jnp.asarray(a)
                                          for a in (r, g, b)))))


@pytest.mark.parametrize("pattern,fmt", [
    ("bars", "BGRx"), ("smpte", "RGBA"), ("gradient", "xRGB"),
    ("checkers", "BGRx"), ("black", "BGRx"), ("white", "AYUV"),
    ("solid-color", "BGRx"), ("ball", "BGRx"), ("ball", "AYUV"),
    ("ball", "GRAY8"), ("bars", "I420"), ("ball", "NV12"),
    ("checkers", "YUY2"), ("ball", "UYVY"), ("ball", "Y41B"),
    ("ball", "RGB16"), ("bars", "RGB")])
def test_videotestsrc_generate(pattern, fmt):
    """Two consecutive windows (the int64 frame counter carries), data,
    the int32 word and its broadcast base, pts, flags and valid.  The ball
    uses float64 cos/sin; the sizes and frames here give no pixel within
    1e-6 * radius^2 of the rim, where a last-ulp difference between
    libms could flip a pixel."""
    outs = []
    for pkg in (gt, gtt):
        el = pkg.make("videotestsrc", pattern=pattern, format=fmt,
                      width=44, height=22, **{"foreground-color": 0x336699})
        el.set_info(None)
        st = el.init_state(3)
        wins = []
        for _ in range(2):
            st, batch = el.generate({}, st, 3)
            wins.append(batch)
        outs.append((wins, np.asarray(st)))
    (jw, js), (tw, ts) = outs
    assert int(js) == int(ts) == 6 and ts.dtype == np.int64
    for a, b in zip(jw, tw):
        a = jax.tree_util.tree_map(np.asarray, a)
        b = b.to_numpy()
        if isinstance(a.data, dict):
            assert sorted(a.data) == sorted(b.data)
            for k in a.data:
                np.testing.assert_array_equal(b.data[k], a.data[k])
        else:
            np.testing.assert_array_equal(b.data, a.data)
        for f in ("pts", "flags", "valid", "word", "word_base"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(y, x)


def test_fakesink_keeps_the_word():
    """fakesink hands on the int32 word when the batch carries one."""
    word = torch.arange(2 * 3 * 5, dtype=torch.int32).reshape(2, 3, 5)
    batch = FrameBatch.make(pointops.unpack32(word)).replace(word=word)
    el = gtt.make("fakesink")
    el.set_info(MediaSpec(kind="video", format="BGRx", width=5, height=3))
    _, out = el.process({}, (), batch)
    assert out.data is word
    _, out = el.process({}, (), batch.with_data(batch.data))
    assert out.data.dtype == torch.uint8


def _default(p):
    """A property's default; a path to a model file that each package
    ships in its own data/ directory (handdetect's cascades) stands for
    the file's name and bytes."""
    import os
    if isinstance(p.default, str) and os.path.isfile(p.default) and (
            os.sep + "data" + os.sep) in p.default:
        with open(p.default, "rb") as f:
            return ("file", os.path.basename(p.default), f.read())
    return p.default


def test_ported_elements_match_jax_properties():
    """Every ported element has the JAX element's properties: names,
    types, defaults (a bundled model file: the same file), ranges and
    flags."""
    for name in gtt.element_names():
        assert name in gt.element_names()
        # jaxfilter is made around its function
        kw = {"fn": lambda x: x} if name == "jaxfilter" else {}
        jp = [(p.name, p.type, _default(p), p.min, p.max, p.controllable,
               p.static) for p in gt.make(name, **kw).PROPERTIES]
        tp = [(p.name, p.type, _default(p), p.min, p.max, p.controllable,
               p.static) for p in gtt.make(name, **kw).PROPERTIES]
        assert tp == jp, name


def test_dynamic_params_and_carried_params_agree():
    """A JAX element's params and states carried with tensors_from_numpy
    equal the port's own, dtype for dtype."""
    for name, props in (("solarize", {"threshold": 9}),
                        ("dilate", {"erode": True}),
                        ("chromahold", {"tolerance": 3}),
                        ("zebrastripe", {})):
        jel, tel = gt.make(name, **props), gtt.make(name, **props)
        carried = tensors_from_numpy(
            jax.tree_util.tree_map(np.asarray, jel.dynamic_params()), "cpu")
        own = tel.dynamic_params()
        assert sorted(carried) == sorted(own)
        for k in own:
            assert carried[k].dtype == own[k].dtype, (name, k)
            assert carried[k].item() == own[k].item(), (name, k)


def test_pts_ramp_int64():
    from gstbad_tpu.core.frame import pts_ramp as jpts_ramp
    from gstbad_tpu_torch.core.frame import pts_ramp
    spec = MediaSpec(kind="video", format="BGRx", width=4, height=2)
    got = pts_ramp(5, spec, start_ns=2**40)
    want = np.asarray(jpts_ramp(5, JMediaSpec(kind="video", format="BGRx",
                                              width=4, height=2), 2**40))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
