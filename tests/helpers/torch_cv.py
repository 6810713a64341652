"""Shared pieces of the cv and video-extras parity tests
(tests/test_torch_cv_{ops,elements}.py, tests/test_torch_video_extras.py):
one element through gstbad_tpu and gstbad_tpu_torch (on the CPU) on the
same numpy frames, and the comparisons with their stated tolerances."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gstbad_tpu.core.harness import Harness as JHarness
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.harness import Harness
from gstbad_tpu_torch.core.spec import MediaSpec
from helpers.torch_runtime import messages

torch.set_num_threads(1)   # parallel test workers share the cores


def host(x):
    """A tensor, a JAX array or a dict of them -> numpy."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def jax_and_torch(fn_jax, fn_torch, *arrays):
    """(fn_jax compiled with jax.jit, as the JAX package's pipeline runs
    it, on the arrays as JAX arrays; fn_torch on them as CPU tensors),
    both as numpy."""
    a = jax.jit(fn_jax)(*[jnp.asarray(x) for x in arrays])
    b = fn_torch(*[torch.from_numpy(np.ascontiguousarray(x))
                   for x in arrays])
    return host(a), host(b)


def assert_exact(a, b, what=""):
    """Same dtype, shape and values."""
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(b, a, err_msg=what)


def assert_lsb(a, b, what="", share=0.01):
    """u8 frames within 1 LSB, with under `share` of the bytes differing
    (the float paths' bound: exp/log/pow and sum orders may differ in the
    last ulp, and a rounded byte with them)."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max(initial=0) <= 1, (what, d.max())
    assert (d > 0).mean() < share, (what, (d > 0).mean())


def assert_frames(jres, tres, lsb=False):
    """Two run() results (lists of host FrameBatch): the same batches with
    equal pts, flags and valid and equal data (within 1 LSB where `lsb`)."""
    assert len(jres) == len(tres)
    for a, t in zip(jres, tres):
        for f in ("pts", "flags", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                          np.asarray(getattr(a, f)))
        ad, td = host(a.data), host(t.data)
        if isinstance(ad, dict):
            assert sorted(ad) == sorted(td)
            pairs = [(ad[k], td[k], k) for k in sorted(ad)]
        else:
            pairs = [(ad, td, "data")]
        for x, y, k in pairs:
            (assert_lsb if lsb else assert_exact)(x, y, k)


def assert_messages(jbus, tbus, rtol=0.0):
    """Equal bus messages: element, name, pts and field names; field
    values of the same kind and equal (floats within rtol)."""
    jm, tm = messages(jbus), messages(tbus)
    assert len(jm) == len(tm), (len(jm), len(tm))
    for a, t in zip(jm, tm):
        assert a[:3] == t[:3], (a[:3], t[:3])
        assert sorted(a[3]) == sorted(t[3])
        for k in a[3]:
            x, y = np.asarray(a[3][k]), np.asarray(t[3][k])
            assert type(a[3][k]) is type(t[3][k]), k
            assert x.dtype.kind == y.dtype.kind and x.shape == y.shape, k
            if x.dtype.kind == "f":
                np.testing.assert_allclose(y, x, rtol=rtol, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(y, x, err_msg=k)


def push_both(name, fmt, windows, props=None, setup=None):
    """Push each window (numpy frames) through element `name` in both
    packages' Harness (the port on the CPU), one pipeline each, so state
    carries across windows.  setup(element) runs before negotiation.
    Returns ((jax outputs, jax bus), (port outputs, port bus)), outputs a
    list of host batches."""
    first = windows[0]
    frame = (first["y"] if isinstance(first, dict) else first)
    h, w = frame.shape[1], frame.shape[2]
    out = []
    for hcls, scls, kw in ((JHarness, JMediaSpec, {}),
                           (Harness, MediaSpec, {"device": "cpu"})):
        hn = hcls(name, **kw, **(props or {}))
        if setup:
            setup(hn.element)
        hn.set_src_spec(scls(kind="video", format=fmt, width=w, height=h))
        res = []
        for data in windows:
            res += hn.push(data)
        out.append((res, hn.bus))
    return out
