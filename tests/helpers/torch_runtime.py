"""Shared pieces of the runtime-surface parity tests
(tests/test_torch_{runtime,trim,files,bridges,observability,videosignal}.py):
one launch string through gstbad_tpu and gstbad_tpu_torch (on the CPU),
and the comparison of what run() hands back — per batch, so trimmed blocks
are compared at their cut lengths — and of the bus messages."""

import numpy as np
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt

torch.set_num_threads(1)   # parallel test workers share the cores


def messages(bus):
    return [(m.element, m.name, m.pts, m.fields) for m in bus.messages]


def assert_messages_equal(jbus, tbus):
    jm, tm = messages(jbus), messages(tbus)
    assert len(jm) == len(tm)
    for a, t in zip(jm, tm):
        assert a[:3] == t[:3]
        assert sorted(a[3]) == sorted(t[3])
        for k in a[3]:
            assert type(a[3][k]) is type(t[3][k]), k
            assert a[3][k] == t[3][k], (a, t)


def _arrays(x):
    if isinstance(x, dict):
        return [(k, np.asarray(x[k])) for k in sorted(x)]
    return [("", np.asarray(x))]


def assert_batches_equal(jres, tres):
    """run() results of the two packages: the same batches (a list, or
    {leaf: list}), each with equal data (dtype, shape, values), pts,
    flags and valid, and no trim left."""
    if isinstance(jres, dict):
        assert sorted(jres) == sorted(tres)
        for k in jres:
            assert_batches_equal(jres[k], tres[k])
        return
    assert len(jres) == len(tres)
    for a, t in zip(jres, tres):
        assert t.trim is None
        for f in ("pts", "flags", "valid"):
            av, tv = np.asarray(getattr(a, f)), getattr(t, f)
            assert av.dtype == tv.dtype, f
            np.testing.assert_array_equal(tv, av, err_msg=f)
        ja, ta = _arrays(a.data), _arrays(t.data)
        assert [k for k, _ in ja] == [k for k, _ in ta]
        for (k, av), (_, tv) in zip(ja, ta):
            assert av.dtype == tv.dtype and av.shape == tv.shape, k
            np.testing.assert_array_equal(tv, av, err_msg=k)


def run_both(desc, n_frames, window, setup=None):
    """(jax pipeline, jax result), (port pipeline, port result) of `desc`
    run for n_frames in windows of `window`; setup(p) runs first."""
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        if setup:
            setup(p)
        out.append((p, p.run(n_frames=n_frames, window=window)))
    return out


def check_both(desc, n_frames, window, setup=None):
    (jp, jres), (tp, tres) = run_both(desc, n_frames, window, setup)
    assert_batches_equal(jres, tres)
    assert_messages_equal(jp.bus, tp.bus)
    return (jp, jres), (tp, tres)
