"""Shared pieces of the overlay and text-renderer parity tests
(tests/test_torch_{overlay,closedcaption,subtitles,qr_rsvg_face}.py): a
chain of elements, or a graph, through gstbad_tpu and gstbad_tpu_torch
(on the CPU) on the same numpy windows, and the comparisons."""

import fractions

import numpy as np
import torch

import jax.numpy as jnp

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.pipeline import Pipeline as JPipeline
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.pipeline import Pipeline
from gstbad_tpu_torch.core.spec import MediaSpec
from helpers.torch_cv import assert_frames, assert_messages, host

torch.set_num_threads(1)   # parallel test workers share the cores

RATE = fractions.Fraction(30)


def _batch(pkg, data, pts):
    if pkg == "jax":
        conv = jnp.asarray
        make = JFrameBatch.make
    else:
        def conv(a):
            return torch.from_numpy(np.ascontiguousarray(a))
        make = FrameBatch.make
    d = ({k: conv(v) for k, v in data.items()} if isinstance(data, dict)
         else conv(data))
    return make(d, pts=None if pts is None
                else conv(np.asarray(pts, np.int64)))


def run_both(chain, spec, windows, setup=None):
    """Each window (data, pts or None) through the chain [(name, props)]
    in both packages, one pipeline each (state carries across windows);
    setup(pkg, elements) runs before negotiation.  -> {"jax": (outputs,
    bus, elements), "torch": (...)}, outputs a list of host batches."""
    out = {}
    for pkg, make, pipe, mspec, kw in (
            ("jax", gt.make, JPipeline, JMediaSpec, {}),
            ("torch", gtt.make, Pipeline, MediaSpec, {"device": "cpu"})):
        els = [make(name, **(props or {})) for name, props in chain]
        if setup:
            setup(pkg, els)
        p = pipe(els, **kw)
        p.negotiate(mspec(**spec))
        res = []
        for data, pts in windows:
            res += p.run(inputs=_batch(pkg, data, pts))
        out[pkg] = (res, p.bus, els)
    return out


def run_launch_both(desc, feed=None, n_frames=None, window=4,
                    feed_first=False):
    """The launch string `desc` in both packages (the port on the CPU);
    feed(pkg, pipeline) pushes host inputs after negotiation, or before
    it with feed_first (an element that renders its inputs when it
    negotiates).  -> {"jax": (outputs, bus, pipeline), "torch": (...)}."""
    out = {}
    for pkg, mod, kw in (("jax", gt, {}), ("torch", gtt, {"device": "cpu"})):
        p = mod.parse_launch(desc, **kw)
        if feed and feed_first:
            feed(pkg, p)
        p.negotiate()
        if feed and not feed_first:
            feed(pkg, p)
        res = p.run(n_frames=n_frames, window=window) if n_frames \
            else p.run(window=window)
        out[pkg] = (res, p.bus, p)
    return out


def assert_same(res, min_messages=0):
    """The two packages' outputs equal (frames, pts, flags, valid) and
    their bus messages equal, with at least one output frame and
    min_messages messages."""
    jres, jbus = res["jax"][:2]
    tres, tbus = res["torch"][:2]
    assert sum(np.asarray(b.valid).sum() for b in tres) > 0
    assert_frames(jres, tres)
    assert_messages(jbus, tbus)
    assert len(tbus.messages) >= min_messages
    return tres


def data_of(res, pkg="torch"):
    """The concatenated output data of one package's run."""
    bs = [host(b.data) for b in res[pkg][0]]
    if isinstance(bs[0], dict):
        return {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
    return np.concatenate(bs)


def spec(fmt, w, h, rate=RATE):
    return dict(kind="video", format=fmt, width=w, height=h, framerate=rate)
