"""Shared pieces of the audio parity tests (tests/test_torch_audio_*.py):
one graph through gstbad_tpu and gstbad_tpu_torch (on the CPU), window by
window, with taps, bus messages and the final states, and the XLA form of
the JAX VAD's serial power kernel.

The JAX VAD's serial power recurrence is a Pallas kernel
(gstbad_tpu/ops/audio.py:_vad_powers_pallas); in interpret mode each
window shape compiles for 20-40 s on the CPU.  The element and graph
tests swap it for `xla_vad_powers`, the same recurrence as an XLA scan in
the kernel's output layout (the form of gstbad_tpu.ops.audio.vad_block).
tests/test_torch_audio_vad.py holds the port's recurrence against the
Pallas kernel itself in interpret mode, and the JAX package's own tests
hold the kernel against the serial reference.
"""

import numpy as np
import torch

import jax.numpy as jnp
from jax import lax

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec


def xla_vad_powers(p0_hi_lo, sq, interpret=False):
    """_vad_powers_pallas's result (block-end (hi, lo) power limbs, [nb, 2]
    int32) computed as an XLA scan of the reference update."""
    del interpret
    a, b = jaudio.VAD_POWER_ALPHA, jaudio._VAD_B
    p0 = ((p0_hi_lo[0].astype(jnp.int64) << 16)
          | p0_hi_lo[1].astype(jnp.int64))

    def row(p, r):
        p, _ = lax.scan(lambda q, s: (a * s + ((b * q) >> 16), None), p,
                        r.astype(jnp.int64))
        return p, p

    _, ends = lax.scan(row, p0, sq)
    return jnp.stack([(ends >> 16).astype(jnp.int32),
                      (ends & 0xFFFF).astype(jnp.int32)], axis=1)


def use_xla_vad_serial(monkeypatch):
    monkeypatch.setattr(jaudio, "_vad_powers_pallas", xla_vad_powers)


def numpy_tree(x):
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def audio_spec(pkg, fmt, channels, rate=48000):
    cls = JMediaSpec if pkg is gt else MediaSpec
    return cls(kind="audio", format=fmt, rate=rate, channels=channels)


def run_both(desc, n_windows, window, taps=(), spec=None, inputs=None):
    """Run `desc` for n_windows windows in both packages (the port on the
    CPU); see run_pipelines."""
    return run_pipelines(gt.parse_launch(desc),
                         gtt.parse_launch(desc, device="cpu"), n_windows,
                         window, taps, spec, inputs)


def run_pipelines(pj, pt, n_windows, window, taps=(), spec=None,
                  inputs=None):
    """Run the JAX pipeline pj and the port's pt (on the CPU) for
    n_windows windows, stepping the compiled window function.  With
    `spec` (fmt, channels, rate) the graph has no source and takes
    `inputs` (data [n_windows * window, S, C], pts, valid numpy arrays).
    Returns per package a dict: "batches" ((data, pts, valid) of the sink
    per window, every slot, valid or not), "taps" ({name: [data]}),
    "messages" and "states" (numpy trees)."""
    out = {}
    for key, pkg, p, fb_cls, conv in (
            ("jax", gt, pj, JFrameBatch, jnp.asarray),
            ("torch", gtt, pt, FrameBatch, torch.from_numpy)):
        p.negotiate(None if spec is None else audio_spec(pkg, *spec))
        step = p.compile(window, taps=taps)
        params, states = p.params(), p.init_states(window)
        batches, tapped = [], {t: [] for t in taps}
        for w in range(n_windows):
            batch = None
            if inputs is not None:
                sl = slice(w * window, (w + 1) * window)
                data, pts, valid = (conv(np.ascontiguousarray(a[sl]))
                                    for a in inputs)
                batch = fb_cls.make(data, pts=pts, valid=valid)
            states, leaves, msgs = step(params, states, batch)
            p._drain_messages(leaves[0], msgs)
            leaf = leaves[0]
            batches.append(tuple(numpy_tree(x) for x in
                                 (leaf.data, leaf.pts, leaf.valid)))
            for t, b in p.taps_of(leaves).items():
                tapped[t].append(numpy_tree(b.data))
        out[key] = {"batches": batches, "taps": tapped,
                    "messages": [(m.element, m.name, m.pts, m.fields)
                                 for m in p.bus.messages],
                    "states": numpy_tree(states)}
    return out["jax"], out["torch"]


def assert_states_close(a, b, atol=0.0, path="state"):
    """Equal trees of numpy arrays: same keys, dtypes and shapes, values
    equal (integers, bools) or within atol (floats)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_states_close(a[k], b[k], atol, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_states_close(x, y, atol, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f" and atol:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
