"""Shared pieces of the codec and host-engine parity tests
(tests/test_torch_video_codecs.py, tests/test_torch_audio_engines.py):
seeded inputs, a launch string or an element chain in either package (the
port's on the CPU) for helpers/torch_transport.assert_both's scenarios,
what run() and the bus hand back as plain values, and the JAX tests of
the io modules run on both packages."""

import numpy as np

import gstbad_tpu_torch as gtt
from gstbad_tpu.core.pipeline import Pipeline as JPipeline
from gstbad_tpu.core.pipeline import parse_launch as jparse_launch
from gstbad_tpu_torch.core.pipeline import Pipeline as TPipeline
from helpers.torch_transport import JAX, canon
from helpers.twin import Twin


def launch(pkg, desc):
    """pkg.parse_launch(desc) (pkg: helpers/torch_transport's JAX or
    TORCH), the port's on the CPU."""
    return jparse_launch(desc) if pkg is JAX \
        else gtt.parse_launch(desc, device="cpu")


def chain(pkg, elements):
    """A linear Pipeline of `elements` (made by pkg), the port's on the
    CPU."""
    return JPipeline(elements) if pkg is JAX \
        else TPipeline(elements, device="cpu")


def batches(outs):
    """run()'s batches as plain values: data (planes sorted), pts, flags
    and valid, each as (dtype, shape, bytes)."""
    return [canon((b.data, b.pts, b.flags, b.valid)) for b in outs]


def messages(bus):
    return [canon((m.element, m.name, m.pts, m.fields))
            for m in bus.messages]


def i420(n, w, h, seed):
    """n seeded I420 frames, {plane: [n, ...]}: a moving gradient with a
    sprinkle of noise, so that the codecs have both smooth areas and
    detail."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(xx * 3 + yy * 2 + 9 * i) % 256 for i in range(n)])
    y = y.astype(np.uint8)
    y[:, ::5, ::7] = rng.integers(0, 256, y[:, ::5, ::7].shape, np.uint8)
    cy, cx = np.mgrid[0:h // 2, 0:w // 2]
    u = np.stack([(cx * 5 + 7 * i) % 256 for i in range(n)]).astype(np.uint8)
    v = np.stack([(cy * 4 + 200 - 5 * i) % 256
                  for i in range(n)]).astype(np.uint8)
    return {"y": y, "u": u, "v": v}


def packed(n, w, h, c, seed):
    """n seeded packed frames [n, h, w, c] (c of 1 gives [n, h, w])."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + k) + yy * (2 + k) + 40 * k) % 256
                     for k in range(c)], -1)
    out = np.stack([(base + 11 * i) % 256 for i in range(n)]).astype(np.uint8)
    out[:, ::3, ::4] = rng.integers(0, 256, out[:, ::3, ::4].shape, np.uint8)
    return out[..., 0] if c == 1 else out


def run_twinned(monkeypatch, names, mod, fn, kwargs, seeds=None):
    """A JAX test function with its module names bound to Twins of the
    JAX package's and the port's objects (helpers/twin.py); a test that
    takes `rng` gets a generator seeded from `seeds[mod]` (the conftest
    fixture's seed by default)."""
    for name, pair in names[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    code = fn.__code__
    if "rng" in code.co_varnames[:code.co_argcount]:
        kwargs = dict(kwargs, rng=np.random.default_rng(
            (seeds or {}).get(mod, 1234)))
    fn(**kwargs)
