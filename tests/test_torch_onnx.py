"""onnxobjectdetector (ext/onnx) and io/onnx.py through gstbad_tpu and
gstbad_tpu_torch on the same seeded models and inputs: each supported op
(to_jax against to_torch on the CPU, within 1e-5 of the largest output
magnitude: float32 products and convolutions summed in another order),
the JAX tests' toy convnet and toy detector, a window run as one batch
against its frames one at a time (the same function), the element's
messages, and the three corrections of the JAX interpreter: Shape, Gather
and Unsqueeze raise in both; a pool without `strides` takes ONNX's 1 in
the port (the JAX package takes the kernel size); `auto_pad` other than
NOTSET raises in the port (the JAX package ignores it); and with
explicit strides and pads both agree."""

import numpy as np
import pytest
import torch

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_onnx as to
from gstbad_tpu.io import onnx as jonnx
from gstbad_tpu_torch.io import onnx as tonnx

REL = 1e-5


def _attr_str(name, v):
    return to._ld(1, name.encode()) + to._ld(4, v.encode())


def _attr_tensor(name, arr):
    return to._ld(1, name.encode()) + to._ld(5, to._tensor(name, arr))


def _both(blob, *inputs):
    """The model's outputs from the JAX interpreter and the port's."""
    import jax.numpy as jnp
    fn, _, _ = jonnx.to_jax(jonnx.load_model(blob))
    m, _, _ = tonnx.to_torch(tonnx.load_model(blob), "cpu")
    j = [np.asarray(o) for o in fn(*[jnp.asarray(x) for x in inputs])]
    t = [o.numpy() for o in m(*[torch.from_numpy(x) for x in inputs])]
    return j, t


def _close(j, t):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        assert np.abs(a.astype(np.float64) - b).max(initial=0.0) \
            <= REL * scale


def _one(op, inputs, attrs=(), inits=(), out_shape=None, extra=()):
    """A one-node model: graph inputs `inputs` ({name: array}), the
    initializers `inits` ({name: array}) and the node's extra input names
    `extra` after them."""
    names = list(inputs) + list(dict(inits)) + list(extra)
    nodes = [to._node(op, names, ["y"], list(attrs))]
    return to._model(nodes, [to._tensor(k, v) for k, v in dict(inits).items()],
                     [(k, list(v.shape)) for k, v in inputs.items()],
                     [("y", out_shape or [1])])


R = np.random.default_rng(7)
X4 = R.standard_normal((2, 6, 9, 11)).astype(np.float32)
X2 = R.standard_normal((5, 4)).astype(np.float32)
POS = (np.abs(X2) + 0.5).astype(np.float32)

OPS = {
    "Conv": ({"x": X4}, [to._attr_ints("pads", [1, 0, 2, 1]),
                         to._attr_ints("strides", [2, 1]),
                         to._attr_ints("dilations", [1, 2]),
                         to._attr_int("group", 3)],
             {"w": R.standard_normal((9, 2, 3, 3)).astype(np.float32),
              "b": R.standard_normal(9).astype(np.float32)}),
    "Gemm": ({"a": X2}, [to._attr_int("transA", 1), to._attr_int("transB", 1),
                         to._attr_float("alpha", 0.5),
                         to._attr_float("beta", 2.0)],
             {"b": R.standard_normal((3, 5)).astype(np.float32),
              "c": R.standard_normal(3).astype(np.float32)}),
    "MatMul": ({"a": X4}, [], {"b": R.standard_normal((11, 4)
                                                      ).astype(np.float32)}),
    "Add": ({"a": X4}, [], {"b": R.standard_normal((9, 1)
                                                   ).astype(np.float32)}),
    "Sub": ({"a": X2, "b": POS}, [], {}),
    "Mul": ({"a": X2}, [], {"b": R.standard_normal(4).astype(np.float32)}),
    "Div": ({"a": X2, "b": POS}, [], {}),
    "Relu": ({"x": X4}, [], {}),
    "LeakyRelu": ({"x": X4}, [to._attr_float("alpha", 0.2)], {}),
    "Sigmoid": ({"x": X4}, [], {}),
    "Tanh": ({"x": X4}, [], {}),
    "Exp": ({"x": X2}, [], {}),
    "Softmax": ({"x": X4}, [to._attr_int("axis", 1)], {}),
    "Clip": ({"x": X4}, [to._attr_float("min", -0.5),
                         to._attr_float("max", 0.75)], {}),
    "Concat": ({"a": X2, "b": POS}, [to._attr_int("axis", 1)], {}),
    "Reshape": ({"x": X4}, [], {"s": np.array([2, -1, 11], np.int64)}),
    "Flatten": ({"x": X4}, [to._attr_int("axis", 2)], {}),
    "Transpose": ({"x": X4}, [to._attr_ints("perm", [0, 2, 3, 1])], {}),
    "MaxPool": ({"x": X4}, [to._attr_ints("kernel_shape", [3, 2]),
                            to._attr_ints("strides", [2, 2]),
                            to._attr_ints("pads", [1, 0, 1, 1])], {}),
    "AveragePool": ({"x": X4}, [to._attr_ints("kernel_shape", [3, 3]),
                                to._attr_ints("strides", [2, 1]),
                                to._attr_ints("pads", [1, 1, 0, 1])], {}),
    "GlobalAveragePool": ({"x": X4}, [], {}),
    "BatchNormalization": (
        {"x": X4}, [to._attr_float("epsilon", 1e-3)],
        {"s": R.standard_normal(6).astype(np.float32),
         "bb": R.standard_normal(6).astype(np.float32),
         "m": R.standard_normal(6).astype(np.float32),
         "v": (R.random(6) + 0.1).astype(np.float32)}),
    "Identity": ({"x": X2}, [], {}),
    "Constant": ({}, [_attr_tensor("value", X2)], {}),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax(op):
    """Each supported op alone on seeded inputs (pads, strides, groups,
    dilations, transposes and broadcasts among them)."""
    inputs, attrs, inits = OPS[op]
    j, t = _both(_one(op, inputs, attrs, inits), *inputs.values())
    _close(j, t)


def test_toy_convnet_and_batched_frames():
    """The JAX tests' convnet (tests/test_onnx.py _make_convnet): the port
    against the JAX interpreter and the numpy forward; and a window of 5
    frames run as one batch (OnnxModule.frames) against the frames one at
    a time, within the same tolerance (the batched convolutions sum in
    another order)."""
    import pathlib
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path, ref = to._make_convnet(pathlib.Path(d),
                                     np.random.default_rng(3))
        blob = open(path, "rb").read()
    x = np.random.default_rng(4).standard_normal((1, 3, 16, 16)).astype(
        np.float32)
    j, t = _both(blob, x)
    _close(j, t)
    np.testing.assert_allclose(t[0], ref(x.astype(np.float64)), rtol=2e-4,
                               atol=2e-4)
    m, _, _ = tonnx.to_torch(tonnx.load_model(blob), "cpu")
    xs = np.random.default_rng(5).standard_normal((5, 1, 3, 16, 16)
                                                  ).astype(np.float32)
    (batched, was), = m.frames(torch.from_numpy(xs))
    assert was and batched.shape == (5, 1, 10)
    one = np.stack([m(torch.from_numpy(f))[0].numpy() for f in xs])
    _close([one], [batched.numpy()])


def test_phase_4m_model_matches_jax_and_batches():
    """chip_smoke.onnx_model (phase 4m's detector: BatchNormalization,
    LeakyRelu, a depthwise group convolution, Clip, Reshape, Transpose,
    three MatMuls and a Sigmoid) on seeded 0..255 planes: the port
    against the JAX interpreter, and two frames as one batch against each
    alone."""
    blob = chip_smoke.onnx_model()
    x = np.random.default_rng(6).integers(0, 256, (2, 1, 3, 320, 320)
                                          ).astype(np.float32)
    j, t = _both(blob, x[0])
    _close(j, t)
    assert [a.shape for a in t] == [(1, 100, 1), (1, 100, 4), (1, 100, 1)]
    m, _, _ = tonnx.to_torch(tonnx.load_model(blob), "cpu")
    batched = [o.numpy() for o, _ in m.frames(torch.from_numpy(x))]
    for k in range(2):
        _close([o.numpy() for o in m(torch.from_numpy(x[k]))],
               [b[k] for b in batched])


def _detector(tmp_path, rng):
    """The JAX tests' toy detector (tests/test_onnx.py:153): Conv ->
    GlobalAveragePool -> two Gemm heads (scores by Sigmoid, boxes)."""
    w = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.1
    wscore = rng.standard_normal((5, 8)).astype(np.float32)
    wbox = rng.standard_normal((20, 8)).astype(np.float32)
    nodes = [
        to._node("Conv", ["x", "w"], ["c"],
                 [to._attr_ints("pads", [1, 1, 1, 1]),
                  to._attr_ints("kernel_shape", [3, 3])]),
        to._node("GlobalAveragePool", ["c"], ["g"]),
        to._node("Flatten", ["g"], ["f"], [to._attr_int("axis", 1)]),
        to._node("Gemm", ["f", "wscore"], ["logits"],
                 [to._attr_int("transB", 1)]),
        to._node("Sigmoid", ["logits"], ["scores"]),
        to._node("Gemm", ["f", "wbox"], ["boxes"],
                 [to._attr_int("transB", 1)]),
    ]
    blob = to._model(nodes, [to._tensor("w", w), to._tensor("wscore", wscore),
                             to._tensor("wbox", wbox)],
                     [("x", [1, 3, 32, 32])],
                     [("scores", [1, 5]), ("boxes", [1, 20])])
    mp = tmp_path / "det.onnx"
    mp.write_bytes(blob)
    labels = tmp_path / "labels.txt"
    labels.write_text("cat\ndog\nbird\ncar\ntree\n")
    return mp, labels


@pytest.mark.parametrize("fmt", ["RGBx", "BGRx"])
def test_detector_element_messages(tmp_path, fmt):
    """The toy detector in onnxobjectdetector behind videotestsrc (ball,
    64x48, resized to the model's 32x32 plane), 2 windows of 3, in both
    packages: the same messages (count and the keep masks equal; scores
    and boxes within the tolerance) and labels."""
    mp, labels = _detector(tmp_path, np.random.default_rng(8))
    desc = (f"videotestsrc pattern=ball width=64 height=48 format={fmt} "
            f"! onnxobjectdetector name=d model-file={mp} "
            f"label-file={labels} input-image-format=chw "
            "score-node-index=0 box-node-index=1 score-threshold=0.5 "
            "! fakesink")
    got = {}
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.run(n_frames=6, window=3)
        got[pkg] = ([(m.element, m.name, m.pts, m.fields)
                     for m in p.bus.messages], p.get_by_name("d").labels)
    (jm, jl), (tm, tl) = got[gt], got[gtt]
    assert tl == jl == ["cat", "dog", "bird", "car", "tree"]
    assert len(tm) == len(jm) == 6
    for a, b in zip(jm, tm):
        assert a[:3] == b[:3] and sorted(a[3]) == sorted(b[3])
        assert int(a[3]["count"]) == int(b[3]["count"])
        np.testing.assert_array_equal(np.asarray(a[3]["scores"]) > 0,
                                      np.asarray(b[3]["scores"]) > 0)
        _close([np.asarray(a[3][k]) for k in ("scores", "boxes")],
               [np.asarray(b[3][k]) for k in ("scores", "boxes")])


def test_port_element_runs_the_window_as_one_batch(tmp_path, monkeypatch):
    """The port's element calls its module once a window (frames), on
    the pipeline's device, where the JAX element maps the model over the
    frames."""
    mp, labels = _detector(tmp_path, np.random.default_rng(9))
    calls = []
    orig = tonnx.OnnxModule.frames

    def spy(self, *args):
        calls.append(tuple(args[0].shape))
        return orig(self, *args)
    monkeypatch.setattr(tonnx.OnnxModule, "frames", spy)
    p = gtt.parse_launch(
        f"videotestsrc pattern=ball width=64 height=48 format=RGBx "
        f"! onnxobjectdetector model-file={mp} input-image-format=chw "
        "score-node-index=0 ! fakesink", device="cpu")
    p.run(n_frames=8, window=4)
    assert calls == [(4, 1, 3, 32, 32)] * 2


# ------------------------------------------ the JAX interpreter's faults

@pytest.mark.parametrize("op", ["Shape", "Gather", "Unsqueeze"])
def test_unlisted_shape_ops_raise_in_both(op):
    """The JAX docstring lists Shape+Gather+Unsqueeze, but to_jax has no
    branch for them: both packages raise "unsupported op"."""
    import jax.numpy as jnp
    blob = _one(op, {"x": X2}, (), {"i": np.array([0], np.int64)}
                if op != "Shape" else {})
    fn, _, _ = jonnx.to_jax(jonnx.load_model(blob))
    with pytest.raises(ValueError, match="unsupported op"):
        fn(jnp.asarray(X2))
    m, _, _ = tonnx.to_torch(tonnx.load_model(blob))
    with pytest.raises(ValueError, match="unsupported op"):
        m(torch.from_numpy(X2))


@pytest.mark.parametrize("op", ["MaxPool", "AveragePool"])
def test_pool_default_strides(op):
    """Without `strides` ONNX takes 1: the port does; the JAX package takes
    the kernel size.  With strides given, both agree."""
    attrs = [to._attr_ints("kernel_shape", [2, 2])]
    j, t = _both(_one(op, {"x": X4}, attrs), X4)
    assert t[0].shape == (2, 6, 8, 10)          # stride 1
    assert j[0].shape == (2, 6, 4, 5)           # stride 2, the kernel size
    for s in ([1, 1], [2, 2]):
        j, t = _both(_one(op, {"x": X4},
                          attrs + [to._attr_ints("strides", s)]), X4)
        _close(j, t)


@pytest.mark.parametrize("op", ["Conv", "MaxPool"])
def test_auto_pad_raises_in_the_port(op):
    """auto_pad SAME_UPPER: the JAX package ignores it and runs unpadded
    (a smaller output, no error); the port raises.  With the same padding
    as explicit pads, both agree."""
    if op == "Conv":
        inits = {"w": R.standard_normal((4, 6, 3, 3)).astype(np.float32)}
        base = [to._attr_ints("kernel_shape", [3, 3])]
    else:
        inits = {}
        base = [to._attr_ints("kernel_shape", [3, 3]),
                to._attr_ints("strides", [1, 1])]
    blob = _one(op, {"x": X4}, base + [_attr_str("auto_pad", "SAME_UPPER")],
                inits)
    import jax.numpy as jnp
    fn, _, _ = jonnx.to_jax(jonnx.load_model(blob))
    assert np.asarray(fn(jnp.asarray(X4))[0]).shape[2:] == (7, 9)
    m, _, _ = tonnx.to_torch(tonnx.load_model(blob))
    with pytest.raises(ValueError, match="auto_pad 'SAME_UPPER'"):
        m(torch.from_numpy(X4))
    j, t = _both(_one(op, {"x": X4}, base + [
        to._attr_ints("pads", [1, 1, 1, 1])], inits), X4)
    _close(j, t)
    assert t[0].shape[2:] == (9, 11)
