"""Minimal ONNX model loader — ModelProto parsing + a PyTorch interpreter.

The reference's onnx plugin (ext/onnx/gstonnxclient.cpp) hands the model
file to onnxruntime; here the model FILE is parsed directly (a varint
protobuf reader over the ONNX ModelProto subset below — the `onnx` python
package is not needed) and lowered to an nn.Module on the pipeline's
device, whose forward walks the graph's nodes in order.

Supported graph surface (raise loudly otherwise):
- initializers: float32/float64/int64/int32 tensors (raw_data or the
  typed repeated fields)
- ops: Conv (groups/pads/strides/dilations), Gemm, MatMul, Add, Sub,
  Mul, Div, Relu, LeakyRelu, Sigmoid, Tanh, Softmax, Exp, Concat,
  Reshape, Flatten, Transpose, MaxPool, AveragePool,
  GlobalAveragePool, BatchNormalization (inference form), Identity,
  Constant, Clip; `auto_pad` NOTSET only

A port of the JAX package's io/onnx.py: the protobuf reader is a copy,
and to_jax becomes to_torch.  Three corrections of the JAX interpreter:
it names Shape, Gather and Unsqueeze as supported but raises on them
("unsupported op"), as this one does, so they are not listed above; its
pools default `strides` to `kernel_shape` where ONNX defaults them to 1,
as this one does; and its Conv ignores `auto_pad` (a SAME_UPPER model ran
unpadded), where this one raises on any `auto_pad` but NOTSET.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gstbad_tpu_torch.ops.numerics import full_fp32


# ---------------------------------------------------------------------------
# protobuf wire-format reader (varint subset; no proto schema compiler)
# ---------------------------------------------------------------------------


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:      # varint
            val, i = _varint(buf, i)
        elif wtype == 1:    # 64-bit
            val = buf[i:i + 8]
            i += 8
        elif wtype == 2:    # length-delimited
            ln, i = _varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wtype == 5:    # 32-bit
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"onnx: unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_varints(val) -> List[int]:
    if isinstance(val, int):
        return [val]
    out, i = [], 0
    while i < len(val):
        v, i = _varint(val, i)
        out.append(v)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


class Tensor:
    def __init__(self, buf: bytes):
        self.dims: List[int] = []
        self.data_type = 1
        self.name = ""
        raw = b""
        floats: List[float] = []
        int64s: List[int] = []
        int32s: List[int] = []
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                self.dims += [_signed(v) for v in _packed_varints(val)]
            elif fnum == 2:
                self.data_type = val
            elif fnum == 4:
                if wtype == 5:
                    floats.append(struct.unpack("<f", val)[0])
                else:
                    floats += list(np.frombuffer(val, "<f4"))
            elif fnum == 5:
                int32s += [_signed(v) for v in _packed_varints(val)]
            elif fnum == 7:
                int64s += [_signed(v) for v in _packed_varints(val)]
            elif fnum == 8:
                self.name = val.decode()
            elif fnum == 9:
                raw = val
        dt = {1: "<f4", 6: "<i4", 7: "<i8", 11: "<f8"}.get(self.data_type)
        if dt is None:
            raise ValueError(f"onnx: unsupported tensor data_type "
                             f"{self.data_type} ({self.name!r})")
        if raw:
            arr = np.frombuffer(raw, dt)
        elif floats:
            arr = np.array(floats, dt)
        elif int64s:
            arr = np.array(int64s, dt)
        elif int32s:
            arr = np.array(int32s, dt)
        else:
            arr = np.zeros(0, dt)
        self.array = arr.reshape(self.dims) if self.dims else arr


class Attribute:
    def __init__(self, buf: bytes):
        self.name = ""
        self.f = None
        self.i = None
        self.s = None
        self.t = None
        self.floats: List[float] = []
        self.ints: List[int] = []
        for fnum, wtype, val in _fields(buf):
            if fnum == 1:
                self.name = val.decode()
            elif fnum == 2:
                self.f = struct.unpack("<f", val)[0]
            elif fnum == 3:
                self.i = _signed(val)
            elif fnum == 4:
                self.s = val
            elif fnum == 5:
                self.t = Tensor(val)
            elif fnum == 7:
                if wtype == 5:
                    self.floats.append(struct.unpack("<f", val)[0])
                else:
                    self.floats += list(np.frombuffer(val, "<f4"))
            elif fnum == 8:
                self.ints += [_signed(v) for v in _packed_varints(val)]


class Node:
    def __init__(self, buf: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.op = ""
        self.name = ""
        self.attrs: Dict[str, Attribute] = {}
        for fnum, _, val in _fields(buf):
            if fnum == 1:
                self.inputs.append(val.decode())
            elif fnum == 2:
                self.outputs.append(val.decode())
            elif fnum == 3:
                self.name = val.decode()
            elif fnum == 4:
                self.op = val.decode()
            elif fnum == 5:
                a = Attribute(val)
                self.attrs[a.name] = a


def _vi_name_shape(buf: bytes):
    """ValueInfoProto -> (name, shape list or None)."""
    name, shape = "", None
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            shape = []
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dv = 0
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = _signed(v5)
                                    shape.append(dv)
    return name, shape


class Graph:
    def __init__(self, buf: bytes):
        self.nodes: List[Node] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.inputs: List[Tuple[str, list]] = []
        self.outputs: List[str] = []
        self.name = ""
        for fnum, _, val in _fields(buf):
            if fnum == 1:
                self.nodes.append(Node(val))
            elif fnum == 2:
                self.name = val.decode()
            elif fnum == 5:
                t = Tensor(val)
                self.initializers[t.name] = t.array
            elif fnum == 11:
                self.inputs.append(_vi_name_shape(val))
            elif fnum == 12:
                self.outputs.append(_vi_name_shape(val)[0])
        init = set(self.initializers)
        self.inputs = [(n, s) for n, s in self.inputs if n not in init]


def load_model(path_or_bytes) -> Graph:
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else open(path_or_bytes, "rb").read())
    for fnum, _, val in _fields(bytes(data)):
        if fnum == 7:  # ModelProto.graph
            return Graph(val)
    raise ValueError("onnx: no graph in model file")


# ---------------------------------------------------------------------------
# PyTorch interpreter
# ---------------------------------------------------------------------------


def _check_auto_pad(node, at) -> None:
    pad = at.get("auto_pad", b"NOTSET")
    pad = pad.decode() if isinstance(pad, bytes) else str(pad)
    if pad != "NOTSET":
        raise ValueError(f"onnx: auto_pad {pad!r} is not supported "
                         f"(node {node.name!r}); give explicit pads")


def _pads(attrs, rank: int):
    """ONNX pads [b1, b2, ..., e1, e2, ...] -> F.pad's order (the last
    axis first, begin then end)."""
    pads = [int(p) for p in attrs.get("pads", [0] * (2 * rank))]
    out = []
    for i in reversed(range(rank)):
        out += [pads[i], pads[i + rank]]
    return out


def _conv(x, w, b, attrs, group):
    strides = tuple(int(s) for s in attrs.get("strides", [1, 1]))
    dil = tuple(int(d) for d in attrs.get("dilations", [1, 1]))
    pad = _pads(attrs, 2)
    if pad[0] == pad[1] and pad[2] == pad[3]:
        padding = (pad[2], pad[0])
    else:
        x = F.pad(x, pad)
        padding = 0
    y = F.conv2d(x, w, None, strides, padding, dil, group)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def _pool(x, attrs, kind):
    ks = tuple(int(k) for k in attrs["kernel_shape"])
    strides = tuple(int(s) for s in attrs.get("strides", [1] * len(ks)))
    pad = _pads(attrs, len(ks))
    if kind == "max":
        return F.max_pool2d(F.pad(x, pad, value=-float("inf")), ks, strides)
    # the sum of the in-bounds taps over their count
    sums = F.avg_pool2d(F.pad(x, pad), ks, strides, divisor_override=1)
    counts = F.avg_pool2d(F.pad(torch.ones_like(x[:1, :1]), pad), ks,
                          strides, divisor_override=1)
    return sums / counts


def _per_frame(fn, x):
    """fn of [B * n, ...] (an op that treats its leading axis as the
    model's batch: convolutions, pools) on the frames' [B, n, ...]."""
    b = x.shape[0]
    return fn(x.flatten(0, 1)).unflatten(0, (b, -1))


def _align(vals, bat):
    """The operands of a broadcasting op over frames: an operand without
    the frame axis gets one of size 1, and each gets size-1 axes after
    the frame axis up to the largest model rank, so that numpy's
    right-aligned broadcasting meets the model's axes with the model's."""
    vals = [v if b else v[None] for v, b in zip(vals, bat)]
    r = max(v.dim() for v in vals)
    return [v.reshape(v.shape[:1] + (1,) * (r - v.dim()) + v.shape[1:])
            for v in vals]


class OnnxModule(nn.Module):
    """The graph as a module: its initializers are buffers on `device`,
    and forward walks the nodes in order, as to_jax's fn does.

    forward(*inputs) runs the model on its inputs as given.
    frames(*inputs) runs it on each frame of a window at once: every
    input carries one more leading axis than the model sees, the frame,
    and each frame is one call of the model (as the JAX element's vmap
    over frames), computed as one batch: the values the inputs reach keep
    the frame axis (convolutions and pools take the B frames' model
    batches as one batch, a Reshape or Transpose acts after it)."""

    def __init__(self, graph: Graph, device="cpu"):
        super().__init__()
        self.graph = graph
        self.input_names = [n for n, _ in graph.inputs]
        self.output_names = list(graph.outputs)
        self._np_consts = dict(graph.initializers)
        self._device = torch.device(device)
        self._buffer_of = {}
        for i, (k, v) in enumerate(graph.initializers.items()):
            self.register_buffer(f"init{i}", torch.from_numpy(
                np.array(v)).to(self._device))
            self._buffer_of[k] = f"init{i}"

    def forward(self, *args):
        outs = self.frames(*[a[None] for a in args])
        return [o[0] if batched else o for o, batched in outs]

    def frames(self, *args):
        """The model on each frame of args ([B, ...] each): a list of
        (output, batched) pairs, a batched output [B, ...]."""
        env = {k: getattr(self, n) for k, n in self._buffer_of.items()}
        env.update(zip(self.input_names, args))
        batched = set(self.input_names)
        with full_fp32():
            for node in self.graph.nodes:
                at = {n: (a.i if a.i is not None else a.f if a.f is not None
                          else a.ints if a.ints else a.floats if a.floats
                          else a.t if a.t is not None else a.s)
                      for n, a in node.attrs.items()}
                ins = [env[i] if i else None for i in node.inputs]
                bat = [bool(i) and i in batched for i in node.inputs]
                out, out_b = self._node(node, at, ins, bat)
                env[node.outputs[0]] = out
                if out_b:
                    batched.add(node.outputs[0])
                else:
                    batched.discard(node.outputs[0])
        return [(env[o], o in batched) for o in self.output_names]

    def _node(self, node, at, ins, bat):
        """One node: (its output, whether it carries the frame axis)."""
        op = node.op
        x = ins[0] if ins else None
        xb = bool(bat) and bat[0]
        any_b = any(bat)
        if op == "Conv":
            _check_auto_pad(node, at)
            bias = ins[2] if len(ins) > 2 else None
            fn = lambda v: _conv(v, ins[1], bias, at,    # noqa: E731
                                 int(at.get("group", 1)))
            return (_per_frame(fn, x) if xb else fn(x)), xb
        if op in ("MaxPool", "AveragePool"):
            _check_auto_pad(node, at)
            kind = "max" if op == "MaxPool" else "avg"
            fn = lambda v: _pool(v, at, kind)             # noqa: E731
            return (_per_frame(fn, x) if xb else fn(x)), xb
        if op in ("Gemm", "MatMul"):
            a, b = ins[0], ins[1]
            if op == "Gemm" and at.get("transA", 0):
                a = a.transpose(-1, -2)
            if op == "Gemm" and at.get("transB", 0):
                b = b.transpose(-1, -2)
            if not any_b:
                out = torch.matmul(a, b)
            else:
                # a model vector is a matrix of one row (column) here
                a_vec, b_vec = a.dim() - bat[0] == 1, b.dim() - bat[1] == 1
                a = a.unsqueeze(-2) if a_vec else a
                b = b.unsqueeze(-1) if b_vec else b
                out = torch.matmul(*_align([a, b], bat[:2]))
                out = out.squeeze(-1) if b_vec else out
                out = out.squeeze(-2) if a_vec else out
            if op == "MatMul":
                return out, any_b
            out = at.get("alpha", 1.0) * out
            if len(ins) > 2 and ins[2] is not None:
                out = out + at.get("beta", 1.0) * ins[2]
            return out, any_b or (len(bat) > 2 and bat[2])
        if op in ("Add", "Sub", "Mul", "Div"):
            a, b = _align(ins[:2], bat[:2]) if any_b else ins[:2]
            f = {"Add": torch.add, "Sub": torch.sub,
                 "Mul": torch.mul, "Div": torch.div}[op]
            return f(a, b), any_b
        if op == "Relu":
            return torch.clamp_min(x, 0), xb
        if op == "LeakyRelu":
            alpha = at.get("alpha", 0.01)
            return torch.where(x >= 0, x, alpha * x), xb
        if op == "Sigmoid":
            return 1.0 / (1.0 + torch.exp(-x)), xb
        if op == "Tanh":
            return torch.tanh(x), xb
        if op == "Exp":
            return torch.exp(x), xb
        if op == "Softmax":
            axis = int(at.get("axis", -1))
            axis = axis + 1 if xb and axis >= 0 else axis
            z = x - torch.amax(x, dim=axis, keepdim=True)
            e = torch.exp(z)
            return e / torch.sum(e, dim=axis, keepdim=True), xb
        if op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None \
                else at.get("min", -float("inf"))
            hi = ins[2] if len(ins) > 2 and ins[2] is not None \
                else at.get("max", float("inf"))
            return torch.clamp(x, lo, hi), xb
        if op == "Concat":
            axis = int(at.get("axis", 0))
            if not any_b:
                return torch.cat(ins, dim=axis), False
            n = next(v.shape[0] for v, b in zip(ins, bat) if b)
            parts = [v if b else v[None].expand((n,) + tuple(v.shape))
                     for v, b in zip(ins, bat)]
            return torch.cat(parts, dim=axis + 1 if axis >= 0
                             else axis), True
        if op == "Reshape":
            shape = (self._np_consts[node.inputs[1]]
                     if node.inputs[1] in self._np_consts
                     else ins[1].cpu().numpy())
            shape = [int(s) for s in np.asarray(shape).tolist()]
            return (x.reshape([x.shape[0]] + shape) if xb
                    else x.reshape(shape)), xb
        if op == "Flatten":
            ax = int(at.get("axis", 1))
            dims = x.shape[1:] if xb else x.shape
            lead = int(np.prod(dims[:ax])) if ax else 1
            return (x.reshape(x.shape[0], lead, -1) if xb
                    else x.reshape(lead, -1)), xb
        if op == "Transpose":
            rank = x.dim() - xb
            perm = list(at.get("perm") or reversed(range(rank)))
            return x.permute([0] + [p + 1 for p in perm] if xb
                             else perm), xb
        if op == "GlobalAveragePool":
            return torch.mean(x, dim=(-2, -1), keepdim=True), xb
        if op == "BatchNormalization":
            scale, bias, mean, var = ins[1:5]
            eps = at.get("epsilon", 1e-5)
            shp = (1, -1) + (1,) * (x.dim() - xb - 2)
            return ((x - mean.reshape(shp))
                    / torch.sqrt(var.reshape(shp) + eps)
                    * scale.reshape(shp) + bias.reshape(shp)), xb
        if op == "Identity":
            return x, xb
        if op == "Constant":
            t = node.attrs["value"].t
            return torch.from_numpy(np.array(t.array)).to(
                self._device), False
        raise ValueError(f"onnx: unsupported op {op!r} "
                         f"(node {node.name!r})")


def to_torch(graph: Graph, device="cpu"):
    """Graph -> (OnnxModule with its buffers on `device`, input_names,
    output_names)."""
    m = OnnxModule(graph, device)
    return m, m.input_names, m.output_names
