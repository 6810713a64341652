"""Shared pieces of the transport-plane parity tests
(tests/test_torch_{rtp,ts_ps,parsers,parser_fuzz}.py): one scenario run
through gstbad_tpu and through gstbad_tpu_torch on the same inputs, its
results reduced to plain values (bytes, numbers, strings, lists, field
dicts) and compared, errors by class and message."""

import dataclasses
import enum
import importlib
import socket
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt


def _package(root, top):
    return SimpleNamespace(
        name=root, make=top.make,
        io=lambda name: importlib.import_module(f"{root}.io.{name}"),
        el=lambda name: importlib.import_module(f"{root}.elements.{name}"))


JAX = _package("gstbad_tpu", gt)
TORCH = _package("gstbad_tpu_torch", gtt)


def canon(x, _seen=None):
    """`x` as plain comparable values: arrays (numpy, torch or JAX) as
    (dtype, shape, bytes), dataclasses and objects as their class name
    and fields, containers element by element."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if x is None or isinstance(x, (str, bool, int, float)):
        return x
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, Fraction):
        return ("Fraction", x.numerator, x.denominator)
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if not isinstance(x, np.ndarray) and hasattr(x, "__array__") \
            and type(x).__module__.startswith(("jax", "jaxlib")):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape,
                np.ascontiguousarray(x).tobytes())
    if isinstance(x, dict):
        return ("dict", sorted(((repr(canon(k)), canon(v, _seen))
                                for k, v in x.items()), key=lambda t: t[0]))
    if isinstance(x, (list, tuple)):
        return [canon(v, _seen) for v in x]
    if isinstance(x, (set, frozenset)):
        return ("set", sorted(repr(canon(v, _seen)) for v in x))
    _seen = set() if _seen is None else _seen
    if id(x) in _seen:
        return ("cycle", type(x).__name__)
    _seen = _seen | {id(x)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: canon(getattr(x, f.name), _seen)
                 for f in dataclasses.fields(x)})
    if hasattr(x, "__dict__") and not callable(x):
        return (type(x).__name__,
                {k: canon(v, _seen) for k, v in vars(x).items()
                 if not isinstance(v, socket.socket)})
    return repr(x)


def outcome(scenario, pkg, *args):
    """The scenario's result through one package, or the class name and
    message of the error it raised."""
    try:
        return ("ok", canon(scenario(pkg, *args)))
    except Exception as e:     # the class and message are compared
        return ("raise", type(e).__name__, str(e))


def assert_both(scenario, *args, raises=False):
    """Run `scenario(pkg, *args)` through both packages and require the
    same result, or the same error where `raises`; returns the port's."""
    j = outcome(scenario, JAX, *args)
    t = outcome(scenario, TORCH, *args)
    assert t == j, (scenario.__name__, _first_difference(j, t))
    assert t[0] == ("raise" if raises else "ok"), t
    return t


def _first_difference(a, b, path="$"):
    if type(a) is not type(b):
        return path, repr(a)[:200], repr(b)[:200]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return path + ".len", len(a), len(b)
        for i, (u, v) in enumerate(zip(a, b)):
            if u != v:
                return _first_difference(u, v, f"{path}[{i}]")
    if isinstance(a, dict):
        for k in a:
            if a.get(k) != b.get(k):
                return _first_difference(a.get(k), b.get(k), f"{path}.{k}")
    return path, repr(a)[:200], repr(b)[:200]


def free_port_pair():
    """An even UDP port whose odd neighbour is free as well (RTP on the
    port, RTCP on the next)."""
    for _ in range(64):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        if port % 2 or port >= 65534:
            continue
        try:
            socks = []
            for p in (port, port + 1):
                t = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(t)
                t.bind(("127.0.0.1", p))
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
        return port
    raise RuntimeError("no free even UDP port pair")
