"""Twin: one host module of the JAX package and its copy in the port,
driven side by side.  A JAX test of the module runs unchanged with the
module's name bound to Twin(jax_module, port_module): every attribute read
and call goes to both, their results are held equal (as trees: objects by
class name and attributes, XML elements by their serialisation, cycles cut),
and the JAX side's value goes on to the test's own assertions — a plain
value as it is, an object as a Twin of the pair (the same Twin for the
same pair, so `is` holds where it holds for the JAX objects).  An
exception must be raised by both, of the same class name and message; the
JAX one goes on."""

import dataclasses
import enum
import inspect
import itertools
import numbers
import types
import xml.etree.ElementTree as ET

import numpy as np
import pytest

PLAIN = (type(None), bool, numbers.Number, str, bytes, bytearray)


def tree(x, seen=None):
    """x as nested tuples, dicts and plain values, the same for the JAX
    package's object and the port's copy of it."""
    seen = set() if seen is None else seen
    if isinstance(x, PLAIN):
        return x
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape,
                np.ascontiguousarray(x).tobytes())
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, ET.Element):
        return ET.tostring(x)
    if isinstance(x, (types.FunctionType, types.MethodType, type,
                      types.ModuleType)):
        return ("callable", getattr(x, "__name__", "?"))
    if id(x) in seen:
        return ("cycle", type(x).__name__)
    seen = seen | {id(x)}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(tree(v, seen) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((tree(k, seen), tree(v, seen))
                              for k, v in x.items()))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(tree(v, seen)) for v in x)))
    if dataclasses.is_dataclass(x) or hasattr(x, "__dict__"):
        # the port's elements also hold their pipeline's torch device
        return (type(x).__name__, tuple(
            (k, tree(v, seen)) for k, v in sorted(vars(x).items())
            if not (k == "device" and type(v).__module__ == "torch")))
    if hasattr(x, "__slots__"):
        return (type(x).__name__, tuple(
            (k, tree(getattr(x, k, None), seen)) for k in x.__slots__))
    return ("repr", type(x).__name__, repr(x))


def _plain(x):
    if isinstance(x, PLAIN + (np.ndarray,)):
        return True
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    if isinstance(x, dict):
        return all(_plain(k) and _plain(v) for k, v in x.items())
    return False


def wrap(j, t, known, owned=False):
    """The JAX side's value to hand on: plain as it is, else the Twin of
    the pair (`known`: the pairs wrapped so far from one root Twin;
    `owned`: an attribute of an object, not a call's result)."""
    if isinstance(j, type) and issubclass(j, BaseException):
        assert isinstance(t, type) and t.__name__ == j.__name__
        return j                       # pytest.raises takes the JAX class
    if not callable(j) or isinstance(j, type):
        assert tree(j) == tree(t), (j, t)
    # a list or dict of plain values goes on as it is, but an attribute's
    # own list or dict (which a test may fill) as the Twin of the pair
    if _plain(j) and not (owned and isinstance(j, (list, dict))):
        return j
    key = (id(j), id(t))
    if key not in known:
        known[key] = Twin(j, t, known)
    return known[key]


def _side(a, i):
    """Argument `a` for side i (0 JAX, 1 the port): each Twin in it, at any
    depth of its lists, tuples and dicts, replaced by that side's object."""
    if isinstance(a, Twin):
        return (a._j, a._t)[i]
    if isinstance(a, (list, tuple)):
        return type(a)(_side(v, i) for v in a)
    if isinstance(a, dict):
        return {k: _side(v, i) for k, v in a.items()}
    return a


def _sides(args):
    return [_side(a, 0) for a in args], [_side(a, 1) for a in args]


class Twin:
    def __init__(self, j, t, known=None):
        object.__setattr__(self, "_j", j)
        object.__setattr__(self, "_t", t)
        object.__setattr__(self, "_known", {} if known is None else known)

    def __getattr__(self, name):
        return wrap(getattr(self._j, name), getattr(self._t, name),
                    self._known, owned=not isinstance(self._j,
                                                      types.ModuleType))

    def __setattr__(self, name, value):
        jv, tv = _sides([value])
        setattr(self._j, name, jv[0])
        setattr(self._t, name, tv[0])

    def __call__(self, *args, **kw):
        ja, ta = _sides(args)
        keys = list(kw)
        jk, tk = _sides([kw[k] for k in keys])
        try:
            jr = self._j(*ja, **dict(zip(keys, jk)))
        except Exception as je:
            try:
                self._t(*ta, **dict(zip(keys, tk)))
            except Exception as te:
                assert type(te).__name__ == type(je).__name__, (je, te)
                assert str(te) == str(je)
                raise je
            raise AssertionError(f"the port did not raise {je!r}")
        tr = self._t(*ta, **dict(zip(keys, tk)))
        return wrap(jr, tr, self._known)

    def __getitem__(self, key):
        (jk,), (tk,) = _sides([key])
        return wrap(self._j[jk], self._t[tk], self._known)

    def __len__(self):
        n = len(self._j)
        assert len(self._t) == n
        return n

    def __iter__(self):
        end = object()
        for a, b in itertools.zip_longest(self._j, self._t, fillvalue=end):
            assert a is not end and b is not end, "lengths differ"
            yield wrap(a, b, self._known)

    def __contains__(self, item):
        (ji,), (ti,) = _sides([item])
        r = ji in self._j
        assert (ti in self._t) == r
        return r

    def __bool__(self):
        r = bool(self._j)
        assert bool(self._t) == r
        return r

    def __instancecheck__(self, obj):
        r = isinstance(_side(obj, 0), self._j)
        assert isinstance(_side(obj, 1), self._t) == r
        return r

    def __eq__(self, other):
        (jo,), (to,) = _sides([other])
        r = self._j == jo
        assert (self._t == to) == r
        return r

    def __ne__(self, other):
        return not self == other

    __hash__ = None

    def __repr__(self):
        return f"Twin({self._j!r})"


def jax_test_cases(modules, skip=(), fixtures=()):
    """pytest params (module, test function, its arguments) for every test
    of the JAX test modules but those named in `skip`, a parametrized one
    once per value.  A test may take the fixtures named in `fixtures`
    (the runner supplies them); its skipif marks carry over."""
    out = []
    for mod in modules:
        for name, fn in sorted(vars(mod).items()):
            if (not name.startswith("test_") or not callable(fn)
                    or name in skip):
                continue
            marks = [m for m in getattr(fn, "pytestmark", ())
                     if m.name == "parametrize"]
            skips = [m for m in getattr(fn, "pytestmark", ())
                     if m.name == "skipif"]
            if marks:
                argname, values = marks[0].args[:2]
                names = [a.strip() for a in argname.split(",")]
                out += [pytest.param(
                    mod, fn, dict(zip(names, v if len(names) > 1 else (v,))),
                    marks=skips, id=f"{mod.__name__}.{name}[{i}]")
                        for i, v in enumerate(values)]
            else:
                assert set(inspect.signature(fn).parameters) <= set(
                    fixtures), name
                out.append(pytest.param(mod, fn, {}, marks=skips,
                                        id=f"{mod.__name__}.{name}"))
    return out
