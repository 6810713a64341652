"""LV2 plugin host (ext/lv2/gstlv2.c, gstlv2utils.c) — lilv replaced
by a Turtle-subset RDF parser + a ctypes binding of the LV2 core ABI.

The reference walks lilv: lilv_world_load_all over LV2_PATH bundles,
port classification against the lv2core node URIs
(gstlv2.c:262-307), group-deduped audio port counting
(lv2_count_ports, gstlv2.c:122-160), element naming from the plugin
URI with the protocol cut off and g_strcanon to [A-Za-z0-9-+]
(gstlv2.c:187-193), and control-port -> property marshalling with the
param-name canonicalization and -N dedupe (gstlv2utils.c:560-595).
All of that is re-expressed here over our own world model:

  * Turtle parser: the subset LV2 bundles use — @prefix, a, ;/,
    continuations, blank nodes [ ... ], collections ( ... ), typed
    and plain literals, IRIs and prefixed names.
  * World: every directory on LV2_PATH containing manifest.ttl is a
    bundle; manifest subjects typed lv2:Plugin pull their
    rdfs:seeAlso files into the bundle graph (lilv_world_load_all).
  * Host: dlopen lv2:binary, walk lv2_descriptor(i) for the matching
    URI, instantiate(rate, bundle_path, features=[NULL]) and run over
    connected float32 buffers — the LADSPA host's ctypes pattern
    (io/ladspa.py) applied to the LV2 ABI.

Plugins with any lv2:requiredFeature are skipped like the reference
(gst_lv2_check_required_features, gstlv2utils.c:105-140 — we support
no host features either).  Since this environment ships no system LV2
bundles, build_test_plugins() compiles csrc/lv2_plugins.c and
installs its .ttl manifests as an in-repo fixture bundle — the
csrc/ladspa_plugins.c approach.
A copy of the JAX package's io/lv2.py: the fixture bundle is the port's
own copy in gstbad_tpu_torch/csrc/, built at first use into
gstbad_tpu_torch/_build/ (io/_native_build.py); the rest differs only in
its imports.
"""

from __future__ import annotations

import ctypes
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from gstbad_tpu_torch.io import _native_build

LV2_CORE = "http://lv2plug.in/ns/lv2core#"
RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
RDFS = "http://www.w3.org/2000/01/rdf-schema#"
DOAP = "http://usefulinc.com/ns/doap#"
PGROUPS = "http://lv2plug.in/ns/ext/port-groups#"
PRESETS = "http://lv2plug.in/ns/ext/presets#"
STATE = "http://lv2plug.in/ns/ext/state#"
URID = "http://lv2plug.in/ns/ext/urid#"
ATOM = "http://lv2plug.in/ns/ext/atom#"
XSD = "http://www.w3.org/2001/XMLSchema#"

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


class Lv2Error(ValueError):
    pass


class URI(str):
    """An IRI node (distinct from plain string literals)."""
    __slots__ = ()


class Blank(str):
    """A blank-node id (unique per parse)."""


class Typed(str):
    """A typed literal: compares as its lexical form, carries the
    datatype IRI (needed to decode base64Binary state properties)."""

    __slots__ = ("datatype",)

    def __new__(cls, value: str, datatype: str = ""):
        o = super().__new__(cls, value)
        o.datatype = datatype
        return o


# ---------------------------------------------------------------------------
# Turtle subset parser

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<string>\"\"\"(?:[^"\\]|\\.|"(?!""))*\"\"\"|"(?:[^"\\]|\\.)*")
  | (?P<iri><[^>]*>)
  | (?P<prefix>@prefix\b|@base\b)
  | (?P<num>[+-]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<punct>\^\^|[;,.\[\]()])
  | (?P<pname>[A-Za-z_][\w.-]*)?:(?P<local>[\w.\-%]*)
  | (?P<bare>[A-Za-z_][\w-]*)
""", re.VERBOSE)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            if n == "u" and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append(_ESCAPES.get(n, n))
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


class TurtleParser:
    """Parses a Turtle document into triples(subject, pred, object).

    Graph shape: {subject: {pred: [objects...]}} with URI/Blank node
    keys and python str/int/float/bool literal objects."""

    def __init__(self):
        self.graph: Dict[str, Dict[str, List[object]]] = {}
        self.prefixes: Dict[str, str] = {}
        self._blank_n = 0

    # -- tokenizer
    def _tokens(self, text: str):
        pos = 0
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if not m or m.end() == pos:
                raise Lv2Error(f"turtle: bad syntax at {text[pos:pos+30]!r}")
            pos = m.end()
            if m.lastgroup in ("ws",):
                continue
            yield m
        yield None

    def parse(self, text: str, base: str = "") -> "TurtleParser":
        self._iter = self._tokens(text)
        self._tok = next(self._iter)
        self._base = base
        while self._tok is not None:
            self._statement()
        return self

    def _advance(self):
        t = self._tok
        if t is None:
            raise Lv2Error("turtle: unexpected eof")
        self._tok = next(self._iter)
        return t

    def _expect_punct(self, p: str):
        t = self._advance()
        if t is None or t.group("punct") != p:
            got = t.group(0) if t is not None else "<eof>"
            raise Lv2Error(f"turtle: expected {p!r}, got {got!r}")

    def _statement(self):
        t = self._tok
        if t.group("prefix") == "@prefix":
            self._advance()
            name = self._advance()
            if name.group("local") or name.group("pname") is None \
                    and name.group("local") == "":
                pass
            pfx = name.group("pname") or ""
            iri = self._advance().group("iri")
            self.prefixes[pfx] = iri[1:-1]
            self._expect_punct(".")
            return
        if t.group("prefix") == "@base":
            self._advance()
            self._base = self._advance().group("iri")[1:-1]
            self._expect_punct(".")
            return
        subj = self._node()
        self._predicate_list(subj)
        self._expect_punct(".")

    def _predicate_list(self, subj):
        while True:
            pred = self._node()
            if pred == URI(RDF + "type_kw"):
                pred = URI(RDF + "type")
            while True:
                obj = self._node()
                self.graph.setdefault(subj, {}).setdefault(
                    str(pred), []).append(obj)
                if self._tok is not None and \
                        self._tok.group("punct") == ",":
                    self._advance()
                    continue
                break
            if self._tok is not None and self._tok.group("punct") == ";":
                self._advance()
                # tolerate trailing ';' before '.' or ']'
                if self._tok is not None and (
                        self._tok.group("punct") in (".", "]")):
                    return
                continue
            return

    def _node(self):
        t = self._advance()
        if t is None:
            raise Lv2Error("turtle: unexpected eof")
        if t.group("iri") is not None:
            iri = _unescape(t.group("iri")[1:-1])
            if self._base and "://" not in iri and not iri.startswith(
                    ("urn:", "file:")):
                iri = self._base + iri
            return URI(iri)
        if t.group("string") is not None:
            raw = t.group("string")
            q = 3 if raw.startswith('"""') else 1
            val = _unescape(raw[q:-q])
            # optional ^^datatype: kept as a Typed literal (state
            # properties need base64Binary recognized); @lang swallowed
            if self._tok is not None and self._tok.group("punct") == "^^":
                self._advance()
                return Typed(val, str(self._node()))
            return val
        if t.group("num") is not None:
            s = t.group("num")
            return float(s) if any(c in s for c in ".eE") else int(s)
        if t.group("bare") is not None:
            w = t.group("bare")
            if w == "a":
                return URI(RDF + "type_kw")
            if w == "true":
                return True
            if w == "false":
                return False
            raise Lv2Error(f"turtle: bare word {w!r}")
        if t.group("local") is not None and t.group("iri") is None \
                and t.group("string") is None:
            pfx = t.group("pname") or ""
            if pfx not in self.prefixes:
                raise Lv2Error(f"turtle: unknown prefix {pfx!r}")
            return URI(self.prefixes[pfx] + t.group("local"))
        p = t.group("punct")
        if p == "[":
            self._blank_n += 1
            b = Blank(f"_:b{self._blank_n}")
            if self._tok is not None and self._tok.group("punct") == "]":
                self._advance()
                return b
            self._predicate_list(b)
            self._expect_punct("]")
            return b
        if p == "(":
            items = []
            while not (self._tok is not None
                       and self._tok.group("punct") == ")"):
                items.append(self._node())
            self._advance()
            self._blank_n += 1
            b = Blank(f"_:b{self._blank_n}")
            self.graph.setdefault(b, {})[RDF + "list"] = items
            return b
        raise Lv2Error(f"turtle: unexpected token {t.group(0)!r}")


# ---------------------------------------------------------------------------
# world model

@dataclass
class Lv2Port:
    index: int
    symbol: str
    name: str
    classes: Tuple[str, ...]
    default: Optional[float] = None
    minimum: Optional[float] = None
    maximum: Optional[float] = None
    integer: bool = False
    toggled: bool = False
    enumeration: bool = False
    group: Optional[str] = None
    scale_points: Tuple[Tuple[str, float], ...] = ()

    def is_a(self, cls: str) -> bool:
        return LV2_CORE + cls in self.classes

    @property
    def is_audio(self) -> bool:
        return self.is_a("AudioPort")

    @property
    def is_control(self) -> bool:
        return self.is_a("ControlPort") or self.is_a("CVPort")

    @property
    def is_input(self) -> bool:
        return self.is_a("InputPort")


@dataclass
class PropertySpec:
    name: str
    nick: str
    type: type
    default: object
    minimum: object
    maximum: object
    port: Lv2Port


def _canon(s: str, extra: str = "-") -> str:
    return "".join(c if c.isalnum() or c in extra else "-" for c in s)


def element_name_of(uri: str) -> str:
    """gstlv2.c:187-193: cut the protocol, canon to [A-Za-z0-9-+]."""
    p = uri.find("://")
    name = uri[p + 3:] if p >= 0 else uri
    return _canon(name, "-+")


def _prop_name(symbol: str, taken: set) -> str:
    """gstlv2utils.c:560-595 param-name build with -N dedupe."""
    name = _canon(symbol)
    if not name or not name[0].isalpha():
        name = "param-" + name
    if name in taken:
        n = 1
        while f"{name}-{n}" in taken:
            n += 1
        name = f"{name}-{n}"
    taken.add(name)
    return name


@dataclass
class Lv2Plugin:
    uri: str
    bundle: str
    binary: str
    name: str
    ports: List[Lv2Port]
    required_features: Tuple[str, ...] = ()
    # control-port presets: label -> {port symbol: value}
    # (gst_lv2_load_preset restores port values by symbol and
    # g_object_sets the mapped property, gstlv2utils.c:226-272)
    presets: Dict[str, Dict[str, float]] = field(default_factory=dict)
    # state-extension preset properties: label -> {property URI:
    # (value bytes/str/float/int, type URI)} restored through the
    # plugin's LV2_State_Interface (lilv_state_restore's non-port half)
    preset_state: Dict[str, Dict[str, tuple]] = field(
        default_factory=dict)

    audio_in: List[Lv2Port] = field(default_factory=list)
    audio_out: List[Lv2Port] = field(default_factory=list)
    control_in: List[Lv2Port] = field(default_factory=list)
    control_out: List[Lv2Port] = field(default_factory=list)
    in_props: List[PropertySpec] = field(default_factory=list)
    out_props: List[PropertySpec] = field(default_factory=list)

    def __post_init__(self):
        taken: set = set()
        for p in sorted(self.ports, key=lambda p: p.index):
            if p.is_audio:
                (self.audio_in if p.is_input else self.audio_out).append(p)
            elif p.is_control:
                lst = self.control_in if p.is_input else self.control_out
                props = self.in_props if p.is_input else self.out_props
                lst.append(p)
                props.append(self._prop_spec(p, taken))

    def _prop_spec(self, p: Lv2Port, taken: set) -> PropertySpec:
        name = _prop_name(p.symbol, taken)
        lo = p.minimum if p.minimum is not None else 0.0
        hi = p.maximum if p.maximum is not None else 1.0
        d = p.default if p.default is not None else lo
        if p.toggled:
            return PropertySpec(name, p.name, bool, bool(d), None, None, p)
        if p.integer:
            return PropertySpec(name, p.name, int, int(d),
                                int(lo), int(hi), p)
        return PropertySpec(name, p.name, float, float(d),
                            float(lo), float(hi), p)

    @property
    def element_name(self) -> str:
        return element_name_of(self.uri)

    def audio_group_counts(self) -> Tuple[int, int]:
        """lv2_count_ports (gstlv2.c:122-160): ports sharing a
        pg:group count once."""
        seen: set = set()
        n_in = n_out = 0
        for p in self.ports:
            if not p.is_audio:
                continue
            if p.group is not None:
                if p.group in seen:
                    continue
                seen.add(p.group)
            if p.is_input:
                n_in += 1
            else:
                n_out += 1
        return n_in, n_out

    def instantiate(self, rate: int) -> "Lv2Instance":
        return Lv2Instance(self, rate)


def _first(vals: Optional[List[object]]):
    return vals[0] if vals else None


def _load_bundle(bundle: str) -> List[Lv2Plugin]:
    manifest = os.path.join(bundle, "manifest.ttl")
    if not os.path.exists(manifest):
        return []
    tp = TurtleParser()
    with open(manifest, "r", encoding="utf-8") as f:
        tp.parse(f.read())
    # every subject typed lv2:Plugin: merge its seeAlso files
    plugin_uris = [s for s, preds in tp.graph.items()
                   if URI(LV2_CORE + "Plugin")
                   in preds.get(RDF + "type", [])]
    see_also: List[str] = []
    for s in plugin_uris:
        for obj in tp.graph[s].get(RDFS + "seeAlso", []):
            # several plugins citing one data file parse it ONCE
            # (lilv_world_load_graph's uri-keyed model cache)
            if isinstance(obj, URI) and str(obj) not in see_also:
                see_also.append(str(obj))
    for rel in see_also:
        path = os.path.join(bundle, os.path.basename(rel))
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                tp.parse(f.read())

    out = []
    for s in plugin_uris:
        preds = tp.graph.get(s, {})
        binary = _first(preds.get(LV2_CORE + "binary"))
        if binary is None:
            continue
        name = _first(preds.get(DOAP + "name")) or str(s)
        req = tuple(str(o) for o in
                    preds.get(LV2_CORE + "requiredFeature", []))
        ports = []
        for node in preds.get(LV2_CORE + "port", []):
            pp = tp.graph.get(node, {})
            classes = tuple(str(c) for c in pp.get(RDF + "type", []))
            props = [str(x) for x in
                     pp.get(LV2_CORE + "portProperty", [])]
            sps = []
            for spn in pp.get(LV2_CORE + "scalePoint", []):
                sp = tp.graph.get(spn, {})
                lab = _first(sp.get(RDFS + "label"))
                val = _first(sp.get(RDF + "value"))
                if lab is not None and val is not None:
                    sps.append((str(lab), float(val)))
            grp = _first(pp.get(PGROUPS + "group"))

            def fnum(key):
                v = _first(pp.get(LV2_CORE + key))
                return None if v is None else float(v)

            ports.append(Lv2Port(
                index=int(_first(pp.get(LV2_CORE + "index")) or 0),
                symbol=str(_first(pp.get(LV2_CORE + "symbol")) or ""),
                name=str(_first(pp.get(LV2_CORE + "name")) or ""),
                classes=classes,
                default=fnum("default"),
                minimum=fnum("minimum"),
                maximum=fnum("maximum"),
                integer=LV2_CORE + "integer" in props,
                toggled=LV2_CORE + "toggled" in props,
                enumeration=LV2_CORE + "enumeration" in props,
                group=str(grp) if grp is not None else None,
                scale_points=tuple(sps),
            ))
        # pset:Preset subjects applying to this plugin (the reference
        # walks lilv_plugin_get_related + rdfs:label, gstlv2.c:175-210)
        presets: Dict[str, Dict[str, float]] = {}
        state_by_label: Dict[str, Dict[str, tuple]] = {}
        for ps, pp in tp.graph.items():
            if URI(PRESETS + "Preset") not in pp.get(RDF + "type", []):
                continue
            applies = pp.get(LV2_CORE + "appliesTo", [])
            if URI(str(s)) not in applies:
                continue
            label = _first(pp.get(RDFS + "label"))
            if label is None:
                continue
            vals: Dict[str, float] = {}
            for pn in pp.get(LV2_CORE + "port", []):
                pd = tp.graph.get(pn, {})
                sym = _first(pd.get(LV2_CORE + "symbol"))
                val = _first(pd.get(PRESETS + "value"))
                if sym is not None and val is not None:
                    vals[str(sym)] = float(val)
            presets[str(label)] = vals
            # state:state [ <key> value ; ... ] — the binary/atom
            # property half of a preset (LV2 State extension)
            for sn in pp.get(STATE + "state", []):
                sd = tp.graph.get(sn, {})
                props_s: Dict[str, tuple] = {}
                for key, objs in sd.items():
                    v = _first(objs)
                    if v is None:
                        continue
                    if isinstance(v, Typed):
                        if v.datatype == XSD + "base64Binary":
                            import base64
                            props_s[str(key)] = (
                                base64.b64decode(str(v)),
                                ATOM + "Chunk")
                        elif v.datatype in (XSD + "double",
                                            XSD + "float",
                                            XSD + "decimal"):
                            props_s[str(key)] = (float(str(v)),
                                                 ATOM + "Float")
                        elif v.datatype in (XSD + "integer",
                                            XSD + "int",
                                            XSD + "long"):
                            props_s[str(key)] = (int(str(v)),
                                                 ATOM + "Int")
                        else:
                            props_s[str(key)] = (str(v),
                                                 ATOM + "String")
                    elif isinstance(v, (int, float)):
                        props_s[str(key)] = (
                            v, ATOM + ("Int" if isinstance(v, int)
                                       else "Float"))
                    elif isinstance(v, str) and not isinstance(v, URI):
                        props_s[str(key)] = (str(v), ATOM + "String")
                if props_s:
                    state_by_label[str(label)] = props_s

        binpath = os.path.join(bundle, os.path.basename(str(binary)))
        out.append(Lv2Plugin(uri=str(s), bundle=bundle, binary=binpath,
                             name=str(name), ports=ports,
                             required_features=req, presets=presets,
                             preset_state=state_by_label))
    return out


def scan(path: Optional[str] = None) -> List[Lv2Plugin]:
    """lilv_world_load_all over LV2_PATH: every subdirectory holding a
    manifest.ttl is a bundle.  Plugins with required host features are
    dropped (gstlv2utils.c:105-140; we support none)."""
    path = path if path is not None else os.environ.get("LV2_PATH", "")
    plugins: List[Lv2Plugin] = []
    for directory in filter(None, path.split(os.pathsep)):
        if not os.path.isdir(directory):
            continue
        cands = [directory] + [
            os.path.join(directory, d)
            for d in sorted(os.listdir(directory))]
        for bundle in cands:
            if not os.path.isdir(bundle):
                continue
            try:
                for p in _load_bundle(bundle):
                    if p.required_features:
                        continue
                    plugins.append(p)
            except (Lv2Error, OSError, UnicodeDecodeError):
                # a malformed, unreadable or non-UTF-8 bundle degrades to a
                # skipped plugin (lilv's lilv_world_load_all tolerates bad
                # bundles the same way) rather than failing the whole scan
                continue
    return plugins


# ---------------------------------------------------------------------------
# ctypes host (LV2 core ABI, lv2core/lv2.h)

class _Descriptor(ctypes.Structure):
    _fields_ = [
        ("URI", ctypes.c_char_p),
        ("instantiate", ctypes.CFUNCTYPE(
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
            ctypes.c_char_p, ctypes.c_void_p)),
        ("connect_port", ctypes.CFUNCTYPE(
            None, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p)),
        ("activate", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("run", ctypes.CFUNCTYPE(
            None, ctypes.c_void_p, ctypes.c_uint32)),
        ("deactivate", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("cleanup", ctypes.CFUNCTYPE(None, ctypes.c_void_p)),
        ("extension_data", ctypes.CFUNCTYPE(
            ctypes.c_void_p, ctypes.c_char_p)),
    ]


# -- LV2 URID map + State extension ABI (urid/urid.h, state/state.h) ------

_URID_MAP_FN = ctypes.CFUNCTYPE(ctypes.c_uint32, ctypes.c_void_p,
                                ctypes.c_char_p)


class _UridMapFeature(ctypes.Structure):
    _fields_ = [("handle", ctypes.c_void_p), ("map", _URID_MAP_FN)]


class _Feature(ctypes.Structure):
    _fields_ = [("URI", ctypes.c_char_p), ("data", ctypes.c_void_p)]


# LV2_State_Store_Function / Retrieve_Function (state/state.h)
_STATE_STORE_FN = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
    ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32)
_STATE_RETRIEVE_FN = ctypes.CFUNCTYPE(
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
    ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_uint32),
    ctypes.POINTER(ctypes.c_uint32))


class _StateInterface(ctypes.Structure):
    _fields_ = [
        ("save", ctypes.CFUNCTYPE(
            ctypes.c_int32, ctypes.c_void_p, _STATE_STORE_FN,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p)),
        ("restore", ctypes.CFUNCTYPE(
            ctypes.c_int32, ctypes.c_void_p, _STATE_RETRIEVE_FN,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p)),
    ]


class Lv2Instance:
    """One live plugin instance: control ports in ctypes float slots,
    audio ports connected per run() — io/ladspa.py's LadspaInstance
    over the LV2 descriptor walk (lv2_descriptor(i) until URI match)."""

    def __init__(self, plugin: Lv2Plugin, rate: int):
        self.plugin = plugin
        lib = ctypes.CDLL(plugin.binary)
        getter = lib.lv2_descriptor
        getter.restype = ctypes.POINTER(_Descriptor)
        getter.argtypes = [ctypes.c_uint32]
        desc = None
        i = 0
        while True:
            d = getter(i)
            if not d:
                break
            if d.contents.URI.decode() == plugin.uri:
                desc = d.contents
                break
            i += 1
        if desc is None:
            raise Lv2Error(f"{plugin.binary}: no descriptor for "
                           f"{plugin.uri}")
        self.desc = desc
        self._lib = lib
        # host features: urid:map (needed by the State extension — keys
        # and value types travel as URIDs).  Mapping is 1-based and
        # stable for the instance lifetime (urid.h contract).
        self._urids: Dict[str, int] = {}

        def _map(_handle, uri_b) -> int:
            uri = uri_b.decode() if uri_b else ""
            if uri not in self._urids:
                self._urids[uri] = len(self._urids) + 1
            return self._urids[uri]

        self._map_cb = _URID_MAP_FN(_map)
        self._map_feat = _UridMapFeature(None, self._map_cb)
        self._feat = _Feature((URID + "map").encode(),
                              ctypes.cast(ctypes.byref(self._map_feat),
                                          ctypes.c_void_p))
        features = (ctypes.c_void_p * 2)(
            ctypes.cast(ctypes.byref(self._feat), ctypes.c_void_p), None)
        self._features = features
        bundle = (plugin.bundle.rstrip(os.sep) + os.sep).encode()
        self.handle = desc.instantiate(
            ctypes.byref(desc), float(rate), bundle,
            ctypes.cast(features, ctypes.c_void_p))
        if not self.handle:
            raise Lv2Error(f"could not instantiate {plugin.uri}")
        self.rate = rate
        self.activated = False
        n_in = len(plugin.control_in)
        n_out = len(plugin.control_out)
        self._ctl_in = (ctypes.c_float * max(n_in, 1))()
        self._ctl_out = (ctypes.c_float * max(n_out, 1))()
        for i, port in enumerate(plugin.control_in):
            self._ctl_in[i] = plugin.in_props[i].default
            desc.connect_port(
                self.handle, port.index,
                ctypes.cast(ctypes.byref(self._ctl_in, i * 4),
                            ctypes.c_void_p))
        for i, port in enumerate(plugin.control_out):
            desc.connect_port(
                self.handle, port.index,
                ctypes.cast(ctypes.byref(self._ctl_out, i * 4),
                            ctypes.c_void_p))

    def set_control(self, name: str, value) -> None:
        for i, spec in enumerate(self.plugin.in_props):
            if spec.name == name:
                self._ctl_in[i] = (1.0 if value else 0.0) \
                    if spec.type is bool else float(value)
                return
        raise Lv2Error(f"no writable control '{name}'")

    def get_control(self, name: str):
        for i, spec in enumerate(self.plugin.in_props):
            if spec.name == name:
                v = self._ctl_in[i]
                break
        else:
            for i, spec in enumerate(self.plugin.out_props):
                if spec.name == name:
                    v = self._ctl_out[i]
                    break
            else:
                raise Lv2Error(f"no control '{name}'")
        if spec.type is bool:
            return v > 0.5
        if spec.type is int:
            return int(min(max(v, INT32_MIN), INT32_MAX))
        return v

    # -- LV2 State extension (state/state.h; the lilv_state_restore
    # half gst_lv2_load_preset relies on for non-port preset data) ----
    def _map_uri(self, uri: str) -> int:
        if uri not in self._urids:
            self._urids[uri] = len(self._urids) + 1
        return self._urids[uri]

    def _state_interface(self) -> Optional[_StateInterface]:
        if not self.desc.extension_data:
            return None
        p = self.desc.extension_data((STATE + "interface").encode())
        if not p:
            return None
        return ctypes.cast(p, ctypes.POINTER(_StateInterface)).contents

    def has_state_interface(self) -> bool:
        return self._state_interface() is not None

    def restore_state(self, props: Dict[str, tuple]) -> bool:
        """Restore {property URI: (value, type URI)} through the
        plugin's LV2_State_Interface.restore — the binary/atom half of
        a preset (the control-port half goes through set_control)."""
        iface = self._state_interface()
        if iface is None:
            return False
        entries: Dict[int, tuple] = {}
        keep = []                          # keep buffers alive
        for uri, (value, type_uri) in props.items():
            if isinstance(value, bytes):
                buf = ctypes.create_string_buffer(value, len(value))
                size = len(value)
            elif isinstance(value, float):
                buf = ctypes.c_float(value)
                size = 4
            elif isinstance(value, int):
                buf = ctypes.c_int32(value)
                size = 4
            else:
                raw = str(value).encode() + b"\x00"
                buf = ctypes.create_string_buffer(raw, len(raw))
                size = len(raw)
            keep.append(buf)
            entries[self._map_uri(uri)] = (
                ctypes.cast(ctypes.byref(buf), ctypes.c_void_p).value,
                size, self._map_uri(type_uri))

        def _retrieve(_h, key, size_p, type_p, flags_p):
            e = entries.get(int(key))
            if e is None:
                return None
            addr, size, turid = e
            if size_p:
                size_p[0] = size
            if type_p:
                type_p[0] = turid
            if flags_p:
                flags_p[0] = 3            # IS_POD | IS_PORTABLE
            return addr

        cb = _STATE_RETRIEVE_FN(_retrieve)
        status = iface.restore(self.handle, cb, None, 0, None)
        del keep, cb
        return status == 0                # LV2_STATE_SUCCESS

    def save_state(self) -> Optional[Dict[str, tuple]]:
        """Snapshot the plugin's state properties via
        LV2_State_Interface.save -> {property URI: (value, type URI)}
        (the lilv_state_new_from_instance analog; used by the preset
        round-trip test)."""
        iface = self._state_interface()
        if iface is None:
            return None
        rev = {}

        def unmap(urid: int) -> str:
            nonlocal rev
            rev = {v: k for k, v in self._urids.items()}
            return rev.get(urid, f"urn:urid:{urid}")

        out: Dict[str, tuple] = {}

        def _store(_h, key, value, size, turid, _flags) -> int:
            raw = ctypes.string_at(value, size)
            type_uri = unmap(int(turid))
            if type_uri == ATOM + "Float":
                val = ctypes.cast(
                    value, ctypes.POINTER(ctypes.c_float))[0]
            elif type_uri == ATOM + "Int":
                val = ctypes.cast(
                    value, ctypes.POINTER(ctypes.c_int32))[0]
            elif type_uri == ATOM + "String":
                val = raw.rstrip(b"\x00").decode(errors="replace")
            else:
                val = raw
            out[unmap(int(key))] = (val, type_uri)
            return 0

        cb = _STATE_STORE_FN(_store)
        status = iface.save(self.handle, cb, None, 0, None)
        del cb
        return out if status == 0 else None

    def activate(self) -> None:
        if not self.activated and self.desc.activate:
            self.desc.activate(self.handle)
        self.activated = True

    def deactivate(self) -> None:
        if self.activated and self.desc.deactivate:
            self.desc.deactivate(self.handle)
        self.activated = False

    def run(self, samples: int,
            audio_in: Optional[np.ndarray] = None) -> np.ndarray:
        plugin = self.plugin
        if not self.activated:
            self.activate()
        n_in = len(plugin.audio_in)
        n_out = len(plugin.audio_out)
        if n_in:
            audio_in = np.ascontiguousarray(audio_in, np.float32)
            if audio_in.ndim == 1:
                audio_in = audio_in[:, None]
            if audio_in.shape != (samples, n_in):
                raise Lv2Error(f"expected [{samples}, {n_in}] input")
            deinter = np.ascontiguousarray(audio_in.T)
        else:
            deinter = np.zeros((0, samples), np.float32)
        out = np.zeros((n_out, samples), np.float32)
        for i, port in enumerate(plugin.audio_in):
            self.desc.connect_port(
                self.handle, port.index,
                deinter[i].ctypes.data_as(ctypes.c_void_p))
        for i, port in enumerate(plugin.audio_out):
            self.desc.connect_port(
                self.handle, port.index,
                out[i].ctypes.data_as(ctypes.c_void_p))
        self.desc.run(self.handle, samples)
        return np.ascontiguousarray(out.T)

    def close(self) -> None:
        if self.handle:
            self.deactivate()
            if self.desc.cleanup:
                self.desc.cleanup(self.handle)
            self.handle = None


# ------------------------------------------------- native test bundle

def build_test_plugins() -> str:
    """Compile csrc/lv2_plugins.c into a content-hash bundle
    directory with its .ttl manifests installed, fit for LV2_PATH
    (the io/ladspa.py build_test_plugins pattern)."""
    directory = _native_build.build_dir(
        "lv2", ["lv2_plugins.c", "lv2_manifest.ttl", "lv2_plugins.ttl"])
    bundle = os.path.join(directory, "gstbad.lv2")
    os.makedirs(bundle, exist_ok=True)
    _native_build.install(os.path.join(bundle, "manifest.ttl"),
                          "lv2_manifest.ttl")
    _native_build.install(os.path.join(bundle, "plugins.ttl"),
                          "lv2_plugins.ttl")
    _native_build.gcc_shared(os.path.join(bundle, "gstbad_lv2.so"),
                             "lv2_plugins.c")
    return directory
