"""The dynamic plugin hosts (LADSPA, LV2, frei0r) of gstbad_tpu and
gstbad_tpu_torch over each package's own copy of the C fixtures: the JAX
tests of io/ladspa, io/lv2 and io/frei0r and their element families run on
both packages side by side (helpers/twin.py), the twelve dynamic names and
their property tables equal in both registries, and the two paths that put
a host plugin in front of a device graph at small size on the CPU, against
the JAX package:

- frei0r-src-fixgradient ! frei0r-filter-fixbrightness on the host, then
  appsrc into the headline's chain (coloreffects ... zebrastripe), then
  frei0r-mixer-fixblend of each output window with its input: every stage
  byte for byte;
- eight ladspasrc-gstbadtest-sine-osc channels through urn-gstbad-lv2-amp
  (and urn-gstbad-lv2-width on channels 0-1), then appsrc into config 3's
  chain (audiomixmatrix ! freeverb ! audioconvert ! removesilence), then
  ladspasink-gstbadtest-peak-meter on the S16 output: the host blocks
  exact, the S16 output within 1 LSB (freeverb within 2e-6, config 3's
  gate), the messages exact and the peaks within 1 LSB.

Every test that registers dynamic names does so in copies of both
registries (and of frei0r's class cache), which monkeypatch puts back, so
the static counts of the other test files stay 227 on any worker."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_frei0r as tfrei0r
import test_ladspa as tladspa
import test_lv2 as tlv2
from gstbad_tpu.core import registry as jregistry
from gstbad_tpu.elements.audio import ladspa as jladspa_el
from gstbad_tpu.elements.audio import lv2 as jlv2_el
from gstbad_tpu.elements.video import frei0r as jfrei0r_el
from gstbad_tpu.io import frei0r as jfrei0r
from gstbad_tpu.io import ladspa as jladspa
from gstbad_tpu.io import lv2 as jlv2
from gstbad_tpu_torch.core import registry as tregistry
from gstbad_tpu_torch.elements.audio import ladspa as tladspa_el
from gstbad_tpu_torch.elements.audio import lv2 as tlv2_el
from gstbad_tpu_torch.elements.video import frei0r as tfrei0r_el
from gstbad_tpu_torch.io import frei0r as tfrei0r
from gstbad_tpu_torch.io import ladspa as tladspa_io
from gstbad_tpu_torch.io import lv2 as tlv2_io
from helpers.torch_audio import use_xla_vad_serial
from helpers.twin import Twin, jax_test_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYNAMIC = sorted(chip_smoke.PLUGIN_NAMES)   # the twelve fixture names


def _own_registries(monkeypatch):
    """Both registries as copies holding the port's static names only,
    and empty frei0r class caches; monkeypatch puts the originals back."""
    static = {k: v for k, v in tregistry._REGISTRY.items()
              if k not in DYNAMIC}
    monkeypatch.setattr(tregistry, "_REGISTRY", dict(static))
    monkeypatch.setattr(jregistry, "_REGISTRY", {
        k: v for k, v in jregistry._REGISTRY.items() if k in static})
    monkeypatch.setattr(jfrei0r_el, "_REGISTERED", {})
    monkeypatch.setattr(tfrei0r_el, "_REGISTERED", {})


def _register_all():
    """Every fixture registered in both packages: the new names of each."""
    out = {}
    for pkg, lad, lv, f0r, ldir, vdir in (
            ("jax", jladspa_el, jlv2_el, jfrei0r_el,
             jladspa.build_test_plugins(), jlv2.build_test_plugins()),
            ("torch", tladspa_el, tlv2_el, tfrei0r_el,
             tladspa_io.build_test_plugins(), tlv2_io.build_test_plugins())):
        out[pkg] = (lad.register_ladspa_elements(ldir)
                    + lv.register_lv2_elements(vdir)
                    + sorted(f0r.register_frei0r_elements()))
    return out


# ------------------------------------------ the JAX tests on both packages

_LADSPA_DIR = lambda: Twin(jladspa.build_test_plugins(),  # noqa: E731
                           tladspa_io.build_test_plugins())
_LV2_DIR = lambda: Twin(jlv2.build_test_plugins(),  # noqa: E731
                        tlv2_io.build_test_plugins())


def _fixtures(mod):
    """The JAX test module's fixtures, each a Twin of both packages'."""
    if mod is tladspa:
        d = _LADSPA_DIR()
        L = Twin(jladspa, tladspa_io)
        return {"plugin_dir": lambda: d,
                "plugins": lambda: {p.label: p for p in L.scan(d)},
                "registered": lambda: Twin(
                    jladspa_el.register_ladspa_elements,
                    tladspa_el.register_ladspa_elements)(d)}
    if mod is tlv2:
        d = _LV2_DIR()
        L = Twin(jlv2, tlv2_io)
        return {"bundle_dir": lambda: d,
                "plugins": lambda: {p.uri: p for p in L.scan(d)},
                "registered": lambda: Twin(
                    jlv2_el.register_lv2_elements,
                    tlv2_el.register_lv2_elements)(d)}
    d = Twin(jfrei0r.build_fixture_plugins(), tfrei0r.build_fixture_plugins())
    return {"plugins": lambda: {p.name: p for p in Twin(
                jfrei0r, tfrei0r).scan([d])},
            "elements": lambda: Twin(jfrei0r_el.register_frei0r_elements,
                                     tfrei0r_el.register_frei0r_elements)()}


_NAMES = {tladspa: {"L": (jladspa, tladspa_io), "gt": (gt, gtt)},
          tlv2: {"L": (jlv2, tlv2_io), "gt": (gt, gtt)},
          tfrei0r: {"f0r": (jfrei0r, tfrei0r),
                    "register_frei0r_elements": (
                        jfrei0r_el.register_frei0r_elements,
                        tfrei0r_el.register_frei0r_elements),
                    "_canon": (jfrei0r_el._canon, tfrei0r_el._canon),
                    "_prop_name": (jfrei0r_el._prop_name,
                                   tfrei0r_el._prop_name)}}
# left out: the state-extension round trip, which imports the JAX modules
# inside its body (test_lv2_state_preset_round_trip below holds both
# packages to it)
NOT_HERE = ("test_state_extension_preset_roundtrip",)


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(
    _NAMES, NOT_HERE, fixtures=("plugin_dir", "plugins", "registered",
                                "bundle_dir", "elements")))
def test_jax_plugin_host_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of io/ladspa, io/lv2, io/frei0r and their element
    families with its module names (and fixtures) bound to the JAX
    package's and the port's side by side: each call's result, or error,
    equal; the JAX test's own assertions on top."""
    _own_registries(monkeypatch)
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    fix = _fixtures(mod)
    fn(**kwargs, **{k: fix[k]() for k in inspect.signature(fn).parameters
                    if k not in kwargs})


# ----------------------------------------------------------- registries

def _prop_table(cls):
    return [(p.name, p.type.__name__, p.default, p.min, p.max, p.static,
             p.controllable, p.doc) for p in cls.PROPERTIES]


def test_every_fixture_registers_the_same_names_and_properties(
        monkeypatch):
    """The twelve dynamic names, registered from each package's fixtures,
    are the same in both registries (239 names in all), with the same
    kinds, property tables and documentation; then both registries are
    restored and count their static names again."""
    n_static = len(tregistry.element_names())
    _own_registries(monkeypatch)
    assert len(tregistry.element_names()) == 227
    new = _register_all()
    assert sorted(new["jax"]) == sorted(new["torch"]) == DYNAMIC
    assert len(tregistry.element_names()) == 239
    assert tregistry.element_names() == jregistry.element_names()
    for name in DYNAMIC:
        j, t = jregistry.get_class(name), tregistry.get_class(name)
        assert (t.__name__, t.KIND, t.__doc__.split(" from ")[0]) == (
            j.__name__, j.KIND, j.__doc__.split(" from ")[0]), name
        assert _prop_table(t) == _prop_table(j), name
    monkeypatch.undo()
    assert len(tregistry.element_names()) == n_static
    assert not set(DYNAMIC) & set(tregistry.element_names())


def test_registering_twice_adds_no_name(monkeypatch):
    """register_*_elements skips names already registered (the reference's
    collision warning), in both packages alike."""
    _own_registries(monkeypatch)
    _register_all()
    again = _register_all()
    assert again["jax"] == again["torch"]
    # frei0r's hands back its registered classes, the others no new name
    assert again["torch"] == DYNAMIC[:4]
    assert len(tregistry.element_names()) == 239


def test_lv2_state_preset_round_trip(monkeypatch):
    """test_lv2.py's state-extension case on both packages: the preset's
    state block as parsed, the plugin's output before and after
    restore_state, save_state's snapshot, and the element's load_preset."""
    _own_registries(monkeypatch)
    got = {}
    for key, io, el_mod, pkg in (("jax", jlv2, jlv2_el, gt),
                                 ("torch", tlv2_io, tlv2_el, gtt)):
        d = io.build_test_plugins()
        sf = {p.uri: p for p in io.scan(d)}["urn:gstbad:lv2:statefilter"]
        st = sf.preset_state["steps"]
        inst = sf.instantiate(48000)
        x = np.ones(8, np.float32)
        before = inst.run(8, x).copy()
        ok = inst.restore_state(st)
        after = inst.run(8, x).copy()
        snap = inst.save_state()
        inst.close()
        el_mod.register_lv2_elements(d)
        el = pkg.make("urn-gstbad-lv2-statefilter", rate=48000)
        names = el.get_preset_names()
        loaded = el.load_preset("steps")
        y = np.asarray(el.chain(np.ones(8, np.float32))).copy()
        el.close()
        got[key] = (st, before, ok, after, snap, names, loaded, y)
    j, t = got["jax"], got["torch"]
    assert t[0] == j[0] and t[4] == j[4] and t[2] is j[2] is True
    for a, b in zip(j[1:], t[1:]):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
    assert t[5] == j[5] and "steps" in t[5] and t[6] is j[6] is True
    np.testing.assert_array_equal(
        t[7].ravel(), np.tile(np.array([2.0, 0.5, 1.5, 1.0], np.float32), 2))


def test_port_modules_import_without_jax_or_the_jax_package():
    """The plugin hosts, the codec layer and the byte tools import in a
    process where `jax` and `gstbad_tpu` cannot be imported."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'gstbad_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gstbad_tpu_torch\n"
        "from gstbad_tpu_torch.io import (ladspa, lv2, frei0r, vp8, chop,\n"
        "    bz2stream, midi, jp2k, _vp8_tables)\n"
        "from gstbad_tpu_torch.codecs import (h264, h265, mpeg2, vp8 as v,\n"
        "    vp9, av1)\n"
        "from gstbad_tpu_torch.data import vp9_quant_tables\n"
        "from gstbad_tpu_torch.elements.audio import ladspa, lv2\n"
        "from gstbad_tpu_torch.elements.video import frei0r\n"
        "print(len(gstbad_tpu_torch.element_names()))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["227"]


def test_fixtures_build_into_the_port_build_dir():
    """The port builds its own copies of the fixtures (csrc/) into
    gstbad_tpu_torch/_build/, from a content hash of the sources."""
    pkg = os.path.join(ROOT, "gstbad_tpu_torch")
    dirs = {"ladspa": tladspa_io.build_test_plugins(),
            "lv2": tlv2_io.build_test_plugins(),
            "frei0r": tfrei0r.build_fixture_plugins()}
    for kind, d in dirs.items():
        assert os.path.dirname(d) == os.path.join(pkg, "_build"), d
        assert os.path.basename(d).startswith(kind + "-")
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    assert sorted(os.listdir(dirs["frei0r"])) == [
        "fixblend.so", "fixbrightness.so", "fixgradient.so",
        "fixlabeler.so"]
    assert sorted(os.listdir(os.path.join(dirs["lv2"], "gstbad.lv2"))) == [
        "gstbad_lv2.so", "manifest.ttl", "plugins.ttl"]
    for src in ("ladspa_plugins.c", "frei0r_plugins.c", "lv2_plugins.c",
                "lv2_plugins.ttl", "lv2_manifest.ttl"):
        assert os.path.exists(os.path.join(pkg, "csrc", src))


# --------------------------------------------- the two paths, small size

FW, FH, FN, FWIN = 64, 48, 8, 4         # frei0r_headline at small size


def _jax_launch(desc, device=None):
    return gt.parse_launch(desc)


@pytest.mark.parametrize("level", [0.35, 0.8])
def test_frei0r_headline_path_equals_the_jax_package(monkeypatch, level):
    """chip_smoke.frei0r_headline_path at 64x48 through both packages (the
    port on the CPU): the source's frames, the filter's, the chain's
    output and the mix byte for byte, pts alike."""
    _own_registries(monkeypatch)
    _register_all()
    got = {}
    for key, pkg, dev in (("jax", gt, None), ("torch", gtt, "cpu")):
        launch = _jax_launch if pkg is gt else gtt.parse_launch
        got[key] = chip_smoke.frei0r_headline_path(
            launch, pkg.make, dev, FN, FWIN, FW, FH, level)
    j, t = got["jax"], got["torch"]
    for part in ("source", "filtered", "out", "pts", "mixed"):
        assert t[part].dtype == j[part].dtype, part
        np.testing.assert_array_equal(t[part], j[part], err_msg=part)
    assert j["out"].shape == (FN, FH, FW, 4)
    # the filter and the chain changed the frames; the mix is of both
    assert not np.array_equal(j["filtered"], j["source"])
    assert not np.array_equal(j["out"][..., :3], j["filtered"][..., :3])


ABLOCK, AN, AWIN = 480, 4, 2            # ladspa_config3 at small size


def test_ladspa_config3_path_within_config3_tolerance(monkeypatch):
    """chip_smoke.ladspa_config3_path over 4 blocks of 480 samples through
    both packages (the port on the CPU): the host blocks exact, the S16
    output within 1 LSB, the messages and pts exact, the peak meter's
    readings within 1 LSB of S16."""
    use_xla_vad_serial(monkeypatch)
    _own_registries(monkeypatch)
    _register_all()
    got = {}
    for key, pkg, dev in (("jax", gt, None), ("torch", gtt, "cpu")):
        launch = _jax_launch if pkg is gt else gtt.parse_launch
        got[key] = chip_smoke.ladspa_config3_path(
            launch, pkg.make, dev, AN, AWIN, ABLOCK)
    j, t = got["jax"], got["torch"]
    np.testing.assert_array_equal(t["blocks"], j["blocks"])
    assert j["blocks"].shape == (AN, ABLOCK, 8)
    assert t["out"].shape == j["out"].shape == (AN, ABLOCK, 1)
    assert t["out"].dtype == np.int16
    assert np.abs(t["out"].astype(int) - j["out"].astype(int)).max() <= 1
    np.testing.assert_array_equal(t["pts"], j["pts"])
    assert t["messages"] == j["messages"]
    np.testing.assert_allclose(t["peaks"], j["peaks"], rtol=0,
                               atol=1 / 32768)
    assert min(j["peaks"]) > 0.01
