"""The io modules no element reaches (io/chop.py, io/bz2stream.py,
io/midi.py, io/jp2k.py) of gstbad_tpu and gstbad_tpu_torch: the JAX tests
of jp2kdecimator, the MIDI walk, bz2enc/bz2dec and chopmydata run on both
packages side by side (helpers/twin.py), and chip_smoke.py's phase-4o host
checks at small size on the CPU port: their inputs through both packages,
and the whole check on the port."""

import bz2

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu_torch as gtt
import test_bz2 as tbz2
import test_jp2k as tjp2k
import test_midi as tmidi
import test_misc_elements as tmisc
from gstbad_tpu.core import registry as jregistry
from gstbad_tpu.io import bz2stream as jbz2stream
from gstbad_tpu.io import chop as jchop
from gstbad_tpu.io import jp2k as jjp2k
from gstbad_tpu.io import midi as jmidi
from gstbad_tpu_torch.core import registry as tregistry
from gstbad_tpu_torch.elements.video import frei0r as tfrei0r_el
from gstbad_tpu_torch.io import bz2stream, chop, jp2k, midi
from helpers.twin import Twin, jax_test_cases

_NAMES = {tjp2k: {"jp2k": (jjp2k, jp2k)}, tmidi: {"midi": (jmidi, midi)},
          tbz2: {"bz2stream": (jbz2stream, bz2stream)}}


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(_NAMES))
def test_jax_byte_tool_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of io/jp2k, io/midi and io/bz2stream with its module
    name bound to the JAX package's and the port's side by side: each
    call's result, or error, equal; the JAX test's own assertions on
    top."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    fn(**kwargs)


def test_jax_chopmydata_case_runs_on_both(monkeypatch):
    """test_misc_elements.py's chopmydata case with ChopMyData bound to
    both packages' (the JAX test imports it inside its body, so the name
    is bound on the JAX module): the same chunks from the same seeds, and
    the JAX videoparse's frames equal under the chopped feed."""
    monkeypatch.setattr(jchop, "ChopMyData", Twin(jchop.ChopMyData,
                                                  chop.ChopMyData))
    tmisc.test_chopmydata_sizes_and_parser_fuzz(np.random.default_rng(1234))


@pytest.mark.parametrize("seed", [3, 9, 117])
def test_chopmydata_sizes_equal_the_jax_package(seed):
    """The port's ChopMyData draws the JAX package's sizes from numpy's
    PCG64 for the same seed, steps and tail."""
    data = bytes(range(256)) * 97
    got = []
    for mod in (jchop, chop):
        c = mod.ChopMyData(min_size=5, max_size=300, step_size=3, seed=seed)
        got.append([len(x) for x in c.push(data) + c.flush()])
    assert got[0] == got[1]
    assert all(s % 3 == 0 or s == 5 for s in got[0])


def test_chopped_h264_into_h264parse_equals_the_unchopped_feed():
    """Phase 4o's chop check at one second: the seeded H.264 stream
    through ChopMyData into the port's h264parse gives the access units
    of the unchopped feed, which are the stream's own."""
    aus = [a for a, _ in chip_smoke.h264_stream(1, chip_smoke.TS_FPS,
                                                4000)]
    stream = b"".join(aus)
    out = {}
    for key in ("whole", "chopped"):
        el = gtt.make("h264parse")
        if key == "whole":
            chunks = [stream]
        else:
            c = chop.ChopMyData(min_size=1, max_size=4096, step_size=7,
                                seed=117)
            chunks = c.push(stream) + c.flush()
            assert len(chunks) > len(aus)
        got = []
        for ch in chunks:
            got += el.push(ch)
        got += el.finish()
        out[key] = [o["data"] for o in got]
    assert out["chopped"] == out["whole"] == aus


def test_phase_4o_inputs_equal_in_both_packages():
    """The synthetic 1080p JPEG 2000 codestream decimated, the MIDI file
    walked and a frame's bz2 stream: the port gives the JAX package's
    bytes and events."""
    stream, bodies = chip_smoke.jp2k_codestream(1920, 1080, 3, 2, 64)
    small = [m.decimate(stream, max_layers=1, max_decomposition_levels=1)
             for m in (jjp2k, jp2k)]
    assert small[0] == small[1] and len(small[1]) < len(stream)
    events = [[(e.event, e.data, e.pulse, e.time_ns)
               for e in m.parse_midi(chip_smoke.midi_file())]
              for m in (jmidi, midi)]
    assert events[0] == events[1]
    frame = np.random.default_rng(5).integers(0, 4, (48, 64, 4), np.uint8)
    raw = frame.tobytes()
    packed = []
    for m in (jbz2stream, bz2stream):
        enc = m.Bz2Enc(block_size=9)
        packed.append(b"".join(enc.push(raw)) + b"".join(enc.finish()))
    assert packed[0] == packed[1] == bz2.compress(raw, 9)


def test_phase_4o_host_checks_hold_on_the_cpu_port(monkeypatch):
    """chip_smoke.plugin_host_checks on the CPU port, fixtures registered
    in copies of the registries: every invariant holds (a failed one exits)
    and its results are plain values."""
    monkeypatch.setattr(tregistry, "_REGISTRY", dict(tregistry._REGISTRY))
    monkeypatch.setattr(jregistry, "_REGISTRY", dict(jregistry._REGISTRY))
    monkeypatch.setattr(tfrei0r_el, "_REGISTERED", {})
    chip_smoke.register_plugin_fixtures()
    aus = [a for a, _ in chip_smoke.h264_stream(1, chip_smoke.TS_FPS, 4000)]
    frame = np.random.default_rng(7).integers(0, 256, (48, 64, 4),
                                              np.uint8)
    res = chip_smoke.plugin_host_checks(gtt, aus, frame)
    assert sorted(res["registry"]) == sorted(chip_smoke.PLUGIN_NAMES)
    assert res["dpb"]["vp8"] is None and len(res["dpb"]["h264"]) > 0
    assert res["chop"][0] == len(aus) and len(res["midi"]) == 17
    assert res["bz2"][0] == frame.nbytes
