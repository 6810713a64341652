"""chromaprint and ofa (ext/chromaprint, ext/ofa) through gstbad_tpu and
gstbad_tpu_torch on the same seeded audio: the chroma image (the port's on
the CPU through ops/fft.rfft and a float32 product, within 1e-6 of the JAX
package's on rows of unit norm: a few float32 ulp of the products' order),
the fingerprint strings (equal), the tag messages, the passthrough, the
duration cap and the library engine (libchromaprint, equal strings where
it is present)."""

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.harness import Harness as JHarness
from gstbad_tpu.elements.audio import fingerprint as jfp
from gstbad_tpu.io import chromaprint as jcp
from gstbad_tpu_torch.core.harness import Harness
from gstbad_tpu_torch.elements.audio import fingerprint as tfp
from gstbad_tpu_torch.io import chromaprint as tcp
from helpers.torch_audio import audio_spec, push_audio_both

RATE = 44100
CHROMA_TOL = 1e-6


def _windows(seconds, block=4410, per_window=10):
    """chip_smoke.chord_audio (phase 4m's signal) as windows of blocks."""
    x = chip_smoke.chord_audio(seconds, RATE)
    blocks = x.reshape(-1, block, 2)
    return [blocks[i:i + per_window]
            for i in range(0, len(blocks), per_window)]


def test_chroma_image_matches():
    """The chroma image of the same 11025 Hz mono signals (seeded noise
    and phase 4m's chords, 5 and 23 s)."""
    rng = np.random.default_rng(5)
    for mono in [(0.3 * rng.standard_normal(11025 * s)).astype(np.float32)
                 for s in (5, 23)] + [
            (chip_smoke.chord_audio(s, 11025).astype(np.float32)
             / 32768).mean(1).astype(np.float32) for s in (5, 23)]:
        a, b = jfp._chroma_image(mono), tfp._chroma_image(mono, "cpu")
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= CHROMA_TOL
        assert tfp._fingerprint_string(tfp._quantize(b)) == \
            jfp._fingerprint_string(jfp._quantize(a))


@pytest.mark.parametrize("name,props", [
    ("chromaprint", {"engine": "native"}), ("ofa", {}),
    ("chromaprint", {"engine": "native", "duration": 2})])
def test_native_fingerprints_are_equal(name, props):
    """5 s of seeded 44.1 kHz stereo S16 through the element in both
    packages' Harness (the port on the CPU), then its end of stream: the
    same passthrough, fingerprint string and tag messages (a 2 s cap posts
    before the end)."""
    (jo, jm), (to, tm) = push_audio_both(name, "S16", 2, RATE, _windows(5),
                                         props)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
    assert tm == jm
    if props.get("duration") == 2:
        assert len(tm) == 1 and tm[0][3]["duration"] == 2


def test_element_fingerprint_and_eos():
    """The elements' own fingerprint property, None until their end of
    stream, then equal in both packages, fed F32 stereo."""
    x = np.concatenate(_windows(3)).astype(np.float32) / 32768.0
    got = {}
    for hcls, pkg, kw in ((JHarness, gt, {}), (Harness, gtt,
                                               {"device": "cpu"})):
        for name in ("chromaprint", "ofa"):
            h = hcls(name, **kw, **({"engine": "native"}
                                   if name == "chromaprint" else {}))
            h.set_src_spec(audio_spec(pkg, "F32", 2, RATE))
            h.push(x)
            assert h.element.fingerprint is None
            h.element.eos(h.bus)
            got.setdefault(name, []).append(h.element.fingerprint)
    for name, (j, t) in got.items():
        assert j and t == j, name


@pytest.mark.skipif(not jcp.available(),
                    reason="libchromaprint not available")
def test_library_engine_gives_the_jax_string():
    """engine=library (and auto, which takes it) binds libchromaprint in
    both packages: the same Acoustid string, and the library's own on the
    same S16 stream."""
    windows = _windows(5)
    x = np.concatenate(windows).reshape(-1, 2)
    for engine in ("library", "auto"):
        (_, jm), (_, tm) = push_audio_both(
            "chromaprint", "S16", 2, RATE, windows,
            {"engine": engine, "duration": 4})
        assert tm == jm and tm
        assert tm[0][3]["chromaprint-fingerprint"] == tcp.fingerprint(
            x[:4 * RATE], RATE)


def test_library_engine_without_the_library_raises(monkeypatch):
    """engine=library where libchromaprint is absent: both packages raise
    the same error (no silent fall back to the native engine)."""
    monkeypatch.setattr(jcp, "available", lambda: False)
    monkeypatch.setattr(tcp, "available", lambda: False)
    errors = []
    for hcls, pkg, kw in ((JHarness, gt, {}), (Harness, gtt,
                                               {"device": "cpu"})):
        h = hcls("chromaprint", engine="library", duration=1, **kw)
        h.set_src_spec(audio_spec(pkg, "S16", 2, RATE))
        with pytest.raises(RuntimeError) as e:
            h.push(np.concatenate(_windows(2)))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "libchromaprint" in errors[0]
