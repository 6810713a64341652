"""kateenc, katedec, kateparse and katetag (ext/kate) and io/kate.py
through gstbad_tpu and gstbad_tpu_torch on the same inputs, byte for byte:
text and SPU streams through kateenc -> kateparse -> katedec (every packet,
granule position, timestamp and decoded output), the keepalives, the
delayed-SPU flush, katetag's header rewrite; and the JAX tests of
tests/test_kate.py run on both packages side by side (helpers/twin.py)."""

import pytest

import chip_smoke
import test_kate as tk
from gstbad_tpu.elements import kate as jkate
from gstbad_tpu.io import kate as jkate_io
from gstbad_tpu.io import typefind as jtypefind
from gstbad_tpu_torch.elements import kate as tkate
from gstbad_tpu_torch.io import kate as tkate_io
from gstbad_tpu_torch.io import typefind as ttypefind
from helpers.torch_transport import assert_both
from helpers.twin import Twin, jax_test_cases

NSEC = 1_000_000_000


def _round_trip(pkg, enc_props, caps, feed, dec_props=None):
    """feed(enc) -> the encoder's packets; then kateparse and katedec
    over them: (packets, parsed, decoded, katedec's tag events)."""
    enc = pkg.make("kateenc", **enc_props)
    enc.set_caps(caps)
    packets = feed(enc) + enc.event_eos()
    parse = pkg.make("kateparse")
    parsed = []
    for p in packets:
        parsed += parse.chain(p["data"], granulepos=p["granulepos"],
                              pts_ns=p["pts"], dur_ns=p["duration"])
    parsed += parse.event_eos()
    dec = pkg.make("katedec", **(dec_props or {}))
    decoded = []
    for p in parsed:
        decoded += dec.chain(p["data"])
    return packets, parsed, decoded, dec.tag_events


TEXTS = [b"hello", "café — naïve".encode(), b"",
         b"<b>bold</b> and <i>italic</i>", b"x" * 600]


@pytest.mark.parametrize("markup", [False, True])
def test_text_stream_round_trip(markup):
    """Five texts (UTF-8, empty, markup, long) with gaps long enough for
    segment keepalives, through kateenc -> kateparse -> katedec."""
    caps = "text/x-raw, format=" + ("pango-markup" if markup else "utf8")

    def run(pkg):
        def feed(enc):
            out = []
            for i, t in enumerate(TEXTS):
                out += enc.event_segment(3 * i * NSEC)
                out += enc.push_text(t, 3 * i * NSEC + 1000, NSEC // 2)
            return out
        out = _round_trip(pkg, {"category": "SUB", "language": "en_GB",
                                "keepalive-min-time": 1.0}, caps, feed,
                          {"remove-markup": markup})
        # katedec posts no text for the empty one
        assert len([d for d in out[2] if d["kind"] == "text"]) == 4
        return out
    assert_both(run)


def test_spu_stream_round_trip():
    """Three seeded VobSub pictures (chip_smoke.spu_packets, the phase-4h
    builder) with their CLUTs, SPU -> kate -> SPU, and a delayed SPU that
    a segment flushes with its trailing keepalives."""
    spus = chip_smoke.spu_packets(3, 2 * NSEC, w=120, h=24, seed=5)

    def run(pkg):
        def feed(enc):
            out = []
            for data, pts, clut in spus:
                enc.set_clut([int(c) for c in clut])
                out += enc.push_spu(data, pts)
            out += enc.push_spu(tk.KATE_SPU, 7 * NSEC)
            out += enc.event_segment(12 * NSEC)
            return out
        out = _round_trip(pkg, {"category": "spu-subtitles",
                                "keepalive-min-time": 1.0,
                                "default-spu-duration": 1.5,
                                "original-canvas-width": 720,
                                "original-canvas-height": 576},
                          "subpicture/x-dvd", feed)
        assert len([d for d in out[2] if d["kind"] == "spu"]) == 4
        return out
    assert_both(run)


def test_katetag_rewrites_headers():
    """katetag on an encoded stream: language, category and canvas size
    rewritten in the identification header, the comments in the comment
    header; the data packets pass."""
    def run(pkg):
        enc = pkg.make("kateenc", category="SUB", language="fr")
        enc.set_caps("text/x-raw, format=utf8")
        enc.event_tag(["TITLE=t", "ARTIST=a"])
        packets = enc.push_text(b"bonjour", 0, NSEC) + enc.event_eos()
        tag = pkg.make("katetag", language="de_DE", category="K-SLD-I",
                       **{"original-canvas-width": 640,
                          "original-canvas-height": 480})
        out = []
        for p in packets:
            out += tag.chain(p["data"], granulepos=p["granulepos"],
                             pts_ns=p["pts"], dur_ns=p["duration"])
        return out + tag.event_eos()
    assert_both(run)


def test_missing_category_raises_in_both():
    def run(pkg):
        enc = pkg.make("kateenc")
        enc.set_caps("text/x-raw, format=utf8")
        return enc.push_text(b"x", 0, NSEC)
    assert_both(run, raises=True)


# ----------------------------------------- the JAX tests on both packages

_NAMES = {tk: {"kate_io": (jkate_io, tkate_io),
               "find_type": (jtypefind.find_type, ttypefind.find_type),
               **{c: (getattr(jkate, c), getattr(tkate, c))
                  for c in ("KateDec", "KateEnc", "KateParse", "KateTag")}}}


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(_NAMES))
def test_jax_kate_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of the kate elements with its names (the four
    element classes, io/kate and typefind) bound to the JAX package's and
    the port's side by side (each call's result, or error, equal; the JAX
    test's own assertions on top)."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    fn(**kwargs)
