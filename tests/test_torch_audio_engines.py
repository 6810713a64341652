"""The host audio engines (sirenenc/sirendec, gsmenc/gsmdec, opusparse,
festival, gmedec, openmptdec) and their io modules through gstbad_tpu and
gstbad_tpu_torch on the same seeded inputs (1-2 s of audio): every
negotiation and refusal, the encoded frames and bus messages byte for
byte, the decoded blocks exactly (the same numpy transcription or the
same library on both sides), opusparse's framing of all four TOC codes,
festival against an in-process server that speaks the protocol, the
module decoders' tags and checkpoint resume; and the JAX tests of
io/siren, io/gsmcodec, io/opus with opusparse, and io/festival run on
both packages side by side (helpers/twin.py).  Each test skips where its
library is missing, as the JAX tests do; siren, opusparse's from-spec
parser and festival need none."""

import socket
import struct

import numpy as np
import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_festival as tfest
import test_gsm as tgsm
import test_opusparse as topus
import test_siren as tsiren
from gstbad_tpu.io import festival as jfest
from gstbad_tpu.io import gsmcodec as jgsm
from gstbad_tpu.io import opus as jopus
from gstbad_tpu.io import siren as jsiren
from gstbad_tpu_torch.io import festival, gme, gsmcodec, openmpt, opus, siren
from gstbad_tpu_torch.utils import fixtures
from helpers.torch_codecs import (batches, chain, launch, messages,
                                  run_twinned)
from helpers.torch_transport import JAX, TORCH, assert_both
from helpers.twin import jax_test_cases

need_gsm = pytest.mark.skipif(not gsmcodec.available(),
                              reason="libgsm not present")
need_gme = pytest.mark.skipif(not gme.available(), reason="no libgme")
need_mpt = pytest.mark.skipif(not openmpt.available(),
                              reason="no libopenmpt")


def _tone(seconds, rate, freqs=(440.0, 1250.0), seed=0):
    """Seeded S16 mono: two tones and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = sum(np.sin(2 * np.pi * f * t) for f in freqs) * 6000
    x += rng.standard_normal(t.shape) * 300
    return np.clip(x, -32768, 32767).astype(np.int16)


# ------------------------------------------------------------ negotiation

def _refused_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                    # nothing listens there now
    return port


NEGOTIATION = [
    ("sirenenc", "sirenenc ! fakesink", None, True),
    ("sirendec", "sirendec ! fakesink", None, True),
    ("gsmenc", "audiotestsrc format=S16 rate=8000 channels=1 ! gsmenc "
     "! fakesink", None, True),
    ("gsmenc", "audiotestsrc format=S16 rate=16000 channels=1 ! gsmenc "
     "! fakesink", None, False),
    ("gsmenc", "audiotestsrc format=F32 rate=8000 channels=1 ! gsmenc "
     "! fakesink", None, False),
    ("gsmenc", "audiotestsrc format=S16 rate=8000 channels=2 ! gsmenc "
     "! fakesink", None, False),
    ("gsmdec", "gsmdec ! fakesink", None, False),
    ("gsmdec", "gsmdec ! fakesink", b"\xd8" * 40, False),
    ("gsmdec", "gsmdec samplesperbuffer=250 ! fakesink", b"\xd8" * 33,
     False),
    ("gsmdec", "gsmdec samplesperbuffer=480 ! fakesink", b"\xd8" * 66,
     True),
    ("opusparse", "opusparse ! fakesink", None, True),
    ("festival", "festival ! fakesink", None, False),
    ("festival", "festival host=127.0.0.1 port={refused} ! fakesink",
     "hello", False),
    ("gmedec", "gmedec ! fakesink", None, False),
    ("gmedec", "gmedec ! fakesink", b"definitely not a module", False),
    ("gmedec", "gmedec track=3 ! fakesink", "vgm", False),
    ("openmptdec", "openmptdec ! fakesink", None, False),
    ("openmptdec", "openmptdec ! fakesink", b"not a module" * 9, False),
    ("openmptdec", "openmptdec subsong=2 ! fakesink", "mod", False),
    ("openmptdec", "openmptdec format=S32 ! fakesink", "mod", False),
    ("openmptdec", "openmptdec format=S16 rate=22050 channels=1 "
     "! fakesink", "mod", True),
]
_NEEDS = {"gsmenc": need_gsm, "gsmdec": need_gsm, "gmedec": need_gme,
          "openmptdec": need_mpt}


@pytest.mark.parametrize("name,desc,push,ok", [
    pytest.param(*case, marks=_NEEDS.get(case[0], ()),
                 id=f"{case[0]}-{i}")
    for i, case in enumerate(NEGOTIATION)])
def test_negotiation_sweep(name, desc, push, ok):
    """Each host audio engine under accepted and refused properties, input
    formats and pushed data: the same output spec, or the same error
    class and message, from both packages."""
    desc = desc.replace("{refused}", str(_refused_port()))
    push = {"vgm": fixtures.make_vgm(1), "mod": fixtures.make_mod()}.get(
        push, push)

    def run(pkg):
        p = launch(pkg, desc)
        el = next(n.element for n in p.nodes if n.element.NAME == name)
        if isinstance(push, str):
            el.push_text(push)
        elif push is not None:
            el.push_packet(push)
        p.negotiate()
        return [n.element.out_spec for n in p.nodes]
    assert_both(run, raises=not ok)


# ------------------------------------------------------------------ siren

def test_siren_round_trip_through_pipelines():
    """2 s of seeded 16 kHz audio through `sirenenc ! fakesink`
    (push_samples) and its 40-byte frames through `sirendec ! fakesink`
    (push_bytes, in two pieces), windows of 16: the same frames, pts and
    decoded blocks from both packages, and the round trip above 15 dB
    once the one-frame transform delay is skipped."""
    sig = _tone(2.0, 16000, seed=1)

    def run(pkg):
        p = launch(pkg, "sirenenc ! fakesink")
        p.nodes[0].element.push_samples(sig)
        enc = p.run(window=16)
        blob = b"".join(np.asarray(b.data).tobytes() for b in enc)
        q = launch(pkg, "sirendec ! fakesink")
        q.nodes[0].element.push_bytes(blob[:1000])
        q.nodes[0].element.push_bytes(blob[1000:])
        return batches(enc), batches(q.run(window=16))
    assert_both(run)
    p = launch(TORCH, "sirenenc ! fakesink")
    p.nodes[0].element.push_samples(sig)
    blob = b"".join(b.data.tobytes() for b in p.run(window=16))
    assert len(blob) == 100 * 40
    q = launch(TORCH, "sirendec ! fakesink")
    q.nodes[0].element.push_bytes(blob)
    out = np.concatenate([b.data for b in q.run(window=16)]).reshape(-1)
    a, b = out[640:].astype(np.float64), sig[320:-320].astype(np.float64)
    assert 10 * np.log10((b ** 2).mean() / ((a - b) ** 2).mean()) > 15


def test_siren_codec_state_equal():
    """The encoder and decoder objects frame by frame on a sine, a chirp
    and silence: the same bytes, samples and carried state (the
    transform's overlap, the decoder's backup frame) in both."""
    t = np.arange(320 * 30) / 16000
    sig = np.concatenate([
        (np.sin(2 * np.pi * 700 * t[:320 * 10]) * 12000),
        (np.sin(2 * np.pi * (200 + 3000 * t[:320 * 10]) * t[:320 * 10])
         * 9000), np.zeros(320 * 10)]).astype(np.int16).reshape(-1, 320)
    out = []
    for mod in (jsiren, siren):
        enc, dec = mod.SirenEncoder(16000), mod.SirenDecoder(16000)
        frames = [enc.encode_frame(f) for f in sig]
        pcm = [dec.decode_frame(f) for f in frames]
        out.append((frames, np.stack(pcm), enc.context, dec.context,
                    dec.backup_frame, dec.dw))
    assert out[1][0] == out[0][0]
    for a, b in zip(out[0][1:], out[1][1:]):
        np.testing.assert_array_equal(b, a)


# -------------------------------------------------------------------- gsm

@need_gsm
@pytest.mark.parametrize("spb", [160, 250, 1000])
def test_gsm_round_trip(spb):
    """audiotestsrc S16 8 kHz mono in blocks of `spb` samples (the
    encoder carries the remainder across blocks and windows) through
    gsmenc: the same gsm-frame messages and packets; the frames through
    gsmdec in blocks of 480 samples: the same blocks, pts and valid."""
    desc = f"audiotestsrc wave=sine freq=300 format=S16 rate=8000 " \
        f"channels=1 samplesperbuffer={spb} ! gsmenc name=enc ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        p.run(n_frames=12, window=4)
        enc = p.get_by_name("enc")
        dec = pkg.make("gsmdec", samplesperbuffer=480)
        dec.push_packet(b"".join(d for _p, d in enc.packets))
        q = chain(pkg, [dec, pkg.make("fakesink")])
        q.negotiate(None)
        return enc.packets, messages(p.bus), batches(q.run(window=4))
    t = assert_both(run)
    assert len(t[1][0]) == 12 * spb // 160


@need_gsm
@pytest.mark.parametrize("wav49", [False, True])
def test_gsm_codec_modes_equal(wav49):
    """The codec object in its plain and WAV49 modes (GSM_OPT_WAV49, the
    audio/ms-gsm framing of gstgsmdec.c): the same frames from both
    packages, and the same samples decoded from them."""
    sig = _tone(1.0, 8000, seed=2).reshape(-1, 160)
    out = []
    for mod in (jgsm, gsmcodec):
        enc, dec = mod.GsmCodec(wav49=wav49), mod.GsmCodec(wav49=wav49)
        frames = [enc.encode_frame(f) for f in sig]
        out.append((frames, np.stack([dec.decode_frame(f)
                                      for f in frames])))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])


# -------------------------------------------------------------- opusparse

@pytest.mark.parametrize("libopus", [True, False])
def test_opusparse_all_toc_codes(monkeypatch, libopus):
    """64 seeded packets over the four TOC codes (fixtures.opus_packets):
    as a test-vector byte stream in pieces of 700 bytes, and packetized
    after an OpusHead and an OpusTags header: the same buffers (data,
    pts, duration, offsets, caps) from both packages, with libopus's
    parser and with the from-spec one that runs where libopus does not
    load."""
    if libopus and not opus.libopus_available():
        pytest.skip("libopus not present")
    if not libopus:
        for mod in (jopus, opus):
            monkeypatch.setattr(mod, "libopus_available", lambda: False)
    packets = fixtures.opus_packets(64, seed=3)
    stream = fixtures.opus_test_vectors(packets)
    head = opus.build_id_header(48000, 1, 0, 1, 0, (0,), pre_skip=312)
    tags = b"OpusTags" + struct.pack("<I", 4) + b"port" + struct.pack(
        "<I", 0)

    def run(pkg):
        el = pkg.make("opusparse")
        out = []
        for k in range(0, len(stream), 700):
            out += el.chain(stream[k:k + 700])
        el2 = pkg.make("opusparse")
        out2 = []
        for p in [head, tags] + packets:
            out2 += el2.chain(p, packetized=True)
        return out, out2
    t = assert_both(run)
    assert len(t[1][1]) == 64


# --------------------------------------------------------------- festival

def test_festival_against_a_protocol_server():
    """festival against an in-process server (fixtures.FestivalServer)
    that answers each text with a seeded waveform, key-stuffed: texts
    with quotes, backslashes, a literal stuff-key prefix and UTF-8, in
    blocks of 160 samples, windows of 4: the same WAV packets, spec and
    blocks from both packages, and the same commands on the wire."""
    texts = ['say "hello" \\ world', "ft_StUfF_ke inside", "café", "x"]
    seen = []

    def run(pkg):
        with fixtures.FestivalServer() as srv:
            p = launch(pkg, f"festival host=127.0.0.1 port={srv.port} "
                            "samplesperbuffer=160 ! fakesink")
            el = p.nodes[0].element
            for text in texts:
                el.push_text(text)
            out = batches(p.run(window=4))
            seen.append(list(srv.commands))
            return el.wav_packets, el.out_spec, out
    t = assert_both(run)
    assert seen[0] == seen[1] and len(seen[0]) == 1 + len(texts)
    assert t[1][0] == [fixtures.spoken(x) for x in texts]


def test_festival_server_error_and_resume():
    """A server that answers ER: the same FestivalError from both
    packages; save_position and restore_position resume the blocks."""
    def refused(pkg):
        with fixtures.FestivalServer(voice=lambda text: None) as srv:
            p = launch(pkg, f"festival host=127.0.0.1 port={srv.port} "
                            "! fakesink")
            p.nodes[0].element.push_text("nothing")
            p.negotiate()
    assert_both(refused, raises=True)

    def resume(pkg):
        with fixtures.FestivalServer() as srv:
            p = launch(pkg, f"festival host=127.0.0.1 port={srv.port} "
                            "samplesperbuffer=32 ! fakesink")
            el = p.nodes[0].element
            el.push_text("resume here, please")
            p.negotiate()
            first = el.pull_window(3)
            pos = el.save_position()
            rest = [el.pull_window(3) for _ in range(2)]
            el.restore_position(pos)
            again = el.pull_window(3)
            assert batches([again]) == batches(rest[:1])
            return pos, batches([first] + rest)
    assert_both(resume)


# ---------------------------------------------------- gmedec / openmptdec

@need_gme
@pytest.mark.parametrize("seconds", [1, 2])
def test_gmedec_equal(seconds):
    """gmedec on a VGM stream (fixtures.make_vgm) in two pushes, windows
    of 8: the same S16 32 kHz blocks, pts, valid and `tags` message
    (track count, duration, system) from both packages."""
    data = fixtures.make_vgm(seconds)

    def run(pkg):
        p = launch(pkg, "gmedec ! fakesink")
        el = p.nodes[0].element
        el.push_packet(data[:50])
        el.push_packet(data[50:])
        out = batches(p.run(window=8))
        return el.out_spec, out, messages(p.bus)
    t = assert_both(run)
    assert len(t[1][1]) == 3 * seconds


@need_mpt
@pytest.mark.parametrize("props", [
    {}, {"format": "S16", "rate": 44100},
    {"stereo-separation": 0, "master-gain": 600, "filter-length": 2},
    {"channels": 1, "volume-ramping": 4, "num-loops": 1,
     "output-buffer-size": 777}])
def test_openmptdec_equal(props):
    """openmptdec on a ProTracker MOD (fixtures.make_mod) under its render
    properties, windows of 8: the same pts, valid and `tags` message
    (title, subsongs, duration) from both packages, and the same F32
    blocks.  libopenmpt dithers its S16 output from a random seed of each
    module it opens, so two renders differ by up to 2 LSB, in either
    package: S16 blocks are held within 2 LSB of each other."""
    pcm = []

    def run(pkg):
        p = launch(pkg, "openmptdec " + " ".join(
            f"{k}={v}" for k, v in props.items()) + " ! fakesink")
        el = p.nodes[0].element
        el.push_packet(fixtures.make_mod(b"PORTSONG"))
        outs = p.run(n_frames=16, window=8)
        pcm.append(np.concatenate([np.asarray(b.data) for b in outs]))
        return el.out_spec, [batches([b.replace(data=None)])
                             for b in outs], messages(p.bus)
    assert_both(run)
    assert pcm[0].dtype == pcm[1].dtype and pcm[0].shape == pcm[1].shape
    lsb = 2 if props.get("format") == "S16" else 0
    assert np.abs(pcm[0].astype(np.float64) - pcm[1]).max() <= lsb


@pytest.mark.parametrize("name", [pytest.param("gmedec", marks=need_gme),
                                  pytest.param("openmptdec",
                                               marks=need_mpt)])
def test_module_decoder_checkpoint_resume(tmp_path, name):
    """save_checkpoint after a window, load_checkpoint into a fresh
    pipeline (the engine seeks): the same resumed blocks from both
    packages."""
    data = fixtures.make_vgm(2) if name == "gmedec" else fixtures.make_mod()

    def run(pkg):
        def fresh():
            el = pkg.make(name)
            el.push_packet(data)
            p = chain(pkg, [el, pkg.make("fakesink")])
            p.negotiate(None)
            return p
        p1 = fresh()
        out1 = p1.run(n_frames=4, window=4)
        ck = tmp_path / f"{pkg.name}.pkl"
        p1.save_checkpoint(ck)
        p2 = fresh()
        p2.compile(4)
        p2.load_checkpoint(ck)
        return batches(out1), batches(p2.run(n_frames=4, window=4))
    assert_both(run)


# ------------------------------------------ the JAX tests on both packages

class _ServerOfTwo(fixtures.FestivalServer):
    """The JAX tests' MockFestival(wav) as a server that takes both
    packages' connections."""

    def __init__(self, wav):
        super().__init__(voice=lambda text: wav)

    def start(self):
        pass


_NAMES = {tsiren: {"siren": (jsiren, siren)},
          tgsm: {"gsmcodec": (jgsm, gsmcodec)},
          topus: {"op": (jopus, opus), "gt": (gt, gtt)},
          tfest: {"fest": (jfest, festival)}}
# left out: the element tests that build JAX Pipelines or use the JAX
# registry directly (the tests above hold both packages' elements to each
# other on the same inputs)
NOT_HERE = ("test_elements_roundtrip", "test_gsmenc_element_frames",
            "test_element_roundtrip", "test_gsmenc_rejects_wrong_caps",
            "test_festival_element_synthesizes_audio")


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(
    _NAMES, NOT_HERE, fixtures=("rng",)))
def test_jax_audio_engine_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of io/siren, io/gsmcodec, io/opus and opusparse, and
    io/festival, with its module names bound to the JAX package's and
    the port's side by side (each call's result, or error, equal; the
    JAX test's own assertions on top; festival's mock server takes both
    connections)."""
    if mod is tfest:
        monkeypatch.setattr(mod, "MockFestival", _ServerOfTwo)
    run_twinned(monkeypatch, _NAMES, mod, fn, kwargs)


def test_opusparse_without_libopus_looks_it_up_once(monkeypatch):
    """Where libopus does not load, the port's io/opus remembers the
    failed load (its one correction of the JAX copy): opusparse framing
    256 packets looks the library up once, where the JAX module looks it
    up again for every packet and every skipped byte; both frame the
    same buffers on the from-spec parser."""
    import ctypes.util

    def missing(*a, **k):
        raise OSError("libopus: not on this host")
    looked = {jopus: 0, opus: 0}
    for mod in (jopus, opus):
        monkeypatch.setattr(mod, "_LIBOPUS", None)
        monkeypatch.setattr(mod.ctypes, "CDLL", missing)
    if hasattr(opus, "_LIBOPUS_ERROR"):
        monkeypatch.setattr(opus, "_LIBOPUS_ERROR", None)
    real = ctypes.util.find_library
    stream = fixtures.opus_test_vectors(fixtures.opus_packets(256, seed=7))
    out = []
    for pkg, mod in ((gt, jopus), (gtt, opus)):
        def counting(name, mod=mod):
            looked[mod] += 1
            return None
        monkeypatch.setattr(ctypes.util, "find_library", counting)
        el = pkg.make("opusparse")
        got = []
        for k in range(0, len(stream), 4096):
            got += el.chain(stream[k:k + 4096])
        out.append([(b["data"], b["pts"], b["offset_end"]) for b in got])
    monkeypatch.setattr(ctypes.util, "find_library", real)
    assert out[1] == out[0] and len(out[1]) > 50
    assert looked[opus] == 1 and looked[jopus] > 256, looked
