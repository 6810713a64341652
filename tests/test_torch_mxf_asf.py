"""mxfmux/mxfdemux (gst/mxf) and asfmux/asfparse (gst/asfmux) and their
io modules (io/mxf.py, io/asf.py) through gstbad_tpu and gstbad_tpu_torch
on the same inputs, byte for byte: every muxed byte, every demuxed payload,
track and timestamp, the parsed packets; libavformat (the JAX package's
io/tsoracle, tests may import both packages) demuxes the port's files to
the payloads sent; chip_smoke.asf_payloads (phase 4m's reader) reads them
back too; and the JAX tests of tests/test_mxf.py and tests/test_asf.py run
on both packages side by side (helpers/twin.py)."""

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_asf as tasf
import test_mxf as tmxf
from gstbad_tpu.io import asf as jasf
from gstbad_tpu.io import mxf as jmxf
from gstbad_tpu.io import tsoracle
from gstbad_tpu.io import typefind as jtypefind
from gstbad_tpu_torch.io import asf as tasf_io
from gstbad_tpu_torch.io import mxf as tmxf_io
from gstbad_tpu_torch.io import typefind as ttypefind
from helpers.torch_transport import assert_both
from helpers.twin import Twin, jax_test_cases

NSEC = 1_000_000_000


def _payloads(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi)),
                         dtype=np.uint8).tobytes() for _ in range(n)]


VIDEO = _payloads(1, 12, 200, 9000)
AUDIO = _payloads(2, 12, 1920, 1921)


@pytest.mark.parametrize("tracks", ["av", "video", "audio"])
def test_mxf_round_trip(tracks):
    """mxfmux on seeded video and audio payloads, then mxfdemux in 997-byte
    chunks: the same file, frames, tracks and caps from both packages."""
    video, audio = tracks in ("av", "video"), tracks in ("av", "audio")

    def run(pkg):
        mux = pkg.make("mxfmux")
        if video:
            mux.connect_video(64, 48, (30000, 1001))
        if audio:
            mux.connect_audio(48000, 2, 16)
        for v, a in zip(VIDEO, AUDIO):
            if video:
                mux.chain_video(v)
            if audio:
                mux.chain_audio(a)
        blob = mux.event_eos()
        dmx = pkg.make("mxfdemux")
        out = []
        for i in range(0, len(blob), 997):
            out += dmx.push_bytes(blob[i:i + 997])
        return blob, out, {n: (t.kind, t.edit_rate)
                           for n, t in dmx.tracks.items()}
    assert_both(run)


@pytest.mark.parametrize("ecc,streamable,size", [
    (False, False, 4800), (True, False, 4800), (False, True, 1000),
    (True, True, 65535)])
def test_asf_round_trip(ecc, streamable, size):
    """asfmux with an audio and a video stream, payloads larger than a
    packet among them, then asfparse in 997-byte chunks: the same bytes
    and packets from both packages, and every payload and presentation
    time back (chip_smoke.asf_payloads)."""
    def run(pkg):
        mux = pkg.make("asfmux", ecc=ecc, streamable=streamable,
                       **{"packet-size": size})
        a = mux.connect_audio(0x0050, 2, 48000, block_align=384)
        v = mux.connect_video(b"MPG2", 64, 48)
        stream = b""
        for i, (vd, ad) in enumerate(zip(VIDEO, AUDIO)):
            stream += mux.chain(v, vd, pts_ns=i * NSEC // 25,
                                keyframe=i % 5 == 0)
            stream += mux.chain(a, ad, pts_ns=i * NSEC // 25)
        tail = mux.event_eos()
        stream = stream + tail if streamable else tail
        parse = pkg.make("asfparse")
        units = []
        for i in range(0, len(stream), 997):
            units += parse.chain(stream[i:i + 997])
        assert b"".join(units) == stream
        return stream, units, parse.packet_size
    _, (stream, _, _) = assert_both(run)
    got = chip_smoke.asf_payloads(stream)
    want = []       # the audio stream is number 1, the video 2
    for i, (vd, ad) in enumerate(zip(VIDEO, AUDIO)):
        want += [(1, False, i, 40 * i + 5000, ad),
                 (2, i % 5 == 0, i, 40 * i + 5000, vd)]
    assert sorted(got, key=lambda o: (o[3], o[0])) == want


def test_asf_packets_above_64k_carry_the_length_type_fault():
    """A packet size above 65535 takes DWORD length fields; both packages
    write their types as 4 << 5 and 4 << 3 (io/asf.py _flush_packet), not
    3 (ASF's DWORD): the flags byte is 0xA1, whose bit 7 is the
    error-correction flag, whose packet-length type reads as BYTE and
    whose padding-length type as none.  The same bytes from both
    (ROADMAP queue 3)."""
    def run(pkg):
        mux = pkg.make("asfmux", **{"packet-size": 70000})
        v = mux.connect_video(b"MPG2", 64, 48)
        for i, vd in enumerate(VIDEO):
            mux.chain(v, vd, pts_ns=i * NSEC // 25)
        return mux.event_eos()
    _, stream = assert_both(run)
    pkt = pkg_packets(stream)[0]
    assert pkt[0] == 0xA1


def pkg_packets(stream):
    units = tasf_io.AsfParse().push(stream)
    return units[1:]


@pytest.mark.skipif(not tsoracle.available(),
                    reason="libavformat not available")
def test_port_files_demux_in_libavformat():
    """The port's MXF (OP1a) and ASF (ECC layout) files demuxed by
    libavformat: every payload back."""
    mux = gtt.make("mxfmux")
    mux.connect_video(64, 48)
    for v in VIDEO:
        mux.chain_video(v)
    _, pkts = tsoracle.demux(mux.event_eos(), any_format=True)
    assert [p.data for p in pkts] == VIDEO
    amux = gtt.make("asfmux", ecc=True)
    st = amux.connect_video(b"MPG2", 64, 48)
    for i, v in enumerate(VIDEO):
        amux.chain(st, v, pts_ns=i * NSEC // 25, keyframe=True)
    _, pkts = tsoracle.demux(amux.event_eos(), any_format=True)
    assert sorted(p.data for p in pkts) == sorted(VIDEO)


def test_mxf_demux_of_libavformat_file():
    """mxfdemux on an MXF file libavformat wrote (MPEG-2 and PCM): the
    same frames and tracks from both packages."""
    if not tsoracle.available():
        pytest.skip("libavformat not available")
    blob = tsoracle.make_sample("mxf", 6)

    def run(pkg):
        dmx = pkg.make("mxfdemux")
        return dmx.push_bytes(blob), dmx._dmx.descriptors, {
            n: (t.kind, t.edit_rate, dmx._dmx.track_caps(n))
            for n, t in dmx.tracks.items()}
    assert_both(run)


def test_demux_errors_match():
    def run(pkg):
        return pkg.make("asfparse").chain(b"\x00" * 64)
    assert_both(run, raises=True)


# ----------------------------------------- the JAX tests on both packages

_NAMES = {
    tmxf: {"gt": (gt, gtt), "mxf": (jmxf, tmxf_io),
           "find_type": (jtypefind.find_type, ttypefind.find_type)},
    tasf: {"gt": (gt, gtt), "asf": (jasf, tasf_io),
           "find_type": (jtypefind.find_type, ttypefind.find_type)},
}
_SEEDS = {tmxf: 31, tasf: 21}       # the modules' rng fixtures


# left out: a test that reads its descriptors' class names (type(x)),
# which a Twin hides; test_mxf_demux_of_libavformat_file compares them
NOT_HERE = ("test_ffmpeg_mux_descriptor_caps",)


@pytest.mark.parametrize("mod,fn,kwargs",
                         jax_test_cases(_NAMES, NOT_HERE, fixtures=("rng",)))
def test_jax_mxf_asf_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of the MXF and ASF elements with its module names
    bound to the JAX package's and the port's side by side (each call's
    result, or error, equal; the JAX test's own assertions on top;
    libavformat stays the JAX package's oracle)."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    if "rng" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs = dict(kwargs, rng=np.random.default_rng(_SEEDS[mod]))
    fn(**kwargs)
