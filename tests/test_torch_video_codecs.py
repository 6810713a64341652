"""The video codecs (x265enc/libde265dec, av1enc/av1dec, webpenc/webpdec,
openjpegenc/openjpegdec, openexrdec) and their io modules through
gstbad_tpu and gstbad_tpu_torch on the same seeded 64x48 inputs: every
negotiation and refusal, the encoded packets and bus messages (byte for
byte: the same library under the same settings), the decoded frames
(exact), the seven make_source routes, the transcoder's hevc and av1
profiles through `python -m gstbad_tpu_torch transcode` against the JAX
transcoder, and the slice as a whole: a decoder in front of the
headline's chain, where the port's fused tail takes K1 once a window.
The JAX tests of io/h265, io/av1, io/webp and io/exr run on both packages
side by side (helpers/twin.py).  Each test skips where its library is
missing, as the JAX tests do."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_av1 as tav1
import test_exr as texr
import test_h265 as th265
import test_webp as twebp
from gstbad_tpu.io import av1 as jav1
from gstbad_tpu.io import exr as jexr
from gstbad_tpu.io import h265 as jh265
from gstbad_tpu.io import typefind as jtypefind
from gstbad_tpu.io import webp as jwebp
from gstbad_tpu.session import Transcoder as JTranscoder
from gstbad_tpu_torch.elements.video import jpeg2000
from gstbad_tpu_torch.io import av1, exr, gme, h265, openmpt, webp, y4m
from gstbad_tpu_torch.io import typefind as ttypefind
from gstbad_tpu_torch.utils import fixtures
from helpers.torch_codecs import (batches, chain, i420, launch, messages,
                                  packed, run_twinned)
from helpers.torch_transport import JAX, TORCH, assert_both
from helpers.twin import jax_test_cases

W, H = 64, 48
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
need_h265 = pytest.mark.skipif(not h265.available(),
                               reason="libx265/libde265 not present")
need_av1 = pytest.mark.skipif(not av1.available(),
                              reason="libaom not present")
need_webp = pytest.mark.skipif(not webp.available(),
                               reason="libwebp not present")
need_j2k = pytest.mark.skipif(not jpeg2000.available(),
                              reason="libopenjp2 (via Pillow) not present")
need_exr = pytest.mark.skipif(not exr.available(),
                              reason="OpenEXRCore not present")
HEADLINE = " ! videoconvert format=BGRx ! " + chip_smoke.HEAD \
    + " ! zebrastripe ! fakesink"


def _feed_i420(p, frames, name="src"):
    src = p.get_by_name(name)
    src.props.update(format="I420", width=frames["y"].shape[2],
                     height=frames["y"].shape[1])
    src.push_frames(frames)


def _hevc_stream(frames, **props):
    """The annex-B stream x265enc (the JAX package's) makes of frames."""
    desc = "appsrc name=src ! x265enc name=enc speed-preset=ultrafast " \
        "tune=zerolatency " + " ".join(f"{k}={v}" for k, v in props.items()) \
        + " ! fakesink"
    p = gt.parse_launch(desc)
    _feed_i420(p, frames)
    p.run(window=4)
    return p.get_by_name("enc").stream()


def _av1_units(frames, **props):
    desc = "appsrc name=src ! av1enc name=enc usage-profile=realtime " \
        "cpu-used=8 " + " ".join(f"{k}={v}" for k, v in props.items()) \
        + " ! fakesink"
    p = gt.parse_launch(desc)
    _feed_i420(p, frames)
    p.run(window=4)
    return [d for _pts, d in p.get_by_name("enc").stream_packets()]


# ------------------------------------------------------------ negotiation

NEGOTIATION = [
    # libx265 opens no encoder at 64x48 under its medium preset
    ("x265enc", "videotestsrc width=64 height=48 format=I420 ! x265enc "
     "qp=30 key-int-max=8 ! fakesink"),
    ("x265enc", "videotestsrc width=64 height=48 format=I420 ! x265enc "
     "speed-preset=ultrafast qp=30 key-int-max=8 ! fakesink"),
    ("x265enc", "videotestsrc width=64 height=48 format=I420 ! x265enc "
     "speed-preset=ultrafast tune=zerolatency "
     "option-string=bframes=0:ref=1:no-sao ! fakesink"),
    ("x265enc", "videotestsrc width=64 height=48 format=BGRx ! x265enc "
     "! fakesink"),
    ("x265enc", "videotestsrc width=64 height=48 format=I420 ! x265enc "
     "speed-preset=warp ! fakesink"),
    ("x265enc", "videotestsrc width=64 height=48 format=I420 ! x265enc "
     "option-string=no-such-option=3 ! fakesink"),
    ("av1enc", "videotestsrc width=64 height=48 format=I420 ! av1enc "
     "end-usage=cbr cpu-used=8 usage-profile=realtime ! fakesink"),
    ("av1enc", "videotestsrc width=64 height=48 format=RGB ! av1enc "
     "! fakesink"),
    ("av1enc", "videotestsrc width=64 height=48 format=I420 ! av1enc "
     "end-usage=abr ! fakesink"),
    ("av1enc", "videotestsrc width=64 height=48 format=I420 ! av1enc "
     "usage-profile=fast ! fakesink"),
    ("webpenc", "videotestsrc width=64 height=48 format=RGBA ! webpenc "
     "preset=drawing ! fakesink"),
    ("webpenc", "videotestsrc width=64 height=48 format=I420 ! webpenc "
     "! fakesink"),
    ("webpenc", "videotestsrc width=64 height=48 format=BGRx ! webpenc "
     "! fakesink"),
    ("webpenc", "videotestsrc width=64 height=48 format=RGB ! webpenc "
     "preset=cartoon ! fakesink"),
    ("openjpegenc", "videotestsrc width=64 height=48 format=GRAY8 ! "
     "openjpegenc container=jp2 ! fakesink"),
    ("openjpegenc", "videotestsrc width=64 height=48 format=I420 ! "
     "openjpegenc ! fakesink"),
    ("openjpegenc", "videotestsrc width=64 height=48 format=RGB ! "
     "openjpegenc progression-order=XYZW ! fakesink"),
    ("openjpegenc", "videotestsrc width=64 height=48 format=RGB ! "
     "openjpegenc container=jpx ! fakesink"),
    ("openjpegenc", "videotestsrc width=64 height=48 format=RGB ! "
     "openjpegenc num-resolutions=7 ! fakesink"),
    ("libde265dec", "libde265dec ! fakesink"),
    ("av1dec", "av1dec ! fakesink"),
    ("webpdec", "webpdec ! fakesink"),
    ("openjpegdec", "openjpegdec ! fakesink"),
    ("openexrdec", "openexrdec ! fakesink"),
]
# the cases that negotiate (by index); the rest are refused
ACCEPTED = {1: ("x265enc",), 2: ("x265enc",), 6: ("av1enc",),
            10: ("webpenc",), 11: ("webpenc",), 14: ("openjpegenc",)}
_NEEDS = {"x265enc": need_h265, "libde265dec": need_h265,
          "av1enc": need_av1, "av1dec": need_av1, "webpenc": need_webp,
          "webpdec": need_webp, "openjpegenc": need_j2k,
          "openjpegdec": need_j2k, "openexrdec": need_exr}


@pytest.mark.parametrize("name,desc,ok", [
    pytest.param(n, d, n in ACCEPTED.get(i, ()), marks=_NEEDS[n],
                 id=f"{n}-{i}")
    for i, (n, d) in enumerate(NEGOTIATION)])
def test_negotiation_sweep(name, desc, ok):
    """Each video codec under accepted and refused properties and input
    formats (a decoder with nothing pushed): the same output spec, or the
    same error class and message, from both packages."""
    def run(pkg):
        p = launch(pkg, desc)
        p.negotiate()
        return [n.element.out_spec for n in p.nodes]
    assert_both(run, raises=not ok)


def test_decoders_refuse_garbage():
    """Bytes no decoder can read: the same refusal from both packages,
    for each decoder whose library loads."""
    names = [n for n, lib in (("libde265dec", h265), ("av1dec", av1),
                              ("webpdec", webp), ("openexrdec", exr))
             if lib.available()]
    assert len(names) == 4     # this host has every library
    for name in names:
        def run(pkg):
            p = launch(pkg, f"{name} ! fakesink")
            p.nodes[0].element.push_packet(b"\x00\x00\x01garbage" * 8)
            p.negotiate()
            return p.run(window=2)
        assert_both(run, raises=True)


# ------------------------------------------------------- encode / decode

@need_h265
def test_x265_lossless_round_trip_is_exact():
    """appsrc ! x265enc lossless=true: the same h265-nal messages and
    packets from both packages; the port's libde265dec gives back the
    frames the encoder was given, byte for byte, with the JAX decoder's
    pts and valid."""
    frames = i420(10, W, H, seed=3)
    desc = "appsrc name=src ! x265enc name=enc lossless=true " \
        "speed-preset=ultrafast tune=zerolatency ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        _feed_i420(p, frames)
        p.run(window=4)
        enc = p.get_by_name("enc")
        stream = enc.stream()
        dec = pkg.make("libde265dec", framerate="25/1")
        dec.push_packet(stream)
        q = chain(pkg, [dec, pkg.make("fakesink")])
        q.negotiate(None)
        return stream, enc.packets, messages(p.bus), batches(q.run(window=4))
    t = assert_both(run)
    dec = gtt.make("libde265dec")
    dec.push_packet(t[1][0])
    q = chain(TORCH, [dec, gtt.make("fakesink")])
    q.negotiate(None)
    got = q.run(window=4)
    for k in ("y", "u", "v"):
        np.testing.assert_array_equal(
            np.concatenate([b.data[k] for b in got]), frames[k])


@need_h265
@pytest.mark.parametrize("props", [{"qp": 26}, {"bitrate": 300,
                                                "key-int-max": 4}])
def test_x265enc_lossy_packets_equal(props):
    """x265enc under qp and under bitrate rate control: the same access
    units, pts and bus messages from both packages, and libde265dec's
    frames of them equal."""
    frames = i420(8, W, H, seed=4)
    desc = "appsrc name=src ! x265enc name=enc speed-preset=ultrafast " \
        "tune=zerolatency " + " ".join(f"{k}={v}" for k, v in props.items()) \
        + " ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        _feed_i420(p, frames)
        p.run(window=3)
        enc = p.get_by_name("enc")
        dec = pkg.make("libde265dec")
        dec.push_packet(enc.stream())
        q = chain(pkg, [dec, pkg.make("fakesink")])
        q.negotiate(None)
        return enc.packets, messages(p.bus), batches(q.run(window=3))
    assert_both(run)


@need_av1
@pytest.mark.parametrize("props", [
    {}, {"end-usage": "cbr", "target-bitrate": 120, "keyframe-max-dist": 3},
    {"end-usage": "q", "min-quantizer": 20, "max-quantizer": 20}])
def test_av1_round_trip_equal(props):
    """av1enc (realtime, cpu-used 8) under three rate controls: the same
    temporal units, pts and av1-frame messages from both packages, and
    av1dec's frames of them equal."""
    frames = i420(6, W, H, seed=5)
    desc = "appsrc name=src ! av1enc name=enc usage-profile=realtime " \
        "cpu-used=8 " + " ".join(f"{k}={v}" for k, v in props.items()) \
        + " ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        _feed_i420(p, frames)
        p.run(window=4)
        enc = p.get_by_name("enc")
        units = enc.stream_packets()
        dec = pkg.make("av1dec")
        for _pts, d in units:
            dec.push_packet(d)
        q = chain(pkg, [dec, pkg.make("fakesink")])
        q.negotiate(None)
        return units, messages(p.bus), batches(q.run(window=4))
    assert_both(run)


@need_webp
@pytest.mark.parametrize("fmt,props", [
    ("RGB", "lossless=true"), ("RGBA", "lossless=true speed=6"),
    ("RGB", "quality=60 preset=picture"), ("I420", "quality=80")])
def test_webp_round_trip(fmt, props):
    """webpenc on RGB, RGBA and I420 windows: the same webp-image
    messages from both packages; webpdec (with and without its decoder
    options) gives the same frames, and a lossless stream gives back the
    input exactly."""
    if fmt == "I420":
        frames = i420(3, W, H, seed=6)
    else:
        frames = packed(3, W, H, len(fmt), seed=6)
        if fmt == "RGBA":
            frames[..., 3] = np.maximum(frames[..., 3], 1)
    desc = f"appsrc name=src format={fmt} width={W} height={H} " \
        f"! webpenc name=enc {props} ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        p.get_by_name("src").push_frames(frames)
        p.run(window=2)
        images = [d for _p, d in p.get_by_name("enc").packets]
        out = []
        for opts in ({}, {"no-fancy-upsampling": True,
                          "bypass-filtering": True}):
            dec = pkg.make("webpdec", **opts)
            for d in images:
                dec.push_packet(d)
            q = chain(pkg, [dec, pkg.make("fakesink")])
            q.negotiate(None)
            out.append((dec.out_spec.format, batches(q.run(window=2))))
        return messages(p.bus), out
    assert_both(run)
    if "lossless" in props:
        dec = gtt.make("webpdec")
        p = launch(TORCH, desc)
        p.get_by_name("src").push_frames(frames)
        p.run(window=2)
        for _p, d in p.get_by_name("enc").packets:
            dec.push_packet(d)
        q = chain(TORCH, [dec, gtt.make("fakesink")])
        q.negotiate(None)
        got = np.concatenate([b.data for b in q.run(window=3)])
        np.testing.assert_array_equal(got[..., -len(fmt):] if fmt == "RGB"
                                      else got[..., [1, 2, 3, 0]], frames)


@need_j2k
@pytest.mark.parametrize("fmt,props", [
    ("RGB", ""), ("RGBA", "container=jp2 num-layers=3"),
    ("GRAY8", "progression-order=RPCL num-resolutions=4"),
    ("RGB", "tile-width=32 tile-height=16 num-resolutions=4 "
            "progression-order=CPRL")])
def test_openjpeg_round_trip_is_lossless(fmt, props):
    """openjpegenc under its progression, layer, tiling and container
    properties: the same j2k-image messages from both packages, and
    openjpegdec gives back the input exactly in both."""
    frames = packed(3, W, H, {"RGB": 3, "RGBA": 4, "GRAY8": 1}[fmt], 7)
    desc = f"appsrc name=src format={fmt} width={W} height={H} " \
        f"! openjpegenc name=enc {props} ! fakesink"

    def run(pkg):
        p = launch(pkg, desc)
        p.get_by_name("src").push_frames(frames)
        p.run(window=2)
        dec = pkg.make("openjpegdec")
        for _p, d in p.get_by_name("enc").packets:
            dec.push_packet(d)
        q = chain(pkg, [dec, pkg.make("fakesink")])
        q.negotiate(None)
        got = q.run(window=2)
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(b.data) for b in got]), frames)
        return messages(p.bus), dec.out_spec, batches(got)
    assert_both(run)


@need_exr
@pytest.mark.parametrize("pixel,feed", [("half", "packet"),
                                        ("float", "packet"),
                                        ("half", "bytes")])
def test_openexrdec_equal(pixel, feed):
    """openexrdec on files the port's write_exr made (half and float
    pixels, ZIP compression, a pixel aspect ratio), pushed as images or
    as one raw stream split at its magics: the same ARGB64 frames from
    both packages, each the reference's conversion of the pixels."""
    rng = np.random.default_rng(8)
    imgs = [{c: (rng.random((H, W)) * 1.2).astype(np.float32)
             for c in "RGBA"} for _ in range(3)]
    ptype = exr.PIXEL_HALF if pixel == "half" else exr.PIXEL_FLOAT
    blobs = [exr.write_exr(None, planes, compression=exr.COMPRESSION_ZIP,
                           pixel_type=ptype, pixel_aspect=1.25)
             for planes in imgs]

    def run(pkg):
        el = pkg.make("openexrdec", framerate="24/1")
        if feed == "packet":
            for b in blobs:
                el.push_packet(b)
        else:
            stream = b"".join(blobs)
            el.push_bytes(stream[:1000])
            el.push_bytes(stream[1000:])
            el.event_eos()
        p = chain(pkg, [el, pkg.make("fakesink")])
        p.negotiate(None)
        return el.out_spec, batches(p.run(window=2))
    assert_both(run)
    el = gtt.make("openexrdec")
    for b in blobs:
        el.push_packet(b)
    p = chain(TORCH, [el, gtt.make("fakesink")])
    p.negotiate(None)
    got = np.concatenate([b.data for b in p.run(window=3)])
    for i, b in enumerate(blobs):
        np.testing.assert_array_equal(
            got[i], exr.to_argb64(exr.decode_exr(b)[0]))


def test_decoder_positions_resume():
    """save_position after a window, restore_position on a fresh element:
    the rest of the stream from both packages equals the uninterrupted
    run (libde265dec, av1dec, webpdec, openjpegdec, openexrdec)."""
    frames = i420(5, W, H, seed=9)
    rgb = packed(5, W, H, 3, seed=9)
    streams = {"libde265dec": [_hevc_stream(frames, lossless="true")],
               "av1dec": _av1_units(frames),
               "webpdec": [webp.encode(f, lossless=True) for f in rgb],
               "openjpegdec": [],
               "openexrdec": [exr.write_exr(None, {"R": f[..., 0] / 255.0})
                              for f in rgb]}
    import io as _io
    from PIL import Image
    for f in rgb:
        buf = _io.BytesIO()
        Image.fromarray(f, "RGB").save(buf, "JPEG2000", no_jp2=True)
        streams["openjpegdec"].append(buf.getvalue())
    for name, packets in streams.items():
        def element(pkg):
            el = pkg.make(name)
            for d in packets:
                el.push_packet(d)
            chain(pkg, [el, pkg.make("fakesink")]).negotiate(None)
            return el

        def run(pkg):
            el = element(pkg)
            whole = [canon_window(el.pull_window(2)) for _ in range(3)]
            el2 = element(pkg)
            el2.restore_position(2)
            rest = [canon_window(el2.pull_window(2)) for _ in range(2)]
            assert rest == whole[1:]
            return whole, el2.save_position()
        assert_both(run)


def canon_window(b):
    return batches([b])[0]


# ----------------------------------------------------------- the slice

@pytest.mark.parametrize("dec", [
    pytest.param("libde265dec", marks=need_h265),
    pytest.param("av1dec", marks=need_av1)])
def test_decoder_headline_graph_and_route(monkeypatch, dec):
    """The slice as a whole: a stream decoded on the host through
    `<decoder> ! videoconvert format=BGRx ! the headline's chain !
    zebrastripe`, 2 windows of 3 (the second one frame short), the same
    frames and pts from both packages.  Behind the decoder the port's
    chain folds as behind videotestsrc: its fused tail calls
    dilate_zebra_fused (K1; its plain version on the CPU) once a window
    and no whole-word lookup (K2)."""
    from gstbad_tpu_torch.ops import chainfuse, lut
    calls = {"k1": 0, "k2": 0}

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    spy(chainfuse, "dilate_zebra_plain", "k1")
    spy(lut, "apply_word_table_plain", "k2")
    frames = i420(5, W, H, seed=10)
    packets = ([_hevc_stream(frames, lossless="true")] if dec == "libde265dec"
               else _av1_units(frames))

    def run(pkg):
        p = launch(pkg, dec + " framerate=60/1" + HEADLINE)
        for d in packets:
            p.nodes[0].element.push_packet(d)
        return batches(p.run(window=3))
    t = assert_both(run)
    assert len(t[1]) == 2
    assert calls == {"k1": 2, "k2": 0}, calls
    assert chainfuse.dilate_zebra_fused.launches == 0   # the CPU: plain


@pytest.mark.parametrize("name", [
    pytest.param("libde265dec", marks=need_h265),
    pytest.param("av1dec", marks=need_av1),
    pytest.param("webpdec", marks=need_webp),
    pytest.param("openjpegdec", marks=need_j2k),
    pytest.param("openexrdec", marks=need_exr)])
def test_port_decoder_uploads_once_to_its_device(monkeypatch, name):
    """Each decoder hands the runner a window in one host-to-device copy
    (core/frame.upload_frames), on the pipeline's device."""
    from gstbad_tpu_torch.core import frame
    seen = []
    orig = frame.upload_frames

    def spy(device, frames, **kw):
        seen.append((str(device), len(frames)))
        return orig(device, frames, **kw)
    module = {"libde265dec": "h265codec", "av1dec": "av1codec",
              "webpdec": "webpcodec", "openjpegdec": "jpeg2000",
              "openexrdec": "openexr"}[name]
    monkeypatch.setattr(f"gstbad_tpu_torch.elements.video.{module}."
                        "upload_frames", spy)
    frames = i420(5, W, H, seed=11)
    rgb = packed(5, W, H, 3, seed=11)
    if name == "libde265dec":
        packets = [_hevc_stream(frames, lossless="true")]
    elif name == "av1dec":
        packets = _av1_units(frames)
    elif name == "webpdec":
        packets = [webp.encode(f, lossless=True) for f in rgb]
    elif name == "openexrdec":
        packets = [exr.write_exr(None, {"G": f[..., 1] / 255.0})
                   for f in rgb]
    else:
        import io as _io
        from PIL import Image
        packets = []
        for f in rgb:
            buf = _io.BytesIO()
            Image.fromarray(f, "RGB").save(buf, "JPEG2000", no_jp2=True)
            packets.append(buf.getvalue())
    el = gtt.make(name)
    for d in packets:
        el.push_packet(d)
    p = chain(TORCH, [el, gtt.make("fakesink")])
    p.negotiate(None)
    out = p.run(window=4)
    assert seen == [("cpu", 4), ("cpu", 4)]
    assert [len(b.pts) for b in out] == [4, 1]


# ------------------------------------------------------------ make_source

def _route_data(route):
    """A stream of each of make_source's seven decoder routes."""
    frames = i420(3, W, H, seed=12)
    rgb = packed(1, W, H, 3, seed=12)[0]
    if route == "h265":
        return _hevc_stream(frames, lossless="true")
    if route == "av1-ivf":
        import tempfile
        from gstbad_tpu_torch.io.ivf import write_ivf
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "a.ivf")
            write_ivf(path, b"AV01", W, H, 30, 1,
                      list(enumerate(_av1_units(frames))))
            with open(path, "rb") as f:
                return f.read()
    if route == "webp":
        return webp.encode(rgb, lossless=True)
    if route in ("jp2", "j2c"):
        import io as _io
        from PIL import Image
        buf = _io.BytesIO()
        Image.fromarray(rgb, "RGB").save(buf, "JPEG2000",
                                         no_jp2=route == "j2c")
        return buf.getvalue()
    if route == "exr":
        return exr.write_exr(None, {c: rgb[..., i] / 255.0
                                    for i, c in enumerate("RGB")})
    if route == "vgm":
        return fixtures.make_vgm(1)
    return fixtures.make_mod()


ROUTES = [("h265", need_h265), ("av1-ivf", need_av1), ("webp", need_webp),
          ("jp2", need_j2k), ("j2c", need_j2k), ("exr", need_exr),
          ("vgm", pytest.mark.skipif(not gme.available(),
                                     reason="libgme not present")),
          ("mod", pytest.mark.skipif(not openmpt.available(),
                                     reason="libopenmpt not present"))]


@pytest.mark.parametrize("route", [pytest.param(r, marks=m)
                                   for r, m in ROUTES])
def test_make_source_routes(route):
    """make_source on a stream of each decoder route (h265, av1 in IVF,
    webp, jp2 and j2c, exr, the gme formats and the tracker formats): the
    same media type, element and properties from both packages, and the
    same output through fakesink (2 windows of 2)."""
    data = _route_data(route)

    def run(pkg):
        mtype, el = pkg.io("typefind").make_source(data)
        p = chain(pkg, [el, pkg.make("fakesink")])
        p.negotiate(None)
        outs = []
        for _ in range(2):
            b = el.pull_window(2)
            if b is not None:
                outs.append(canon_window(b))
        return mtype, el.NAME, el.props, el.out_spec, outs
    t = assert_both(run)
    assert t[1][1] == ttypefind._DECODERS[t[1][0]][0]


# ------------------------------------------------------------ transcoder

FILTERS = "videoconvert format=BGRx ! solarize ! videoconvert format=I420"


@pytest.mark.parametrize("profile", [
    pytest.param("hevc:lossless", marks=need_h265),
    pytest.param("hevc:qp=24", marks=need_h265),
    pytest.param("av1", marks=need_av1),
    pytest.param("av1:bitrate=400", marks=need_av1)])
def test_transcode_cli_profile(tmp_path, profile):
    """`python -m gstbad_tpu_torch transcode --profile <p> --device cpu`
    on a seeded y4m with a filter chain: the same bytes as the JAX
    transcoder's (an annex-B stream, or IVF); the lossless stream
    decodes, by the port's libde265dec, to the JAX transcoder's y4m
    output of the same chain exactly."""
    from gstbad_tpu_torch.core.spec import MediaSpec
    src = tmp_path / "in.y4m"
    y4m.write_y4m(str(src), MediaSpec(kind="video", format="I420",
                                      width=W, height=H), i420(7, W, H, 13))
    ext = "h265" if profile.startswith("hevc") else "ivf"
    JTranscoder(str(src), str(tmp_path / f"j.{ext}"), FILTERS, window=3,
                profile=profile).run()
    r = subprocess.run(
        [sys.executable, "-m", "gstbad_tpu_torch", "transcode", str(src),
         str(tmp_path / f"t.{ext}"), "--filters", FILTERS, "--window", "3",
         "--profile", profile, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "wrote 7 frames" in r.stderr
    t_bytes = (tmp_path / f"t.{ext}").read_bytes()
    assert t_bytes == (tmp_path / f"j.{ext}").read_bytes()
    if profile == "hevc:lossless":
        JTranscoder(str(src), str(tmp_path / "j.y4m"), FILTERS,
                    window=3).run()
        _spec, want = y4m.read_y4m(str(tmp_path / "j.y4m"))
        dec = gtt.make("libde265dec")
        dec.push_packet(t_bytes)
        p = chain(TORCH, [dec, gtt.make("fakesink")])
        p.negotiate(None)
        got = p.run(window=7)[0].data
        for k in "yuv":
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------ the JAX tests on both packages

_NAMES = {th265: {"h265": (jh265, h265)}, tav1: {"av1": (jav1, av1)},
          twebp: {"webp": (jwebp, webp)},
          texr: {"exr": (jexr, exr), "find_type": (jtypefind.find_type,
                                                   ttypefind.find_type)}}
# left out: the element tests, which build JAX Pipelines (the tests above
# hold the two packages' elements to each other on the same streams)
NOT_HERE = ("test_elements_roundtrip_through_pipeline",
            "test_decoded_feeds_filter_graph", "test_x265enc_rejects_non_i420",
            "test_elements_roundtrip", "test_av1enc_rejects_non_i420",
            "test_webpenc_element_posts_images", "test_webpenc_i420_path",
            "test_webpdec_element_roundtrip_lossless",
            "test_webpdec_rgb_when_no_alpha", "test_webp_transcode_chain",
            "test_openexrdec_element", "test_openexrdec_push_bytes_stream",
            "test_exr_chain_to_8bit", "test_videoconvert_argb64_roundtrip")


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(
    _NAMES, NOT_HERE, fixtures=("rng",)))
def test_jax_video_codec_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of io/h265, io/av1, io/webp and io/exr with its
    module names bound to the JAX package's and the port's side by side
    (each call's result, or error, equal; the JAX test's own assertions
    on top)."""
    run_twinned(monkeypatch, _NAMES, mod, fn, kwargs,
                seeds={twebp: 42, texr: 42})


# ------------------------------------------------------ sessions, devices

@pytest.mark.parametrize("route", [pytest.param("h265", marks=need_h265),
                                   pytest.param("webp", marks=need_webp),
                                   pytest.param("j2c", marks=need_j2k)])
def test_play_file_uri_through_a_decoder(tmp_path, route):
    """Play.from_uri's typefind fallback on a file of each route: the port
    builds the decoder the JAX package builds, and Play runs it to
    end-of-stream with every dispatched frame and message equal."""
    from helpers.torch_session import Recorder, play_both
    path = tmp_path / f"clip.{route}"
    path.write_bytes(_route_data(route))

    def make(mod, **dev):
        rec = Recorder()
        p = mod.Play(window=2, realtime=False, on_frame=rec, **dev)
        p.set_uri(f"file://{path}")
        return p, rec
    out = play_both(make)
    names = [m[1] for m in out["port"][2]]
    assert names[0] == "uri-loaded" and "end-of-stream" in names
    assert len(out["port"][1]) >= 1
    assert out["port"][0].pipeline.nodes[0].element.NAME == \
        out["jax"][0].pipeline.nodes[0].element.NAME


@pytest.mark.parametrize("what", ["libde265dec", "av1dec", "webpdec",
                                  "openjpegdec", "openexrdec", "make_source",
                                  "transcoder"])
def test_card_request_without_a_card_raises(tmp_path, what):
    """The decoders, a make_source element and the hevc transcoder ask for
    the card by default; without one they raise, and nothing falls back
    to the CPU."""
    import torch
    from gstbad_tpu_torch.core.pipeline import Pipeline
    from gstbad_tpu_torch.session import Transcoder
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if what == "make_source":
            _mtype, el = ttypefind.make_source(fixtures.make_vgm(1))
            Pipeline([el, gtt.make("fakesink")])
        elif what == "transcoder":
            Transcoder(str(tmp_path / "in.y4m"), str(tmp_path / "o.h265"),
                       profile="hevc:lossless")
        else:
            gtt.parse_launch(f"{what} ! fakesink")
