"""The port's copies of the host parsers against the JAX package's:
io/m3u8.py, io/dashmpd.py, io/mss.py (with io/isoff.py and the SPS part
of io/h264.py) and io/isoff.py run every JAX test of theirs
(tests/test_{m3u8,dash_mpd,mss,isoff}.py) side by side with the JAX
modules (helpers/twin.py: each call's result, or exception, equal), and
io/typefind.py and io/subtitles.py on the JAX tests' inputs."""

import struct

import numpy as np
import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_dash_mpd
import test_isoff
import test_m3u8
import test_mss
from gstbad_tpu.io import (dashmpd as j_dashmpd, isoff as j_isoff,
                           m3u8 as j_m3u8, mss as j_mss,
                           subtitles as j_subtitles, typefind as j_typefind)
from gstbad_tpu_torch.io import (dashmpd as t_dashmpd, isoff as t_isoff,
                                 m3u8 as t_m3u8, mss as t_mss,
                                 subtitles as t_subtitles,
                                 typefind as t_typefind)
from helpers.twin import Twin, jax_test_cases, tree

#: each JAX test module, and its module names bound to the twins
TWINS = {test_m3u8: {"m3u8": (j_m3u8, t_m3u8)},
         test_dash_mpd: {"mpd": (j_dashmpd, t_dashmpd)},
         test_mss: {"mss": (j_mss, t_mss), "isoff": (j_isoff, t_isoff)},
         test_isoff: {"isoff": (j_isoff, t_isoff)}}


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(TWINS))
def test_jax_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    for name, (j, t) in TWINS[mod].items():
        monkeypatch.setattr(mod, name, Twin(j, t))
    fn(**kwargs)


MAGICS = [
    b"YUV4MPEG2 W64 H48 F30:1\n" + b"\0" * 8,
    b"DKIF\0\0\x20\0AV01" + b"\0" * 20, b"DKIF\0\0\x20\0VP90" + b"\0" * 20,
    b"RIFF\x10\0\0\0WEBPVP8 ", bytes.fromhex("0000000c6a502020") + b"\0" * 8,
    bytes.fromhex("ff4fff51") + b"\0" * 12,
    b"\x00\x00\x00\x01\x40\x01" + b"\0" * 8, b"\x00\x00\x01\xba" + b"\0" * 12,
    b"Vgm " + b"\0" * 12, b"FORM\0\0\0\x20AIFF" + b"\0" * 4,
    b"MThd" + b"\0" * 12, b"P5\n64 48\n255\n" + b"\0" * 4,
    b"BZh9" + b"\0" * 12, bytes(1080) + b"M.K." + bytes(964),
    b"garbage here....", b"OpusHead" + b"\0" * 12,
    struct.pack(">I", 16) + b"ftyp" + b"isom" + b"\x00" * 4,
    struct.pack(">I", 24) + b"moof" + b"\x00" * 16,
    b"#EXTM3U\n#EXT-X-TARGETDURATION:2\n",
    b'<?xml version="1.0"?>\n<MPD xmlns="urn:mpeg:dash:schema:mpd:2011">'
    b"</MPD>",
    b'<SmoothStreamingMedia TimeScale="10000000"></SmoothStreamingMedia>',
    b'<?xml version="1.0"?><tt xmlns="http://www.w3.org/ns/ttml"></tt>',
    b"\xff\xd8\xff\xe0" + b"\x00" * 16, b"\x89PNG\r\n\x1a\n" + b"\0" * 8,
    b"short",
]


def test_typefind():
    """find_type on the JAX tests' magics; make_source for the y4m and
    AIFF routes (the port's file sources) and, for a VGM stream, the
    port's gmedec with the JAX element's properties (the seven decoder
    routes are held against the JAX package in
    tests/test_torch_video_codecs.py)."""
    assert [t_typefind.find_type(m) for m in MAGICS] == [
        j_typefind.find_type(m) for m in MAGICS]
    assert t_typefind.decodable_types() == j_typefind.decodable_types()
    rng = np.random.default_rng(2)
    y4m = (b"YUV4MPEG2 W8 H4 F30:1 C420jpeg\n"
           + b"FRAME\n" + rng.integers(0, 256, 48, np.uint8).tobytes())
    for data, name in ((y4m, "y4mfilesrc"),
                       (b"FORM\0\0\0\x20AIFF" + b"\0" * 4, "aifffilesrc")):
        (jt, je), (tt, te) = (tf.make_source(data, path="/x/in")
                              for tf in (j_typefind, t_typefind))
        assert tt == jt and te.NAME == je.NAME == name
        assert te.props == je.props
    with pytest.raises(ValueError, match="file path"):
        t_typefind.make_source(y4m)
    (jt, je), (tt, te) = (tf.make_source(b"Vgm " + bytes(256))
                          for tf in (j_typefind, t_typefind))
    assert tt == jt == "audio/x-vgm" and te.NAME == je.NAME == "gmedec"
    assert te.props == je.props
    with pytest.raises(ValueError, match="unrecognized"):
        t_typefind.make_source(b"garbage here....")
    assert "gmedec" in gt.element_names()
    assert "gmedec" in gtt.element_names()


def test_subtitles():
    texts = [
        "1\n00:00:00,000 --> 00:00:00,300\nhello\n\n"
        "2\n00:00:00,500 --> 00:00:00,800\nworld\n\n",
        "WEBVTT\n\n00:00:01.000 --> 00:00:02.500 align:start\ntwo\nlines"
        "\n\n3\n01:01:01,002 --> 01:01:02,002\nlast\n",
        "\ufeff1\r\n00:00:05,000 --> 00:00:06,000\r\ncrlf\r\n\r\n"
        "bad --> stanza\nx\n\n",
    ]
    for t in texts:
        assert t_subtitles.parse_srt(t) == j_subtitles.parse_srt(t)
        assert t_subtitles.parse_srt(t.encode()) == j_subtitles.parse_srt(
            t.encode())
    for mod in (j_subtitles, t_subtitles):
        with pytest.raises(ValueError, match="no SRT"):
            mod.parse_srt("this is not a subtitle file")
    outs = []
    for mod in (j_subtitles, t_subtitles):
        srt, vtt = mod.SrtEnc(timestamp_offset_ns=5), mod.WebvttEnc()
        outs.append([srt.encode("hello", 0),
                     srt.encode("world", 61_500 * 10**6, 2 * 10**9),
                     vtt.encode("hi", 3_661_002 * 10**6),
                     vtt.encode("again", 0)])
    assert outs[1] == outs[0]
    assert tree(t_subtitles.parse_srt(texts[1])) == tree(
        j_subtitles.parse_srt(texts[1]))


def test_ivf(tmp_path):
    """typefind's IVF framing: the port's writer and parser against the
    JAX package's on ragged pushes."""
    from gstbad_tpu.io import ivf as j_ivf
    from gstbad_tpu_torch.io import ivf as t_ivf
    rng = np.random.default_rng(4)
    frames = [(i * 3000, rng.integers(0, 256, (50 + i,), np.uint8)
               .tobytes()) for i in range(5)]
    blobs = []
    for name, mod in (("j", j_ivf), ("t", t_ivf)):
        mod.write_ivf(tmp_path / f"{name}.ivf", b"AV01", 320, 240, 30000,
                      1001, frames)
        blobs.append((tmp_path / f"{name}.ivf").read_bytes())
    assert blobs[1] == blobs[0]
    parsed = []
    for mod in (j_ivf, t_ivf):
        p = mod.IvfParse()
        got = []
        for i in range(0, len(blobs[0]), 23):
            got += p.push(blobs[0][i:i + 23])
        parsed.append((got, tree(p.header), p.header.media_type))
        with pytest.raises(ValueError):
            mod.IvfParse().push(b"XXXX" + bytes(40))
    assert parsed[1] == parsed[0] and parsed[1][0] == frames
    assert t_typefind.find_type(blobs[1]) == "video/x-av1-ivf"
