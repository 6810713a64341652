"""Files in the port against the JAX package on the CPU: the y4m reader
and writer (the bytes equal the JAX writer's), y4mfilesrc/y4mfilesink,
filesink and multifilesink, and the transcoder through its class and its
CLI: the output y4m byte for byte the JAX Transcoder's on the verify
chain, y4m:GRAY8, the position messages, and the hevc and av1 profiles'
graphs (their streams are held in test_torch_video_codecs.py; pnm and gdp
in test_torch_gdp_aiff.py)."""

import numpy as np
import pytest
import torch

from gstbad_tpu.io import y4m as jy4m
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.session import Transcoder as JTranscoder
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.cli import transcode_main
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.io import y4m
from gstbad_tpu_torch.session import Transcoder

torch.set_num_threads(1)   # parallel test workers share the cores

CHAIN = ("videoconvert format=AYUV ! gaussianblur sigma=2 "
         "! videoconvert format=I420")


def _planes(n=12, w=64, h=48, seed=7):
    rng = np.random.default_rng(seed)
    return {"y": rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            "u": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            "v": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)}


@pytest.fixture
def src(tmp_path):
    path = tmp_path / "in.y4m"
    y4m.write_y4m(path, MediaSpec(kind="video", format="I420", width=64,
                                  height=48), _planes())
    return path


def test_y4m_round_trip_bytes_equal_the_jax_writer(tmp_path):
    from fractions import Fraction
    planes = _planes(n=3, w=10, h=6)
    for fr in (Fraction(30), Fraction(30000, 1001)):
        a, b = tmp_path / "t.y4m", tmp_path / "j.y4m"
        y4m.write_y4m(a, MediaSpec(kind="video", format="I420", width=10,
                                   height=6, framerate=fr), planes)
        jy4m.write_y4m(b, JMediaSpec(kind="video", format="I420", width=10,
                                     height=6, framerate=fr), planes)
        assert a.read_bytes() == b.read_bytes()
        spec, back = y4m.read_y4m(a)
        jspec, jback = jy4m.read_y4m(a.read_bytes())
        assert str(spec) == str(jspec) and spec.framerate == fr
        for k in planes:
            np.testing.assert_array_equal(back[k], planes[k])
            np.testing.assert_array_equal(jback[k], back[k])


def test_y4mfilesrc_to_y4mfilesink_equals_jax(src, tmp_path):
    outs = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        dest = tmp_path / f"{pkg.__name__}.y4m"
        p = pkg.parse_launch(f"y4mfilesrc location={src} ! {CHAIN} "
                             f"! y4mfilesink location={dest}", **kw)
        p.run(window=5)
        p.close()
        outs.append(dest.read_bytes())
    assert outs[0] == outs[1] and len(outs[1]) > 12 * 64 * 48


def test_filesink_equals_jax(src, tmp_path):
    outs = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        dest = tmp_path / f"{pkg.__name__}.raw"
        p = pkg.parse_launch(f"y4mfilesrc location={src} ! videoconvert "
                             f"format=BGRx ! filesink location={dest}", **kw)
        p.run(window=5)
        p.close()
        outs.append(dest.read_bytes())
    assert outs[0] == outs[1] and len(outs[1]) == 12 * 64 * 48 * 4


def test_multifilesink_equals_jax(src, tmp_path):
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        d = tmp_path / pkg.__name__
        d.mkdir()
        p = pkg.parse_launch(f"y4mfilesrc location={src} ! "
                             f"multifilesink location={d}/f%03d.raw", **kw)
        p.run(window=8)
    names = sorted(x.name for x in (tmp_path / "gstbad_tpu").iterdir())
    assert names == [f"f{i:03d}.raw" for i in range(12)]
    for name in names:
        assert ((tmp_path / "gstbad_tpu" / name).read_bytes()
                == (tmp_path / "gstbad_tpu_torch" / name).read_bytes())


def test_transcoder_output_equals_jax(src, tmp_path):
    JTranscoder(str(src), str(tmp_path / "j.y4m"), CHAIN, window=5).run()
    t = Transcoder(str(src), str(tmp_path / "t.y4m"), CHAIN, window=5,
                   device="cpu")
    assert t.run() == 12
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()


def test_transcode_cli_output_equals_jax(src, tmp_path, capsys):
    JTranscoder(str(src), str(tmp_path / "j.y4m"), CHAIN, window=8).run()
    rc = transcode_main([str(src), str(tmp_path / "t.y4m"), "--filters",
                         CHAIN, "--window", "8", "--device", "cpu"])
    assert rc == 0 and "wrote 12 frames" in capsys.readouterr().err
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()


def test_transcoder_gray8_profile_equals_jax(src, tmp_path):
    """y4m:GRAY8 appends videoconvert format=GRAY8; the y4m writer needs
    planar output, so both packages refuse it the same way."""
    with pytest.raises(ValueError, match="planar"):
        JTranscoder(str(src), str(tmp_path / "j.y4m"),
                    profile="y4m:GRAY8").run()
    with pytest.raises(ValueError, match="planar"):
        Transcoder(str(src), str(tmp_path / "t.y4m"), profile="y4m:GRAY8",
                   device="cpu").run()
    JTranscoder(str(src), str(tmp_path / "j.y4m"), "videoconvert "
                "format=GRAY8", profile="y4m:I420").run()
    Transcoder(str(src), str(tmp_path / "t.y4m"), "videoconvert "
               "format=GRAY8", profile="y4m:I420", device="cpu").run()
    assert (tmp_path / "t.y4m").read_bytes() == \
        (tmp_path / "j.y4m").read_bytes()


def test_transcoder_positions_equal_jax(src, tmp_path):
    seen = {}
    for name, cls, kw in (("jax", JTranscoder, {}),
                          ("torch", Transcoder, {"device": "cpu"})):
        calls = []
        t = cls(str(src), str(tmp_path / f"{name}.y4m"), window=5,
                on_position=lambda pos, total: calls.append((pos, total)),
                **kw)
        t.run()
        seen[name] = (calls, [(m.element, m.name, m.pts, m.fields)
                              for m in t.bus.messages])
    assert seen["jax"] == seen["torch"]
    calls = seen["torch"][0]
    assert len(calls) == 3 and calls[-1][1] == 12 * 33333333


@pytest.mark.parametrize("profile", ["hevc:qp=24", "av1"])
def test_profiles_not_yet_ported_raise(src, tmp_path, profile):
    """The hevc and av1 profiles, which raised until their encoders were
    ported, now build the JAX transcoder's graph: the same elements with
    the same properties (their streams are held against the JAX
    package's in tests/test_torch_video_codecs.py)."""
    j = JTranscoder(str(src), str(tmp_path / "o_%d.pnm"), profile=profile)
    t = Transcoder(str(src), str(tmp_path / "o_%d.pnm"), profile=profile,
                   device="cpu")
    assert [(n.element.NAME, n.element.props) for n in t.pipeline.nodes] \
        == [(n.element.NAME, n.element.props) for n in j.pipeline.nodes]
    assert t.codec_opt == j.codec_opt and t.out_format is None


def test_unknown_profile_raises(src, tmp_path):
    with pytest.raises(ValueError, match="unknown profile"):
        Transcoder(str(src), str(tmp_path / "o.y4m"), profile="mkv",
                   device="cpu")


def test_transcoder_reads_y4m_only(tmp_path):
    # .y4m and .gdp inputs are read (tests/test_torch_gdp_aiff.py)
    with pytest.raises(ValueError, match=".y4m or .gdp"):
        Transcoder(str(tmp_path / "in.mp4"), str(tmp_path / "o.y4m"),
                   device="cpu")
