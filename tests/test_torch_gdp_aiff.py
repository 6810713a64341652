"""GDP and AIFF in the port against the JAX package on the CPU: the GDP
wire (GDP 1.0 packets and the batch packets, byte for byte), gdppay and
gdpdepay, gdpfilesink and gdpfilesrc (the file's bytes and the frames read
back), AIFF/AIFC reading and writing, aifffilesrc and aifffilesink,
aiffparse, and the transcoder's pnm and gdp profiles and .gdp input,
through the class and the CLI, against tools/tpu_transcode.py's bytes.

Tolerance: bit exact (bytes, frames, pts, flags, valid).  One difference
is the JAX package's and is stated at its test: aifffilesrc's last window
when the file ends inside it.
"""

import struct

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.cli import transcode_main as jax_transcode_main
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.io import aiff as jaiff
from gstbad_tpu.io import gdp as jgdp
from gstbad_tpu.io import y4m as jy4m
from gstbad_tpu_torch.cli import transcode_main
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.io import aiff, gdp
from gstbad_tpu_torch.session import Transcoder
from helpers.torch_runtime import assert_batches_equal, run_both

torch.set_num_threads(1)   # parallel test workers share the cores


def _cpu(pkg):
    return {} if pkg is gt else {"device": "cpu"}


def test_gdp_packets_equal_the_jax_package():
    for flags in (0, 1, 2, 3):
        for data, pts in ((b"", jgdp.CLOCK_TIME_NONE), (b"x" * 77, 42),
                          (bytes(range(256)) * 3, -1)):
            assert gdp.dp_payload_buffer(data, pts=pts, duration=7,
                                         flags=flags) == \
                jgdp.dp_payload_buffer(data, pts=pts, duration=7,
                                       flags=flags)
        caps = "video/x-raw, format=(string)I420, width=(int)64"
        assert gdp.dp_payload_caps(caps, flags) == \
            jgdp.dp_payload_caps(caps, flags)
        assert gdp.dp_payload_event(1, "", flags=flags) == \
            jgdp.dp_payload_event(1, "", flags=flags)
    pkt = gdp.dp_payload_buffer(b"abc", pts=5, flags=3)
    assert list(gdp.dp_depay(pkt)) == list(jgdp.dp_depay(pkt))
    bad = bytearray(pkt)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="crc"):
        list(gdp.dp_depay(bytes(bad)))


@pytest.mark.parametrize("planar", [False, True])
def test_batch_pay_and_depay_equal_the_jax_package(planar):
    rng = np.random.default_rng(3)
    if planar:
        data = {"y": rng.integers(0, 256, (3, 6, 8), dtype=np.uint8),
                "u": rng.integers(0, 256, (3, 3, 4), dtype=np.uint8),
                "v": rng.integers(0, 256, (3, 3, 4), dtype=np.uint8)}
        fmt = "I420"
    else:
        data = rng.integers(0, 256, (3, 6, 8, 4), dtype=np.uint8)
        fmt = "BGRx"
    pts = np.array([0, 33, -5], np.int64)
    flags = np.array([1, 0, 4], np.int32)
    valid = np.array([True, False, True])
    tree = ({k: torch.from_numpy(v) for k, v in data.items()} if planar
            else torch.from_numpy(data))
    batch = FrameBatch(data=tree, pts=torch.from_numpy(pts),
                       flags=torch.from_numpy(flags),
                       valid=torch.from_numpy(valid))
    from gstbad_tpu.core.frame import FrameBatch as JFrameBatch
    jbatch = JFrameBatch(data=data, pts=pts, flags=flags, valid=valid)
    blob = gdp.pay(batch, MediaSpec(kind="video", format=fmt, width=8,
                                    height=6))
    assert blob == jgdp.pay(jbatch, JMediaSpec(kind="video", format=fmt,
                                              width=8, height=6))
    assert gdp.pay(batch.to_numpy(), MediaSpec(
        kind="video", format=fmt, width=8, height=6)) == blob
    back, spec = gdp.depay(blob)
    jback, jspec = jgdp.depay(blob)
    assert str(spec) == str(jspec)
    assert_batches_equal([jback], [back.to_numpy()])


def test_gdppay_and_gdpdepay_equal_the_jax_elements():
    streams = []
    for pkg in (gt, gtt):
        pay = pkg.make("gdppay", **{"crc-payload": True})
        pay.set_caps("video/x-raw, format=(string)I420, width=(int)32")
        s = pay.chain(b"frame0", pts=0)
        s += pay.chain(b"frame1" * 100, pts=1000, duration=33,
                       buf_flags=0x40)
        s += pay.event_eos()
        streams.append(s)
    assert streams[0] == streams[1]
    outs = []
    for pkg in (gt, gtt):
        dep = pkg.make("gdpdepay")
        got = []
        for i in range(0, len(streams[0]), 37):   # arbitrary chunking
            got += dep.chain(streams[0][i:i + 37])
        outs.append((got, dep.caps, dep.events))
    assert outs[0] == outs[1] and len(outs[1][0]) == 2
    assert outs[1][2] == [1]


@pytest.mark.parametrize("desc,n", [
    ("videotestsrc pattern=ball width=16 height=12 format=I420", 10),
    ("videotestsrc pattern=ball width=16 height=12 format=BGRx", 8),
    ("audiotestsrc samplesperbuffer=128 format=S16", 6)])
def test_gdp_files_equal_the_jax_elements(tmp_path, desc, n):
    files = {}
    for pkg in (gt, gtt):
        path = tmp_path / f"{pkg.__name__}.gdp"
        p = pkg.parse_launch(f"{desc} ! gdpfilesink location={path}",
                             **_cpu(pkg))
        p.run(n_frames=n, window=4)
        p.close()
        files[pkg] = path
    assert files[gt].read_bytes() == files[gtt].read_bytes()
    (jp, jres), (tp, tres) = run_both(
        f"gdpfilesrc location={files[gt]} ! identity ! fakesink", 0, 4)
    assert_batches_equal(jres, tres)
    assert sum(b.batch for b in tres) == -(-n // 4) * 4   # whole windows


def test_gdpfilesrc_checkpoint_resumes_at_the_next_packet(tmp_path):
    path = tmp_path / "s.gdp"
    p = gtt.parse_launch("videotestsrc pattern=ball width=8 height=8 ! "
                         f"gdpfilesink location={path}", device="cpu")
    p.run(n_frames=12, window=4)
    p.close()
    desc = f"gdpfilesrc location={path} ! fakesink"
    whole = gtt.parse_launch(desc, device="cpu").run(window=4)
    p = gtt.parse_launch(desc, device="cpu")
    p.compile(4)
    first = p.pull_inputs(4)
    p.save_checkpoint(tmp_path / "ck.pkl")
    q = gtt.parse_launch(desc, device="cpu")
    q.negotiate()
    q.load_checkpoint(tmp_path / "ck.pkl")
    rest = q.run(window=4)
    assert_batches_equal(whole[1:], rest)
    assert torch.equal(first.pts, torch.from_numpy(whole[0].pts))


@pytest.mark.parametrize("fmt,dtype", [("S16", np.int16), ("S32", np.int32),
                                       ("F32", np.float32),
                                       ("F64", np.float64),
                                       ("S8", np.int8)])
def test_aiff_files_equal_the_jax_writer_and_reader(tmp_path, fmt, dtype):
    rng = np.random.default_rng(9)
    samples = (rng.standard_normal((301, 2)) * 20000).clip(
        -100 if dtype == np.int8 else -30000,
        100 if dtype == np.int8 else 30000).astype(dtype)
    a, b = tmp_path / "t.aiff", tmp_path / "j.aiff"
    aiff.write_aiff(a, MediaSpec(kind="audio", format=fmt, rate=44100,
                                 channels=2), samples)
    jaiff.write_aiff(b, JMediaSpec(kind="audio", format=fmt, rate=44100,
                                   channels=2), samples)
    assert a.read_bytes() == b.read_bytes()
    spec, got = aiff.read_aiff(a)
    jspec, jgot = jaiff.read_aiff(str(a))
    assert str(spec) == str(jspec) and got.dtype == jgot.dtype
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(got, samples)
    for rate in (8000.0, 22050.0, 44100.0, 96000.0, 11025.5):
        assert aiff.write_ieee80(rate) == jaiff.write_ieee80(rate)
        assert aiff.read_ieee80(aiff.write_ieee80(rate)) == rate


def _aifc_sowt_s24():
    """A hand-built AIFC (sowt: little-endian S16) and a big-endian S24
    AIFF, the reader's two byte-order paths."""
    def chunk(tag, payload):
        return tag + struct.pack(">I", len(payload)) + payload + (
            b"\x00" if len(payload) & 1 else b"")
    data = np.array([[1000, -2000], [32767, -32768]], np.int16)
    comm = (struct.pack(">HIH", 2, 2, 16) + aiff.write_ieee80(22050.0)
            + b"sowt")
    body = b"AIFC" + chunk(b"COMM", comm) + chunk(
        b"SSND", struct.pack(">II", 0, 0) + data.astype("<i2").tobytes())
    sowt = b"FORM" + struct.pack(">I", len(body)) + body
    raw = b"".join(int(v).to_bytes(3, "big", signed=True)
                   for v in (-(1 << 23), (1 << 23) - 1, -1))
    comm = struct.pack(">HIH", 1, 3, 24) + aiff.write_ieee80(48000.0)
    body = b"AIFF" + chunk(b"COMM", comm) + chunk(
        b"SSND", struct.pack(">II", 0, 0) + raw)
    return sowt, b"FORM" + struct.pack(">I", len(body)) + body


def test_aiffparse_equals_the_jax_element():
    for blob in _aifc_sowt_s24():
        outs = []
        for pkg in (gt, gtt):
            el = pkg.make("aiffparse")
            el.chain(blob[:11])
            el.chain(blob[11:])
            outs.append(el.finish())
        assert outs[0]["caps"] == outs[1]["caps"]
        np.testing.assert_array_equal(outs[1]["data"], outs[0]["data"])
        assert outs[1]["data"].dtype == outs[0]["data"].dtype


@pytest.mark.parametrize("n_samples,fmt", [(2048, "S16"), (1536, "F32"),
                                           (1024, "S8")])
def test_aiff_file_elements_equal_the_jax_elements(tmp_path, n_samples,
                                                   fmt):
    """aifffilesrc ! identity ! aifffilesink: the file read in blocks of
    256 samples (windows of 4) and written back.  Where the file ends on a
    window's last block both packages give the same windows and files; the
    file ends inside a window at 1536 samples: the JAX element then fills
    the window with valid zero blocks that repeat the last pts (a
    reference-side issue, ROADMAP queue 3), which it writes out too, and
    the port marks them invalid."""
    rng = np.random.default_rng(n_samples)
    dt = {"S16": np.int16, "F32": np.float32, "S8": np.int8}[fmt]
    samples = (rng.standard_normal((n_samples, 2)) * 100).astype(dt)
    src = tmp_path / "in.aiff"
    aiff.write_aiff(src, MediaSpec(kind="audio", format=fmt, rate=48000,
                                   channels=2), samples)
    res, files = {}, {}
    for pkg in (gt, gtt):
        files[pkg] = tmp_path / f"{pkg.__name__}.aiff"
        p = pkg.parse_launch(f"aifffilesrc location={src} "
                             "samplesperbuffer=256 ! identity ! "
                             f"aifffilesink location={files[pkg]}",
                             **_cpu(pkg))
        res[pkg] = p.run(window=4)
        p.close()
    n_blocks = n_samples // 256
    if n_blocks % 4 == 0:
        assert_batches_equal(res[gt], res[gtt])
        assert files[gt].read_bytes() == files[gtt].read_bytes()
    else:
        got = np.concatenate([b.data for b in res[gtt]])
        want = np.concatenate([np.asarray(b.data) for b in res[gt]])
        np.testing.assert_array_equal(got, want[:n_blocks])
        assert not want[n_blocks:].any()
    _, back = aiff.read_aiff(files[gtt])
    np.testing.assert_array_equal(back, samples.astype(
        np.int16 if fmt == "S8" else dt))


def _y4m(path, n=10, w=32, h=24, seed=1):
    rng = np.random.default_rng(seed)
    planes = {"y": rng.integers(0, 256, (n, h, w), dtype=np.uint8),
              "u": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
              "v": rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8)}
    jy4m.write_y4m(str(path), JMediaSpec(kind="video", format="I420",
                                         width=w, height=h), planes)
    return planes


@pytest.mark.parametrize("profile,filters,dest", [
    ("gdp", "", "o.gdp"),
    ("gdp:BGRx", "", "o.gdp"),
    ("gdp", "videoconvert format=AYUV ! gaussianblur sigma=1.5", "o.gdp"),
    ("pnm:RGB", "", "o_%d.pnm"),
    ("pnm:GRAY8", "", "o_%03d.pgm"),
    ("pnm", "videoconvert format=BGRx ! solarize", "o_%d.ppm")])
def test_transcoder_profiles_equal_tpu_transcode(tmp_path, profile, filters,
                                                 dest):
    src = tmp_path / "in.y4m"
    _y4m(src)
    out = {}
    for name, main in (("jax", jax_transcode_main),
                       ("torch", transcode_main)):
        d = tmp_path / name
        d.mkdir()
        args = [str(src), str(d / dest), "--profile", profile,
                "--window", "4"] + (["--filters", filters] if filters
                                    else [])
        assert main(args + (["--cpu"] if name == "jax"
                            else ["--device", "cpu"])) == 0
        out[name] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    assert out["jax"] == out["torch"]
    assert len(out["torch"]) == (1 if profile.startswith("gdp") else 10)


@pytest.mark.parametrize("profile", ["y4m", "gdp", "pnm:RGB"])
def test_gdp_input_transcodes_as_the_jax_transcoder(tmp_path, profile):
    """A .gdp file in (caps on the wire), each profile out, against the
    JAX Transcoder; the y4m -> gdp -> y4m round trip gives the input's
    bytes back."""
    src = tmp_path / "in.y4m"
    _y4m(src, n=9)
    mid = tmp_path / "mid.gdp"
    Transcoder(str(src), str(mid), profile="gdp", window=4,
               device="cpu").run()
    dest = "o.y4m" if profile == "y4m" else (
        "o.gdp" if profile == "gdp" else "o_%d.ppm")
    out = {}
    from gstbad_tpu.session import Transcoder as JTranscoder
    for name, cls, kw in (("jax", JTranscoder, {}),
                          ("torch", Transcoder, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        t = cls(str(mid), str(d / dest), profile=profile, window=3, **kw)
        assert t.run() == 9
        out[name] = ({f.name: f.read_bytes() for f in sorted(d.iterdir())},
                     [(m.name, m.pts, m.fields) for m in t.bus.messages])
    assert out["jax"] == out["torch"]
    if profile == "y4m":
        assert (tmp_path / "torch" / dest).read_bytes() == src.read_bytes()
