"""The ADPCM codecs and audiobuffersplit of the port against the JAX
package on the CPU, bit exact: the IMA and Microsoft decoders and the IMA
encoder (the plain walks the CPU takes), adpcmenc and adpcmdec through
both packages' pipelines (an encode -> decode round trip), and
audiobuffersplit's rechunking, resync and gapless paths with state
across windows."""

import numpy as np
import pytest
import torch

import jax

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.ops import audio as jaudio
from gstbad_tpu_torch.ops import audio as taudio
from helpers.torch_audio import (batches_within, push_audio_both,
                                 run_pipelines)

torch.set_num_threads(1)


@pytest.mark.parametrize("ch,bsz", [(1, 16), (1, 256), (2, 32), (2, 256)])
def test_ima_decode(ch, bsz):
    rng = np.random.default_rng(bsz + ch)
    blocks = rng.integers(0, 256, (5, bsz), dtype=np.uint8)
    a = jax.jit(lambda b: jaudio.adpcm_ima_decode(b, ch))(blocks)
    b = taudio.adpcm_ima_decode(torch.from_numpy(blocks), ch)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert b.dtype == torch.int16


@pytest.mark.parametrize("ch,bsz", [(1, 7), (1, 256), (2, 15), (2, 256)])
def test_ms_decode(ch, bsz):
    rng = np.random.default_rng(bsz * 3 + ch)
    blocks = rng.integers(0, 256, (5, bsz), dtype=np.uint8)
    blocks[0, :ch] = 200       # a predictor index past the table
    a = jax.jit(lambda b: jaudio.adpcm_ms_decode(b, ch))(blocks)
    b = taudio.adpcm_ms_decode(torch.from_numpy(blocks), ch)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("ch", [1, 2])
def test_ima_encode(ch):
    rng = np.random.default_rng(ch)
    x = rng.integers(-32768, 32768, (4, 33, ch)).astype(np.int16)
    si0 = np.array([3, 40][:ch], np.int32)
    a = jax.jit(jaudio.adpcm_ima_encode)(x, si0)
    b = taudio.adpcm_ima_encode(torch.from_numpy(x), torch.from_numpy(si0))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(v.numpy(), np.asarray(u))


def _sine_enc(ch):
    return (f"audiotestsrc wave=sine freq=997 format=S16 rate=44100 "
            f"channels={ch} samplesperbuffer=25 ! adpcmenc "
            f"blocksize={16 * ch} ! fakesink")


@pytest.mark.parametrize("ch", [1, 2])
def test_encode_decode_round_trip(ch):
    """adpcmenc on a sine, its bytes through adpcmdec: both packages'
    blocks and samples equal, and the decode tracks the sine."""
    desc = _sine_enc(ch)
    outs = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        enc = p.run(n_frames=12, window=6)
        data = np.concatenate([np.asarray(b.data) for b in enc])
        dec = pkg.parse_launch(
            f"adpcmdec name=dec layout=dvi blocksize={data.shape[1]} rate=44100 "
            f"channels={ch} ! fakesink", **kw)
        dec.get_by_name("dec").push_bytes(data.tobytes())
        outs.append((enc, dec.run(window=5)))
    batches_within(outs[0][0], outs[1][0])
    batches_within(outs[0][1], outs[1][1])
    pcm = np.concatenate([np.asarray(b.data) for b in outs[1][1]])
    assert pcm.shape == (12, 25, ch) and pcm.dtype == np.int16
    assert np.abs(pcm.astype(int)).max() > 10000


@pytest.mark.parametrize("ch", [1, 2])
def test_ms_decoder_element(ch):
    rng = np.random.default_rng(7)
    bsz = 7 * ch + 40
    blocks = rng.integers(0, 256, (9, bsz), dtype=np.uint8)
    blocks[:, :ch] %= 7
    outs = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(f"adpcmdec name=dec layout=microsoft blocksize={bsz} "
                             f"rate=22050 channels={ch} ! fakesink", **kw)
        p.get_by_name("dec").push_bytes(blocks.tobytes())
        outs.append(p.run(window=4))
    batches_within(*outs)


def _s16(rng, n, s, c):
    return rng.integers(-32768, 32768, (n, s, c)).astype(np.int16)


@pytest.mark.parametrize("fmt", ["S16", "F32", "S32", "F64"])
def test_buffersplit_rechunks(fmt):
    rng = np.random.default_rng(4)
    dt = {"S16": np.int16, "S32": np.int32, "F32": np.float32,
          "F64": np.float64}[fmt]
    wins = [(rng.standard_normal((3, 700, 2)) * 1000).astype(dt)
            for _ in range(3)]
    (ja, _), (ta, _) = push_audio_both("audiobuffersplit", fmt, 2, 48000,
                                       wins, {"output-buffer-duration":
                                              "1/100"})
    batches_within(ja, ta)
    assert all(b.data.shape[1] == 480 for b in ta)


@pytest.mark.parametrize("props", [
    {"alignment-threshold": 1_000_000, "discont-wait": 0},
    {"gapless": True, "max-silence-time": 40_000_000},
    {"gapless": True, "max-silence-time": 5_000_000,
     "strict-buffer-size": True}])
def test_buffersplit_discont_paths(props):
    """Windows whose pts jump forward and back: the resync and the
    gapless silence and drop paths; every slot, valid or not, and the
    final states equal."""
    rng = np.random.default_rng(9)
    s, w = 480, 2
    data = _s16(rng, 8, s, 1)
    dur = 10_000_000
    pts = np.arange(8, dtype=np.int64) * dur
    pts[2:] += 25_000_000       # a gap forward
    pts[6:] -= 12_000_000       # and back
    valid = np.ones(8, bool)
    desc = "audiobuffersplit " + " ".join(
        f"{k}={v}" for k, v in props.items())
    j, t = run_pipelines(gt.parse_launch(desc),
                         gtt.parse_launch(desc, device="cpu"), 4, w,
                         spec=("S16", 1, 48000), inputs=(data, pts, valid))
    for a, b in zip(j["batches"], t["batches"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    for k in j["states"][0]:
        np.testing.assert_array_equal(t["states"][0][k], j["states"][0][k])


def test_walk_entry_points_are_registered():
    """The walks' entry points and their chain probes have ctypes
    signatures (a pointer per tensor, an int per size) and C definitions
    with as many parameters and a trailing stream (no nvcc needed)."""
    import re
    from gstbad_tpu_torch.ops import _cuda
    for src, names in (("adpcm_kernels.cu", ("gst_adpcm_ima_decode",
                                             "gst_adpcm_ms_decode",
                                             "gst_adpcm_ima_encode",
                                             "gst_adpcm_step_cycles")),
                       ("scope_kernels.cu", ("gst_scope_filter",
                                             "gst_scope_step_cycles"))):
        text = (_cuda.CSRC / src).read_text()
        for name in names:
            m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
            assert m, name
            params = [p.strip() for p in m.group(1).split(",")]
            sig = _cuda.SIGNATURES[name]
            assert len(params) == len(sig) + 1, name
            assert params[-1] == "void* stream"
            for p, t in zip(params, sig):
                assert ("void*" in p) == (t is _cuda._P), (name, p)
