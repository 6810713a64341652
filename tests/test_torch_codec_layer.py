"""The stateless-decoder base layer (codecs/{h264,h265,mpeg2,vp8,vp9,av1})
and the VP8 frame-header parser (io/vp8.py, io/_vp8_tables.py) of
gstbad_tpu and gstbad_tpu_torch: the JAX tests of the six engines and of
the parser run on both packages side by side (helpers/twin.py; libavcodec,
the tests' oracle, through the JAX package's io/codecoracle.py), and the
six engines over the streams chip_smoke.py's phase 4o hands them (those of
phase 4l's parsers): each picture's frame number and POC in output order,
equal in both packages."""

import inspect

import pytest

import chip_smoke
import test_codec_engines as tengines
import test_h264dec as th264dec
import test_h265dec as th265dec
import test_vp8parser as tvp8parser
import test_vp9dec as tvp9dec
from gstbad_tpu.codecs import av1 as jav1
from gstbad_tpu.codecs import h264 as jh264
from gstbad_tpu.codecs import h265 as jh265
from gstbad_tpu.codecs import mpeg2 as jmpeg2
from gstbad_tpu.codecs import vp8 as jvp8
from gstbad_tpu.codecs import vp9 as jvp9
from gstbad_tpu.io import h264 as jioh264
from gstbad_tpu.io import h265nal as jh265nal
from gstbad_tpu.io import mpegvideo as jmpegvideo
from gstbad_tpu.io import vp8 as jiovp8
from gstbad_tpu.io import vp9 as jiovp9
from gstbad_tpu_torch.codecs import av1, h264, h265, mpeg2, vp8, vp9
from gstbad_tpu_torch.io import h264 as ioh264
from gstbad_tpu_torch.io import h265nal, mpegvideo
from gstbad_tpu_torch.io import vp8 as iovp8
from gstbad_tpu_torch.io import vp9 as iovp9
from helpers.twin import Twin, jax_test_cases

_NAMES = {
    th264dec: {"dec": (jh264, h264),
               "H264Decoder": (jh264.H264Decoder, h264.H264Decoder),
               "h": (jioh264, ioh264)},
    th265dec: {"H265Decoder": (jh265.H265Decoder, h265.H265Decoder),
               "hv": (jh265nal, h265nal)},
    tvp9dec: {"cvp9": (jvp9, vp9), "iovp9": (jiovp9, iovp9)},
    tvp8parser: {"vp8": (jiovp8, iovp8)},
    tengines: {"Av1Decoder": (jav1.Av1Decoder, av1.Av1Decoder),
               "Mpeg2Decoder": (jmpeg2.Mpeg2Decoder, mpeg2.Mpeg2Decoder),
               "Vp8Decoder": (jvp8.Vp8Decoder, vp8.Vp8Decoder),
               "mv": (jmpegvideo, mpegvideo)}}


# left out: get_qindex's case, which fills the lists inside a
# SegmentationParams by index (a Twin hands such an item on as the JAX
# side's list); test_vp9_qindex_abs_vs_delta below holds both packages
NOT_HERE = ("test_qindex_abs_vs_delta",)


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(
    _NAMES, NOT_HERE, fixtures=("recwarn",)))
def test_jax_codec_layer_test_runs_on_both(monkeypatch, recwarn, mod, fn,
                                           kwargs):
    """Every JAX test of the six engines and of the VP8 parser with its
    module names bound to the JAX package's and the port's side by side:
    each call's result (the output pictures, the DPB, the parsed headers),
    or error, equal; the JAX test's own assertions on top."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    if "recwarn" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, recwarn=recwarn)
    fn(**kwargs)


def test_vp9_qindex_abs_vs_delta():
    """test_vp9dec.py's get_qindex case (8.6.1: a delta adds to the base,
    an absolute value replaces it) on each package's own objects."""
    got = []
    for mod in (jvp9, vp9):
        seg = mod.SegmentationParams()
        quant = mod.QuantizationParams(base_q_idx=100)
        row = [mod.get_qindex(seg, quant, 0)]
        seg.segmentation_enabled = 1
        seg.feature_enabled[3][mod.SEG_LVL_ALT_Q] = 1
        seg.feature_data[3][mod.SEG_LVL_ALT_Q] = -30
        row += [mod.get_qindex(seg, quant, 3), mod.get_qindex(seg, quant, 0)]
        seg.segmentation_abs_or_delta_update = 1
        row.append(mod.get_qindex(seg, quant, 3))
        seg.feature_data[3][mod.SEG_LVL_ALT_Q] = 200
        row.append(mod.get_qindex(seg, quant, 3))
        got.append(row)
    assert got[0] == got[1] == [100, 70, 100, 0, 200]


def jax_engines():
    """The JAX package's DPB engines in chip_smoke.port_engines()'s form."""
    return ({"h264": jh264.H264Decoder, "h265": jh265.H265Decoder,
             "mpeg2": jmpeg2.Mpeg2Decoder, "vp9": jvp9.Vp9Decoder,
             "av1": jav1.Av1Decoder}, jiovp9.split_superframe)


@pytest.fixture(scope="module")
def streams():
    return chip_smoke.dpb_streams()


@pytest.mark.parametrize("codec", ["h264", "h265", "mpeg2", "vp9", "av1"])
def test_engines_over_phase_4o_streams_equal_the_jax_package(streams,
                                                             codec):
    """chip_smoke.dpb_orders over phase 4o's streams: the port's engines
    put out the pictures the JAX package's do, in the same order with the
    same POCs, and something for each stream."""
    one = {codec: streams[codec]}
    got = chip_smoke.dpb_orders(one)[codec]
    want = chip_smoke.dpb_orders(one, jax_engines())[codec]
    assert got == want
    assert got and len({n for n, _ in got}) == len(got)


def test_vp8_has_no_phase_4o_stream(streams):
    """Phase 4l feeds no VP8 parser, so phase 4o prints VP8's engine as
    not run."""
    assert streams["vp8"] is None
    assert chip_smoke.dpb_orders(streams)["vp8"] is None


def test_h264_engine_output_is_poc_order_per_idr(streams):
    """Over the seeded H.264 stream (an IDR a second), the output restarts
    at POC 0 on each IDR and rises within each second, in both
    packages."""
    got = chip_smoke.dpb_orders({"h264": streams["h264"]})["h264"]
    starts = [i for i, (_, poc) in enumerate(got) if poc == 0]
    assert len(starts) == chip_smoke.TS_SECONDS
    for a, b in zip(starts, starts[1:] + [len(got)]):
        pocs = [poc for _, poc in got[a:b]]
        assert pocs == sorted(pocs)
