"""The eleven elementary-stream parsers (h264parse, h265parse,
mpegvideoparse, av1parse, vp9parse, mpeg4videoparse, h263parse,
jpeg2000parse, vc1parse, pngparse, diracparse) and their io modules
through gstbad_tpu and gstbad_tpu_torch on the same streams: every
output buffer, its flags and the caps, under several chunkings and
output formats (the scenarios of tests/test_h264parse.py,
test_h265parse.py, test_mpegvideoparse.py, test_vp9_av1_parse.py,
test_mpeg4videoparse.py, test_h263parse.py, test_jpeg2000parse.py,
test_vc1parse.py and test_pngdirac_parse.py); and those JAX test files
run on both packages side by side, with their upstream golden vectors."""

import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_h263parse as t263
import test_h264parse as t264
import test_h265parse as t265
import test_jpeg2000parse as tj2k
import test_mpeg4videoparse as tm4
import test_mpegvideoparse as tmpv
import test_pngdirac_parse as tpng
import test_vc1parse as tvc1
import test_vp9_av1_parse as tva
from helpers.torch_transport import JAX, TORCH, assert_both
from helpers.twin import Twin, jax_test_cases


def run_parser(pkg, name, stream, step=None, props=None, caps=None,
               output=None, finish=True, pts_ns=None):
    """Push `stream` in chunks of `step` bytes through a fresh element;
    every output buffer, then the caps and the element's own fields."""
    el = pkg.make(name, **(props or {}))
    if caps is not None:
        el.set_caps(*caps[0], **caps[1])
    if output is not None:
        el.set_output(*output[0], **output[1])
    feed = el.chain if name == "vc1parse" else el.push
    kw = {} if pts_ns is None else {"pts_ns": pts_ns}
    outs = []
    step = step or len(stream) or 1
    for i in range(0, len(stream), step):
        outs += feed(stream[i:i + step], **kw)
    if finish:
        outs += el.finish(**kw)
    return outs, el.src_caps, _fields(el)


def _fields(el):
    """The element's own public fields (the port's elements also hold
    the pipeline's `device`)."""
    return {k: v for k, v in vars(el).items()
            if not k.startswith("_") and k != "device"}


def A(*args, **kw):
    return (args, kw)


# (name, stream, runner options); each case runs through both packages
H264_STREAMS = [
    (t264.STREAM, {"output": A("byte-stream", "au")}),
    (t264.H264_SEI_CLLI + t264.H264_SEI_MDCV + t264.STREAM, {}),
    ((t264.H264_AUD + t264.STREAM) * 3, {"step": 5}),
    ((t264.H264_AUD + t264.STREAM) * 3, {"step": 17}),
    (b"\xde\xad" * 32 + t264.STREAM, {}),
    (t264.STREAM + t264.H264_AUD, {"output": A("avc", "au")}),
    (t264.STREAM, {"output": A("byte-stream", "nal")}),
    (t264.STREAM + t264.H264_IDRFRAME, {}),
    (t264.STREAM * 2, {"props": {"config-interval": -1},
                       "output": A("byte-stream", "au"), "pts_ns": 0}),
]
H265_STREAMS = [
    (t265.STREAM16 + t265.H265_128_IDR, {}),
    (t265.H265_SEI_CLLI + t265.H265_SEI_MDCV + t265.STREAM16
     + t265.H265_128_IDR, {}),
    ((t265.H265_128_VPS + t265.H265_128_SPS + t265.H265_128_PPS
      + t265.H265_128_IDR) * 3, {"step": 7}),
    (t265.H265_128_VPS + t265.H265_128_SPS + t265.H265_128_PPS
     + t265.H265_128_IDR * 2, {}),
    ((t265.H265_S_VPS + t265.H265_S_SPS + t265.H265_S_PPS
      + t265.H265_S_SLICE1 + t265.H265_S_SLICE2) * 2, {"step": 3}),
    (t265.STREAM16 + t265.H265_128_IDR, {"output": A("hvc1", "au")}),
    (t265.STREAM16 + t265.H265_128_IDR, {"output": A("byte-stream",
                                                     "nal")}),
]
MPV_STREAMS = [
    (tmpv.MPEG2_SEQ + tmpv.MPEG2_IFRAME, {}),
    (tmpv.MPEG1_SEQ + tmpv.MPEG1_IFRAME, {}),
    (tmpv.MPEG2_SEQ + tmpv.MPEG2_IFRAME * 3, {"step": 7}),
    (tmpv.MPEG2_SEQ + tmpv.MPEG2_IFRAME, {"props": {"gop-split": True}}),
    (open(tmpv.CC_FILE, "rb").read(), {"step": 4096}),
]


def _vp9():
    return tva._vp9_frames()[0]


def _av1():
    return tva._av1_streams()[0]


AV1_STREAMS = [
    (lambda: _av1()["stream_no_annexb_av1"], {
        "step": 1000, "output": A("obu-stream", "frame")}),
    (lambda: _av1()["stream_no_annexb_av1"], {"output": A("annexb",
                                                          "tu")}),
    (lambda: _av1()["stream_annexb_av1"], {
        "caps": A("annexb"), "output": A("obu-stream", "obu")}),
    (lambda: _av1()["stream_annexb_av1"], {
        "caps": A("annexb"), "output": A("obu-stream", "frame")}),
    (lambda: (tva._obu(2, b"") + tva._tg_seq_header()
              + tva._tg_key_frame_header(0) + tva._tg_obu(0, 1)
              + tva._tg_obu(2, 3) + tva._obu(2, b"")
              + tva._tg_key_frame_header(1) + tva._tg_obu(0, 3)), {
        "step": 9, "output": A("obu-stream", "frame")}),
]
M4_STREAMS = [
    (tm4.MPEG4_CONFIG + tm4.MPEG4_IFRAME, {}),
    (tm4.MPEG4_CONFIG + tm4.MPEG4_IFRAME * 3, {"step": 7}),
    (tm4.MPEG4_CONFIG + tm4.MPEG4_IFRAME * 2, {
        "props": {"config-interval": -1}, "pts_ns": 0}),
]
H263_STREAMS = [
    (t263.H263_IFRAME * 5, {"step": 13}),
    (b"\xde\xad\xbe\xef" * 8 + t263.H263_IFRAME, {}),
]
J2K_STREAMS = [
    (lambda: tj2k._vec("rgb_32_32_j2k"), {"finish": False}),
    (lambda: tj2k._vec("mono_32_32_j2k"), {"finish": False}),
    (lambda: tj2k._vec("rgb_32_32_j2c"), {"finish": False}),
    (lambda: tj2k._vec("rgb_32_32_jp2"), {"finish": False}),
    (lambda: tj2k._vec("rgb_32_32_j2k") * 3, {"step": 17}),
]
PNG_STREAMS = [
    (tpng.make_png(64, 48) * 2, {}),
    (b"junk\x89PNGnope garbage" + tpng.make_png(16, 8), {"step": 7}),
    (tpng.make_png(10, 10) + tpng.make_png(20, 5), {
        "caps": A(framerate=(30, 1))}),
    (tpng.make_png(4, 4, extra_chunks=((b"tEXt", b"Comment\x00hi"),)),
     {"finish": False}),
]

ELEMENT_CASES = (
    [("h264parse", s, o) for s, o in H264_STREAMS]
    + [("h265parse", s, o) for s, o in H265_STREAMS]
    + [("mpegvideoparse", s, o) for s, o in MPV_STREAMS]
    + [("av1parse", s, o) for s, o in AV1_STREAMS]
    + [("vp9parse", lambda i=i: _vp9()[i], {"finish": False})
       for i in range(3)]
    + [("vp9parse", lambda: b"".join(_vp9()[:3]), {
        "finish": False, "output": A("super-frame")})]
    + [("mpeg4videoparse", s, o) for s, o in M4_STREAMS]
    + [("h263parse", s, o) for s, o in H263_STREAMS]
    + [("jpeg2000parse", s, o) for s, o in J2K_STREAMS]
    + [("pngparse", s, o) for s, o in PNG_STREAMS]
)


def _element_case(pkg, i):
    name, stream, opts = ELEMENT_CASES[i]
    stream = stream() if callable(stream) else stream
    return run_parser(pkg, name, stream, **opts)


@pytest.mark.parametrize("i", range(len(ELEMENT_CASES)),
                         ids=[c[0] for c in ELEMENT_CASES])
def test_parser_element_parity(i):
    assert_both(_element_case, i)


def test_vp9_superframe_members_in_one_element():
    """vp9parse keeps its state across pushes: the three frames pushed
    one after another into ONE element, in both packages."""
    def scenario(pkg):
        el = pkg.make("vp9parse")
        return [el.push(f) for f in _vp9()[:3]], el.src_caps
    kind, (outs, caps) = assert_both(scenario)
    assert len(outs) == 3


# ----------------------------------------------------------- io modules

def _split(pkg, raw):
    return pkg.io("h264").split_bytestream(raw)[0]


def h264_io(pkg):
    h = pkg.io("h264")
    sps = h.parse_sps(_split(pkg, t264.H264_SPS))
    nals = [_split(pkg, x) for x in (t264.H264_SPS, t264.H264_PPS,
                                     t264.H264_IDRFRAME)]
    return (sps, h.profile_name(sps.profile_idc, sps.constraint_flags),
            h.level_name(sps.level_idc, sps.constraint_flags),
            h.build_avcc(nals[:1], nals[1:2]),
            h.parse_avcc(t264.H264_AVC_CODEC_DATA),
            [h.parse_sei(_split(pkg, x)) for x in (
                t264.H264_SEI_CLLI, t264.H264_SEI_MDCV,
                t264.H264_SEI_BUFFERING)],
            h.parse_pps(nals[1]), h.first_mb_in_slice(nals[2]),
            h.to_avc(nals), h.split_avc(h.to_avc(nals)),
            h.to_bytestream(nals), [h.nal_type(n) for n in nals])


def h264_tables(pkg):
    h = pkg.io("h264")
    return ([h.level_name(lv, f) for lv in (9, 10, 11, 12, 13, 20, 21, 22,
                                            30, 31, 32, 40, 41, 42, 50,
                                            51, 52, 60, 61, 62)
             for f in (0, 0x08, 0x10)],
            [h.compatible_profiles(p, f)
             for p in (66, 77, 88, 100, 110, 122, 244, 44)
             for f in (0, 0x80, 0x40, 0x80 | 0x40, 0x10)],
            [h.profile_name(p, f) for p in (66, 77, 88, 100, 110, 122, 244,
                                            44, 83, 86, 118, 128, 138, 139,
                                            134, 135, 1)
             for f in (0, 0x40, 0x10, 0x08)],
            [h.remove_emulation(x) for x in (
                b"\x00\x00\x03\x01", b"\x00\x00\x03\x00\x00\x03",
                b"\x01\x02\x03", b"\x00\x00\x03", b"")])


def h264_slice_headers(pkg):
    h = pkg.io("h264")
    sps = h.parse_sps(_split(pkg, t264.H264_SPS))
    pps = h.parse_pps(_split(pkg, t264.H264_PPS))
    return h.parse_slice_header(_split(pkg, t264.H264_IDRFRAME),
                                {sps.sps_id: sps}, {pps.pps_id: pps})


def h265_io(pkg):
    h = pkg.io("h265nal")
    n = {k: _split(pkg, getattr(t265, k)) for k in (
        "H265_VPS", "H265_SPS", "H265_PPS", "H265_128_SPS", "H265_S_SPS",
        "H265_128_IDR", "H265_SEI_CLLI", "H265_SEI_MDCV", "H265_S_SLICE1",
        "H265_S_SLICE2")}
    sps = h.parse_sps(n["H265_SPS"])
    cd = h.build_hvcc([n["H265_VPS"]], [n["H265_SPS"]], [n["H265_PPS"]])
    return (sps, h.profile_name(sps.ptl), h.tier_name(sps.ptl),
            h.level_name(sps.ptl), h.parse_sps(n["H265_128_SPS"]),
            h.parse_sps(n["H265_S_SPS"]),
            {k: h.nal_type(v) for k, v in n.items()},
            h.is_irap(h.nal_type(n["H265_128_IDR"])),
            h.parse_sei(n["H265_SEI_CLLI"]), h.parse_sei(n["H265_SEI_MDCV"]),
            h.first_slice_segment_in_pic(n["H265_S_SLICE1"]),
            h.first_slice_segment_in_pic(n["H265_S_SLICE2"]),
            cd, h.parse_hvcc(cd))


def mpv_io(pkg):
    mpv = pkg.io("mpegvideo")
    hdr = mpv.parse_sequence_header(tmpv.MPEG2_SEQ[4:])
    mpv.parse_sequence_extension(tmpv.MPEG2_SEQ[16:], hdr)
    return (hdr, mpv.par_from_aspect(hdr),
            mpv.parse_sequence_header(tmpv.MPEG1_SEQ[4:]),
            mpv.picture_type(tmpv.MPEG2_IFRAME[4:]))


def vp9_io(pkg):
    vp9 = pkg.io("vp9")
    frames = _vp9()
    hdrs = [vp9.parse_frame_header(f) for f in frames[:1]]
    return (hdrs, vp9.chroma_format(hdrs[0]),
            [vp9.split_superframe(f) for f in frames[:3]])


def av1_io(pkg):
    av1 = pkg.io("av1obu")
    arr = _av1()
    obus = av1.split_obu_stream(arr["stream_no_annexb_av1"])
    seq, st, headers = None, av1.ParserState(), []
    for o in obus:
        if o.obu_type == av1.OBU_SEQUENCE_HEADER:
            seq = av1.parse_sequence_header(o.payload)
        elif o.obu_type in (av1.OBU_FRAME, av1.OBU_FRAME_HEADER):
            fh = av1.parse_frame_header(o, seq, st)
            if not fh.show_existing_frame or fh.frame_type == av1.FRAME_KEY:
                av1.reference_frame_update(st, fh)
            if o.obu_type == av1.OBU_FRAME:
                st.seen_frame_header = False
            headers.append(fh)
    leb = [(av1.write_leb128(v), av1.read_leb128(av1.write_leb128(v), 0))
           for v in (0, 1, 127, 128, 300, 5454, 10519, 1 << 30)]
    return [(o.obu_type, o.raw) for o in obus], seq, headers, leb


def av1_tile_groups(pkg):
    av1 = pkg.io("av1obu")
    seq = av1.parse_sequence_header(
        av1.split_obu_stream(tva._tg_seq_header())[0].payload)
    st = av1.ParserState()
    fh = av1.parse_frame_header(
        av1.split_obu_stream(tva._tg_key_frame_header(0))[0], seq, st)
    out = [seq, fh]
    for a, b in ((0, 2), (3, 3), (0, 0)):
        try:
            out.append(av1.parse_tile_group(
                av1.split_obu_stream(tva._tg_obu(a, b))[0].payload, st))
        except ValueError as e:
            out.append((type(e).__name__, str(e)))
        out.append(st.seen_frame_header)
    return out


def m4_h263_io(pkg):
    m4, h263 = pkg.io("mpeg4video"), pkg.io("h263")
    vol = m4.Vol()
    m4.parse_vos(tm4.MPEG4_CONFIG[4:5], vol)
    off = tm4.MPEG4_CONFIG.find(b"\x00\x00\x01\x20") + 4
    m4.parse_vol(tm4.MPEG4_CONFIG[off:], vol)
    return vol, h263.parse_picture(t263.H263_IFRAME)


def dirac_io(pkg):
    dirac = pkg.io("dirac")
    hdr = dirac.SequenceHeader(
        major_version=2, minor_version=2, profile=8, level=0, index=0,
        width=352, height=288, chroma_format=2, interlaced=0,
        frame_rate_numerator=25, frame_rate_denominator=1,
        aspect_ratio_numerator=1, aspect_ratio_denominator=1,
        clean_width=352, clean_height=288, luma_offset=0,
        luma_excursion=255, chroma_offset=128, chroma_excursion=255)
    payload = dirac.build_sequence_header_payload(hdr)
    std = dirac.Pack().put_uint(2).put_uint(2).put_uint(2).put_uint(1) \
        .put_uint(9)
    for _ in range(8):
        std = std.put_bit(0)
    u = dirac.Unpack(b"")
    return (payload, dirac.parse_sequence_header(payload),
            dirac.parse_sequence_header(std.put_uint(0).bytes()),
            [dirac.Pack().put_uint(v).bytes()
             for v in (0, 1, 2, 3, 4, 7, 8, 100, 255, 256, 1000, 65535)],
            (u.decode_bit(), u.decode_uint()),
            [(dirac.is_picture(c), dirac.num_refs(c), dirac.is_reference(c))
             for c in range(256)])


def dirac_element(pkg):
    dirac = pkg.io("dirac")
    seq_hdr = dirac_io(pkg)[0]
    stream = (dirac.build_parse_unit(dirac.PARSE_CODE_SEQUENCE_HEADER,
                                     seq_hdr)
              + dirac.build_parse_unit(dirac.PARSE_CODE_AUXILIARY_DATA,
                                       b"x" * 7)
              + dirac.build_parse_unit(0x0C, b"picturedata")
              + dirac.build_parse_unit(0x08, b"p2"))
    return (run_parser(pkg, "diracparse", stream, step=11, finish=False),
            run_parser(pkg, "diracparse", b"garbage-without-sync"
                       + dirac.build_parse_unit(0x0C, b"d" * 5)),
            run_parser(pkg, "diracparse", stream * 2, step=5))


IO_CASES = [h264_io, h264_tables, h264_slice_headers, h265_io, mpv_io,
            vp9_io, av1_io, av1_tile_groups, m4_h263_io, dirac_io,
            dirac_element]


@pytest.mark.parametrize("fn", IO_CASES, ids=[f.__name__ for f in IO_CASES])
def test_parser_io_parity(fn):
    assert_both(fn)


# ------------------------------------------------------------------ vc1

def _struct_c(vc1):
    return vc1.StructC(profile=vc1.PROFILE_MAIN, frmrtq_postproc=5,
                       bitrtq_postproc=10, loop_filter=1, multires=0,
                       fastuvmc=1, extended_mv=0, dquant=1, vstransform=1,
                       overlap=1, syncmarker=0, rangered=0, maxbframes=2,
                       quantizer=1, finterpflag=0)


def _layer(vc1, **kw):
    args = dict(width=320, height=240, level=2, fps_n=25, fps_d=1)
    args.update(kw)
    return vc1.make_sequence_layer(vc1.PROFILE_MAIN, _struct_c(vc1), **args)


def vc1_struct_and_layers(pkg):
    vc1 = pkg.io("vc1")
    word = vc1.make_struct_c_from_fields(vc1.PROFILE_MAIN, _struct_c(vc1))
    layer = _layer(vc1)
    bad = []
    for off in (3, 4, 20):
        b = bytearray(layer)
        b[off] ^= 0xFF
        bad.append(bytes(b))
    out = [word, vc1.parse_struct_c(word.to_bytes(4, "big")), layer,
           vc1.parse_sequence_layer(layer),
           vc1.parse_sequence_layer(_layer(vc1, fps_n=0, fps_d=0)),
           [vc1._framerate_bitrate(a, b) for a in range(8)
            for b in range(32)]]
    for blob in bad + [layer[:35]]:
        try:
            vc1.parse_sequence_layer(blob)
        except vc1.Vc1Error as e:
            out.append(("Vc1Error", str(e)))
    return out


def vc1_headers(pkg):
    vc1 = pkg.io("vc1")
    hdr = vc1.parse_sequence_header(tvc1._advanced_seq_hdr())
    ep = vc1.parse_entry_point_header(tvc1._entrypoint(), hdr)
    hdr2 = vc1.parse_sequence_header(tvc1._advanced_seq_hdr(
        level=1, w=64, h=48, interlace=1, aspect_ratio=15, frnr=7, frdr=1))
    ep2 = vc1.parse_entry_point_header(
        tvc1._entrypoint(extended_mv=0, coded_size=(640, 480)), hdr2)
    data = (b"\x00\x00\x01\x0f" + b"a" * 5 + b"\x00\x00\x01\x0e" + b"b" * 3
            + b"\x00\x00\x01\x0d" + b"c" * 7)
    return (hdr, ep, hdr2, ep2, vc1.split_bdus(data),
            vc1.identify_next_bdu(data), vc1.identify_next_bdu(data[-11:]),
            vc1.identify_next_bdu(b"\xff" * 20),
            [vc1.make_frame_layer_header(*a) for a in (
                (1234, True, 0xDEADBEEF), (7, False, 40))],
            vc1.parse_frame_layer_header(
                vc1.make_frame_layer_header(1234, True, 0xDEADBEEF)))


def _vc1_el(pkg, caps, output=None):
    el = pkg.make("vc1parse")
    el.set_caps(**caps)
    if output:
        el.set_output(**output)
    return el


def vc1_profile_quirk(pkg):
    return [_fields(_vc1_el(pkg, {"profile": p, "stream_format": "asf"}))
            for p in ("simple", "main", "advanced")]


def vc1_seq_layer_codec_data(pkg):
    vc1 = pkg.io("vc1")
    layer = _layer(vc1, level=1)
    return _fields(_vc1_el(pkg, {"codec_data": layer,
                                     "stream_format": "frame-layer"}))


def vc1_asf_to_seq_layer_raw(pkg):
    vc1 = pkg.io("vc1")
    cd = vc1.make_struct_c_from_fields(vc1.PROFILE_MAIN,
                                       _struct_c(vc1)).to_bytes(4, "big")
    el = _vc1_el(pkg, dict(width=320, height=240, framerate=(25, 1),
                           header_format="asf", stream_format="asf",
                           codec_data=cd),
                 dict(header_format="none",
                      stream_format="sequence-layer-raw-frame"))
    return el.chain(b"frame-one", pts_ns=0) + el.chain(b"frame-two",
                                                       pts_ns=40)


def _adv_cd():
    return (b"\x2b" + b"\x00\x00\x01\x0f" + tvc1._advanced_seq_hdr()
            + b"\x00\x00\x01\x0e" + tvc1._entrypoint())


def vc1_advanced_asf_to_bdu(pkg):
    el = _vc1_el(pkg, dict(format="WVC1", header_format="asf",
                           stream_format="asf", codec_data=_adv_cd()),
                 dict(header_format="asf", stream_format="bdu"))
    return (_fields(el), el.chain(b"rawframe", pts_ns=0),
            el.chain(b"\x00\x00\x01\x0dcoded", pts_ns=40))


def vc1_asf_to_frame_layer(pkg):
    el = _vc1_el(pkg, dict(format="WVC1", header_format="asf",
                           stream_format="asf", codec_data=_adv_cd()),
                 dict(header_format="asf", stream_format="frame-layer"))
    return (el.chain(b"K1", pts_ns=0, keyframe=True)
            + el.chain(b"D2", pts_ns=40, keyframe=False)
            + el.chain(b"K3", pts_ns=80, keyframe=True))


def vc1_bdu_to_seq_layer_bdu(pkg):
    stream = (b"\x00\x00\x01\x0f" + tvc1._advanced_seq_hdr()
              + b"\x00\x00\x01\x0e" + tvc1._entrypoint()
              + b"\x00\x00\x01\x0d" + b"frame-a"
              + b"\x00\x00\x01\x0d" + b"frame-b")
    return run_parser(pkg, "vc1parse", stream, step=7,
                      caps=A(format="WVC1", stream_format="bdu-frame"),
                      output=A(header_format="none",
                               stream_format="sequence-layer-bdu-frame"))


def vc1_seq_layer_frame_layer(pkg):
    vc1 = pkg.io("vc1")
    layer = _layer(vc1)
    f1 = vc1.make_frame_layer_header(4, True, 0) + b"AAAA"
    f2 = vc1.make_frame_layer_header(2, False, 40) + b"BB"
    return (run_parser(pkg, "vc1parse", layer + f1 + f2, finish=False,
                       caps=A(header_format="sequence-layer")),
            run_parser(pkg, "vc1parse", layer + f1, finish=False,
                       caps=A(header_format="sequence-layer",
                              stream_format="sequence-layer-frame-layer"),
                       output=A(header_format="sequence-layer",
                                stream_format="frame-layer")))


def vc1_simple_rejects_bdu(pkg):
    vc1 = pkg.io("vc1")
    cd = vc1.make_struct_c_from_fields(
        vc1.PROFILE_SIMPLE, vc1.StructC(profile=vc1.PROFILE_SIMPLE)
    ).to_bytes(4, "big")
    return _vc1_el(pkg, dict(width=176, height=144, header_format="asf",
                             stream_format="asf", codec_data=cd),
                   dict(header_format="asf", stream_format="bdu")
                   ).chain(b"frame")


def vc1_needs_headers(pkg):
    return _vc1_el(pkg, dict(format="WVC1", stream_format="asf"),
                   dict(header_format="none", stream_format="asf")
                   ).chain(b"frame")


VC1_CASES = [vc1_struct_and_layers, vc1_headers, vc1_profile_quirk,
             vc1_seq_layer_codec_data, vc1_asf_to_seq_layer_raw,
             vc1_advanced_asf_to_bdu, vc1_asf_to_frame_layer,
             vc1_bdu_to_seq_layer_bdu, vc1_seq_layer_frame_layer,
             vc1_simple_rejects_bdu, vc1_needs_headers]
VC1_RAISING = (vc1_simple_rejects_bdu, vc1_needs_headers)


@pytest.mark.parametrize("fn", VC1_CASES, ids=[f.__name__ for f in VC1_CASES])
def test_vc1_parity(fn):
    assert_both(fn, raises=fn in VC1_RAISING)


# ----------------------------------------- the JAX tests on both packages

# each JAX test module and its module names, bound to the twins of the
# JAX package's module and the port's copy
_IO = {"h": "h264", "h26x": "h264", "vc1": "vc1", "mpv": "mpegvideo",
       "av1": "av1obu", "vp9": "vp9", "m4": "mpeg4video", "h263": "h263",
       "dirac": "dirac"}
_NAMES = {t264: ("gt", "h"), t265: ("gt", "h26x", "h"), tmpv: ("gt", "mpv"),
          tva: ("gt", "av1", "vp9"), tm4: ("gt", "m4"), t263: ("gt", "h263"),
          tj2k: ("gt",), tvc1: ("gt", "vc1"), tpng: ("gt", "dirac")}
# left out: the libaom encoder (io/av1.py, a codec wrapper not in this
# slice) and the intersub pair (gst/inter, not a parser)
NOT_HERE = ("test_av1_frame_header_real_aom_nonuniform_tiles",
            "test_intersub_latch_semantics", "test_intersub_channel_isolation")


def _pair(mod, name):
    if name == "gt":
        return gt, gtt
    io = _IO[name] if not (mod is t265 and name == "h") else "h265nal"
    return JAX.io(io), TORCH.io(io)


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(_NAMES, NOT_HERE))
def test_jax_parser_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of the eleven parsers with its module names (the
    package and the io modules) bound to the JAX package's and the port's
    side by side (helpers/twin.py: each call's result, or error, equal;
    the JAX test's own assertions on top)."""
    for name in _NAMES[mod]:
        monkeypatch.setattr(mod, name, Twin(*_pair(mod, name)))
    fn(**kwargs)
