"""Robustness sweep of the transport plane's byte parsers (the scheme of
tests/test_parser_fuzz.py) through gstbad_tpu and gstbad_tpu_torch: every
parser meets garbage, truncations and random mutations of a valid stream,
drawn from fixed numpy seeds, and both packages give the same output, or
raise the same documented error (a ValueError) with the same message, on
every one of them.  RTP packet parsing (io/rtp.py RtpPacket.parse) raises
struct.error on a datagram shorter than its header in both packages; that
is the reference's behaviour, kept in the port's copy and compared here as
it is."""

import struct

import numpy as np
import pytest

import test_h263parse as t263
import test_h264parse as t264
import test_h265parse as t265
import test_jpeg2000parse as tj2k
import test_mpeg4videoparse as tm4
import test_mpegvideoparse as tmpv
import test_pngdirac_parse as tpng
import test_vp9_av1_parse as tva
from helpers.torch_transport import JAX, TORCH, canon
from test_pcap import PCAP_FRAME_WITH_ETH_PADDING, PCAP_HEADER
from test_sdp import SDP


def mutations(seed, blob, n=40):
    rng = np.random.default_rng(seed)
    yield b""
    yield blob[: len(blob) // 3]
    yield blob[len(blob) // 3:]
    for _ in range(n):
        b = bytearray(blob)
        for _ in range(rng.integers(1, 8)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        yield bytes(b)
    yield bytes(rng.integers(0, 256, 512, np.uint8))


def _fuzz_outcome(fn, pkg, blob, errors=(ValueError,)):
    try:
        return ("ok", canon(fn(pkg, blob)))
    except errors as e:          # every io error derives from ValueError
        return ("raise", type(e).__name__, str(e))


def _parse(name, finish=True, **setup):
    def fn(pkg, blob):
        el = pkg.make(name)
        for method, args in setup.items():
            getattr(el, method)(*args)
        out = el.push(blob)
        if finish:
            out += el.finish()
        return out, el.src_caps
    return fn


def ts_demux(pkg, blob):
    d = pkg.io("mpegts").TsDemux()
    out = d.push(blob) + d.eos()
    return out, d.continuity_errors, d.streams, [
        (s.table_id, s.data) for s in d.si_sections]


def ps_demux(pkg, blob):
    d = pkg.io("mpegps").PsDemux()
    return d.push(blob), d.stream_types, d.saw_end


def vc1_headers(pkg, blob):
    vc1 = pkg.io("vc1")
    out = [vc1.parse_sequence_layer(blob), vc1.parse_sequence_header(blob)]
    if len(blob) >= 4:
        out.append(vc1.identify_next_bdu(blob))
    return out


def pcap(pkg, blob):
    return pkg.make("pcapparse").chain(blob)


def irtsp(pkg, blob):
    return pkg.make("irtspparse").chain(blob)


def sdp(pkg, blob):
    return pkg.make("sdpdemux").push_sdp(blob.decode("latin1"))


def rtp_rtcp(pkg, blob):
    return (pkg.io("rtp").RtpPacket.parse(blob),
            pkg.io("rtpnet").parse_rtcp(blob))


def onvif_parse(pkg, blob):
    return pkg.make("rtponvifparse").chain(blob)


def si_section(pkg, blob):
    si = pkg.io("mpegts_si")
    sec = si.section_new(0x12, blob)
    return sec, sec.get_eit(), sec.get_pat(), sec.get_sdt()


def _ts_stream():
    from gstbad_tpu.io import mpegts
    mux = mpegts.TsMux()
    v = mux.add_stream(mpegts.ST_VIDEO_H264)
    return b"".join(mux.add_data(v, bytes(np.random.default_rng(1).integers(
        0, 256, 500, np.uint8)), pts=90000))


def _ps_stream():
    from gstbad_tpu.io import mpegps
    mux = mpegps.PsMux()
    v = mux.add_stream(mpegps.ST_VIDEO_MPEG2)
    return mux.add_data(v, bytes(np.random.default_rng(2).integers(
        0, 256, 500, np.uint8)), pts=90000) + mux.finish()


def _vc1_layer():
    from gstbad_tpu.io import vc1
    return vc1.make_sequence_layer(vc1.PROFILE_MAIN,
                                   vc1.StructC(profile=vc1.PROFILE_MAIN),
                                   320, 240, 2, 25, 1)


def _rtp_with_onvif():
    onvif = JAX.make("rtponviftimestamp", **{
        "set-e-bit": True, "set-t-bit": True, "ntp-offset": 3600 * 10**9})
    from gstbad_tpu.io.rtp import RtpPacket
    pkt = RtpPacket(payload_type=96, seq=1, ssrc=5, payload=b"x" * 40)
    return (onvif.chain(pkt.serialize(), pts_ns=10**9)
            + onvif.event_eos())[0]


def _eit_section():
    from gstbad_tpu.io import mpegts_si as si
    eit = si.Eit(service_id=1, transport_stream_id=2, original_network_id=3)
    for i in range(3):
        eit.events.append(si.EitEvent(
            event_id=i, start_time=si.DvbTime(2026, 8, 18, i, 0, 0),
            duration=1800, running_status=si.RUNNING_STATUS_RUNNING))
    return si.section_from_eit(eit).packetize()


def _rtsp():
    return b"".join(bytes([0x24, c]) + struct.pack(">H", len(p)) + p
                    for c, p in ((0, b"abc"), (1, b"rtcp!"), (0, bytes(40))))


# (name, parse function, valid stream, mutations)
CASES = [
    ("mpegts", ts_demux, _ts_stream, 40),
    ("mpegps", ps_demux, _ps_stream, 40),
    ("h264parse", _parse("h264parse"), lambda: t264.STREAM, 40),
    ("h265parse", _parse("h265parse"),
     lambda: t265.STREAM16 + t265.H265_128_IDR, 40),
    ("av1parse", _parse("av1parse", set_output=("obu-stream", "frame")),
     lambda: tva._av1_streams()[0]["stream_no_annexb_av1"][:2000], 25),
    ("vp9parse", _parse("vp9parse", finish=False),
     lambda: tva._vp9_frames()[0][0][:512], 25),
    ("h263parse", _parse("h263parse"), lambda: t263.H263_IFRAME, 40),
    ("mpegvideoparse", _parse("mpegvideoparse"),
     lambda: tmpv.MPEG2_SEQ + tmpv.MPEG2_IFRAME * 2, 40),
    ("mpeg4videoparse", _parse("mpeg4videoparse"),
     lambda: tm4.MPEG4_CONFIG + tm4.MPEG4_IFRAME * 2, 40),
    ("jpeg2000parse", _parse("jpeg2000parse"),
     lambda: tj2k._vec("rgb_32_32_jp2"), 25),
    ("pngparse", _parse("pngparse"), lambda: tpng.make_png(8, 4) * 2, 40),
    ("diracparse", _parse("diracparse"),
     lambda: __import__("gstbad_tpu.io.dirac", fromlist=["x"])
     .build_parse_unit(0x0C, b"picturedata") * 3, 40),
    ("vc1", vc1_headers, _vc1_layer, 25),
    ("pcapparse", pcap,
     lambda: PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING * 2, 40),
    ("irtspparse", irtsp, _rtsp, 40),
    ("sdpdemux", sdp, lambda: SDP.encode(), 40),
    ("rtp_rtcp", rtp_rtcp, _rtp_with_onvif, 40),
    ("rtponvifparse", onvif_parse, _rtp_with_onvif, 40),
    ("mpegts_si", si_section, _eit_section, 40),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_fuzz_both_packages(case):
    name, fn, stream, n = CASES[case]
    errors = ((ValueError, struct.error) if fn in (rtp_rtcp, onvif_parse)
              else (ValueError,))
    kinds = set()
    for blob in mutations(1000 + case, stream(), n=n):
        j = _fuzz_outcome(fn, JAX, blob, errors)
        t = _fuzz_outcome(fn, TORCH, blob, errors)
        assert t == j, (name, blob)
        kinds.add(t[0])
    assert "ok" in kinds, name       # the sweep reaches the parse itself
