"""rtpsrc/rtpsink, the io/rtpnet.py session layer, sdpdemux, the ONVIF
pair, pcapparse and irtspparse through gstbad_tpu and gstbad_tpu_torch
on the same inputs (the scenarios of tests/test_rtp_net.py, test_sdp.py,
test_onvif.py and test_pcap.py), the raw-video RTP headline graph over
localhost sockets through both packages, the route its fused tail takes,
and the two rtp faults of the JAX element that the port corrects."""

import socket
import struct
import time

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from helpers.torch_transport import JAX, TORCH, assert_both, free_port_pair
from test_onvif import CSEQ, NSEC, NTP_OFFSET
from test_pcap import (PADDING_OFFSET, PCAP_FRAME_WITH_ETH_PADDING,
                       PCAP_HEADER, ZEROSIZE_DATA)
from test_sdp import SDP

torch.set_num_threads(1)   # parallel test workers share the cores


def _np_batch(pkg, frames, pts=None):
    """A host batch as each package's host sinks receive it."""
    if pkg is JAX:
        import jax.numpy as jnp
        from gstbad_tpu.core.frame import FrameBatch
        return FrameBatch.make(jnp.asarray(frames), pts=None if pts is None
                               else jnp.asarray(pts))
    from gstbad_tpu_torch.core.frame import FrameBatch
    return FrameBatch.make(torch.from_numpy(frames), pts=None if pts is None
                           else torch.from_numpy(pts)).to_numpy()


def _spec(pkg, **kw):
    import importlib
    return importlib.import_module(f"{pkg.name}.core.spec").MediaSpec(**kw)


def _batch_fields(b):
    return None if b is None else (b.data, b.pts, b.flags, b.valid)


# ---------------------------------------------------------------------------
# io/rtpnet.py and io/rtp.py
# ---------------------------------------------------------------------------

def jb_reorder(pkg):
    rtpnet, rtp = pkg.io("rtpnet"), pkg.io("rtp")
    jb = rtpnet.JitterBuffer(latency_ms=50)
    seqs = [65533, 65534, 65535, 0, 1, 2]
    pkts = [rtp.RtpPacket(seq=s, ssrc=9, payload=bytes([i]))
            for i, s in enumerate(seqs)]
    for i in [0, 2, 1, 4, 3, 5]:
        jb.insert(pkts[i], now=0.0)
    return [p.payload for p in jb.pop_ready(now=0.0)], jb.num_lost


def jb_gap(pkg):
    rtpnet, rtp = pkg.io("rtpnet"), pkg.io("rtp")
    jb = rtpnet.JitterBuffer(latency_ms=100)
    jb.insert(rtp.RtpPacket(seq=10, ssrc=1, payload=b"a"), now=0.0)
    out = [jb.pop_ready(now=0.0)]
    jb.insert(rtp.RtpPacket(seq=12, ssrc=1, payload=b"c"), now=0.01)
    out += [jb.pop_ready(now=0.05), jb.pop_ready(now=0.2)]
    return [[p.payload for p in o] for o in out], jb.num_lost


def jb_ssrc(pkg):
    rtpnet, rtp = pkg.io("rtpnet"), pkg.io("rtp")
    jb = rtpnet.JitterBuffer()
    jb.insert(rtp.RtpPacket(seq=0, ssrc=7), now=0.0)
    jb.insert(rtp.RtpPacket(seq=1, ssrc=8), now=0.0)
    return jb.num_foreign, [p.serialize() for p in jb.pop_ready(now=0.0)]


def rfc4175(pkg, sampling, shape, width):
    rtpnet = pkg.io("rtpnet")
    frame = np.random.default_rng(7).integers(0, 256, shape, np.uint8)
    pay = rtpnet.RawVideoPayloader(sampling, width, shape[0], mtu=200)
    pkts = pay.pay_frame(frame, ts90=123450)
    depay = rtpnet.RawVideoDepayloader(sampling, width, shape[0])
    done = []
    for p in pkts:
        done += depay.depay(p)
    return [p.serialize() for p in pkts], done, pay.seq32, pay.octet_count


def rfc4175_loss(pkg):
    rtpnet = pkg.io("rtpnet")
    frame = np.random.default_rng(7).integers(0, 256, (16, 16, 3), np.uint8)
    pay = rtpnet.RawVideoPayloader("RGB", 16, 16, mtu=100)
    pkts = pay.pay_frame(frame, ts90=0)
    depay = rtpnet.RawVideoDepayloader("RGB", 16, 16)
    done = []
    for p in pkts[:1] + pkts[2:]:
        done += depay.depay(p)
    dropped = depay.num_dropped
    for p in pay.pay_frame(frame, ts90=3000):
        done += depay.depay(p)
    return dropped, done


def l16(pkg):
    rtpnet = pkg.io("rtpnet")
    samples = np.random.default_rng(7).integers(-30000, 30000, (1000, 2),
                                                dtype=np.int16)
    pay = rtpnet.L16Payloader(48000, 2, mtu=300)
    pkts = pay.pay(samples)
    depay = rtpnet.L16Depayloader(2)
    return [p.serialize() for p in pkts], [depay.depay(p) for p in pkts]


def mp2t(pkg):
    rtpnet = pkg.io("rtpnet")
    pay = rtpnet.Mp2tPayloader(mtu=1400)
    pkts = pay.pay(bytes(range(256)) * 10)
    depay = rtpnet.Mp2tDepayloader()
    return ([p.serialize() for p in pkts], pay._partial,
            [depay.depay(p) for p in pkts])


def rtcp(pkg):
    rtpnet = pkg.io("rtpnet")
    sr = rtpnet.RtcpSR(ssrc=0xAA, ntp=rtpnet.unix_to_ntp64(1234.5),
                       rtp_ts=777, packet_count=10, octet_count=999)
    compound = (sr.serialize() + rtpnet.rtcp_sdes_cname(0xAA, "x@y")
                + rtpnet.rtcp_bye(0xAA))
    return compound, rtpnet.parse_rtcp(compound)


def payload_info(pkg):
    rtpnet = pkg.io("rtpnet")
    return ([rtpnet.payload_info_for_pt(pt) for pt in range(0, 128, 3)],
            [rtpnet.payload_info_for_name(n)
             for n in ("mp2t", "L16", "pcmu", "nope")],
            rtpnet.parse_rtp_uri("rtp://127.0.0.1:6000?latency=50&pt=33"))


def rtp_packet(pkg):
    rtp = pkg.io("rtp")
    p = rtp.RtpPacket(marker=True, payload_type=96, seq=0x1234,
                      timestamp=0xDEADBEEF, ssrc=42, csrcs=[1, 2],
                      payload=b"hello")
    p.extension = (0xABAC, bytes(12))
    data = p.serialize()
    return data, rtp.RtpPacket.parse(data)


IO_CASES = [
    (jb_reorder, ()), (jb_gap, ()), (jb_ssrc, ()),
    (rfc4175, ("RGB", (17, 31, 3), 31)),
    (rfc4175, ("BGRA", (12, 25, 4), 25)),
    (rfc4175, ("YCbCr-4:2:2", (16, 44), 22)),
    (rfc4175_loss, ()), (l16, ()), (mp2t, ()), (rtcp, ()),
    (payload_info, ()), (rtp_packet, ()),
]


@pytest.mark.parametrize("case", range(len(IO_CASES)))
def test_rtp_io_parity(case):
    fn, args = IO_CASES[case]
    assert_both(fn, *args)


# ---------------------------------------------------------------------------
# rtpsrc / rtpsink over localhost sockets
# ---------------------------------------------------------------------------

RAW_CAPS = ("application/x-rtp,media=video,encoding-name=RAW,"
            "sampling={s},width={w},height={h},framerate=30/1")


def loopback_raw_video(pkg):
    port = free_port_pair()
    src = pkg.make("rtpsrc", uri=f"rtp://127.0.0.1:{port}?latency=50",
                   caps=RAW_CAPS.format(s="RGB", w=32, h=24))
    spec = src.negotiate(None)
    src.open()
    sink = pkg.make("rtpsink", uri=f"rtp://127.0.0.1:{port}", mtu=400)
    sink.negotiate(_spec(pkg, kind="video", format="RGB", width=32,
                         height=24))
    frames = np.random.default_rng(7).integers(0, 256, (4, 24, 32, 3),
                                               dtype=np.uint8)
    pts = np.arange(4, dtype=np.int64) * 33_333_333
    sink.host_process(_np_batch(pkg, frames, pts), None)
    batch = src.pull_window(4)
    sink.close()
    src.close()
    return (spec.format, spec.width, spec.height, _batch_fields(batch),
            sink._pay.seq32, sink._pay.octet_count)


def loopback_l16(pkg):
    port = free_port_pair()
    sink = pkg.make("rtpsink", address="127.0.0.1", port=port, pt=96)
    sink.negotiate(_spec(pkg, kind="audio", format="S16", rate=8000,
                         channels=2))
    src = pkg.make("rtpsrc", address="127.0.0.1", port=port,
                   caps=("application/x-rtp,media=audio,encoding-name=L16,"
                         "clock-rate=8000,channels=2,samplesperbuffer=256"))
    spec = src.negotiate(None)
    src.open()
    audio = np.random.default_rng(7).integers(-3000, 3000, (2, 512, 2),
                                              dtype=np.int16)
    sink.host_process(_np_batch(pkg, audio), None)
    batch = src.pull_window(4)
    sink.close()
    src.close()
    return spec.rate, spec.channels, _batch_fields(batch)


def loopback_reorder(pkg):
    rtpnet = pkg.io("rtpnet")
    port = free_port_pair()
    src = pkg.make("rtpsrc", address="127.0.0.1", port=port, latency=100,
                   timeout=3.0, caps=RAW_CAPS.format(s="BGRA", w=16, h=8))
    src.negotiate(None)
    src.open()
    rng = np.random.default_rng(7)
    pay = rtpnet.RawVideoPayloader("BGRA", 16, 8, mtu=300)
    frames = rng.integers(0, 256, (3, 8, 16, 4), dtype=np.uint8)
    pkts = []
    for i in range(3):
        pkts += pay.pay_frame(frames[i], ts90=3000 * i)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i in rng.permutation(len(pkts)):
        s.sendto(pkts[i].serialize(), ("127.0.0.1", port))
    s.close()
    batch = src.pull_window(3)
    src.close()
    return _batch_fields(batch)


def loopback_mp2t(pkg):
    rtpnet = pkg.io("rtpnet")
    port = free_port_pair()
    src = pkg.make("rtpsrc", address="127.0.0.1", port=port,
                   caps="application/x-rtp,media=video,encoding-name=MP2T",
                   timeout=2.0)
    spec = src.negotiate(None)
    src.open()
    pay = rtpnet.Mp2tPayloader()
    ts = bytes([0x47, 0x1F, 0xFF, 0x10]) + bytes(184)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for p in pay.pay(ts * 14):
        s.sendto(p.serialize(), ("127.0.0.1", port))
    s.close()
    time.sleep(0.05)
    data = src.pull_bytes()
    src.close()
    return spec.kind, spec.format, data


def _recv_rtcp(pkg, frames, pts, props):
    port = free_port_pair()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", port + 1))
    rx.settimeout(2.0)
    sink = pkg.make("rtpsink", address="127.0.0.1", port=port,
                    **{"rtcp-interval": 0.0}, **props)
    if frames.dtype == np.int16:
        sink.negotiate(_spec(pkg, kind="audio", format="S16", rate=8000,
                             channels=1))
    else:
        sink.negotiate(_spec(pkg, kind="video", format="RGB",
                             width=frames.shape[2], height=frames.shape[1]))
    sink.host_process(_np_batch(pkg, frames, pts), None)
    data, _ = rx.recvfrom(4096)
    sink.close()
    rx.close()
    items = pkg.io("rtpnet").parse_rtcp(data)
    for it in items:
        it.pop("ntp", None)           # the wall clock
    return items


def sink_sends_rtcp_sr(pkg):
    audio = np.random.default_rng(7).integers(-100, 100, (1, 64, 1),
                                              dtype=np.int16)
    return _recv_rtcp(pkg, audio, None, {})


LOOPBACK_CASES = [loopback_raw_video, loopback_l16, loopback_reorder,
                  loopback_mp2t, sink_sends_rtcp_sr]


@pytest.mark.parametrize("case", range(len(LOOPBACK_CASES)))
def test_rtp_loopback_parity(case):
    assert_both(LOOPBACK_CASES[case])


def test_port_rtpsrc_uploads_once_to_its_device():
    """pull_window hands the window to the pipeline's device in one
    copy: every field a view of the same storage."""
    _, _, _, (data, pts, flags, valid), _, _ = loopback_raw_video(TORCH)
    base = data.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in (pts, flags, valid))
    assert data.device.type == "cpu" and data.shape == (4, 24, 32, 3)


# ---------------------------------------------------------------------------
# The two corrections of the JAX element
# ---------------------------------------------------------------------------

def test_uri_query_values_are_coerced_through_their_properties():
    """The JAX element stores rtp:// query values as strings
    (elements/rtp.py:58-61), so ?timeout=0.2 leaves "0.2" and pull_window
    adds it to a float; the port coerces each through its Property."""
    port = free_port_pair()
    uri = f"rtp://127.0.0.1:{port}?timeout=0.2&latency=50"
    caps = RAW_CAPS.format(s="RGB", w=8, h=8)
    j = gt.make("rtpsrc", uri=uri, caps=caps)
    t = gtt.make("rtpsrc", uri=uri, caps=caps)
    assert j.props["timeout"] == "0.2" and t.props["timeout"] == 0.2
    assert j.props["latency"] == t.props["latency"] == 50
    for el in (j, t):
        el.negotiate(None)
    j.open()
    with pytest.raises(TypeError):
        j.pull_window(2)
    j.close()
    t.open()
    t0 = time.monotonic()
    assert t.pull_window(2) is None           # nothing came: times out
    assert 0.2 <= time.monotonic() - t0 < 2.0
    t.close()
    # a value outside the property's range is refused, as g_object_set
    # refuses it (the JAX element takes it and fails at bind)
    with pytest.raises(ValueError, match="latency"):
        gtt.make("rtpsrc", uri=f"rtp://127.0.0.1:{port}?latency=-5")
    assert gt.make("rtpsrc", uri=f"rtp://127.0.0.1:{port}?latency=-5"
                   ).props["latency"] == -5


def test_rtcp_sr_carries_the_90khz_timestamp_of_raw_video():
    """RFC 3550 6.4.1: the SR's RTP timestamp is on the media clock.
    The JAX element sends its packet counter (elements/rtp.py:185-191);
    the port sends the last frame's 90 kHz timestamp."""
    frames = np.random.default_rng(3).integers(0, 256, (3, 8, 16, 3),
                                               dtype=np.uint8)
    pts = np.array([0, 40_000_000, 80_000_000], np.int64)
    j = _recv_rtcp(JAX, frames, pts, {"mtu": 200})
    t = _recv_rtcp(TORCH, frames, pts, {"mtu": 200})
    assert j[0]["type"] == t[0]["type"] == "sr"
    n_packets = t[0]["packet_count"]
    assert j[0]["packet_count"] == n_packets > 3
    assert j[0]["rtp_ts"] == n_packets            # the counter
    assert t[0]["rtp_ts"] == 80_000_000 * 90000 // 1_000_000_000 == 7200
    for item in (j[0], t[0]):
        item.pop("rtp_ts")
    assert j == t


# ---------------------------------------------------------------------------
# The raw-video RTP headline graph over localhost sockets
# ---------------------------------------------------------------------------

W, H, WINDOW, WINDOWS = 32, 24, 4, 2


def headline_desc(src_port, sink_port, w=W, h=H):
    return (f"rtpsrc uri=rtp://127.0.0.1:{src_port}?latency=50 "
            f'caps="{RAW_CAPS.format(s="BGRA", w=w, h=h)}" '
            "! videoconvert format=BGRx ! coloreffects preset=sepia "
            "! solarize ! chromium ! dodge ! burn ! exclusion ! dilate "
            "! chromahold ! videoconvert format=AYUV ! zebrastripe "
            f"! videoconvert format=BGRA ! rtpsink uri=rtp://127.0.0.1:"
            f"{sink_port}")


def run_headline(pkg, frames, w=W, h=H, window=WINDOW):
    """Pay `frames` to a fresh rtpsrc port, end the stream with an RTCP
    BYE, run the graph, and depay what rtpsink sent."""
    rtpnet = TORCH.io("rtpnet")
    p_in, p_out = free_port_pair(), free_port_pair()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", p_out))
    rx.setblocking(False)
    kw = {} if pkg is JAX else {"device": "cpu"}
    pipe = (gt if pkg is JAX else gtt).parse_launch(
        headline_desc(p_in, p_out, w, h), **kw)
    pipe.negotiate()
    src = pipe.nodes[0].element
    src.open()
    pay = rtpnet.RawVideoPayloader("BGRA", w, h)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for i, f in enumerate(frames):
        for p in pay.pay_frame(f, 1500 * i):
            tx.sendto(p.serialize(), ("127.0.0.1", p_in))
    tx.sendto(rtpnet.rtcp_bye(pay.ssrc), ("127.0.0.1", p_in + 1))
    tx.close()
    out = pipe.run(window=window)
    pipe.close()
    depay = rtpnet.RawVideoDepayloader("BGRA", w, h)
    got = []
    while True:
        try:
            data = rx.recv(65536)
        except BlockingIOError:
            break
        got += depay.depay(rtpnet.RtpPacket.parse(data))
    rx.close()
    return ([np.asarray(b.data) for b in out], [np.asarray(b.pts)
                                                 for b in out], got)


def test_rtp_headline_graph_through_both_packages():
    """2 windows of 4 seeded 32x24 BGRA frames in over RTP, the headline's
    filter chain, and out over RTP: the same frames back from both
    packages, every one, in order, pts within one 90 kHz tick."""
    frames = np.random.default_rng(17).integers(
        0, 256, (WINDOW * WINDOWS, H, W, 4), dtype=np.uint8)
    j = run_headline(JAX, frames)
    t = run_headline(TORCH, frames)
    assert len(t[2]) == len(j[2]) == len(frames)
    for (ts_j, fj), (ts_t, ft) in zip(j[2], t[2]):
        assert ts_j == ts_t
        np.testing.assert_array_equal(fj, ft)
    for a, b in zip(j[0] + j[1], t[0] + t[1]):
        np.testing.assert_array_equal(a, b)
    sent = np.arange(len(frames)) * 1500 * 1_000_000_000 // 90000
    np.testing.assert_array_equal(np.concatenate(t[1]), sent)
    back = np.array([ts for ts, _ in t[2]])
    assert np.abs(back - 1500 * np.arange(len(frames))).max() <= 1


def test_rtp_headline_route(monkeypatch):
    """Behind rtpsrc the chain folds as behind videotestsrc: the port's
    fused tail calls dilate_zebra_fused (K1) once per window, on frames
    that are not time-invariant, and no whole-word lookup (K2); the JAX
    package takes its fused Pallas tail (ops/chainfuse.py) for the same
    graph where its tiling allows it (width a multiple of 128)."""
    from gstbad_tpu.ops import chainfuse as jchainfuse
    from gstbad_tpu.ops import lut as jlut
    from gstbad_tpu_torch.ops import chainfuse, lut
    calls = {"k1": 0, "k2": 0, "j1": 0, "j2": 0}

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(chainfuse, "dilate_zebra_plain", "k1")
    spy(lut, "apply_word_table_plain", "k2")
    spy(jchainfuse, "dilate_zebra_fused", "j1")
    spy(jlut, "apply_word_table", "j2")
    monkeypatch.setattr(jchainfuse, "INTERPRET", True)
    frames = np.random.default_rng(5).integers(
        0, 256, (2 * WINDOW, 8, 128, 4), dtype=np.uint8)
    t = run_headline(TORCH, frames, w=128, h=8)
    assert (calls["k1"], calls["k2"]) == (2, 0)
    j = run_headline(JAX, frames, w=128, h=8)
    assert calls["j1"] >= 1 and calls["j2"] == 0
    assert chainfuse.dilate_zebra_fused.launches == 0   # the CPU: plain
    for a, b in zip(j[0], t[0]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sdpdemux (tests/test_sdp.py)
# ---------------------------------------------------------------------------

def sdp_parse(pkg):
    return pkg.io("sdp").SdpMessage.parse(SDP)


def sdp_caps(pkg):
    sdp = pkg.io("sdp")
    msg = sdp.SdpMessage.parse(SDP)
    out = [sdp.media_to_caps(msg.medias[0], 96),
           sdp.media_to_caps(msg.medias[1], 0),
           sdp.media_to_caps(msg.medias[2], 97)]
    try:
        sdp.media_to_caps(msg.medias[1], 98)
    except sdp.SdpError as e:
        out.append(("SdpError", str(e)))
    return out


def sdp_streams_and_rtp(pkg):
    rtp = pkg.io("rtp")
    el = pkg.make("sdpdemux")
    streams = el.push_sdp(SDP)
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, 20, np.uint8).tobytes()
                for _ in range(4)]
    seqs = [65534, 65535, 0, 1]
    routed = []
    for i in [2, 0, 3, 1]:
        pkt = rtp.RtpPacket(payload_type=96, seq=seqs[i],
                            timestamp=90000 * i, ssrc=0x1234,
                            payload=payloads[i])
        routed.append(streams.index(el.push_rtp(pkt.serialize(),
                                                port=5004)))
    out = el.pull(0)
    pkt = rtp.RtpPacket(payload_type=0, seq=7, payload=b"\xff" * 8)
    routed.append(streams.index(el.push_rtp(pkt.serialize())))
    return streams, routed, out, el.pull(1)


def sdp_container(pkg):
    return pkg.make("sdpdemux").push_sdp(
        "v=0\no=- 1 1 IN IP4 10.0.0.1\ns=x\nc=IN IP4 10.0.0.2\n"
        "m=video 5000 RTP/AVP 96\na=rtpmap:96 MP2T/90000\n"
        "m=audio 5002 RTP/AVP 96\na=rtpmap:96 MP2T/90000\n")


def sdp_no_connection(pkg):
    return pkg.make("sdpdemux").push_sdp(
        "v=0\ns=x\nm=video 5000 RTP/AVP 96\na=rtpmap:96 H264/90000\n")


SDP_CASES = [sdp_parse, sdp_caps, sdp_streams_and_rtp, sdp_container,
             sdp_no_connection]


@pytest.mark.parametrize("case", range(len(SDP_CASES)))
def test_sdp_parity(case):
    fn = SDP_CASES[case]
    assert_both(fn, raises=fn is sdp_no_connection)


def test_sdpdemux_refuses_a_session_without_connection():
    kind, cls, msg = assert_both(sdp_no_connection, raises=True)
    assert kind == "raise" and "no connection" in msg


# ---------------------------------------------------------------------------
# rtponviftimestamp / rtponvifparse (tests/test_onvif.py)
# ---------------------------------------------------------------------------

def _rtp(pkg, payload=b""):
    return pkg.io("rtp").RtpPacket(payload_type=96, seq=1, timestamp=0,
                                   ssrc=0x11223344,
                                   payload=payload).serialize()


def _onvif(pkg, **kw):
    props = {"ntp-offset": NTP_OFFSET, "cseq": CSEQ}
    props.update(kw)
    return pkg.make("rtponviftimestamp", **props)


def onvif_clean_point(pkg):
    return _onvif(pkg).chain(_rtp(pkg), pts_ns=0, keyframe=True)


def onvif_no_e_bit(pkg):
    el = _onvif(pkg)
    outs = []
    for i in range(3):
        outs += el.chain(_rtp(pkg), pts_ns=i * NSEC, keyframe=False)
    return outs + el.event_eos()


def onvif_e_bit(pkg):
    el = _onvif(pkg, **{"set-e-bit": True})
    outs = [el.chain(_rtp(pkg), pts_ns=i * NSEC) for i in range(3)]
    return outs, el.event_eos()


def onvif_t_bit(pkg):
    el = _onvif(pkg, **{"set-e-bit": True, "set-t-bit": True})
    outs = el.chain(_rtp(pkg), pts_ns=0)
    outs += el.chain(_rtp(pkg), pts_ns=NSEC)
    return outs + el.event_eos()


def onvif_segment(pkg):
    el = _onvif(pkg, **{"set-e-bit": True})
    outs = el.chain(_rtp(pkg), pts_ns=0)
    outs += el.event_segment()
    outs += el.chain(_rtp(pkg), pts_ns=2 * NSEC)
    return outs + el.event_eos()


def onvif_parse_roundtrip(pkg):
    el = _onvif(pkg, **{"set-e-bit": True, "set-t-bit": True})
    outs = el.chain(_rtp(pkg), pts_ns=5 * NSEC, keyframe=True)
    outs += el.event_eos()
    return pkg.make("rtponvifparse").chain(outs[0])


def onvif_parse_passthrough(pkg):
    return pkg.make("rtponvifparse").chain(_rtp(pkg, payload=b"payload"))


def onvif_ntp(pkg):
    onvif = pkg.el("onvif")
    out = []
    for t in (0, 1, NSEC, 5 * NSEC + 123456789, (1 << 40) + 7):
        ntp = onvif.to_ntp(t)
        out.append((ntp, onvif.from_ntp_parts(ntp >> 32, ntp & 0xFFFFFFFF)))
    return out, onvif.EXTENSION_ID


ONVIF_CASES = [onvif_clean_point, onvif_no_e_bit, onvif_e_bit, onvif_t_bit,
               onvif_segment, onvif_parse_roundtrip, onvif_parse_passthrough,
               onvif_ntp]


@pytest.mark.parametrize("case", range(len(ONVIF_CASES)))
def test_onvif_parity(case):
    assert_both(ONVIF_CASES[case])


# ---------------------------------------------------------------------------
# pcapparse / irtspparse (tests/test_pcap.py)
# ---------------------------------------------------------------------------

def _chunked(pkg, name, stream, step, **props):
    el = pkg.make(name, **props)
    got = []
    for i in range(0, len(stream), step):
        got += el.chain(stream[i:i + step])
    return got


def pcap_padding(pkg):
    return pkg.make("pcapparse").chain(PCAP_HEADER
                                       + PCAP_FRAME_WITH_ETH_PADDING)


def pcap_chunking(pkg):
    stream = PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING * 3
    return [_chunked(pkg, "pcapparse", stream, s) for s in (1, 7, 24, 999)]


def pcap_zerosize_and_offset(pkg):
    return (pkg.make("pcapparse").chain(ZEROSIZE_DATA),
            pkg.make("pcapparse", **{"ts-offset": 5}).chain(ZEROSIZE_DATA))


def pcap_filters(pkg):
    stream = PCAP_HEADER + PCAP_FRAME_WITH_ETH_PADDING
    src_port = struct.unpack_from(">H", PCAP_FRAME_WITH_ETH_PADDING,
                                  PADDING_OFFSET - 8)[0]
    return [len(pkg.make("pcapparse", **p).chain(stream)) for p in (
        {"src-ip": "82.197.77.214"}, {"src-ip": "10.0.0.1"},
        {"src-port": src_port}, {"dst-port": 1}, {"dst-ip": "1.2.3.4"})]


def pcap_bad_magic(pkg):
    return pkg.make("pcapparse").chain(b"\x00" * 24)


def pcap_nanosecond(pkg):
    header = struct.pack("<IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 0xFFFF, 1)
    rec = struct.pack("<IIII", 1, 500, len(ZEROSIZE_DATA) - 40, 0) \
        + ZEROSIZE_DATA[40:]
    return pkg.make("pcapparse").chain(header + rec)


def _rtsp_frame(channel, payload):
    return bytes([0x24, channel]) + struct.pack(">H", len(payload)) \
        + payload


def irtsp_channel(pkg):
    stream = (_rtsp_frame(0, b"drop me") + _rtsp_frame(3, b"keep")
              + _rtsp_frame(5, b"drop") + _rtsp_frame(3, b"this too"))
    return pkg.make("irtspparse", **{"channel-id": 3}).chain(stream)


def irtsp_garbage(pkg):
    stream = (b"RTSP/1.0 200 OK\r\n\r\n" + _rtsp_frame(0, b"abc")
              + _rtsp_frame(0, bytes(300)))
    return [_chunked(pkg, "irtspparse", stream, s) for s in (1, 5, 999)]


PCAP_CASES = [pcap_padding, pcap_chunking, pcap_zerosize_and_offset,
              pcap_filters, pcap_bad_magic, pcap_nanosecond, irtsp_channel,
              irtsp_garbage]


@pytest.mark.parametrize("case", range(len(PCAP_CASES)))
def test_pcap_parity(case):
    fn = PCAP_CASES[case]
    assert_both(fn, raises=fn is pcap_bad_magic)


def test_pcap_of_rtp_datagrams_round_trips():
    """A pcap written from the raw-video RTP datagrams of a seeded frame
    (Ethernet/IPv4/UDP records) gives the datagrams back through both
    packages' pcapparse, and their payloads depay to the frame."""
    rtpnet = TORCH.io("rtpnet")
    frame = np.random.default_rng(9).integers(0, 256, (8, 32, 4), np.uint8)
    pkts = [p.serialize() for p in rtpnet.RawVideoPayloader(
        "BGRA", 32, 8, mtu=300).pay_frame(frame, 90000)]
    blob = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1)
    for i, d in enumerate(pkts):
        udp = struct.pack(">HHHH", 5004, 5004, 8 + len(d), 0) + d
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 20 + len(udp), 0, 0, 64,
                         17, 0, bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
        eth = bytes(12) + b"\x08\x00" + ip + udp
        blob += struct.pack("<IIII", 1, i, len(eth), len(eth)) + eth

    def scenario(pkg):
        return pkg.make("pcapparse", **{"dst-port": 5004}).chain(blob)
    kind, out = assert_both(scenario)
    payloads = [d["data"] for d in scenario(TORCH)]
    assert payloads == pkts
    depay = rtpnet.RawVideoDepayloader("BGRA", 32, 8)
    done = []
    for d in payloads:
        done += depay.depay(rtpnet.RtpPacket.parse(d))
    np.testing.assert_array_equal(done[0][1], frame.reshape(8, -1))
