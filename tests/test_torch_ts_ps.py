"""MPEG transport and program streams (io/mpegts.py, io/mpegps.py,
io/mpegts_si.py and the mpegtsmux, tsdemux, tsparse, mpegpsmux and
mpegpsdemux elements) through gstbad_tpu and gstbad_tpu_torch on the same
inputs: the scenarios of tests/test_mpegts.py and test_mpegps.py, where
the JAX tests' ffmpeg oracle is replaced by the JAX package's own mux
output, compared byte for byte; and the JAX package's PSI/SI section
tests (tests/test_mpegts_si.py) run on both packages side by side."""

import numpy as np
import pytest

import test_mpegts_si
from gstbad_tpu.io import mpegts_si as JSI
from helpers.torch_transport import TORCH, assert_both
from helpers.twin import Twin, jax_test_cases

NSEC = 1_000_000_000


def _mux_av(pkg, n=12, seed=7):
    """A 2-stream (video + audio) TS with seeded payloads."""
    ts = pkg.io("mpegts")
    rng = np.random.default_rng(seed)
    mux = ts.TsMux()
    v = mux.add_stream(ts.ST_VIDEO_H264)
    a = mux.add_stream(ts.ST_AUDIO_AAC, language="eng")
    stream = b""
    for i in range(n):
        vd = rng.integers(0, 256, 700 + 13 * i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 200, np.uint8).tobytes()
        pts = 90000 + i * 3000
        stream += b"".join(mux.add_data(v, vd, pts=pts, dts=pts - 1500,
                                        random_access=(i % 5 == 0)))
        stream += b"".join(mux.add_data(a, ad, pts=pts))
    return mux, stream


def _demux(pkg, stream, step=None):
    ts = pkg.io("mpegts")
    dmx = ts.TsDemux()
    outs = []
    step = step or len(stream) or 1
    for i in range(0, len(stream), step):
        outs += dmx.push(stream[i:i + step])
    outs += dmx.eos()
    return outs, dmx.continuity_errors, dmx.streams, dmx.pcr_pid, dmx.pat


# --------------------------------------------------------------- TS wire

def ts_mux_bytes(pkg):
    return _mux_av(pkg)[1]


def ts_sections(pkg):
    ts = pkg.io("mpegts")
    mux = ts.TsMux()
    mux.add_stream(ts.ST_VIDEO_H264)
    pat, pmt = mux._pat_section(), mux._pmt_section()
    return pat, pmt, ts.crc32_mpeg(pat), ts.crc32_mpeg(pmt)


def ts_pes_timestamps(pkg):
    ts = pkg.io("mpegts")
    out = []
    for v in (0, 1, 90000, (1 << 33) - 1):
        st = ts.TsMuxStream(0x40, ts.ST_VIDEO_H264)
        hdr = st.pes_header(10, v, v - 1 if v else ts.NO_TS)
        out.append((hdr, ts._get_ts(hdr[9:14])))
    return out


def ts_roundtrip(pkg):
    return _demux(pkg, _mux_av(pkg)[1], step=997)


def ts_resync(pkg):
    stream = _mux_av(pkg)[1]
    cut = 30 * 188
    bad = stream[:cut] + b"\xde\xad\xbe\xef" * 50 + stream[cut + 2 * 188:]
    return _demux(pkg, bad)


def ts_random_access(pkg):
    outs = _demux(pkg, _mux_av(pkg)[1])[0]
    return [(o.pid, o.random_access) for o in outs]


def ts_psi_cadence(pkg):
    ts = pkg.io("mpegts")
    mux = ts.TsMux(pat_interval=3000, pmt_interval=3000)
    v = mux.add_stream(ts.ST_VIDEO_H264)
    return b"".join(b"".join(mux.add_data(v, b"x" * 64, pts=i * 1500))
                    for i in range(10))


def ts_unbounded_pes(pkg):
    ts = pkg.io("mpegts")
    mux = ts.TsMux()
    v = mux.add_stream(ts.ST_VIDEO_H264)
    big = np.random.default_rng(7).integers(0, 256, 70000,
                                            np.uint8).tobytes()
    stream = b"".join(mux.add_data(v, big, pts=90000))
    stream += b"".join(mux.add_data(v, b"tail", pts=93000))
    out = [stream, _demux(pkg, stream)]
    a = mux.add_stream(ts.ST_AUDIO_AAC)
    try:
        mux.add_data(a, big, pts=90000)
    except ts.TsError as e:
        out.append(("TsError", str(e)))
    return out


def ts_other_mux_our_demux(pkg):
    """The JAX tests' ffmpeg-muxed MPEG-2 video + MP2 audio case, muxed
    here by the JAX package: each package demuxes the same bytes."""
    from gstbad_tpu.io import mpegts as jts
    rng = np.random.default_rng(7)
    mux = jts.TsMux()
    v = mux.add_stream(jts.ST_VIDEO_MPEG2)
    a = mux.add_stream(jts.ST_AUDIO_MPEG1)
    blob = b""
    for i in range(12):
        vd = rng.integers(0, 256, 600 + i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 150, np.uint8).tobytes()
        pts = 180000 + i * 3000
        blob += b"".join(mux.add_data(v, vd, pts=pts, dts=pts - 1000))
        blob += b"".join(mux.add_data(a, ad, pts=pts))
    return _demux(pkg, blob, step=1000)


def ts_elements(pkg):
    mux = pkg.make("mpegtsmux")
    v = mux.connect("video/x-h264")
    a = mux.connect("audio/aac", language="deu")
    stream = b""
    for i in range(5):
        stream += mux.chain(v, b"video%d" % i, pts_ns=i * NSEC,
                            dts_ns=i * NSEC - 500 if i else 0,
                            random_access=True)
        stream += mux.chain(a, b"audio%d" % i, pts_ns=i * NSEC)
    dmx = pkg.make("tsdemux")
    outs = dmx.push_bytes(stream) + dmx.event_eos()
    return (stream, outs, dmx.streams, dmx.pcr_pid, dmx.continuity_errors,
            mux.packets_out)


def ts_tsparse(pkg):
    stream = _mux_av(pkg, n=4)[1]
    parse = pkg.make("tsparse")
    out = parse.chain(stream[:1000]) + parse.chain(stream[1000:])
    return out, parse.programs, parse.streams


def ts_typefind(pkg):
    return pkg.io("typefind").find_type(_mux_av(pkg, n=2)[1])


def ts_m2ts(pkg):
    rng = np.random.default_rng(7)
    mux = pkg.make("mpegtsmux", **{"m2ts-mode": True})
    v = mux.connect("video/x-h264")
    stream = b"".join(mux.chain(v, rng.integers(0, 256, 400,
                                                np.uint8).tobytes(),
                                pts_ns=i * NSEC) for i in range(6))
    dmx = pkg.make("tsdemux")
    outs = []
    for i in range(0, len(stream), 700):
        outs += dmx.push_bytes(stream[i:i + 700])
    return stream, outs + dmx.event_eos()


def ts_unknown_caps(pkg):
    return pkg.make("mpegtsmux").connect("video/x-nope")


TS_CASES = [ts_mux_bytes, ts_sections, ts_pes_timestamps, ts_roundtrip,
            ts_resync, ts_random_access, ts_psi_cadence, ts_unbounded_pes,
            ts_other_mux_our_demux, ts_elements, ts_tsparse, ts_typefind,
            ts_m2ts, ts_unknown_caps]


@pytest.mark.parametrize("case", range(len(TS_CASES)))
def test_mpegts_parity(case):
    fn = TS_CASES[case]
    assert_both(fn, raises=fn is ts_unknown_caps)


def test_ts_roundtrip_gives_back_what_went_in():
    """The port's demux of its own mux: every PES, its pts and dts, no
    continuity error, the PMT's stream table and PCR PID."""
    ts = TORCH.io("mpegts")
    outs, cc, streams, pcr, pat = ts_roundtrip(TORCH)
    assert len(outs) == 24 and cc == 0
    assert streams == {0x40: ts.ST_VIDEO_H264, 0x41: ts.ST_AUDIO_AAC}
    assert pcr == 0x40 and pat == {1: ts.START_PMT_PID}
    assert [o.pts for o in outs[::2]] == [90000 + 3000 * i
                                          for i in range(12)]
    assert all(o.dts == o.pts - 1500 for o in outs[::2])


# --------------------------------------------------------------- PS

def _ps_mux_av(pkg, n=10):
    ps = pkg.io("mpegps")
    rng = np.random.default_rng(11)
    mux = ps.PsMux()
    v = mux.add_stream(ps.ST_VIDEO_MPEG2)
    a = mux.add_stream(ps.ST_AUDIO_MPEG1)
    stream = b""
    for i in range(n):
        vd = rng.integers(0, 256, 900 + i, np.uint8).tobytes()
        ad = rng.integers(0, 256, 300, np.uint8).tobytes()
        pts = 90000 + i * 3000
        stream += mux.add_data(v, vd, pts=pts, dts=pts - 1500)
        stream += mux.add_data(a, ad, pts=pts)
    return stream + mux.finish()


def _ps_demux(pkg, stream, step=None):
    d = pkg.io("mpegps").PsDemux()
    outs = []
    step = step or len(stream) or 1
    for i in range(0, len(stream), step):
        outs += d.push(stream[i:i + step])
    return outs, d.stream_types, d.last_scr, d.saw_end


def ps_stream_ids(pkg):
    ps = pkg.io("mpegps")
    mux = ps.PsMux()
    return [mux.add_stream(t).stream_id for t in (
        ps.ST_AUDIO_MPEG1, ps.ST_AUDIO_MPEG2, ps.ST_VIDEO_MPEG2,
        ps.ST_PRIVATE_DATA, ps.ST_VIDEO_H264, ps.ST_AUDIO_AAC)]


def ps_pack_header(pkg):
    stream = _ps_mux_av(pkg, n=1)
    return stream, _ps_demux(pkg, stream)


def ps_roundtrip(pkg):
    return _ps_demux(pkg, _ps_mux_av(pkg), step=777)


def ps_large_payload(pkg):
    ps = pkg.io("mpegps")
    mux = ps.PsMux()
    v = mux.add_stream(ps.ST_VIDEO_MPEG2)
    big = np.random.default_rng(11).integers(0, 256, 150000,
                                             np.uint8).tobytes()
    stream = mux.add_data(v, big, pts=90000)
    return stream, _ps_demux(pkg, stream)


def ps_psm(pkg):
    ps = pkg.io("mpegps")
    mux = ps.PsMux()
    mux.add_stream(ps.ST_VIDEO_MPEG2)
    sec = mux._psm()
    return sec, ps.crc32_mpeg(sec)


def ps_other_mux_our_demux(pkg):
    """The JAX tests' ffmpeg PS case, muxed here by the JAX package."""
    from gstbad_tpu.io import mpegps as jps
    rng = np.random.default_rng(11)
    mux = jps.PsMux()
    v = mux.add_stream(jps.ST_VIDEO_MPEG2)
    a = mux.add_stream(jps.ST_AUDIO_MPEG1)
    blob = b""
    for i in range(10):
        pts = 180000 + i * 3000
        blob += mux.add_data(v, rng.integers(0, 256, 600,
                                             np.uint8).tobytes(),
                             pts=pts, dts=pts - 1000)
        blob += mux.add_data(a, rng.integers(0, 256, 150,
                                             np.uint8).tobytes(), pts=pts)
    return _ps_demux(pkg, blob + mux.finish(), step=512)


def ps_elements(pkg):
    mux = pkg.make("mpegpsmux")
    v = mux.connect("video/mpeg2")
    a = mux.connect("audio/mpeg")
    stream = b""
    for i in range(4):
        stream += mux.chain(v, b"v%d" % i, pts_ns=i * NSEC)
        stream += mux.chain(a, b"a%d" % i, pts_ns=i * NSEC)
    stream += mux.event_eos()
    dmx = pkg.make("mpegpsdemux")
    return stream, dmx.push_bytes(stream), dmx.saw_end, dmx.stream_types


def ps_typefind(pkg):
    return pkg.io("typefind").find_type(_ps_mux_av(pkg, n=1))


def ps_unknown_caps(pkg):
    return pkg.make("mpegpsmux").connect("video/x-nope")


PS_CASES = [ps_stream_ids, ps_pack_header, ps_roundtrip, ps_large_payload,
            ps_psm, ps_other_mux_our_demux, ps_elements, ps_typefind,
            ps_unknown_caps]


@pytest.mark.parametrize("case", range(len(PS_CASES)))
def test_mpegps_parity(case):
    fn = PS_CASES[case]
    assert_both(fn, raises=fn is ps_unknown_caps)


# --------------------------------------------------------------- PSI/SI

def si_canned_vectors(pkg):
    """The upstream packetize vectors (tests/test_mpegts_si.py), parsed
    into typed sections by both packages."""
    import test_mpegts_si as jt
    si = pkg.io("mpegts_si")
    out = []
    for pid, data in ((0, jt.PAT_DATA), (0x20, jt.PMT_DATA),
                      (0x10, jt.NIT_DATA), (0x11, jt.SDT_DATA),
                      (0x1FFB, jt.STT_DATA)):
        sec = si.section_new(pid, data)
        out.append((sec, sec.get_pat(), sec.get_pmt(), sec.get_nit(),
                    sec.get_sdt(), sec.get_atsc_stt(), sec.packetize()))
    return out


def si_walk_on_muxed_stream(pkg):
    ts, si = pkg.io("mpegts"), pkg.io("mpegts_si")
    mux = ts.TsMux()
    st = mux.add_stream(0x1B)
    out = bytearray()
    eit = si.Eit(service_id=1, transport_stream_id=2,
                 original_network_id=3)
    for i in range(12):
        eit.events.append(si.EitEvent(
            event_id=i, start_time=si.DvbTime(2026, 8, 18, i, 0, 0),
            duration=1800, running_status=si.RUNNING_STATUS_RUNNING,
            descriptors=[si.descriptor_from_dvb_network_name(
                f"Programme number {i} with a longish name")]))
    for pid, sec in ((0x12, si.section_from_eit(eit)),
                     (0x14, si.section_from_tdt(
                         si.DvbTime(2026, 8, 18, 9, 30, 0))),
                     (0x14, si.section_from_tot(si.Tot(
                         utc_time=si.DvbTime(2026, 8, 18, 9, 30, 0)))),
                     (0x01, si.section_from_cat(si.Cat(descriptors=[
                         si.Descriptor.build(0x09, b"\x0b\x00\xe0\x64")])))):
        for pkt in mux.psi_packets(pid, sec.packetize()):
            out += pkt
    for pkt in mux.add_data(st, b"\x00" * 512, pts=90000, dts=90000,
                            random_access=True):
        out += pkt
    dmx = ts.TsDemux()
    pes = dmx.push(bytes(out))
    return (bytes(out), pes, [(s.table_id, s.pid, s.data)
                              for s in dmx.si_sections],
            [s.get_eit() for s in dmx.si_sections if s.table_id == 0x4E])


@pytest.mark.parametrize("fn", [si_canned_vectors, si_walk_on_muxed_stream])
def test_mpegts_si_parity(fn):
    assert_both(fn)


# test_si_walk_on_muxed_stream imports the JAX io/mpegts.py in its body,
# so its sections are the JAX package's alone: si_walk_on_muxed_stream
# above runs that walk through both packages
@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(
    [test_mpegts_si], skip=("test_si_walk_on_muxed_stream",)))
def test_jax_si_section_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of the PSI/SI sections with `si` bound to the JAX
    module and the port's copy side by side (helpers/twin.py: each call's
    result, or error, equal; the JAX test's own assertions on top)."""
    monkeypatch.setattr(mod, "si", Twin(JSI, TORCH.io("mpegts_si")))
    fn(**kwargs)


@pytest.mark.parametrize("n", [169, 345, 529, 1081])
def test_ts_mux_of_a_pes_whose_last_packet_carries_183_bytes(n):
    """One PES size in 184 leaves 183 bytes for its last packet, one byte
    short of a packet with an adaptation field of flags: the JAX module
    raises TsError there (io/mpegts.py _ts_packet); the port writes the
    adaptation field of length 0 (ISO/IEC 13818-1 2.4.3.5), and both
    packages demux what it wrote back to the buffers, with their pts."""
    from gstbad_tpu.io import mpegts as jts
    ts = TORCH.io("mpegts")
    data = (bytes(range(256)) * 8)[:n]
    jm = jts.TsMux()
    jv, ja = jm.add_stream(jts.ST_VIDEO_H264), jm.add_stream(jts.ST_AUDIO_AAC)
    tm = ts.TsMux()
    tv, ta = tm.add_stream(ts.ST_VIDEO_H264), tm.add_stream(ts.ST_AUDIO_AAC)
    stream_type = {345: tv, 529: tv, 1081: tv, 169: ta}[n]
    with pytest.raises(jts.TsError, match="payload too large"):
        jm.add_data(jv if stream_type is tv else ja, data, pts=90000,
                    dts=90000 if stream_type is tv else jts.NO_TS)
    blob = b"".join(tm.add_data(stream_type, data, pts=90000,
                                dts=90000 if stream_type is tv else ts.NO_TS))
    blob += b"".join(tm.add_data(tv, b"next", pts=93000, dts=93000))
    assert len(blob) % 188 == 0
    for mod in (jts, ts):
        d = mod.TsDemux()
        outs = d.push(blob) + d.eos()
        assert [(o.data, o.pts) for o in outs] == [(data, 90000),
                                                   (b"next", 93000)]
        assert d.continuity_errors == 0
