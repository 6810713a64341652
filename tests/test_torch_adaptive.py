"""Adaptive-streaming parity: gstbad_tpu_torch.session.adaptive and the
port's dashdemux, hlsdemux and mssdemux against the JAX package's, on the
manifests of tests/test_adaptive.py with an injected fetch and clock
(FakeNet: each URI downloads at a set link rate).  Every scenario's
emitted fragments (URIs, byte ranges, pts, durations, caps changes,
bitrate switches, needs-manifest) and the URIs fetched, in order, are
equal; so are the rate estimator's values and a failed download's
error."""

import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.session import adaptive as j_ad
from gstbad_tpu_torch.session import adaptive as t_ad
from test_adaptive import (MASTER, MPD, MPD_TIMELINE, MPD_TWO_PERIODS, MSS,
                           FakeNet, _dash_files, _hls_files)

PACKAGES = ((j_ad, gt), (t_ad, gtt))


class Net(FakeNet):
    """FakeNet that logs each fetch's byte range beside its URI."""

    def fetch(self, uri, byte_range=None):
        data = super().fetch(uri, byte_range)
        self.log[-1] = (uri, byte_range)
        return data


def _mss_files(sizes=(("300000", 20_000), ("2000000", 200_000))):
    return {f"http://m/QualityLevels({q})/Fragments(video={t})": b"f" * n
            for q, n in sizes for t in range(0, 80000000, 20000000)}


def hls_up(ad, pkg):
    net = Net(_hls_files(), rate_bps=10_000_000)
    d = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                    clock=net.clock)
    return list(d.fragments()), net.log


def hls_down(ad, pkg):
    net = Net(_hls_files(), rate_bps=10_000_000)
    d = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                    clock=net.clock)
    d.streams[0].adapter.select_bitrate(2_000_000)
    net.rate = 200_000
    return list(d.fragments()), net.log


def hls_pinned(ad, pkg):
    net = Net(_hls_files(), rate_bps=50_000)
    d = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                    clock=net.clock, connection_speed_kbps=2000)
    return list(d.fragments(max_fragments=3)), net.log


def hls_live(ad, pkg):
    live = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-MEDIA-SEQUENCE:0\n"
            "#EXTINF:2,\nhttp://x/s0.ts\n")
    net = Net({"http://x/live.m3u8": live.encode(),
               "http://x/s0.ts": b"a" * 100,
               "http://x/s1.ts": b"b" * 100})
    it = ad.open_hls(live, "http://x/live.m3u8", net.fetch,
                     clock=net.clock).fragments()
    got = [next(it), next(it)]
    net.files["http://x/live.m3u8"] = (
        live + "#EXTINF:2,\nhttp://x/s1.ts\n").encode()
    got.append(next(it))
    assert got[1].get("needs-manifest")
    return got, net.log


def hls_byte_ranges(ad, pkg):
    media = ("#EXTM3U\n#EXT-X-TARGETDURATION:2\n#EXT-X-VERSION:4\n"
             "#EXTINF:2,\n#EXT-X-BYTERANGE:1000@0\nhttp://x/all.ts\n"
             "#EXTINF:2,\n#EXT-X-BYTERANGE:1500\nhttp://x/all.ts\n"
             "#EXTINF:2,\n#EXT-X-BYTERANGE:700@4000\nhttp://x/all.ts\n"
             "#EXT-X-ENDLIST\n")
    net = Net({"http://x/one.m3u8": media.encode(),
               "http://x/all.ts": bytes(range(256)) * 20})
    d = ad.open_hls(media, "http://x/one.m3u8", net.fetch, clock=net.clock)
    frags = list(d.fragments())
    assert [r for _, r in net.log] == [(0, 1000), (1000, 1500),
                                      (4000, 700)]
    return frags, net.log


def hls_seek(ad, pkg):
    net = Net(_hls_files())
    d = ad.open_hls(MASTER, "http://x/master.m3u8", net.fetch,
                    clock=net.clock, connection_speed_kbps=50)
    got = []
    for pos, snap in ((5_000_000_000, False), (4_000_000_000, True),
                      (4_100_000_000, True), (0, False)):
        d.seek(pos, snap_after=snap)
        got.append(next(d.fragments()))
    return got, net.log


def dash_switch(ad, pkg):
    net = Net(_dash_files(), rate_bps=10_000_000)
    d = ad.open_dash(MPD, net.fetch, base_uri="http://d/", clock=net.clock)
    return list(d.fragments()), net.log


def dash_timeline(ad, pkg):
    net = Net({"http://d/a/0.m4s": b"1" * 10,
               "http://d/a/2000.m4s": b"2" * 10,
               "http://d/a/3500.m4s": b"3" * 10})
    d = ad.open_dash(MPD_TIMELINE, net.fetch, base_uri="http://d/",
                     clock=net.clock)
    return list(d.fragments()), net.log


def dash_seek(ad, pkg):
    net = Net(_dash_files())
    d = ad.open_dash(MPD, net.fetch, base_uri="http://d/", clock=net.clock,
                     connection_speed_kbps=50)
    got = list(d.fragments(max_fragments=3))
    d.seek(7_000_000_000)
    return got + list(d.fragments(max_fragments=2)), net.log


def dash_periods(ad, pkg):
    net = Net({f"http://d/p{p}/{n}.m4s": b"x" * 50
               for p in (1, 2) for n in (1, 2)})
    d = ad.open_dash(MPD_TWO_PERIODS, net.fetch, base_uri="http://d/",
                     clock=net.clock)
    return list(d.fragments()), net.log


def mss_switch(ad, pkg):
    net = Net(_mss_files(), rate_bps=50_000_000)
    d = ad.open_mss(MSS.encode(), net.fetch, base_uri="http://m/",
                    clock=net.clock)
    return list(d.fragments()), net.log


def mss_seek(ad, pkg):
    net = Net(_mss_files())
    d = ad.open_mss(MSS.encode(), net.fetch, base_uri="http://m/",
                    clock=net.clock, connection_speed_kbps=50)
    d.seek(4_500_000_000)
    return list(d.fragments()), net.log


def hlsdemux_element(ad, pkg):
    net = Net(_hls_files(), rate_bps=10_000_000)
    el = pkg.make("hlsdemux", **{"connection-speed": 150})
    el.load(MASTER, net.fetch, uri="http://x/master.m3u8", clock=net.clock)
    return list(el.fragments(max_fragments=4)), net.log


def dashdemux_element(ad, pkg):
    net = Net(_dash_files(), rate_bps=3_000_000)
    el = pkg.make("dashdemux", **{"bitrate-limit": 0.5})
    el.load(MPD, net.fetch, base_uri="http://d/", clock=net.clock)
    assert el.demux.bitrate_limit == 0.5
    return list(el.fragments()), net.log


def mssdemux_element(ad, pkg):
    net = Net(_mss_files(), rate_bps=5_000_000)
    el = pkg.make("mssdemux")
    el.load(MSS, net.fetch, base_uri="http://m/", clock=net.clock)
    return [el.streams[0].adapter.caps()] + list(el.fragments()), net.log


SCENARIOS = [hls_up, hls_down, hls_pinned, hls_live, hls_byte_ranges,
             hls_seek, dash_switch, dash_timeline, dash_seek, dash_periods,
             mss_switch, mss_seek, hlsdemux_element, dashdemux_element,
             mssdemux_element]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fragments_equal(scenario):
    (jf, jlog), (tf, tlog) = (scenario(ad, pkg) for ad, pkg in PACKAGES)
    assert tf == jf
    assert tlog == jlog
    assert tf


def test_rate_estimator():
    """The moving average, the bitrate limit's conservative minimum and
    the connection-speed override give the JAX package's values."""
    out = []
    for ad, _ in PACKAGES:
        st = ad._StreamState(ad.AdaptiveStream())
        avg = [st.update_average_bitrate(b) for b in (300, 600, 900, 1200,
                                                      77, 5)]
        demux = ad.AdaptiveDemux(fetch=lambda *a, **k: b"")
        st = ad._StreamState(ad.AdaptiveStream())
        cur = []
        for last in (1000, 100, 4321, 9):
            st.last_bitrate = last
            cur.append(demux._update_current_bitrate(st))
        pinned = ad.AdaptiveDemux(fetch=lambda *a, **k: b"",
                                  connection_speed_kbps=5000)
        out.append((avg, cur, pinned._update_current_bitrate(st)))
    assert out[1] == out[0]


def test_download_error_propagates():
    files = {"http://x/one.m3u8":
             b"#EXTM3U\n#EXTINF:2,\nhttp://x/s0.ts\n#EXT-X-ENDLIST\n"}

    def fetch(uri, byte_range=None):
        if uri.endswith(".m3u8"):
            return files[uri]
        raise IOError(f"404 {uri}")

    errors = []
    for ad, _ in PACKAGES:
        d = ad.open_hls(files["http://x/one.m3u8"].decode(),
                        "http://x/one.m3u8", fetch)
        with pytest.raises(IOError) as e:
            list(d.fragments())
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(t_ad.AdaptiveError):
        gtt.make("hlsdemux").fragments()
