"""The io element facades and the debug elements in the port against the
JAX package on the CPU: aesenc/aesdec (AES-128 and -256 CBC, padding per
buffer or at EOS, the IV in band or not), id3mux (v2.3
and v2.4, with and without the v1 footer, Latin-1 and wider text),
pnmenc/pnmdec (P5 and P6, a header with comments), autovideoconvert
through a graph, checksumsink's digests (packed, planar and audio frames,
with invalid frames in the window), watchdog and clockselect.

Tolerance: bit exact (bytes, digests, frames, messages).
"""

import time

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from helpers.torch_runtime import assert_messages_equal, check_both

torch.set_num_threads(1)   # parallel test workers share the cores

KEY128 = "1f9423681beb9a79215820f6bda73d0f"
KEY256 = KEY128 + "00112233445566778899aabbccddeeff"
IV = "e9aa8e834d8d70b7e0d254ff670dd718"


def _payloads(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (0, 1, 15, 16, 17, 100, 4096, 33)]


@pytest.mark.parametrize("cipher,key", [("aes-128-cbc", KEY128),
                                        ("aes-256-cbc", KEY256)])
@pytest.mark.parametrize("per_buffer", [True, False])
@pytest.mark.parametrize("serialize_iv", [False, True])
def test_aes_equals_the_jax_elements(cipher, key, per_buffer, serialize_iv):
    props = {"key": key, "iv": IV, "cipher": cipher,
             "per-buffer-padding": per_buffer, "serialize-iv": serialize_iv}
    cts = []
    for pkg in (gt, gtt):
        enc = pkg.make("aesenc", **props)
        cts.append([enc.chain(p) for p in _payloads()] + [enc.finish()])
    assert cts[0] == cts[1]
    outs = []
    for pkg in (gt, gtt):
        dec = pkg.make("aesdec", **props)
        outs.append([dec.chain(c) for c in cts[1] if c] + [dec.finish()])
    assert outs[0] == outs[1]
    assert b"".join(outs[1]) == b"".join(_payloads())


def test_aes_refuses_bad_keys_and_padding():
    for pkg in (gt, gtt):
        with pytest.raises(ValueError, match="hex"):
            pkg.make("aesenc", key="abc", iv=IV).chain(b"x")
        dec = pkg.make("aesdec", key=KEY128, iv=IV)
        with pytest.raises(ValueError):
            dec.chain(b"\x00" * 16)
            dec.finish()


@pytest.mark.parametrize("v1,version", [(False, 3), (True, 3), (True, 4),
                                        (False, 4)])
def test_id3mux_equals_the_jax_element(v1, version):
    tags = {"title": "Tìtle", "artist": "Artist", "album": "日本語",
            "track-number": 3, "track-count": 12, "date": 1999,
            "genre": "Jazz", "comment": "seeded", "bpm": 120.4}
    blobs = []
    for pkg in (gt, gtt):
        mux = pkg.make("id3mux", **{"write-v1": v1, "v2-version": version})
        mux.set_tags(**tags)
        mux.chain(b"AUDIO" * 50)
        mux.chain(b"MORE")
        blobs.append(mux.finish())
    assert blobs[0] == blobs[1]
    assert blobs[1][:3] == b"ID3" and (blobs[1][-128:-125] == b"TAG") == v1


def test_pnm_elements_equal_the_jax_elements():
    rng = np.random.default_rng(5)
    for img in (rng.integers(0, 256, (12, 16, 3), np.uint8),
                rng.integers(0, 256, (7, 5), np.uint8)):
        docs = [pkg.make("pnmenc").chain(img) for pkg in (gt, gtt)]
        assert docs[0] == docs[1]
        decs = [pkg.make("pnmdec") for pkg in (gt, gtt)]
        outs = [d.chain(docs[1]) for d in decs]
        np.testing.assert_array_equal(outs[1], outs[0])
        np.testing.assert_array_equal(outs[1], img)
        assert decs[0].src_caps == decs[1].src_caps
    doc = b"P5\n# a comment\n4 2\n255\n" + bytes(range(8))
    assert np.array_equal(gtt.make("pnmdec").chain(doc),
                          gt.make("pnmdec").chain(doc))
    with pytest.raises(ValueError):
        gtt.make("pnmenc").chain(np.zeros((2, 2, 4), np.uint8))


@pytest.mark.parametrize("fmt", ["I420", "BGRx", "GRAY8"])
def test_autovideoconvert_equals_the_jax_element(fmt):
    check_both(f"videotestsrc pattern=ball width=16 height=12 format={fmt} "
               "! autovideoconvert ! fakesink", 4, 2)


@pytest.mark.parametrize("desc", [
    "videotestsrc pattern=ball width=16 height=12 format=BGRx",
    "videotestsrc pattern=ball width=16 height=12 format=I420",
    "videotestsrc pattern=ball width=16 height=12 format=GRAY8 "
    "! videosegmentclip start=40000000 stop=140000000",
    "audiotestsrc samplesperbuffer=64 format=S16"])
def test_checksumsink_digests_equal_the_jax_element(desc):
    (jp, _), (tp, _) = check_both(desc + " ! checksumsink name=c", 8, 4)
    j, t = jp.get_by_name("c"), tp.get_by_name("c")
    assert t.checksums == j.checksums and t.checksums
    assert_messages_equal(jp.bus, tp.bus)


def test_watchdog_and_clockselect():
    check_both("videotestsrc width=8 height=8 ! watchdog timeout=50 "
               "! clockselect clock-id=monotonic ! fakesink", 4, 2)
    p = gtt.parse_launch("videotestsrc width=8 height=8 ! watchdog "
                         "name=w timeout=100000 ! fakesink", device="cpu")
    p.run(n_frames=2, window=2)
    w = p.get_by_name("w")
    w.check()
    w.set_property("timeout", 1)
    time.sleep(0.01)
    with pytest.raises(TimeoutError, match="watchdog"):
        w.check()
    for cid, clock in (("default", time.monotonic),
                       ("monotonic", time.monotonic),
                       ("realtime", time.time)):
        assert gtt.make("clockselect", **{"clock-id": cid}).clock() is clock
    tai = gtt.make("clockselect", **{"clock-id": "tai"}).clock()
    assert abs(tai() - time.clock_gettime(time.CLOCK_TAI)) < 1.0
    with pytest.raises(RuntimeError, match="ptp"):
        gtt.make("clockselect", **{"clock-id": "ptp"}).clock()
    with pytest.raises(ValueError, match="clock-id"):
        gtt.make("clockselect", **{"clock-id": "bogus"})
