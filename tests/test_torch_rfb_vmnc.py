"""rfbsrc (gst/librfb) and vmncdec (gst/vmnc) and their io modules
(io/rfb.py, io/vmnc.py) through gstbad_tpu and gstbad_tpu_torch on the
same inputs, byte for byte: rfbsrc against scripted servers (the JAX
tests' in-memory MockServer, one copy a package, and chip_smoke's RFB 3.8
server over localhost TCP), vmncdec's negotiation and frames for each
pixel layout, its checkpoint position, and the slice as a whole:
`vmncdec ! the headline's chain` through both packages' parse_launch, with
the route its fused tail takes in each; and the JAX tests of
tests/test_rfb.py and tests/test_vmnc.py run on both packages side by
side (helpers/twin.py)."""

import copy
import hashlib
import socket
import struct
import threading

import numpy as np
import pytest

import chip_smoke
import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_rfb as trfb
import test_vmnc as tvmnc
from gstbad_tpu.io import rfb as jrfb
from gstbad_tpu.io import vmnc as jvmnc
from gstbad_tpu_torch.io import rfb as trfb_io
from gstbad_tpu_torch.io import vmnc as tvmnc_io
from helpers.torch_transport import JAX, assert_both
from helpers.twin import Twin, jax_test_cases

W, H = 64, 48
HEADLINE = "vmncdec framerate=60/1 ! " + chip_smoke.HEAD \
    + " ! zebrastripe ! fakesink"


def _wmvi(bpp, depth, be, masks, shifts):
    body = bytes([bpp, depth, be, 1]) + struct.pack(">HHH", *masks) \
        + bytes(shifts) + b"\x00\x00\x00"
    return struct.pack(">HHHHI", 0, 0, W, H, tvmnc_io.TYPE_WMVi) + body


def _update(*rects):
    return struct.pack(">BBH", 0, 0, len(rects)) + b"".join(rects)


def _raw(data):
    return struct.pack(">HHHHI", 0, 0, W, H, tvmnc_io.TYPE_RAW) + data


LAYOUTS = {
    "BGRx": (32, 24, 0, (255, 255, 255), (16, 8, 0)),
    "RGBx": (32, 24, 0, (255, 255, 255), (0, 8, 16)),
    "xRGB": (32, 24, 1, (255, 255, 255), (16, 8, 0)),
    "GRAY8": (8, 8, 0, (7, 7, 3), (5, 2, 0)),
    "RGB16": (16, 16, 0, (31, 63, 31), (11, 5, 0)),
    "BGR15_be": (16, 15, 1, (31, 31, 31), (0, 5, 10)),
}


def _run_vmnc(pkg, packets, desc="vmncdec framerate=25/1 ! fakesink",
              window=3):
    p = pkg.parse_launch(desc, **({} if pkg is gt else {"device": "cpu"}))
    src = next(n.element for n in p.nodes if n.element.NAME == "vmncdec")
    for x in packets:
        src.push_packet(x)
    outs = p.run(window=window)
    return ([np.asarray(o.data) for o in outs],
            [np.asarray(o.pts) for o in outs], src.out_spec.format)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_vmncdec_layouts(layout):
    """Each WMVi pixel layout: the same format and frames (a RAW frame,
    then seeded RAW and HEXTILE-free updates) from both packages."""
    bpp, depth, be, masks, shifts = LAYOUTS[layout]
    rng = np.random.default_rng(len(layout))
    packets = [_update(_wmvi(bpp, depth, be, masks, shifts),
                       _raw(rng.integers(0, 256, W * H * bpp // 8,
                                         dtype=np.uint8).tobytes()))]
    for k in range(4):
        x, y = int(rng.integers(0, W - 8)), int(rng.integers(0, H - 8))
        body = rng.integers(0, 256, 64 * bpp // 8, dtype=np.uint8).tobytes()
        packets.append(_update(struct.pack(">HHHHI", x, y, 8, 8,
                                           tvmnc_io.TYPE_RAW) + body))
    j, t = _run_vmnc(gt, packets), _run_vmnc(gtt, packets)
    assert t[2] == j[2]
    for a, b in zip(j[0] + j[1], t[0] + t[1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_vmncdec_refusals_match():
    """A 16-bit mask layout with no VideoFormat, and a stream that starts
    without WMVi: the same error from both packages."""
    odd = [_update(_wmvi(16, 12, 0, (15, 15, 15), (8, 4, 0)))]
    no_wmvi = [_update(_raw(b"\x00" * W * H * 4))]
    for packets in (odd, no_wmvi, []):
        assert_both(lambda pkg: _run_vmnc(
            gt if pkg is JAX else gtt, packets)[2], raises=True)


def test_vmncdec_checkpoint_position():
    """save_position after a window, then restore_position on a new
    element (the decoder replays to it): the rest of the stream is the
    same from both packages and equals the uninterrupted run."""
    packets = chip_smoke.screen_updates(7, W, H, seed=3)

    def run(pkg):
        def element():
            p = (gt.parse_launch("vmncdec ! fakesink") if pkg is JAX
                 else gtt.parse_launch("vmncdec ! fakesink", device="cpu"))
            el = p.nodes[0].element
            for x in packets:
                el.push_packet(x)
            p.negotiate()
            return el
        el = element()
        whole = [np.asarray(el.pull_window(3).data) for _ in range(3)]
        el2 = element()
        el2.restore_position(3)
        rest = [np.asarray(el2.pull_window(3).data) for _ in range(2)]
        assert np.array_equal(rest[0], whole[1])
        return whole, rest, el2.save_position()
    assert_both(run)


def test_vmnc_headline_graph_and_route(monkeypatch):
    """The slice as a whole: a seeded VMnc recording (phase 4m's
    screen_updates: a RAW frame, then COPY, HEXTILE and cursor updates)
    through `vmncdec ! the headline's chain ! zebrastripe`, 2 windows of
    3, at 64x48 and 128x48: the same frames and pts from both packages.
    Behind vmncdec the chain folds as behind videotestsrc: the port's
    fused tail calls dilate_zebra_fused (K1; its plain version on the
    CPU) once a window, and no whole-word lookup (K2).  The JAX package
    takes its fused Pallas tail for the same graph where its tiling
    allows it (width a multiple of 128, elements/video/videofilters.py
    table_tail) and, at 64 wide, its whole-word lookup (apply_word_table,
    K2's)."""
    from gstbad_tpu.ops import chainfuse as jchainfuse
    from gstbad_tpu.ops import lut as jlut
    from gstbad_tpu_torch.ops import chainfuse, lut
    calls = {}

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
    for w in (W, 128):
        calls.update(k1=0, k2=0, j1=0, j2=0)
        packets = chip_smoke.screen_updates(6, w, H)
        t = _run_vmnc(gtt, packets, HEADLINE)
        j = _run_vmnc(gt, packets, HEADLINE)
        assert len(t[0]) == len(j[0]) == 2
        assert t[0][0].shape == (3, H, w, 4)
        for a, b in zip(j[0] + j[1], t[0] + t[1]):
            np.testing.assert_array_equal(a, b)
        assert (calls["k1"], calls["k2"]) == (2, 0), calls
        # the JAX step is traced once and then replayed: one call or more
        fused = w % 128 == 0
        assert (calls["j1"] >= 1, calls["j2"] >= 1) == (fused, not fused), (
            w, calls)
    assert chainfuse.dilate_zebra_fused.launches == 0   # the CPU: plain


def test_port_vmncdec_uploads_once_to_its_device(monkeypatch):
    """vmncdec hands the runner each window in one host-to-device copy
    (core/frame.upload_frames), on the pipeline's device."""
    from gstbad_tpu_torch.core import frame
    seen = []
    orig = frame.upload_frames

    def spy(device, frames, **kw):
        seen.append((str(device), len(frames)))
        return orig(device, frames, **kw)
    monkeypatch.setattr("gstbad_tpu_torch.elements.video.vmncdec."
                        "upload_frames", spy)
    out = _run_vmnc(gtt, chip_smoke.screen_updates(5, W, H), window=4)
    assert seen == [("cpu", 4), ("cpu", 4)]
    assert [len(p) for p in out[1]] == [4, 1]


def test_rfbsrc_over_tcp_against_a_scripted_server():
    """rfbsrc of each package against chip_smoke's scripted RFB 3.8
    server (rfb_serve: VNC authentication, a RAW frame then COPY and
    HEXTILE updates) over localhost TCP, a server thread each: every
    pulled frame equals the server's framebuffer, in both packages."""
    frames, hashes = {}, {}
    for pkg in (gt, gtt):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        th = threading.Thread(target=lambda: hashes.__setitem__(
            pkg, chip_smoke.rfb_serve(srv, 5, W, H, 11)), daemon=True)
        th.start()
        try:
            el = pkg.make("rfbsrc", host="127.0.0.1",
                          port=srv.getsockname()[1], version="3.8",
                          password=chip_smoke.RFB_PASSWORD,
                          **{"use-copyrect": True})
            el.connect_tcp()
            frames[pkg] = [el.pull_frame() for _ in range(5)]
            th.join(timeout=60)
        finally:
            srv.close()
        assert [hashlib.sha256(f.tobytes()).hexdigest()
                for f in frames[pkg]] == hashes[pkg]
    for a, b in zip(frames[gt], frames[gtt]):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------- the JAX tests on both packages

def _dual_connect(server, **props):
    """The JAX tests' _connect on both packages: each rfbsrc gets a copy
    of the scripted server as it stands before the handshake."""
    pair = []
    for pkg, srv in ((gt, server), (gtt, copy.deepcopy(server))):
        el = pkg.make("rfbsrc", **props)
        try:
            el.connect(srv)
            pair.append((el, None))
        except Exception as e:       # the class and message are compared
            pair.append((el, e))
    (j, je), (t, te) = pair
    assert (type(je).__name__, str(je)) == (type(te).__name__, str(te))
    if je is not None:
        raise je
    return Twin(j, t)


_NAMES = {trfb: {"gt": (gt, gtt), "rfb": (jrfb, trfb_io)},
          tvmnc: {"vmnc": (jvmnc, tvmnc_io)}}
# left out: the vmncdec element tests, which build JAX Pipelines
# (test_vmncdec_layouts and test_vmncdec_refusals_match hold the two
# elements to each other on the same streams)
NOT_HERE = ("test_wmvi_byte_layouts_and_element", "test_wmvi_rgbx_and_gray8",
            "test_wmvi_16bit_565_and_555", "test_wmvi_16bit_big_endian_bytes")


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(_NAMES, NOT_HERE))
def test_jax_rfb_vmnc_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of rfbsrc and of the VMnc decoder with its module
    names bound to the JAX package's and the port's side by side (each
    call's result, or error, equal; the JAX test's own assertions on top;
    each rfbsrc talks to its own copy of the mock server)."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    if mod is trfb:
        monkeypatch.setattr(mod, "_connect", _dual_connect)
    fn(**kwargs)
