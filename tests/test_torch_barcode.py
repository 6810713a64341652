"""zbar and zxing of the port against the JAX package on the CPU (host
scanners on the luma plane, io/qrdecode.py and io/barcode1d.py copied
into the port): the barcode messages are equal, field for field, on QR,
EAN-13 and Code 128 frames; and the negotiation of the slice's 9 names
(facedetect, faceblur, handdetect, disparity, segmentation, cvtracker,
grabcut, zbar, zxing) over a sweep of input specs: the same output spec,
or an error of the same class, in both packages."""

import os

import numpy as np
import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.io import barcode1d, qr, qrdecode

SLICE = ("facedetect", "faceblur", "handdetect", "disparity", "segmentation",
         "cvtracker", "grabcut", "zbar", "zxing")


def _qr(text, ps=5, size=200):
    m = qr.encode(text, "M")
    img = np.full((size, size), 255, np.uint8)
    n = m.shape[0]
    img[20:20 + n * ps, 20:20 + n * ps] = np.where(
        np.kron(m, np.ones((ps, ps), bool)), 20, 240)
    return img


def _canvas(sym, h=220, w=380):
    img = np.full((h, w), 255, np.uint8)
    img[10:10 + sym.shape[0], 10:10 + sym.shape[1]] = sym
    return img


def _drive(pkg, name, frames, **props):
    kw = {} if pkg is gt else {"device": "cpu"}
    h, w = frames.shape[1:]
    p = pkg.parse_launch(f"appsrc name=s format=GRAY8 width={w} height={h} "
                         f"! {name} name=z " + " ".join(
                             f"{k}={v}" for k, v in props.items())
                         + " ! fakesink", **kw)
    p.get_by_name("s").push_frames(frames)
    p.run(window=2)
    return p.bus


@pytest.mark.parametrize("name,props", [
    ("zbar", {}), ("zbar", {"cache": "true", "attach-frame": "true"}),
    ("zxing", {}), ("zxing", {"format": "code_128", "try-rotate": "true"})])
def test_barcode_messages(name, props):
    frames = np.stack([_canvas(_qr("port parity")),
                       _canvas(_qr("port parity")),
                       _canvas(qrdecode.ean13_render("4006381333931",
                                                     module_px=3)),
                       _canvas(barcode1d.render_code128("PORT-128"))])
    jb = _drive(gt, name, frames, **props)
    tb = _drive(gtt, name, frames, **props)
    jm = [(m.element, m.name, m.pts, {k: v for k, v in m.fields.items()
                                      if k != "frame"}) for m in jb.messages]
    tm = [(m.element, m.name, m.pts, {k: v for k, v in m.fields.items()
                                      if k != "frame"}) for m in tb.messages]
    assert jm == tm and len(tm) >= 1
    for a, b in zip(jb.messages, tb.messages):
        if "frame" in a.fields:
            np.testing.assert_array_equal(b.fields["frame"], a.fields["frame"])


def _specs(pkg):
    cls = JMediaSpec if pkg is gt else MediaSpec
    out = []
    for fmt in ("RGB", "RGBA", "GRAY8", "I420", "AYUV", "BGRx"):
        for w, h in ((64, 48), (63, 47), (30, 22)):
            out.append(cls(kind="video", format=fmt, width=w, height=h))
    out.append(cls(kind="audio", format="S16", rate=48000, channels=2))
    return out


def _negotiate(pkg, name, spec, props):
    el = pkg.make(name, **props)
    try:
        out = el.set_info([spec, spec] if name == "disparity" else spec)
    except Exception as e:   # noqa: BLE001 - the class is compared
        return type(e).__name__
    return (out.kind, out.format, out.width, out.height)


@pytest.mark.parametrize("name", SLICE)
def test_negotiation_sweep(name):
    """Each name over 19 input specs (disparity over pairs of them), with
    its defaults and, for the cascade elements, the port's alt2 copy."""
    alt2 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "gstbad_tpu_torch", "data",
                        "haarcascade_frontalface_alt2.xml")
    for props in ({}, {"profile": alt2}):
        if props and name not in ("facedetect", "faceblur"):
            continue
        got = {pkg: [_negotiate(pkg, name, s, props) for s in _specs(pkg)]
               for pkg in (gt, gtt)}
        assert got[gt] == got[gtt], name
    assert name in gtt.element_names()
