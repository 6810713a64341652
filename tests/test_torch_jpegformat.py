"""jpegparse and jifmux (gst/jpegformat) and their io modules
(io/jpeg.py, io/exif.py, io/xmp.py) through gstbad_tpu and
gstbad_tpu_torch on the same inputs, byte for byte: the framed images and
their caps, the remuxed JPEGs, the EXIF and XMP blobs and libexif's
reading of them; and the JAX tests of tests/test_jifmux.py run on both
packages side by side (helpers/twin.py)."""

import numpy as np
import pytest

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
import test_jifmux as tj
from gstbad_tpu.io import exif as jexif
from gstbad_tpu.io import jpeg as jjpeg
from gstbad_tpu.io import xmp as jxmp
from gstbad_tpu_torch.io import exif as texif
from gstbad_tpu_torch.io import jpeg as tjpeg
from gstbad_tpu_torch.io import xmp as txmp
from helpers.torch_transport import assert_both
from helpers.twin import Twin, jax_test_cases

cv2 = pytest.importorskip("cv2")


def _jpeg(w, h, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


STREAM = _jpeg(32, 24, 1) + b"\x00garbage\xff\xd8" + _jpeg(64, 48, 2) \
    + b"\xde\xad" + _jpeg(17, 9, 3)


@pytest.mark.parametrize("step", [1, 7, 333, len(STREAM)])
def test_jpegparse_frames_a_stream_in_chunks(step):
    """Three JPEGs with garbage between them, pushed in chunks: the same
    images and caps from both packages."""
    def run(pkg):
        el = pkg.make("jpegparse")
        out = []
        for i in range(0, len(STREAM), step):
            out += el.chain(STREAM[i:i + step])
        return out
    _, got = assert_both(run)
    assert len(got) == 3


TAG_SETS = [
    {},
    tj.UPSTREAM_TAGS,
    {"comment": "a comment", "title": "a title", "artist": "x"},
    {"title": "only a title", "image-orientation": "rotate-270",
     "keywords": ["alpha", "beta"], "geo-location-latitude": 12.5,
     "geo-location-longitude": -3.25},
]


@pytest.mark.parametrize("tags", TAG_SETS, ids=["none", "upstream",
                                                "comment", "title"])
def test_jifmux_remux_is_byte_for_byte(tags):
    """jifmux on a JPEG with each tag set (set_tags, then merge_tags
    again): the same bytes; a second remux of its output too."""
    src = _jpeg(48, 32, 4)

    def run(pkg):
        mux = pkg.make("jifmux")
        mux.set_tags(**tags)
        mux.merge_tags({"device-model": "m2"} if tags else {})
        once = mux.chain(src)
        return once, pkg.make("jifmux").chain(once)
    assert_both(run)


def test_exif_and_xmp_blobs_and_their_readings():
    """build_exif and build_xmp of the upstream taglist give the same
    bytes, parse_xmp the same fields, and libexif reads the port's EXIF
    as it reads the JAX package's (rendered and raw)."""
    assert texif.build_exif(tj.UPSTREAM_TAGS) == jexif.build_exif(
        tj.UPSTREAM_TAGS)
    blob = txmp.build_xmp(tj.UPSTREAM_TAGS)
    assert blob == jxmp.build_xmp(tj.UPSTREAM_TAGS)
    assert txmp.parse_xmp(blob) == jxmp.parse_xmp(blob)
    if not jexif.libexif_available():
        pytest.skip("libexif not available")
    keys = [(jexif.IFD0, 0x013B), (jexif.IFD0, 0x8298),
            (jexif.IFD_EXIF, 0x829A), (jexif.IFD_EXIF, 0x8827)]
    b = texif.build_exif(tj.UPSTREAM_TAGS)
    assert texif.read_exif(b, keys) == jexif.read_exif(b, keys)
    assert texif.read_exif_raw(b, keys) == jexif.read_exif_raw(b, keys)


def test_jif_mux_errors_match():
    def run(pkg):
        return pkg.io("jpeg").jif_mux(b"\xff\xd9 not a jpeg")
    assert_both(run, raises=True)


# ----------------------------------------- the JAX tests on both packages

_NAMES = {tj: {"gt": (gt, gtt), "ex": (jexif, texif),
               "xmp_io": (jxmp, txmp),
               "JpegParse": (jjpeg.JpegParse, tjpeg.JpegParse),
               "jif_mux": (jjpeg.jif_mux, tjpeg.jif_mux)}}


@pytest.mark.parametrize("mod,fn,kwargs", jax_test_cases(_NAMES))
def test_jax_jifmux_test_runs_on_both(monkeypatch, mod, fn, kwargs):
    """Every JAX test of jifmux and jpegparse with its module names bound
    to the JAX package's and the port's side by side (each call's result,
    or error, equal; the JAX test's own assertions on top)."""
    for name, pair in _NAMES[mod].items():
        monkeypatch.setattr(mod, name, Twin(*pair))
    fn(**kwargs)
