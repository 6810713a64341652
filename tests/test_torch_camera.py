"""Camera parity: gstbad_tpu_torch.session.Camera on the CPU against
gstbad_tpu.session.camera.Camera on the same sources — the bytes each
capture and recording writes, the viewfinder's windows, the previews and
the bus messages (image-done, video-done, preview-image, autofocus-done)
equal, exactly.  The photo stage takes its gains on the host once a
window (2^ev as 2.0 ** ev, within 2 ulp of XLA's exp2; a product with a
byte rounds the same here), so no byte differs."""

import os

import numpy as np
import pytest

import gstbad_tpu.session.camera as jcamera
import gstbad_tpu_torch.session.camera as tcamera
from helpers.torch_session import assert_frames_equal, messages

CAMERAS = (("jax", jcamera, {}), ("port", tcamera, {"device": "cpu"}))
SRC = "videotestsrc pattern={} width=64 height=48 format={}"


def both(tmp_path, build, drive):
    """build(mod, location, **device) -> Camera; drive(cam) -> the paths
    it wrote.  The files' bytes, the viewfinder's frames and the bus
    messages are held equal; returns the port's (camera, files)."""
    out = {}
    for label, mod, kw in CAMERAS:
        d = tmp_path / label
        d.mkdir()
        seen = []
        cam = build(mod, str(d / "cap_%d.out"), **kw)
        cam.set_viewfinder(lambda b, spec: seen.extend(
            (int(b.pts[i]), int(b.flags[i]), bool(b.valid[i]),
             {k: np.array(v[i]) for k, v in b.data.items()}
             if isinstance(b.data, dict) else np.array(b.data[i]))
            for i in range(b.batch)))
        paths = drive(cam)
        files = [open(p, "rb").read() for p in paths]
        out[label] = (cam, files, seen, messages(cam.bus))
    (_, jf, js, jm), (tcam, tf, ts, tm) = out["jax"], out["port"]
    assert len(tf) == len(jf) and all(a == b for a, b in zip(jf, tf))
    assert_frames_equal(js, ts)
    assert [m[:3] for m in tm] == [m[:3] for m in jm]
    for a, t in zip(jm, tm):        # file names beside their directories
        assert named(a[3]) == named(t[3]), (a[:3], a[3], t[3])
    return tcam, tf


def named(fields):
    return {k: os.path.basename(v) if k in ("location", "filename") else v
            for k, v in fields.items()}


@pytest.mark.parametrize("fmt", ["BGRx", "AYUV", "I420", "GRAY8", "xRGB"])
def test_image_capture(tmp_path, fmt):
    def build(mod, loc, **kw):
        return mod.Camera(source=SRC.format("gradient", fmt), zoom=2.0,
                          location=loc, **kw)

    def drive(cam):
        return [cam.start_capture(), cam.start_capture()]

    cam, files = both(tmp_path, build, drive)
    assert [m.name for m in cam.bus.messages] == ["image-done"] * 2
    assert files[0].startswith(b"P")


@pytest.mark.parametrize("fmt", ["I420", "AYUV"])
def test_video_recording(tmp_path, fmt):
    def build(mod, loc, **kw):
        return mod.Camera(source=SRC.format("ball", fmt), zoom=1.5,
                          mode=mod.MODE_VIDEO, window=4, location=loc, **kw)

    def drive(cam):
        cam.run_viewfinder(1)
        cam.start_capture()
        assert not cam.idle
        cam.step()
        cam.step()
        return [cam.stop_capture()]

    cam, files = both(tmp_path, build, drive)
    assert cam.idle
    if fmt == "I420":
        assert files[0].startswith(b"YUV4MPEG2") and files[0].count(
            b"FRAME") == 8
    else:
        assert len(files[0]) == 8 * 48 * 64 * 4


@pytest.mark.parametrize("fmt", ["AYUV", "BGRx", "I420", "GRAY8"])
@pytest.mark.parametrize("tone", ["normal", "sepia", "negative",
                                  "grayscale", "solarize"])
def test_photography_settings(tmp_path, fmt, tone):
    """EV, ISO, white balance and tone act on the frames: the viewfinder
    windows and a capture equal the JAX package's."""
    def build(mod, loc, **kw):
        cam = mod.Camera(source=SRC.format("ball", fmt), zoom=1.0,
                         window=2, location=loc, **kw)
        assert cam.set_ev_compensation(0.7)
        assert cam.set_iso_speed(160)
        assert cam.set_white_balance_mode("tungsten")
        assert cam.set_color_tone_mode(tone)
        assert not cam.set_color_tone_mode("no-such-tone")
        return cam

    def drive(cam):
        cam.run_viewfinder(2)
        return [cam.start_capture()]

    both(tmp_path, build, drive)


def test_scene_modes_and_color_temperature(tmp_path):
    def build(mod, loc, **kw):
        return mod.Camera(source=SRC.format("smpte", "BGRx"), window=2,
                          location=loc, **kw)

    def drive(cam):
        paths = []
        for scene in ("snow", "sunset", "barcode", "night"):
            assert cam.set_scene_mode(scene)
            paths.append(cam.start_capture())
        assert cam.set_color_temperature(3200)
        assert cam.get_white_balance_mode() == "manual"
        paths.append(cam.start_capture())
        assert cam.set_focus_mode("manual") and cam.set_lens_focus(0.4)
        cam.set_autofocus(True)
        return paths

    cam, files = both(tmp_path, build, drive)
    assert cam.bus.messages[-1].name == "autofocus-done"
    # three differ: on packed RGB the tone (barcode's grayscale) does
    # nothing, in both packages
    assert len(set(files[:4])) == 3


@pytest.mark.parametrize("mode", ["image", "video"])
def test_previews_viewfinder_and_zoom(tmp_path, mode):
    def build(mod, loc, **kw):
        return mod.Camera(source=SRC.format("ball", "AYUV"),
                          mode=mod.MODE_IMAGE if mode == "image"
                          else mod.MODE_VIDEO, location=loc,
                          post_previews=True, preview_width=16,
                          preview_height=12, window=2, **kw)

    def drive(cam):
        cam.run_viewfinder(2)
        cam.zoom = 3.0
        assert cam.zoom == 3.0
        if mode == "image":
            return [cam.start_capture()]
        cam.start_capture()
        cam.step()
        return [cam.stop_capture()]

    cam, _ = both(tmp_path, build, drive)
    pv = cam.bus.pop(name="preview-image")
    assert len(pv) == 1 and pv[0]["buffer"].shape[:2] == (12, 16)
