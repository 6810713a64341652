"""The 13 elements of the opencv family in gstbad_tpu_torch against
gstbad_tpu's on the CPU, element against element through each package's
Harness (random frames, several windows) or parse_launch (motioncells on
a moving ball): frames, bus messages and carried state.

Tolerances: bit exact, but templatematch's `result` within rtol 1e-5 (its
float32 convolutions sum in another order) and, with it, the green byte of
the drawn rectangle in the normed methods within 1 (255 - 255^result,
truncated).  dewarp's nearest mode is held against a numpy gather over the
JAX package's own fix_map, since the JAX element raises there (shown)."""

import os

import numpy as np
import pytest

import gstbad_tpu_torch as gtt
from gstbad_tpu.core.harness import Harness as JHarness
from gstbad_tpu.core.spec import MediaSpec as JMediaSpec
from gstbad_tpu.ops.remap import dewarp_map as j_dewarp_map, \
    fix_map as j_fix_map
from gstbad_tpu_torch.core.harness import Harness
from gstbad_tpu_torch.core.spec import MediaSpec
from helpers.torch_audio import assert_states_close, numpy_tree
from helpers.torch_cv import assert_frames, assert_messages, push_both
from helpers.torch_runtime import messages, run_both

H, W = 24, 32
K_STR = "40 0 16 0 40 12 0 0 1"
D_STR = "-0.30 0.10 0.001 0.0005 -0.02"


def frames(fmt, n=3, seed=0, patches=True):
    """n random frames of fmt, with skin-coloured and flat patches."""
    rng = np.random.default_rng(seed)
    nch = {"GRAY8": 0, "RGB": 3, "BGR": 3}.get(fmt, 4)
    shape = (n, H, W) if nch == 0 else (n, H, W, nch)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    if not patches:
        return x
    if nch >= 3:
        x[:, 4:14, 6:22, :3] = (220, 150, 110)   # skin-like
    x[:, 14:20, 2:10] = 40                        # flat
    return x


def windows(fmt, n_windows=2, n=3):
    return [frames(fmt, n, seed=s) for s in range(n_windows)]


def check(name, fmt, props=None, setup=None, n_windows=2):
    (jres, jbus), (tres, tbus) = push_both(name, fmt, windows(fmt, n_windows),
                                           props, setup)
    assert_frames(jres, tres)
    assert_messages(jbus, tbus)
    return tres


@pytest.mark.parametrize("props", [
    {"aperture-size": 1}, {"aperture-size": 3},
    {"aperture-size": 5, "x-order": 0, "y-order": 1},
    {"aperture-size": 7, "x-order": 2, "y-order": 1, "mask": False},
    {"aperture-size": 3, "mask": False}])
def test_cvsobel(props):
    check("cvsobel", "RGB", props)


@pytest.mark.parametrize("props", [
    {"aperture-size": 1}, {"aperture-size": 3, "mask": False},
    {"aperture-size": 5, "scale": 0.5, "shift": 20.0},
    {"aperture-size": 7, "scale": 0.0123, "shift": 3.7, "mask": False}])
def test_cvlaplace(props):
    check("cvlaplace", "RGB", props)


@pytest.mark.parametrize("fmt", ["RGB", "BGRx", "GRAY8"])
@pytest.mark.parametrize("props", [
    {"type": "blur", "kernel-width": 5, "kernel-height": 3},
    {"type": "gaussian"},
    {"type": "gaussian", "kernel-width": 7, "kernel-height": 5,
     "color": 1.7},
    {"type": "median", "kernel-width": 5},
    {"type": "bilateral", "color": 25.0},
    {"type": "median", "kernel-width": 3, "position-x": 5,
     "position-y": 3, "width": 14, "height": 9},
    {"type": "gaussian", "kernel-width": 5, "position-x": 20,
     "width": 100},
    {"type": "blur", "position-x": 40}])       # ROI outside the frame
def test_cvsmooth(fmt, props):
    check("cvsmooth", fmt, props)


@pytest.mark.parametrize("name", ["cvdilate", "cverode"])
@pytest.mark.parametrize("fmt,its", [("RGB", 1), ("GRAY8", 3),
                                     ("RGBA", 3)])
def test_cvdilate_cverode(name, fmt, its):
    check(name, fmt, {"iterations": its})


def test_cvequalizehist():
    flat = [np.full((2, H, W), 9, np.uint8)]
    (jres, _), (tres, _) = push_both("cvequalizehist", "GRAY8",
                                     windows("GRAY8") + flat)
    assert_frames(jres, tres)


@pytest.mark.parametrize("props", [
    {}, {"aperture-size": 5, "threshold1": 200, "threshold2": 600},
    {"aperture-size": 7, "threshold1": 1000, "threshold2": 400,
     "mask": False}])
def test_edgedetect(props):
    check("edgedetect", "RGB", props)


@pytest.mark.parametrize("props", [{}, {"sigma": 3.0, "gain": 90},
                                   {"method": "multiscale", "scales": 2}])
def test_retinex(props):
    check("retinex", "RGB", props)


@pytest.mark.parametrize("method", ["sqdiff", "sqdiff-normed", "ccorr",
                                    "ccorr-normed", "ccoeff",
                                    "ccoeff-normed"])
def test_templatematch(method):
    # no flat patches: on a window of zero variance the normed scores are
    # float noise over 1e-30 in both packages (templatematch has no guard)
    win = [frames("RGB", seed=s, patches=False) for s in range(2)]
    templ = win[0][1, 3:11, 5:17].copy()

    def setup(el):
        el.set_template(templ)

    (jres, jbus), (tres, tbus) = push_both(
        "templatematch", "RGB", win, {"method": method}, setup)
    assert_messages(jbus, tbus, rtol=1e-5)
    jm, tm = messages(jbus), messages(tbus)
    assert len(tm) == 6
    for a, t in zip(jres, tres):
        d = np.abs(a.data.astype(int) - t.data.astype(int))
        assert d.max() <= (1 if method.endswith("normed") else 0)
        assert not d[..., [0, 2]].any()
    # frame 1 of window 0 holds the template where it was cut
    assert (tm[1][3]["x"], tm[1][3]["y"]) == (5, 3)


def test_templatematch_npy_template(tmp_path):
    win = windows("RGB", 1)
    path = os.path.join(tmp_path, "t.npy")
    np.save(path, win[0][0, 2:9, 3:14])
    (jres, jbus), (tres, tbus) = push_both("templatematch", "RGB", win,
                                           {"template": path})
    assert_messages(jbus, tbus, rtol=1e-5)
    assert messages(tbus)[0][3]["x"] == 3


@pytest.mark.parametrize("fmt", ["GRAY8", "RGB", "BGRx"])
@pytest.mark.parametrize("props", [{"alpha": 0.0}, {"alpha": 0.5},
                                   {"alpha": 1.0, "crop": True}])
def test_cameraundistort(fmt, props):
    check("cameraundistort", fmt, dict(props, **{
        "camera-matrix": K_STR, "distortion-coeffs": D_STR}))


def test_cameraundistort_set_calibration_and_passthrough():
    K = np.array([[40.0, 0, 16], [0, 40, 12], [0, 0, 1]])

    def setup(el):
        el.set_calibration(K, [-0.2, 0.05])

    tres = check("cameraundistort", "RGB", {"crop": True}, setup)
    # without a calibration the element passes frames through
    out = check("cameraundistort", "RGB")
    np.testing.assert_array_equal(out[0].data, frames("RGB", seed=0))
    assert not np.array_equal(tres[0].data, frames("RGB", seed=0))


DEWARP = {"inner-radius": 0.1, "outer-radius": 0.35}
MODES = ["single-panorama", "double-panorama", "quad-view"]


@pytest.mark.parametrize("mode", MODES)
def test_dewarp_bilinear(mode):
    out = check("dewarp", "RGBA", dict(DEWARP, **{"display-mode": mode}))
    assert out[0].data.shape[1:3] != (H, W)


def _pano_to_display(pano, mode):
    if mode == "single-panorama":
        return pano
    if mode == "double-panorama":
        w = pano.shape[2] // 2
        return np.concatenate([pano[:, :, :w], pano[:, :, w:]], axis=1)
    vw = pano.shape[2] // 4
    v = [pano[:, :, i * vw:(i + 1) * vw] for i in range(4)]
    return np.concatenate([np.concatenate(v[:2], 1),
                           np.concatenate(v[2:], 1)], 2)


@pytest.mark.parametrize("mode", MODES)
def test_dewarp_nearest_against_jax_fix_map(mode):
    win = windows("RGBA", 1)
    h = Harness("dewarp", device="cpu", **DEWARP, **{
        "display-mode": mode, "interpolation-method": "nearest"})
    spec = h.set_src_spec(MediaSpec(kind="video", format="RGBA", width=W,
                                    height=H))
    got = h.push_pull(win[0])
    oh, ow = spec.height, spec.width
    mh, mw = (oh, ow) if mode == "single-panorama" else (oh // 2, ow * 2)
    mx, my = j_dewarp_map(W, H, mw, mh, 0.5, 0.5, 0.1, 0.35, 1.0, 1.0)
    flat, valid = j_fix_map(np.stack([mx, my], -1), W, H, "ignore")
    pano = win[0].reshape(3, H * W, 4)[:, flat]
    pano = np.where(valid[None, :, None], pano, 0).reshape(3, mh, mw, 4)
    np.testing.assert_array_equal(got, _pano_to_display(pano, mode))


def test_dewarp_nearest_raises_in_the_jax_package():
    # gstbad_tpu/ops/remap.py:57 reshapes the panorama to the input's
    # H x W; the day the JAX package is fixed this test says so
    h = JHarness("dewarp", **DEWARP, **{"interpolation-method": "nearest"})
    h.set_src_spec(JMediaSpec(kind="video", format="RGBA", width=W,
                              height=H))
    with pytest.raises(TypeError, match="reshape"):
        h.push(frames("RGBA"))


@pytest.mark.parametrize("props", [{}, {"postprocess": False},
                                   {"method": "rgb"},
                                   {"method": "rgb", "postprocess": False}])
def test_skindetect(props):
    out = check("skindetect", "RGB", props)
    assert out[0].data.any()


BALL = ("videotestsrc pattern=ball width=64 height=48 format=RGB "
        "! motioncells name=mc {props} ! fakesink")


@pytest.mark.parametrize("props", ["", "gridx=4 gridy=3 sensitivity=0.9",
                                   "postallmotion=true display=false "
                                   "cellscolor=0,255,9 threshold=0.2"])
def test_motioncells_messages_and_state(props):
    (jp, jres), (tp, tres) = run_both(BALL.format(props=props), 12, 4)
    assert_frames(jres, tres)
    assert_messages(jp.bus, tp.bus)
    assert len(messages(tp.bus)) > 3
    assert messages(tp.bus)[0][2] > 0     # the first frame posts nothing
    assert_states_close(numpy_tree(jp._states), numpy_tree(tp._states))


def test_motioncells_checkpoint_round_trip(tmp_path):
    desc = BALL.format(props="gridx=6 gridy=5")
    (jp, jres), _ = run_both(desc, 16, 4)
    ck = os.path.join(tmp_path, "mc.ckpt")
    first = gtt.parse_launch(desc, device="cpu")
    out = first.run(n_frames=8, window=4)
    first.save_checkpoint(ck)
    second = gtt.parse_launch(desc, device="cpu")
    second.load_checkpoint(ck)
    out += second.run(n_frames=8, window=4)
    assert_frames(jres, out)
    got = messages(first.bus) + messages(second.bus)
    assert len(got) == len(messages(jp.bus)) > 3
    for a, t in zip(messages(jp.bus), got):
        assert a[:3] == t[:3]
        np.testing.assert_array_equal(t[3]["cells"], a[3]["cells"])
        assert t[3]["n_motion"] == a[3]["n_motion"]


def test_registry_has_the_cv_names():
    from gstbad_tpu.core.registry import element_names as j_names
    from gstbad_tpu_torch.core.registry import element_names as t_names
    new = {"cvsobel", "cvlaplace", "cvsmooth", "cvdilate", "cverode",
           "cvequalizehist", "edgedetect", "retinex", "templatematch",
           "cameraundistort", "dewarp", "skindetect", "motioncells",
           "digitalzoom", "lcms", "alphacombine", "codecalphademux"}
    assert new <= set(t_names())
    assert set(t_names()) <= set(j_names())
    # 93 after the cv slice, 17 more with audio breadth, 9 with the rest
    # of CV, 19 with overlay and the text renderers, 27 with what the
    # runtime slice deferred and the small elements of begun modules, 3
    # with the sessions (dashdemux, hlsdemux, mssdemux), 4 with the
    # inter-process transports (shmsink, shmsrc, ipcpipelinesink,
    # ipcpipelinesrc), 23 with the transport plane (rtp, sdp, onvif, pcap,
    # MPEG-TS/PS and the eleven elementary-stream parsers), 15 with the
    # file formats and the last in-repo device engines, 17 with the
    # codecs and the host audio engines: all of the JAX registry
    assert len(set(t_names())) == 227
