"""The gstbad_tpu_torch package as a whole: it imports neither jax nor
gstbad_tpu, its carried data equals the JAX package's, it exports the same
API, it refuses a CUDA device it cannot have, and chip_smoke.py fails
without the card or the package."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt

torch.set_num_threads(1)   # parallel test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    # every module of the port, the kernels' wrappers included
    code = ("import importlib, pkgutil, sys, gstbad_tpu_torch\n"
            "for m in pkgutil.walk_packages(gstbad_tpu_torch.__path__, "
            "'gstbad_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'gstbad_tpu_torch.ops.remap' in sys.modules\n"
            "assert 'gstbad_tpu_torch.ops.audio' in sys.modules\n"
            "assert 'gstbad_tpu_torch.elements.audio.removesilence' in "
            "sys.modules\n"
            "assert 'gstbad_tpu_torch.elements.analysis.compare' in "
            "sys.modules\n"
            "assert 'gstbad_tpu_torch.ops.dssim' in sys.modules\n"
            "for m in ('core.harness', 'io.y4m', 'elements.bridges', "
            "'elements.files', 'elements.misc', 'elements.observability', "
            "'elements.video.videosignal', 'utils.trace', 'utils.validate', "
            "'session.transcoder', 'cli', '__main__', 'ops.netsim', "
            "'io.gdp', 'io.aiff', 'io.aes', 'elements.ioelements', "
            "'elements.jaxfilter'):\n"
            "    assert 'gstbad_tpu_torch.' + m in sys.modules, m\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'gstbad_tpu.')) "
            "or m == 'gstbad_tpu']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_carried_data_equals_the_jax_package():
    from gstbad_tpu.elements.video import _coloreffects_tables as j_tables
    from gstbad_tpu.golden import coloreffects as j_ce
    from gstbad_tpu.golden import gaudieffects as j_gaudi
    from gstbad_tpu_torch.elements.video import _coloreffects_tables as t_tables
    from gstbad_tpu_torch.golden import coloreffects as t_ce
    from gstbad_tpu_torch.golden import gaudieffects as t_gaudi

    assert sorted(t_tables.TABLES) == sorted(j_tables.TABLES)
    for name, table in j_tables.TABLES.items():
        assert t_tables.TABLES[name].dtype == table.dtype
        np.testing.assert_array_equal(t_tables.TABLES[name], table)
    assert t_ce.LUMA_PRESETS == j_ce.LUMA_PRESETS
    got, want = t_gaudi.chromium_cos_table(), j_gaudi.chromium_cos_table()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the caption glyph atlas, a byte-for-byte copy
    import gstbad_tpu
    import gstbad_tpu_torch
    font = [os.path.join(os.path.dirname(pkg.__file__), "data",
                         "cc_font.npz") for pkg in (gstbad_tpu,
                                                    gstbad_tpu_torch)]
    with open(font[0], "rb") as a, open(font[1], "rb") as b:
        assert a.read() == b.read()


def test_exports_match_the_jax_package():
    assert gtt.__all__ == gt.__all__
    for name in gtt.__all__:
        assert hasattr(gtt, name)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        gtt.parse_launch("videotestsrc ! fakesink", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        gtt.parse_launch("videotestsrc ! fakesink")    # the default


@pytest.mark.parametrize("entry", ["harness", "transcoder", "validate",
                                   "cli_transcode", "cli_launch"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    """Without device="cpu" (--device cpu) every entry point asks for the
    card, and without one it raises: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from gstbad_tpu_torch.cli import launch_main, transcode_main
    from gstbad_tpu_torch.core.harness import Harness
    from gstbad_tpu_torch.session import Transcoder
    from gstbad_tpu_torch.utils.validate import run_validatetest
    src, dest = str(tmp_path / "in.y4m"), str(tmp_path / "out.y4m")
    calls = {
        "harness": lambda: Harness("identity"),
        "transcoder": lambda: Transcoder(src, dest),
        "validate": lambda: run_validatetest(os.path.join(
            ROOT, "tests", "validate", "gaussianblur.validatetest")),
        "cli_transcode": lambda: transcode_main([src, dest]),
        "cli_launch": lambda: launch_main(["videotestsrc", "!",
                                           "fakesink"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not os.path.exists(dest)


def test_unported_parts_refuse_cleanly():
    """An element name the registry lacks raises its KeyError (x265enc,
    the example here until it was ported, now refuses BGRx at negotiation
    as the JAX element does); a format and a pattern that neither package
    knows are refused at negotiation."""
    with pytest.raises(KeyError):
        gtt.parse_launch("videotestsrc ! nosuchelement ! fakesink",
                         device="cpu")
    from gstbad_tpu_torch.core.spec import SpecError
    from gstbad_tpu_torch.io import h265
    if h265.available():
        p = gtt.parse_launch("videotestsrc ! x265enc ! fakesink",
                             device="cpu")
        with pytest.raises(SpecError, match="needs I420"):
            p.negotiate()
    # formats and patterns that neither package knows
    p = gtt.parse_launch("videotestsrc ! videoconvert format=NV16 "
                         "! fakesink", device="cpu")
    with pytest.raises(SpecError):
        p.negotiate()
    p = gtt.parse_launch("videotestsrc pattern=pinwheel ! fakesink",
                         device="cpu")
    with pytest.raises(ValueError, match="pinwheel"):
        p.negotiate()


def test_launch_counters_stay_zero_on_cpu():
    from gstbad_tpu_torch.models import benchmarks
    from gstbad_tpu_torch.ops import (audio, blur, chainfuse, comb,
                                      fieldanalysis, lut, remap)
    audio_graphs = {"config3_audio": 1, "vad_square": 1, "freeverb_22k": 2}
    for name in benchmarks.BENCHMARKS:
        if name in audio_graphs:   # audio: [B, S, C]
            p = benchmarks.build(name, samplesperbuffer=300, device="cpu")
            res = p.run(n_frames=4, window=2)
            assert len(res) == 2 and res[0].data.shape == (
                2, 300, audio_graphs[name])
            continue
        p = benchmarks.build(name, width=64, height=8, device="cpu")
        res = p.run(n_frames=4, window=2)
        if name in ("config5_ivtc", "combdetect_720p"):   # GRAY8, telecine
            assert res and res[0].data.shape[1:] == (8, 64)
        elif name == "transcode_i420_blur":
            assert len(res) == 2 and res[0].data["u"].shape == (2, 4, 32)
        else:
            assert len(res) == 2 and res[0].data.shape == (2, 8, 64, 4)
    assert chainfuse.dilate_zebra_fused.launches == 0
    assert lut.apply_word_table.launches == 0
    assert fieldanalysis.metrics_default.launches == 0
    assert comb.comb_score_pairs.launches == 0
    assert comb.comb_mask.launches == 0
    assert blur.gaussian_blur_words.launches == 0
    assert remap.warp_words.launches == 0
    assert audio.vad_powers_serial.launches == 0
    assert audio.vad_powers_bracket.launches == 0
    assert audio.freeverb_scan.launches == 0


def test_audio_elements_are_registered():
    names = gtt.element_names()
    for name in ("audiotestsrc", "audiomixmatrix", "audiochannelmix",
                 "freeverb", "audioconvert", "removesilence"):
        assert name in names
        assert type(gtt.make(name)).__module__.startswith(
            "gstbad_tpu_torch.elements.")


def test_tensors_from_numpy_keeps_dtypes():
    from gstbad_tpu_torch.core.frame import tensors_from_numpy
    tree = [{"a": np.float32(1.5), "b": np.asarray(3, np.int64)},
            (np.asarray([True, False]), None), ()]
    out = tensors_from_numpy(tree, "cpu")
    assert out[0]["a"].dtype == torch.float32 and out[0]["a"].item() == 1.5
    assert out[0]["b"].dtype == torch.int64 and out[0]["b"].ndim == 0
    assert out[1][0].dtype == torch.bool and out[1][1] is None
    assert out[2] == ()


def test_chip_smoke_imports_no_jax():
    """The card proof runs on a host without jax: none of its imports, at
    any depth of the script, names jax or the JAX package."""
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "gstbad_tpu_torch" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "gstbad_tpu"), name


def test_comb_entry_points_are_registered():
    """The comb chain's entry points and its chain probe have ctypes
    signatures (a pointer per tensor, an int per size)."""
    from gstbad_tpu_torch.ops import _cuda
    P, I = _cuda._P, _cuda._I
    assert _cuda.SIGNATURES["gst_comb_score_pairs"] == (P, P, P, P, I, I, I, I)
    assert _cuda.SIGNATURES["gst_comb_mask"] == (P, P, P, I, I, I)
    assert _cuda.SIGNATURES["gst_comb_row_cycles"] == (P, I)
    src = (_cuda.CSRC / "deinterlace_kernels.cu").read_text()
    for name in ("gst_comb_score_pairs", "gst_comb_mask",
                 "gst_comb_row_cycles"):
        assert f'extern "C" int {name}(' in src


def test_kernel_build_dir_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """The build directory's name is a hash of the CUDA sources and the
    nvcc flags, so an edited source or flag builds anew (no nvcc needed)."""
    from gstbad_tpu_torch.ops import _cuda
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    first = _cuda._digest()
    assert first == _cuda._digest()
    src = sorted(csrc.glob("*.cu"))[0]
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _cuda._digest()
    assert edited != first
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-G",))
    assert _cuda._digest() not in (first, edited)


def test_chip_smoke_fails_alone_and_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line both without
    a CUDA card and in a directory holding nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("name", ["ten_element", "config1_sepia",
                                  "config2_gaudi", "config5_ivtc",
                                  "combdetect_720p", "config2_blur",
                                  "config4_warp", "warp_1080p", "warp_4k"])
def test_benchmark_builders(name):
    """models/benchmarks.py builds the same graphs in both packages."""
    from gstbad_tpu.models import benchmarks as jbench
    from gstbad_tpu_torch.models import benchmarks as tbench
    from test_torch_parity import _messages, assert_same

    pj = jbench.build(name, width=64, height=8)
    pt = tbench.build(name, width=64, height=8, device="cpu")
    assert repr(pt) == repr(pj)
    runs = [(p.run(n_frames=4, window=2), _messages(p.bus))
            for p in (pj, pt)]
    assert_same(*runs)
