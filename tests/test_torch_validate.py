"""The port's validate runner (gstbad_tpu_torch/utils/validate.py) on the
committed scenarios, on the CPU: each matches its committed, unmodified
flow expectations (the same files the JAX package's runner is held to);
a changed scenario fails; a missing expectation fails and writes
nothing; recording writes only into the directory the caller names."""

import glob
import os
import shutil

import pytest
import torch

from gstbad_tpu_torch.utils.validate import (FlowConfig, ValidateTest,
                                             parse_validatetest,
                                             run_validatetest)

torch.set_num_threads(1)   # parallel test workers share the cores

HERE = os.path.join(os.path.dirname(__file__), "validate")
TESTS = sorted(glob.glob(os.path.join(HERE, "*.validatetest")))


def _tree(root):
    """(path, size, mtime_ns) of every file under root."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out.append((os.path.join(d, f), st.st_size, st.st_mtime_ns))
    return sorted(out)


def test_six_scenarios_are_committed():
    assert [os.path.basename(p) for p in TESTS] == [
        "audio_mix.validatetest", "gaussianblur.validatetest",
        "ivtc.validatetest", "solarize_chain.validatetest",
        "videoanalyse.validatetest", "zebrastripe.validatetest"]


@pytest.mark.parametrize("path", TESTS, ids=[
    os.path.splitext(os.path.basename(p))[0] for p in TESTS])
def test_scenario_matches_committed_expectations(path):
    before = _tree(HERE)
    report = run_validatetest(path, device="cpu")
    assert report.ok, "\n".join(report.details)
    assert report.recorded == []
    for lines in report.flows.values():
        assert lines[0].startswith("event caps:")
        assert any(ln.startswith("buffer:") for ln in lines)
    assert _tree(HERE) == before


def test_parse_format():
    with open(os.path.join(HERE, "zebrastripe.validatetest")) as f:
        t = parse_validatetest(f.read())
    assert "zebrastripe name=z" in t.launch
    assert t.flows == [FlowConfig(pad="z", record_buffers=True,
                                  buffers_checksum=True)]
    assert [a for a, _ in t.actions] == ["run", "set-property", "run"]
    assert t.actions[1][1] == {"element-name": "z", "property": "threshold",
                               "value": "40"}


def _copy(tmp_path, name):
    shutil.copy(os.path.join(HERE, f"{name}.validatetest"), tmp_path)
    shutil.copytree(os.path.join(HERE, name), tmp_path / name)
    return tmp_path / f"{name}.validatetest"


def test_changed_scenario_fails(tmp_path):
    t = _copy(tmp_path, "zebrastripe")
    assert run_validatetest(str(t), device="cpu").ok
    t.write_text(t.read_text().replace("threshold=90", "threshold=10"))
    report = run_validatetest(str(t), device="cpu")
    assert not report.ok
    assert any("differs" in d for d in report.details)


def test_missing_expectation_fails_and_writes_nothing(tmp_path):
    t = _copy(tmp_path, "gaussianblur")
    shutil.rmtree(tmp_path / "gaussianblur")
    report = run_validatetest(str(t), device="cpu")
    assert not report.ok and "no expectation" in report.details[0]
    assert report.recorded == []
    assert sorted(os.listdir(tmp_path)) == ["gaussianblur.validatetest"]


def test_record_writes_only_into_out_dir(tmp_path):
    t = _copy(tmp_path, "videoanalyse")
    out = tmp_path / "recorded"
    report = run_validatetest(str(t), device="cpu", record=True,
                              out_dir=str(out))
    assert report.recorded == [str(out / "log-va-expected")]
    want = (tmp_path / "videoanalyse" / "flow-expectations"
            / "log-va-expected").read_text()
    assert (out / "log-va-expected").read_text() == want
    with pytest.raises(ValueError, match="out_dir"):
        run_validatetest(str(t), device="cpu", record=True)


def test_expect_message_failure():
    t = ValidateTest(
        launch="videotestsrc width=32 height=32 format=GRAY8 ! fakesink",
        flows=[],
        actions=[("run", {"n-frames": "8", "window": "8"}),
                 ("expect-message", {"element": "nosuch",
                                     "name": "Never"})])
    r = run_validatetest(t, device="cpu")
    assert not r.ok and "expect-message failed" in r.details[0]


def test_unknown_action_fails():
    t = ValidateTest(
        launch="videotestsrc width=8 height=8 format=GRAY8 ! fakesink",
        flows=[], actions=[("rewind", {})])
    r = run_validatetest(t, device="cpu")
    assert not r.ok and r.details == ["unknown action 'rewind'"]
