"""The port's runtime surface against the JAX package on the CPU: live
graph edits (insert_after, insert_before, remove, set_static_property)
with the states they carry, checkpoint/resume, close, send_eos routing,
HOST element routing through tee branches, and the host-source stall.
Everything is compared exactly: frames, pts, flags, valid and bus
messages."""

import hashlib

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.core.spec import SpecError as JSpecError
from gstbad_tpu_torch.core.frame import same_layout
from gstbad_tpu_torch.core.spec import MediaSpec, SpecError
from helpers.torch_runtime import assert_batches_equal, \
    assert_messages_equal

torch.set_num_threads(1)   # parallel test workers share the cores

BALL = "videotestsrc pattern=ball width=64 height=16 format=BGRx "
HEAD = ("coloreffects preset=sepia ! solarize ! chromium ! dodge ! burn "
        "! exclusion ! dilate ! chromahold ! videoconvert format=AYUV")
GRAY = ("videotestsrc pattern=ball width=64 height=48 format=GRAY8 "
        "framerate=24/1 ")
CONFIG5 = GRAY + "! interlace pattern=2:3 ! fieldanalysis ! ivtc ! fakesink"


def script_both(desc, steps, window):
    """Run `steps` on a pipeline of each package: each step is
    ("run", n_frames) or (method, args) with args a function of the
    package giving the call's arguments.  Returns the run results."""
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        res = []
        for op, arg in steps:
            if op == "run":
                res.append(p.run(n_frames=arg, window=window))
            else:
                getattr(p, op)(*arg(pkg))
        out.append((p, res))
    (jp, jres), (tp, tres) = out
    for j, t in zip(jres, tres):
        assert_batches_equal(j, t)
    assert_messages_equal(jp.bus, tp.bus)
    return jp, tp


def test_insert_after_and_remove_live():
    jp, tp = script_both(BALL + "! burn name=b ! fakesink", [
        ("run", 4),
        ("insert_after", lambda pkg: ("b", pkg.make("solarize"), "sol")),
        ("run", 4),
        ("remove", lambda pkg: ("sol",)),
        ("run", 4)], window=4)
    assert [n.element.NAME for n in tp._order] == [
        "videotestsrc", "burn", "fakesink"]


def test_headline_edits_live():
    """The headline's fused tail, then the prefix chain (the whole-word
    lookup), then the tail again on a new zebrastripe."""
    script_both(BALL + "! " + HEAD + " ! zebrastripe ! fakesink", [
        ("run", 4),
        ("remove", lambda pkg: ("zebrastripe",)),
        ("run", 4),
        ("insert_after", lambda pkg: ("videoconvert",
                                      pkg.make("zebrastripe"))),
        ("run", 4)], window=4)


def test_insert_before_carries_state():
    """scenechange's ring of scores carries across the edit."""
    jp, tp = script_both(GRAY + "! scenechange name=sc ! fakesink", [
        ("run", 8),
        ("insert_before", lambda pkg: ("sc", pkg.make("identity"), "id0")),
        ("run", 8)], window=4)
    assert [n.element.NAME for n in tp._order] == [
        "videotestsrc", "identity", "scenechange", "fakesink"]


def test_set_static_property_keeps_states():
    """A live property change keeps zebrastripe's phase and the source's
    frame counter (the zebrastripe validate scenario's edit)."""
    script_both(GRAY + "! zebrastripe name=z threshold=90 ! fakesink", [
        ("run", 8),
        ("set_static_property", lambda pkg: ("z", "threshold", "40")),
        ("run", 8)], window=4)


def test_set_static_property_shape_change_reinitialises():
    """A new frame size changes scenechange's state shapes: its state
    starts afresh (migrate_state) while the source's counter carries."""
    jp, tp = script_both(GRAY + "! scenechange name=sc ! fakesink", [
        ("run", 8),
        ("set_static_property", lambda pkg: ("videotestsrc", "width",
                                             "32")),
        ("run", 8)], window=4)
    assert tuple(tp._states[1]["prev"].shape) == (48, 32)
    assert int(tp._states[0]) == 16


def test_carry_state_keeps_a_matching_state_and_resets_a_changed_one():
    el = gtt.make("scenechange")
    el.set_info(MediaSpec(kind="video", format="GRAY8", width=8, height=4))
    st = el.init_state(4)
    st["count"] = st["count"] + 3
    assert el.carry_state(st, 4) is st
    el.set_info(MediaSpec(kind="video", format="GRAY8", width=6, height=4))
    fresh = el.carry_state(st, 4)
    assert tuple(fresh["prev"].shape) == (4, 6) and int(fresh["count"]) == 0
    # containers, shapes, dtypes and Python leaf types all count
    t = torch.zeros(3, dtype=torch.int32)
    assert same_layout({"a": [t, 1, (2.0, None)]},
                       {"a": [t + 1, 5, (0.5, None)]})
    for other in ({"a": [t, 1]}, {"a": [t.long(), 1, (2.0, None)]},
                  {"a": [t, 1.0, (2.0, None)]}, {"b": [t, 1, (2.0, None)]},
                  {"a": [t[:2], 1, (2.0, None)]}):
        assert not same_layout({"a": [t, 1, (2.0, None)]}, other)


def test_remove_fan_in_raises():
    desc = ("videotestsrc name=src width=16 height=16 ! cmp.  src. ! cmp.  "
            "compare name=cmp ! fakesink")
    with pytest.raises(JSpecError):
        gt.parse_launch(desc).remove("cmp")
    with pytest.raises(SpecError):
        gtt.parse_launch(desc, device="cpu").remove("cmp")


def test_checkpoint_resume_config5(tmp_path):
    """Two windows, a checkpoint, a fresh pipeline, two more windows:
    equal to an uninterrupted run, and to the JAX package's."""
    whole = gtt.parse_launch(CONFIG5, device="cpu")
    ref = whole.run(n_frames=32, window=8)
    p1 = gtt.parse_launch(CONFIG5, device="cpu")
    out = p1.run(n_frames=16, window=8)
    p1.save_checkpoint(tmp_path / "ck.pkl")
    p2 = gtt.parse_launch(CONFIG5, device="cpu")
    p2.load_checkpoint(tmp_path / "ck.pkl")
    out += p2.run(n_frames=16, window=8)
    assert_batches_equal(ref, out)
    assert p1.bus.messages + p2.bus.messages == whole.bus.messages
    assert len(whole.bus.messages) > 20
    jp = gt.parse_launch(CONFIG5)
    assert_batches_equal(jp.run(n_frames=32, window=8), ref)
    assert_messages_equal(jp.bus, whole.bus)


def _appsrc_run(pkg, tmp_path, frames, split):
    desc = ("appsrc name=src format=GRAY8 width=16 height=8 "
            "! zebrastripe threshold=50 ! fakesink")
    kw = {} if pkg is gt else {"device": "cpu"}
    p = pkg.parse_launch(desc, **kw)
    p.negotiate()
    p.get_by_name("src").push_frames(frames[:split])
    out = p.run(window=4)
    p.save_checkpoint(tmp_path / f"{pkg.__name__}.pkl")
    q = pkg.parse_launch(desc, **kw)
    q.negotiate()
    q.load_checkpoint(tmp_path / f"{pkg.__name__}.pkl")
    q.get_by_name("src").push_frames(frames[split:])
    return out + q.run(window=4)


def test_checkpoint_resume_appsrc_position(tmp_path):
    """An appsrc's frame position goes into the checkpoint: the resumed
    stream's pts continue, and the output equals an uninterrupted run."""
    frames = np.random.default_rng(5).integers(0, 256, (12, 8, 16),
                                                dtype=np.uint8)
    p = gtt.parse_launch("appsrc name=src format=GRAY8 width=16 height=8 "
                         "! zebrastripe threshold=50 ! fakesink",
                         device="cpu")
    p.negotiate()
    p.get_by_name("src").push_frames(frames)
    ref = p.run(window=4)
    got = _appsrc_run(gtt, tmp_path, frames, 8)
    assert_batches_equal(ref, got)
    assert_batches_equal(_appsrc_run(gt, tmp_path, frames, 8), got)


def test_resume_warning_for_a_live_source(tmp_path):
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch("intersubsrc ! fakesink", **kw)
        p.compile(1)
        p.save_checkpoint(tmp_path / "ck.pkl")
        q = pkg.parse_launch("intersubsrc ! fakesink", **kw)
        q.load_checkpoint(tmp_path / "ck.pkl")
        out.append(q)
    assert_messages_equal(out[0].bus, out[1].bus)
    (m,) = out[1].bus.messages
    assert (m.element, m.name) == ("pipeline", "resume-warning")


def test_close_flushes_file_sinks(tmp_path):
    paths = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        path = tmp_path / f"{pkg.__name__}.raw"
        p = pkg.parse_launch(BALL + f"! solarize ! filesink location={path}",
                             **kw)
        p.run(n_frames=6, window=4)
        p.close()
        assert p.elements[-1]._fh is None
        paths.append(path)
    data = [open(x, "rb").read() for x in paths]
    assert len(data[1]) == 8 * 64 * 16 * 4 and data[0] == data[1]


def test_send_eos_reaches_only_downstream_hosts():
    """fieldanalysis's held frame goes to the checksum sink after it and
    not to the one on the tee's other branch."""
    desc = (GRAY + "! interlace pattern=2:3 ! tee name=t  t. ! fieldanalysis "
            "! videocodectestsink name=a  t. ! videocodectestsink name=b")
    sinks, pipes = [], []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        p.run(n_frames=8, window=4)
        before = [len(p.get_by_name(n).frame_checksums) for n in "ab"]
        drained = p.send_eos()
        assert sorted(drained) == ["fieldanalysis"]
        after = [len(p.get_by_name(n).frame_checksums) for n in "ab"]
        assert after == [before[0] + 1, before[1]]
        sinks.append([p.get_by_name(n).frame_checksums for n in "ab"])
        pipes.append(p)
    assert sinks[0] == sinks[1]
    assert_messages_equal(pipes[0].bus, pipes[1].bus)


def test_host_source_stall_ends_the_run_cleanly():
    out = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch("appsrc name=src format=GRAY8 width=8 height=4 "
                             "! fakesink", **kw)
        p.negotiate()
        src = p.get_by_name("src")
        src.push_frames(np.arange(8 * 32, dtype=np.uint8).reshape(8, 4, 8))
        pull = src.pull_window

        def stalling(window, pull=pull, calls=[]):
            calls.append(window)
            if len(calls) > 1:
                raise TimeoutError("no frame within 1.0 s")
            return pull(window)

        src.pull_window = stalling
        out.append((p, p.run(window=4)))
    (jp, jres), (tp, tres) = out
    assert_batches_equal(jres, tres)
    assert_messages_equal(jp.bus, tp.bus)
    assert len(tres) == 1 and [m.name for m in tp.bus.messages] == ["stall"]


def test_pull_inputs_pulls_a_window_as_run_does():
    """Pipeline.pull_inputs gives the window run() steps on (a short last
    one padded with invalid frames), then None once the source is empty;
    a graph without a host source has nothing to pull."""
    frames = np.arange(6 * 32, dtype=np.uint8).reshape(6, 4, 8)
    desc = "appsrc name=src format=GRAY8 width=8 height=4 ! fakesink"
    pulled = gtt.parse_launch(desc, device="cpu")
    run = gtt.parse_launch(desc, device="cpu")
    for p in (pulled, run):
        p.negotiate()
        p.get_by_name("src").push_frames(frames)
    wins = [pulled.pull_inputs(4) for _ in range(3)]
    assert wins[2] is None
    assert [w.valid.tolist() for w in wins[:2]] == [[True] * 4,
                                                    [True] * 2 + [False] * 2]
    np.testing.assert_array_equal(
        np.concatenate([w.data.numpy()[w.valid.numpy()] for w in wins[:2]]),
        frames)
    np.testing.assert_array_equal(
        np.concatenate([b.data for b in run.run(window=4)]), frames)
    sourced = gtt.parse_launch(BALL + "! fakesink", device="cpu")
    sourced.negotiate()
    with pytest.raises(ValueError, match="no host source"):
        sourced.pull_inputs(4)


def test_mid_graph_host_nodes_see_their_own_branch():
    """Checksum sinks in the middle of two tee branches: each sees its own
    node's frames (not the other branch's, not its leaf's), fusion stops
    at them, and the leaves are unchanged."""
    desc = (BALL + "! tee name=t  t. ! solarize ! videocodectestsink name=ca "
            "! chromium ! fakesink  t. ! burn ! videocodectestsink name=cb "
            "! dodge ! fakesink")
    res = []
    for pkg, kw in ((gt, {}), (gtt, {"device": "cpu"})):
        p = pkg.parse_launch(desc, **kw)
        out = p.run(n_frames=8, window=4)
        res.append((out, [p.get_by_name(n).frame_checksums
                          for n in ("ca", "cb")]))
    assert_batches_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1]
    solarized = gtt.parse_launch(BALL + "! solarize ! fakesink",
                                 device="cpu").run(n_frames=8, window=4)
    want = [hashlib.md5(np.ascontiguousarray(f).tobytes()).hexdigest()
            for b in solarized for f in b.data]
    assert res[1][1][0] == want and res[1][1][1] != want
