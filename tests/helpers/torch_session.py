"""Shared pieces of the session parity tests
(tests/test_torch_{play,player,camera}.py): one Play (or Camera) scenario
through gstbad_tpu.session and gstbad_tpu_torch.session (on the CPU), and
the comparison of what each dispatched — every frame with its pts, flags
and valid, in order — and of the messages each posted."""

import dataclasses
import enum
import time

import numpy as np
import torch

import gstbad_tpu.session as jsession
import gstbad_tpu_torch.session as tsession

torch.set_num_threads(1)   # parallel test workers share the cores

#: (package label, session module, extra constructor arguments)
SESSIONS = (("jax", jsession, {}), ("port", tsession, {"device": "cpu"}))


def wait_for(pred, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def normal(v):
    """A message field in a form both packages share: dataclasses (media
    info, MediaSpec) as dicts, enums (PlayState) as their values, arrays
    as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: normal(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (list, tuple)):
        return type(v)(normal(x) for x in v)
    if isinstance(v, dict):
        return {k: normal(x) for k, x in v.items()}
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    return v


def messages(bus):
    return [(m.element, m.name, m.pts, normal(m.fields))
            for m in bus.messages]


class Recorder:
    """An on_frame callback that keeps every dispatched frame: (pts,
    flags, valid, data) with data a copy (a {plane: array} dict for planar
    video)."""

    def __init__(self):
        self.frames = []

    def __call__(self, b, i):
        d = b.data
        data = ({k: np.array(v[i]) for k, v in d.items()}
                if isinstance(d, dict) else np.array(d[i]))
        self.frames.append((int(np.asarray(b.pts)[i]),
                            int(np.asarray(b.flags)[i]),
                            bool(np.asarray(b.valid)[i]), data))


def assert_frames_equal(jf, tf):
    assert len(jf) == len(tf)
    for n, (a, t) in enumerate(zip(jf, tf)):
        assert a[:3] == t[:3], (n, a[:3], t[:3])
        if isinstance(a[3], dict):
            assert sorted(a[3]) == sorted(t[3])
            pairs = [(a[3][k], t[3][k]) for k in sorted(a[3])]
        else:
            pairs = [(a[3], t[3])]
        for av, tv in pairs:
            assert av.dtype == tv.dtype and av.shape == tv.shape, n
            np.testing.assert_array_equal(tv, av, err_msg=f"frame {n}")


def assert_messages_equal(jm, tm):
    assert [m[:3] for m in jm] == [m[:3] for m in tm]
    for a, t in zip(jm, tm):
        assert a[3] == t[3], (a[:3], a[3], t[3])


def run_to_eos(play, timeout=60):
    play.play()
    assert wait_for(lambda: play.state.value == "stopped", timeout), \
        "did not reach EOS"
    play.stop()


def play_both(make, drive=run_to_eos):
    """make(session_module, **device_kw) -> (Play, Recorder); drive(play)
    runs the scenario.  Returns {label: (play, frames, play messages,
    pipeline bus messages)}; the frames and both message lists are held
    equal between the packages."""
    out = {}
    for label, mod, kw in SESSIONS:
        play, rec = make(mod, **kw)
        drive(play)
        bus = play.pipeline.bus if play.pipeline is not None else None
        out[label] = (play, rec.frames, messages(play.message_bus),
                      messages(bus) if bus is not None else [])
    (_, jf, jm, jb), (_, tf, tm, tb) = out["jax"], out["port"]
    assert_frames_equal(jf, tf)
    assert_messages_equal(jm, tm)
    assert_messages_equal(jb, tb)
    return out
