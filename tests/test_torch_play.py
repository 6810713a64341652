"""Play parity: gstbad_tpu_torch.session.Play on the CPU against
gstbad_tpu.session.Play on the same testbin://, launch-string and y4m
inputs — every dispatched frame (pts, flags, valid, data) and every
message, in order, equal.  Exact throughout: the colour balance's luma
takes XLA's three FMA contractions (a 256-entry map built on the host),
its chroma rounds each product and sum on its own, and on the tested
grids (all 65536 (u, v) pairs and 256 luma values under 9 settings,
below) no byte differs from the JAX package's compiled window."""

import numpy as np
import pytest
import torch

import gstbad_tpu as gt
import gstbad_tpu_torch as gtt
from gstbad_tpu.io import y4m as j_y4m
from gstbad_tpu.core.spec import MediaSpec
from gstbad_tpu.session.play import _ColorBalance as JColorBalance
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec as TSpec
from gstbad_tpu_torch.session.play import _ColorBalance as TColorBalance
from helpers.torch_session import (SESSIONS, Recorder,
                                   assert_frames_equal, messages, normal,
                                   play_both, run_to_eos, wait_for)

DUR = 10**9 // 30
V_URI = "testbin://video,pattern=ball,width=64,height=48,format=GRAY8"
A_URI = "testbin://audio,rate=8000,samplesperbuffer=256,channels=1"
AV_URI = ("testbin://video,pattern=ball,width=64,height=48,format=AYUV"
          "+audio,rate=8000,samplesperbuffer=256,channels=1,freq=330")


def maker(uri=None, pipeline=None, setup=None, **kw):
    """A make(mod, **device) for play_both: a Play of window 4, paced by
    nothing, recording every frame; `setup(play)` runs before playing."""
    def make(mod, **dev):
        rec = Recorder()
        kw.setdefault("window", 4)
        p = mod.Play(pipeline, realtime=False, on_frame=rec, **kw, **dev)
        if uri is not None:
            p.set_uri(uri)
        if setup is not None:
            setup(p)
        return p, rec
    return make


@pytest.mark.parametrize("uri", [
    V_URI, A_URI, AV_URI,
    "testbin://video,pattern=smpte,width=64,height=48,format=I420",
])
def test_play_to_eos(uri):
    out = play_both(maker(uri, n_frames=12))
    names = [m[1] for m in out["port"][2]]
    assert names[0] == "uri-loaded" and names[-2:] == ["end-of-stream",
                                                        "state-changed"]


def test_launch_string_state_machine():
    out = play_both(maker(
        pipeline="videotestsrc pattern=ball width=64 height=48 "
                 "format=GRAY8 ! videoanalyse ! fakesink", n_frames=16))
    play, frames, _, bus = out["port"]
    assert [f[0] for f in frames] == [k * DUR for k in range(16)]
    assert len([m for m in bus if m[0] == "videoanalyse"]) == 16


def test_pause_and_resume():
    """Pausing mid-stream and resuming dispatches every frame once, in
    order, as the JAX package does; the states go PLAYING, PAUSED,
    PLAYING, STOPPED."""
    def drive(play):
        play.realtime = True           # paced: 133 ms a window of 4
        play.play()
        assert wait_for(lambda: len(play.on_frame.frames) >= 4)
        play.pause()
        assert play.state.value == "paused"
        play.realtime = False
        run_to_eos(play)

    out = {}
    for label, mod, kw in SESSIONS:
        play, _ = maker(V_URI, n_frames=16)(mod, **kw)
        drive(play)
        out[label] = (play.on_frame.frames, [
            m[3]["state"] for m in messages(play.message_bus)
            if m[1] == "state-changed"])
    assert_frames_equal(out["jax"][0], out["port"][0])
    assert out["port"][1] == out["jax"][1] == [
        "playing", "paused", "playing", "stopped"]
    assert len(out["port"][0]) == 16


@pytest.mark.parametrize("accurate", [False, True])
def test_seek(accurate):
    def setup(p):
        p.set_config(seek_accurate=accurate)
        p.seek(int(2.9 * DUR))

    out = play_both(maker(V_URI, n_frames=16, setup=setup))
    first = out["port"][1][0][0]
    assert first == (3 if accurate else 2) * DUR


@pytest.mark.parametrize("rate", [-1.0, 2.0])
def test_rate(rate):
    def setup(p):
        if rate < 0:
            p.seek(13 * DUR)
        p.set_rate(rate)

    out = play_both(maker(V_URI, n_frames=16, setup=setup))
    pts = [f[0] for f in out["port"][1]]
    if rate < 0:        # reversed, down to the first frame
        assert pts == [k * DUR for k in range(13, -1, -1)]
    else:
        assert pts == [k * DUR for k in range(16)]


@pytest.mark.parametrize("fmt,volume,mute", [
    ("F32", 0.37, False), ("S16", 0.37, False), ("S16", 1.9, False),
    ("F32", 0.5, True)])
def test_volume_and_mute(fmt, volume, mute):
    def setup(p):
        p.set_volume(volume)
        p.set_mute(mute)

    out = play_both(maker(
        f"testbin://audio,format={fmt},rate=8000,samplesperbuffer=256,"
        "channels=1,volume=0.9", n_frames=8, setup=setup))
    frames = out["port"][1]
    assert len(frames) == 8
    assert (not any(f[3].any() for f in frames)) == mute


@pytest.mark.parametrize("fmt", ["AYUV", "I420", "NV12", "GRAY8"])
def test_color_balance_on_playback(fmt):
    def setup(p):
        assert p.has_color_balance()
        for ch, v in (("hue", 0.6), ("saturation", 0.7),
                      ("brightness", 0.55), ("contrast", 0.45)):
            p.set_color_balance(ch, v)

    out = play_both(maker(
        f"testbin://video,pattern=ball,width=64,height=48,format={fmt}",
        n_frames=8, setup=setup))
    assert out["port"][0].get_color_balance("hue") == pytest.approx(0.6)


@pytest.mark.parametrize("fmt", ["AYUV", "I420", "GRAY8"])
def test_color_balance_stage_exhaustive(fmt):
    """Every luma value (and, in AYUV, every (u, v) pair) through the
    stage under 9 settings, three of which put luma on exact .5 ties
    (contrast 1.0 at brightness 0 and 0.25: only XLA's contractions give
    the JAX package's bytes there), the port's element against the JAX
    package's in its compiled pipeline window: equal bytes."""
    xs = np.arange(256, dtype=np.uint8)
    if fmt == "AYUV":
        fr = np.zeros((1, 256, 256, 4), np.uint8)
        fr[..., 0], fr[..., 1] = 255, xs[None, :]
        fr[..., 2], fr[..., 3] = xs[None, :], xs[:, None]
        data = torch.from_numpy(fr)
    elif fmt == "I420":
        fr = {"y": np.broadcast_to(xs, (1, 2, 256)).copy(),
              "u": np.broadcast_to(xs[:128], (1, 1, 128)).copy(),
              "v": np.broadcast_to(xs[128:], (1, 1, 128)).copy()}
        data = {k: torch.from_numpy(v) for k, v in fr.items()}
    else:
        fr = np.broadcast_to(xs, (1, 2, 256)).copy()
        data = torch.from_numpy(fr)
    h = 256 if fmt == "AYUV" else 2
    rng = np.random.default_rng(5)
    settings = [dict(brightness=0.55, contrast=0.45, hue=0.6,
                     saturation=0.7),
                dict(brightness=0.0, contrast=1.0, hue=0.0, saturation=1.0),
                dict(brightness=0.25, contrast=1.0, hue=0.25,
                     saturation=0.75),
                dict(brightness=1.0, contrast=0.0, hue=1.0, saturation=0.0)]
    settings += [dict(zip(("brightness", "contrast", "hue", "saturation"),
                          map(float, rng.random(4)))) for _ in range(5)]
    spec = TSpec(kind="video", format=fmt, width=256, height=h)
    for s in settings:
        p = gt.parse_launch(f"appsrc name=src format={fmt} width=256 "
                            f"height={h} ! fakesink")
        p.insert_before("fakesink", JColorBalance(**s), "bal")
        p.get_by_name("src").push_frames(fr)
        want = p.run(window=1)[0].data
        el = TColorBalance(**s)
        el.set_info(spec)
        _, got, _ = el(FrameBatch.make(data))
        if fmt == "I420":
            for k in want:
                np.testing.assert_array_equal(got.data[k].numpy(),
                                              np.asarray(want[k]),
                                              err_msg=f"{k} {s}")
        else:
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(want),
                                          err_msg=str(s))


@pytest.mark.parametrize("case", ["switch-audio", "disable-video"])
def test_track_selection(case):
    if case == "switch-audio":
        uri = ("testbin://audio,rate=8000,samplesperbuffer=256,channels=1,"
               "freq=100+audio,rate=8000,samplesperbuffer=256,channels=1,"
               "freq=200")

        def setup(p):
            assert not p.set_audio_track(5)
            assert p.set_audio_track(1)
    else:
        uri = AV_URI

        def setup(p):
            p.set_video_track_enabled(False)

    out = play_both(maker(uri, n_frames=8, setup=setup))
    assert {f[3].dtype.kind for f in out["port"][1]} == {"f"}


def test_visualization():
    def setup(p):
        assert not p.set_visualization("no-such-element")
        assert p.set_visualization("wavescope")
        p.set_visualization_enabled(True)

    out = play_both(maker(A_URI, n_frames=8, setup=setup))
    shapes = {f[3].shape for f in out["port"][1]}
    assert shapes == {(256, 1), (240, 320, 4)}


def test_y4m_file_uri(tmp_path):
    rng = np.random.default_rng(3)
    spec = MediaSpec(kind="video", format="I420", width=64, height=48)
    planes = {"y": rng.integers(0, 256, (10, 48, 64), dtype=np.uint8),
              "u": rng.integers(0, 256, (10, 24, 32), dtype=np.uint8),
              "v": rng.integers(0, 256, (10, 24, 32), dtype=np.uint8)}
    path = tmp_path / "in.y4m"
    j_y4m.write_y4m(str(path), spec, planes)
    out = play_both(maker(f"file://{path}"))
    frames = out["port"][1]
    assert len(frames) == 10
    np.testing.assert_array_equal(frames[7][3]["y"], planes["y"][7])


def test_subtitles_with_offsets(tmp_path):
    srt = tmp_path / "subs.srt"
    srt.write_text("1\n00:00:00,000 --> 00:00:00,300\nhello\n\n"
                   "2\n00:00:00,500 --> 00:00:00,800\nworld\n\n"
                   "3\n00:00:01,400 --> 00:00:01,600\nlate\n\n")
    cues = {}

    def make(mod, **dev):
        got = cues.setdefault(mod.__name__, [])
        p, rec = maker(V_URI, n_frames=30)(mod, **dev)
        p.on_subtitle = lambda text, cue: got.append((text, dict(cue)))
        assert p.set_subtitle_uri(str(srt))
        p.set_subtitle_video_offset(300_000_000)
        return p, rec

    play_both(make)
    assert cues["gstbad_tpu_torch.session"] == cues["gstbad_tpu.session"]
    assert [t for t, _ in cues["gstbad_tpu_torch.session"]] == [
        "hello", "world"]


@pytest.mark.parametrize("fmt", ["native", "I420", "RGB"])
def test_video_snapshot(fmt):
    out = play_both(maker(
        "testbin://video,pattern=ball,width=64,height=48,format=AYUV",
        n_frames=8))
    snaps = [out[k][0].get_video_snapshot(fmt) for k in ("jax", "port")]
    (js, jf), (ts, tf) = snaps
    assert js.format == ts.format
    assert_frames_equal([(0, 0, True, jf)], [(0, 0, True, tf)])


def test_av_offset_media_info_and_errors():
    out = play_both(maker(AV_URI, n_frames=8, setup=lambda p:
                          p.set_audio_video_offset(7_000_000)))
    play = out["port"][0]
    info = play.media_info
    assert (info.number_of_video_streams, info.number_of_audio_streams) \
        == (1, 1)
    audio = [f for f in out["port"][1] if f[3].dtype.kind == "f"]
    assert audio[0][0] == 7_000_000
    # an unknown scheme: an error message, not an exception
    play_both(maker("foo://bar"), drive=lambda p: p.play())


def test_worker_exception_posts_error():
    """An exception escaping a window (here the frame callback's) posts
    `error` and stops playback; nothing swallows it."""
    def boom(b, i):
        raise RuntimeError("callback failed")

    p = gtt.session.Play(window=4, realtime=False, n_frames=8,
                         on_frame=boom, device="cpu")
    p.set_uri(V_URI)
    p.play()
    assert wait_for(lambda: p.message_bus.pop(name="error"))
    assert wait_for(lambda: p.state.value == "stopped")
    assert p.message_bus.pop(name="error")[0]["reason"] == "callback failed"
    p.stop()


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request is served")
    for make in (lambda: gtt.session.Play(device="cuda"),
                 lambda: gtt.session.Player(device="cuda"),
                 lambda: gtt.session.Camera(device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- Player / signal adapter ------------------------------------------------

def player_both(make, drive):
    """make(mod, **device) -> (player, events list); drive(player) runs
    the scenario; the events each package's handlers saw are held equal
    (enums by value).  Returns the port's events."""
    out = {}
    for label, mod, kw in SESSIONS:
        player, events = make(mod, **kw)
        drive(player)
        out[label] = [tuple(normal(x) for x in e) for e in events]
    assert out["port"] == out["jax"]
    return out["port"]


def test_player_signals_direct():
    def make(mod, **dev):
        events = []
        player = mod.Player(window=4, realtime=False, n_frames=8, **dev)
        for sig in ("state-changed", "position-updated", "uri-loaded",
                    "media-info-updated", "video-dimensions-changed",
                    "duration-changed", "seek-done", "volume-changed"):
            player.connect(sig, lambda *a, s=sig: events.append((s,) + a))
        player.connect("end-of-stream", lambda: events.append(("eos",)))
        with pytest.raises(KeyError):
            player.connect("no-such-signal", lambda: None)
        player.set_uri(V_URI)
        return player, events

    def drive(player):
        player.set_volume(0.25)
        player.seek(2 * DUR)
        player.play()
        assert wait_for(lambda: player.state.value == "stopped")
        player.stop()

    events = player_both(make, drive)
    assert ("eos",) in events and events[-1] == ("state-changed",
                                                 "stopped")


def test_player_queued_dispatcher():
    def make(mod, **dev):
        events = []
        disp = mod.QueuedDispatcher()
        player = mod.Player(window=4, realtime=False, n_frames=8,
                            dispatcher=disp, **dev)
        player.connect("end-of-stream", lambda: events.append(("eos",)))
        player.set_uri(V_URI)
        player.disp = disp
        return player, events

    def drive(player):
        player.play()
        assert wait_for(lambda: player.state.value == "stopped")
        assert player.disp.dispatch_pending() >= 1
        player.stop()

    assert player_both(make, drive) == [("eos",)]


def test_player_control_forwarding():
    def make(mod, **dev):
        events = []
        player = mod.Player(window=4, realtime=False, n_frames=8, **dev)
        player.set_uri(AV_URI)
        return player, events

    def drive(player):
        assert player.get_uri() == AV_URI
        player.set_volume(0.25)
        player.set_mute(True)
        player.set_rate(2.0)
        assert (player.get_volume(), player.get_mute(),
                player.get_rate()) == (0.25, True, 2.0)
        assert player.media_info.number_of_audio_streams == 1
        player.set_video_track_enabled(False)
        assert player.get_current_video_track() is None
        assert player.set_visualization("wavescope")
        player.set_visualization_enabled(True)
        player.stop()

    player_both(make, drive)


def test_signal_adapter_standalone():
    def make(mod, **dev):
        events = []
        p = mod.Play(window=4, realtime=False, n_frames=8, **dev)
        adapter = mod.SignalAdapter(p)
        adapter.connect("uri-loaded", lambda uri: events.append((uri,)))
        p.set_uri(V_URI)
        return p, events

    assert player_both(make, run_to_eos) == [(V_URI,)]
