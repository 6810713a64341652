"""Player — the GstPlayer wrapper + signal adapter analogs
(gst-libs/gst/player/gstplayer.c, 4.8k LoC, and
gst-libs/gst/play/gstplay-signal-adapter.c).

GstPlayer is a thin signal-emitting facade over GstPlay: it owns a
GstPlay, converts its message-bus records into GObject signals
(gstplayer.c:303-368 the 12 signals), and marshals each emission through
a pluggable GstPlayerSignalDispatcher (gstplayer-signal-dispatcher.c —
the g_main_context variant queues emissions onto an application main
loop).  Here:

  Player.connect("position-updated", fn)   -> g_signal_connect
  DirectDispatcher                         -> emit on the Play worker
                                              thread (sync handlers)
  QueuedDispatcher + dispatch_pending()    -> the GMainContext analog:
      emissions queue; the application thread drains them explicitly

The GstPlaySignalAdapter (play/gstplay-signal-adapter.c:459) is the same
message->signal bridge exposed standalone: SignalAdapter wraps any Play's
message bus without the control API.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

from gstbad_tpu_torch.core.bus import Message
from gstbad_tpu_torch.session.play import PLAY_MESSAGES, Play, PlayState

#: GstPlayer signal names (gstplayer.c:303-368) — identical to the play
#: message names minus none; 'buffering' maps from the buffering message.
PLAYER_SIGNALS = PLAY_MESSAGES


class DirectDispatcher:
    """Emit on the posting thread (the Play worker) — the NULL-dispatcher
    path of gst_player_new (emissions ride the GstPlay thread)."""

    def dispatch(self, emitter: Callable[[], None]) -> None:
        emitter()

    def dispatch_pending(self) -> int:
        return 0


class QueuedDispatcher:
    """GstPlayerGMainContextSignalDispatcher analog
    (gstplayer-g-main-context-signal-dispatcher.c): emissions queue and
    the application drains them from ITS thread with
    dispatch_pending()."""

    def __init__(self):
        self._q = collections.deque()
        self._cv = threading.Condition()

    def dispatch(self, emitter: Callable[[], None]) -> None:
        with self._cv:
            self._q.append(emitter)
            self._cv.notify_all()

    def dispatch_pending(self, timeout: Optional[float] = None) -> int:
        """Run queued emissions on the caller's thread; returns the
        count (the g_main_context_iteration analog)."""
        if timeout:
            with self._cv:
                if not self._q:
                    self._cv.wait(timeout)
        n = 0
        while True:
            with self._cv:
                if not self._q:
                    return n
                emitter = self._q.popleft()
            emitter()
            n += 1


class SignalAdapter:
    """GstPlaySignalAdapter (gstplay-signal-adapter.c): bridges a Play
    message bus to named-callback signals."""

    def __init__(self, play: Play, dispatcher=None):
        self.play_instance = play          # gst_play_signal_adapter_get_play
        self.dispatcher = dispatcher or DirectDispatcher()
        self._handlers: Dict[str, List[Callable]] = {}
        play.message_bus.add_watch(self._on_message)

    def connect(self, signal: str, fn: Callable) -> None:
        if signal not in PLAYER_SIGNALS:
            raise KeyError(f"no signal {signal!r} "
                           f"(have {sorted(PLAYER_SIGNALS)})")
        self._handlers.setdefault(signal, []).append(fn)

    def disconnect(self, signal: str, fn: Callable) -> None:
        self._handlers.get(signal, []).remove(fn)

    # signal argument map (gstplayer.c:444-520 emit sites)
    _ARGS = {
        "uri-loaded": ("uri",),
        "position-updated": ("position",),
        "duration-changed": ("duration",),
        "state-changed": ("state",),
        "buffering": ("percent",),
        "error": ("reason",),
        "warning": ("reason",),
        "video-dimensions-changed": ("width", "height"),
        "media-info-updated": ("media_info",),
        "volume-changed": ("volume",),
        "mute-changed": ("muted",),
        "seek-done": ("position",),
        "end-of-stream": (),
    }

    def _on_message(self, msg: Message) -> None:
        if msg.element != "play":
            return
        handlers = list(self._handlers.get(msg.name, ()))
        if not handlers:
            return
        args = tuple(msg.fields.get(k) for k in self._ARGS[msg.name])

        def emitter():
            for fn in handlers:
                fn(*args)

        self.dispatcher.dispatch(emitter)


class Player(SignalAdapter):
    """gst_player_new analog: a Play plus the signal surface.  All
    control APIs delegate 1:1 (gstplayer.c wraps every gst_play_* call).
    Without `play`, a Play is made on `device` from play_kwargs.
    """

    def __init__(self, play: Optional[Play] = None, dispatcher=None,
                 device="cuda", **play_kwargs):
        self._play = play if play is not None else Play(device=device,
                                                        **play_kwargs)
        super().__init__(self._play, dispatcher)

    # -- playback control ---------------------------------------------------
    def play(self) -> None:
        self._play.play()

    def pause(self) -> None:
        self._play.pause()

    def stop(self) -> None:
        self._play.stop()

    def seek(self, position_ns: int) -> None:
        self._play.seek(position_ns)

    # -- properties (gstplayer.c property forwarding) ------------------------
    @property
    def state(self) -> PlayState:
        return self._play.state

    @property
    def position(self) -> int:
        return self._play.position

    @property
    def duration(self) -> Optional[int]:
        return self._play.duration

    @property
    def media_info(self):
        return self._play.media_info

    def set_uri(self, uri: str) -> None:
        self._play.set_uri(uri)

    def get_uri(self) -> Optional[str]:
        return self._play.get_uri()

    def set_subtitle_uri(self, uri: str) -> bool:
        return self._play.set_subtitle_uri(uri)

    def set_rate(self, rate: float) -> None:
        self._play.set_rate(rate)

    def get_rate(self) -> float:
        return self._play.get_rate()

    def set_volume(self, v: float) -> None:
        self._play.set_volume(v)

    def get_volume(self) -> float:
        return self._play.get_volume()

    def set_mute(self, m: bool) -> None:
        self._play.set_mute(m)

    def get_mute(self) -> bool:
        return self._play.get_mute()

    def set_audio_track(self, i: int) -> bool:
        return self._play.set_audio_track(i)

    def set_video_track(self, i: int) -> bool:
        return self._play.set_video_track(i)

    def set_subtitle_track(self, i: int) -> bool:
        return self._play.set_subtitle_track(i)

    def set_audio_track_enabled(self, e: bool) -> None:
        self._play.set_audio_track_enabled(e)

    def set_video_track_enabled(self, e: bool) -> None:
        self._play.set_video_track_enabled(e)

    def set_subtitle_track_enabled(self, e: bool) -> None:
        self._play.set_subtitle_track_enabled(e)

    def get_current_audio_track(self):
        return self._play.get_current_audio_track()

    def get_current_video_track(self):
        return self._play.get_current_video_track()

    def get_current_subtitle_track(self):
        return self._play.get_current_subtitle_track()

    def set_visualization(self, name: Optional[str], **props) -> bool:
        return self._play.set_visualization(name, **props)

    def set_visualization_enabled(self, e: bool) -> None:
        self._play.set_visualization_enabled(e)

    def get_pipeline(self):
        return self._play.get_pipeline()
