"""debugutils — identity, fakesink and its video/audio/app variants,
errorignore, tee and queue (gst/debugutils/ and the core elements every
launch line uses)."""

from __future__ import annotations

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register


@register
class Identity(Element):
    NAME = "identity"

    def process(self, params, state, batch: FrameBatch):
        return state, batch


@register
class FakeSink(Element):
    """Terminal sink (drops buffers, like GStreamer's fakesink).

    When the batch carries a packed int32 word (FrameBatch.word — the same
    bytes as 4-byte packed video), the sink keeps the WORD as its retained
    data, so a fused chain's output never needs a separate byte view.
    Pipeline.run restores the uint8 view host-side (a free numpy view), so
    run() callers always observe ordinary uint8 frames."""

    NAME = "fakesink"
    KIND = "sink"

    def process(self, params, state, batch: FrameBatch):
        if batch.word is not None and not isinstance(batch.data, dict):
            return state, batch.replace(data=batch.word)
        return state, batch


@register
class FakeVideoSink(FakeSink):
    NAME = "fakevideosink"


@register
class FakeAudioSink(FakeSink):
    NAME = "fakeaudiosink"


@register
class AppSink(FakeSink):
    """Collects frames for the host (the appsink analog); the Pipeline
    runner returns every window's valid frames, so this is a marker."""
    NAME = "appsink"


@register
class ErrorIgnore(Element):
    """gsterrorignore.c: convert downstream errors into OK.  In the graph
    it is a passthrough (errors here are Python exceptions of host
    hooks)."""
    NAME = "errorignore"
    PROPERTIES = (Property("ignore-error", bool, True),)

    def process(self, params, state, batch: FrameBatch):
        return state, batch


@register
class Tee(Identity):
    """tee: fan-out marker.  In the DAG any node may feed several consumers;
    a named tee makes the launch syntax read like gst-launch."""
    NAME = "tee"


@register
class Queue(Identity):
    """queue: a scheduling decoupler in the reference; a no-op in the
    window step (the whole graph is one schedule)."""
    NAME = "queue"
