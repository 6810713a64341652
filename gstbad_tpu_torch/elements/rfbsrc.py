"""rfbsrc — the gst/librfb/gstrfbsrc.c VNC screen-capture source.

A host-source: `connect(transport)` runs the RFB handshake over an
injected transport (tests drive a scripted mock server — the
io/festival.py pattern; `connect_tcp()` wraps a real socket), then each
`pull_frame()` is one gst_rfb_src_fill: send a FramebufferUpdateRequest
(incremental per the property), block for the update, and hand back the
framebuffer copy (gstrfbsrc.c:506-545).

Properties mirror gstrfbsrc.c:106-150: host/port/version/password,
offset-x/offset-y/width/height screen scraping, incremental,
use-copyrect, shared, view-only.

A port of the JAX package's elements/rfbsrc.py, on the host as there.
"""

from __future__ import annotations

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import require
from gstbad_tpu_torch.io import rfb


@register
class RfbSrc(Element):
    NAME = "rfbsrc"
    KIND = "host-source"
    PROPERTIES = (
        Property("host", str, "127.0.0.1", static=True),
        Property("port", int, 5900, 1, 65535, static=True),
        Property("version", str, "3.3", static=True),
        Property("password", str, "", static=True),
        Property("offset-x", int, 0, 0, 65535, static=True),
        Property("offset-y", int, 0, 0, 65535, static=True),
        Property("width", int, 0, 0, 65535, static=True),
        Property("height", int, 0, 0, 65535, static=True),
        Property("incremental", bool, True, static=True),
        Property("use-copyrect", bool, False, static=True),
        Property("shared", bool, True, static=True),
        Property("view-only", bool, False, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._client = None
        self._n = 0

    def connect(self, transport) -> rfb.RfbClient:
        """Handshake over an injected transport (read(n)/write(b))."""
        self._client = rfb.RfbClient(
            transport,
            version=self.props["version"],
            password=self.props["password"] or None,
            shared=self.props["shared"],
            offset_x=self.props["offset-x"],
            offset_y=self.props["offset-y"],
            width=self.props["width"],
            height=self.props["height"],
            use_copyrect=self.props["use-copyrect"])
        self._client.handshake()
        return self._client

    def connect_tcp(self):
        """The reference's TCP path (gst_rfb_src_start)."""
        import socket

        sock = socket.create_connection(
            (self.props["host"], self.props["port"]))

        class _SockTransport:
            def read(self, n, _s=sock):
                out = b""
                while len(out) < n:
                    chunk = _s.recv(n - len(out))
                    if not chunk:
                        break
                    out += chunk
                return out

            def write(self, data, _s=sock):
                _s.sendall(data)

        return self.connect(_SockTransport())

    @property
    def client(self) -> rfb.RfbClient:
        require(self._client is not None, "rfbsrc: not connected")
        return self._client

    @property
    def format(self) -> str:
        return self.client.format

    def pull_frame(self) -> np.ndarray:
        """One gst_rfb_src_fill: update request -> wait for the
        update -> copy of the frame [H, W, bytespp]."""
        c = self.client
        c.send_update_request(incremental=self.props["incremental"])
        frame = c.pull_update().copy()
        self._n += 1
        return frame

    def send_key(self, key: int, down: bool) -> None:
        if not self.props["view-only"]:
            self.client.send_key_event(key, down)

    def send_pointer(self, button_mask: int, x: int, y: int) -> None:
        if not self.props["view-only"]:
            self.client.send_pointer_event(button_mask, x, y)

    def process(self, params, state, batch: FrameBatch):
        return state, batch      # frames come from pull_frame
