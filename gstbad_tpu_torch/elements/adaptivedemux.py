"""dashdemux / hlsdemux / mssdemux element facades over
session/adaptive.py (ext/dash, ext/hls, ext/smoothstreaming).

The reference elements are network-driven bins; here the transport is
the injected fetch callable (see session/adaptive.py).  The element
surface matches the reference's property set where it applies:
connection-speed (kbps, 0 = measure) and bitrate-limit (0..1, default
0.8) from GstAdaptiveDemux (gstadaptivedemux.c:418-433).

Usage:
    d = gt.make("hlsdemux", **{"connection-speed": 2000})
    d.load(manifest_text, uri="http://.../master.m3u8", fetch=fetch)
    for frag in d.fragments(): ...
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.session import adaptive


class _AdaptiveDemuxElement(Element):
    KIND = "host-source"
    PROPERTIES = (
        # connection-speed is in kbps like the reference property
        Property("connection-speed", int, 0, 0, (1 << 32) // 1000),
        Property("bitrate-limit", float, 0.8, 0.0, 1.0),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._demux: Optional[adaptive.AdaptiveDemux] = None

    def _kwargs(self, clock) -> Dict:
        kw = dict(
            connection_speed_kbps=self.props["connection-speed"],
            bitrate_limit=self.props["bitrate-limit"])
        if clock is not None:
            kw["clock"] = clock
        return kw

    @property
    def demux(self) -> adaptive.AdaptiveDemux:
        if self._demux is None:
            raise adaptive.AdaptiveError(
                f"{self.NAME}: no manifest loaded (call load())")
        return self._demux

    @property
    def streams(self):
        return self.demux.streams

    def fragments(self, max_fragments: Optional[int] = None
                  ) -> Iterator[Dict]:
        return self.demux.fragments(max_fragments)


@register
class DashDemux(_AdaptiveDemuxElement):
    NAME = "dashdemux"

    def load(self, manifest: str, fetch: Callable, base_uri: str = "",
             clock=None) -> "DashDemux":
        if isinstance(manifest, bytes):
            manifest = manifest.decode()
        self._demux = adaptive.open_dash(manifest, fetch, base_uri,
                                         **self._kwargs(clock))
        return self


@register
class HlsDemux(_AdaptiveDemuxElement):
    NAME = "hlsdemux"

    def load(self, manifest: str, fetch: Callable, uri: str = "",
             clock=None) -> "HlsDemux":
        if isinstance(manifest, bytes):
            manifest = manifest.decode()
        self._demux = adaptive.open_hls(manifest, uri, fetch,
                                        **self._kwargs(clock))
        return self


@register
class MssDemux(_AdaptiveDemuxElement):
    NAME = "mssdemux"

    def load(self, manifest: bytes, fetch: Callable,
             base_uri: str = "", clock=None) -> "MssDemux":
        if isinstance(manifest, str):
            manifest = manifest.encode()
        self._demux = adaptive.open_mss(manifest, fetch, base_uri,
                                        **self._kwargs(clock))
        return self
