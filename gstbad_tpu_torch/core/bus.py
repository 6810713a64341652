"""Bus & element messages — the GstBus analog.

The reference's metric channel is element messages posted on the pipeline bus
(SURVEY.md section 5.5: videoanalyse luma stats, removesilence
silence_detected/finished PTS, iqa per-pad scores...).  Here elements return
dicts of per-frame device scalars from `process`; the runner fetches them per
window and materializes Message records host-side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Message:
    element: str   # element name, e.g. "videoanalyse"
    name: str      # structure name, e.g. "GstVideoAnalyse"
    pts: int       # nanoseconds
    fields: Dict[str, Any]

    def __getitem__(self, k):
        return self.fields[k]


class Bus:
    """Collects messages; supports sync handlers (gst_bus_add_watch analog)."""

    def __init__(self):
        self.messages: List[Message] = []
        self._watchers: List[Callable[[Message], None]] = []

    def post(self, msg: Message) -> None:
        self.messages.append(msg)
        for w in self._watchers:
            w(msg)

    def add_watch(self, fn: Callable[[Message], None]) -> None:
        self._watchers.append(fn)

    def pop(self, element: Optional[str] = None, name: Optional[str] = None):
        out = [m for m in self.messages
               if (element is None or m.element == element)
               and (name is None or m.name == name)]
        return out
