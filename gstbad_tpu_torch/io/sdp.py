"""SDP session descriptions (RFC 4566) — the gst-libs/gst/sdp message
model that gst/sdp/gstsdpdemux.c consumes.

SdpMessage.parse handles the line-typed grammar (v/o/s/c/b/t/a/m with
media-level c=/a= scoping); media_to_caps is the
gst_sdp_media_get_caps_from_media walk the demuxer calls
(gstsdpdemux.c:395-404): resolve the rtpmap for the payload type
(static RFC 3551 assignments below 96), upper-case the encoding name,
attach clock-rate/encoding-params, then append every fmtp parameter
with a lower-cased key.  The result mirrors the application/x-rtp caps
structure as a plain dict.
A copy of the JAX package's io/sdp.py: only its imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# RFC 3551 static payload assignments (gstrtppayloads.c table)
_STATIC_PT = {
    0: ("audio", "PCMU", 8000, "1"),
    3: ("audio", "GSM", 8000, "1"),
    4: ("audio", "G723", 8000, "1"),
    8: ("audio", "PCMA", 8000, "1"),
    9: ("audio", "G722", 8000, "1"),
    10: ("audio", "L16", 44100, "2"),
    11: ("audio", "L16", 44100, "1"),
    14: ("audio", "MPA", 90000, None),
    26: ("video", "JPEG", 90000, None),
    31: ("video", "H261", 90000, None),
    32: ("video", "MPV", 90000, None),
    33: ("video", "MP2T", 90000, None),
    34: ("video", "H263", 90000, None),
}


class SdpError(ValueError):
    pass


@dataclass
class SdpConnection:
    nettype: str = "IN"
    addrtype: str = "IP4"
    address: str = ""
    ttl: int = 0
    addr_number: int = 1


@dataclass
class SdpMedia:
    media: str = ""            # audio | video | application ...
    port: int = 0
    num_ports: int = 1
    proto: str = ""
    formats: List[str] = field(default_factory=list)
    connections: List[SdpConnection] = field(default_factory=list)
    attributes: List[Tuple[str, str]] = field(default_factory=list)

    def get_attribute_val(self, key: str) -> Optional[str]:
        for k, v in self.attributes:
            if k == key:
                return v
        return None

    def attribute_vals(self, key: str) -> List[str]:
        return [v for k, v in self.attributes if k == key]


@dataclass
class SdpMessage:
    version: str = "0"
    origin: str = ""
    session_name: str = ""
    connection: Optional[SdpConnection] = None
    attributes: List[Tuple[str, str]] = field(default_factory=list)
    medias: List[SdpMedia] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "SdpMessage":
        msg = cls()
        current: Optional[SdpMedia] = None
        for raw in text.replace("\r\n", "\n").split("\n"):
            line = raw.strip()
            if not line:
                continue
            if len(line) < 2 or line[1] != "=":
                raise SdpError(f"malformed SDP line {line!r}")
            key, value = line[0], line[2:]
            if key == "v":
                msg.version = value
            elif key == "o":
                msg.origin = value
            elif key == "s":
                msg.session_name = value
            elif key == "c":
                conn = _parse_connection(value)
                if current is not None:
                    current.connections.append(conn)
                else:
                    msg.connection = conn
            elif key == "a":
                k, _, v = value.partition(":")
                if current is not None:
                    current.attributes.append((k, v))
                else:
                    msg.attributes.append((k, v))
            elif key == "m":
                parts = value.split()
                if len(parts) < 4:
                    raise SdpError(f"malformed m= line {value!r}")
                current = SdpMedia(media=parts[0], proto=parts[2],
                                   formats=parts[3:])
                port = parts[1]
                if "/" in port:
                    p, n = port.split("/", 1)
                    current.port, current.num_ports = int(p), int(n)
                else:
                    current.port = int(port)
                msg.medias.append(current)
            # b=, t=, k=, z=, i=, u=, e=, p=, r= carry no demux state
        return msg


def _parse_connection(value: str) -> SdpConnection:
    parts = value.split()
    if len(parts) != 3:
        raise SdpError(f"malformed c= line {value!r}")
    conn = SdpConnection(nettype=parts[0], addrtype=parts[1])
    addr = parts[2]
    # IP4 multicast carries /ttl[/number-of-addresses]
    pieces = addr.split("/")
    conn.address = pieces[0]
    if len(pieces) > 1:
        conn.ttl = int(pieces[1])
    if len(pieces) > 2:
        conn.addr_number = int(pieces[2])
    return conn


def is_multicast_address(address: str) -> bool:
    """IPv4 224.0.0.0/4 (the gstsdpdemux multicast check)."""
    try:
        first = int(address.split(".")[0])
    except ValueError:
        return address.lower().startswith("ff")   # IPv6 multicast
    return 224 <= first <= 239


def media_to_caps(media: SdpMedia, pt: int) -> Dict[str, object]:
    """gst_sdp_media_get_caps_from_media for one payload type:
    media/payload/clock-rate/encoding-name(+params) from the rtpmap
    (static table below 96), then the fmtp parameters with lower-cased
    keys.  Returns the application/x-rtp structure as a dict."""
    caps: Dict[str, object] = {
        "media": media.media,
        "payload": pt,
    }
    rtpmap = None
    for val in media.attribute_vals("rtpmap"):
        num, _, rest = val.partition(" ")
        if num.strip().isdigit() and int(num) == pt:
            rtpmap = rest.strip()
            break
    if rtpmap is not None:
        fields = rtpmap.split("/")
        caps["encoding-name"] = fields[0].upper()
        if len(fields) > 1 and fields[1]:
            caps["clock-rate"] = int(fields[1])
        if len(fields) > 2 and fields[2]:
            caps["encoding-params"] = fields[2]
    elif pt in _STATIC_PT:
        _media, name, rate, params = _STATIC_PT[pt]
        caps["encoding-name"] = name
        caps["clock-rate"] = rate
        if params is not None:
            caps["encoding-params"] = params
    elif pt >= 96:
        raise SdpError(f"dynamic payload {pt} has no rtpmap")
    for val in media.attribute_vals("fmtp"):
        num, _, rest = val.partition(" ")
        if not (num.strip().isdigit() and int(num) == pt):
            continue
        for pair in rest.strip().split(";"):
            pair = pair.strip()
            if not pair:
                continue
            k, _, v = pair.partition("=")
            caps[k.strip().lower()] = v.strip()
    return caps
