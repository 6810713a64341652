"""pcapparse + irtspparse (gst/pcapparse/): capture-file framing.

pcapparse (gstpcapparse.c): consumes a raw libpcap stream and emits the
UDP/TCP payloads as packets.  Transcribed behavior:
  - global header: 4 magics (millisecond/nanosecond x either endian,
    gstpcapparse.c:45-48), major version must be 2, linktype must be
    Ethernet (1), raw IP (101) or Linux cooked SLL (113)
    (gstpcapparse.c:633-656).
  - per-record: 16-byte header (ts_sec, ts_usec, incl_len); timestamp =
    sec*1e9 + usec*(1 ns or 1 us) (gstpcapparse.c:591-604).
  - frame scan (gstpcapparse.c:362-477): Ethernet with optional 802.1q
    VLAN tag, eth type must be 0x800; IPv4 only, fragments dropped,
    UDP/TCP only; UDP payload length comes from the UDP header (so
    Ethernet trailer padding is excluded - the upstream
    test_parse_frames_with_eth_padding case); TCP payload length from
    the IP total length minus headers; src/dst IP and port filters.
  - zero-length UDP payloads still emit (empty) buffers
    (test_parse_zerosize_frames).
  - the first emitted packet is flagged DISCONT; with ts-offset >= 0
    timestamps are rebased to the first packet plus the offset
    (gstpcapparse.c:545-553).

irtspparse (gstirtspparse.c): parses an interleaved RTSP byte stream
('$' channel u16be-length frames, RFC 2326 section 10.12); frames on
channel-id pass through, other channels are skipped; leading garbage is
scanned for the first 0x24 (gstirtspparse.c:160-170).
A port of the JAX package's elements/pcap.py, on the host as there.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register

NSEC = 1_000_000_000
USEC = 1_000

MAGIC_MS = 0xA1B2C3D4
MAGIC_NS = 0xA1B23C4D
MAGIC_MS_SWAP = 0xD4C3B2A1
MAGIC_NS_SWAP = 0x4D3CB2A1

LINKTYPE_ETHER = 1
LINKTYPE_RAW = 101
LINKTYPE_SLL = 113

ETH_MAC_ADDRESSES_LEN = 12
ETH_HEADER_LEN = 14
ETH_VLAN_HEADER_LEN = 4
SLL_HEADER_LEN = 16
IP_HEADER_MIN_LEN = 20
UDP_HEADER_LEN = 8
IP_PROTO_UDP = 17
IP_PROTO_TCP = 6


class PcapError(ValueError):
    """Maps to the reference's STREAM/WRONG_TYPE element errors."""


def _ip_to_u32(ip_str: str) -> int:
    """inet_addr: the filter value as the packet carries it
    (network byte order, gstpcapparse.c:166-175)."""
    if not ip_str:
        return -1
    try:
        return struct.unpack("<I", socket.inet_aton(ip_str))[0]
    except OSError:
        return -1


@register
class PcapParse(Element):
    NAME = "pcapparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("src-ip", str, "", static=True),
        Property("dst-ip", str, "", static=True),
        Property("src-port", int, -1, -1, 65535, static=True),
        Property("dst-port", int, -1, -1, 65535, static=True),
        Property("caps", str, "", static=True),
        Property("ts-offset", int, -1, None, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self.initialized = False
        self.swap_endian = False
        self.nanosecond_timestamp = False
        self.linktype = 0
        self.cur_packet_size = -1
        self.cur_ts = -1
        self.base_ts = -1
        self.first_packet = True
        self.src_ip = _ip_to_u32(self.props["src-ip"])
        self.dst_ip = _ip_to_u32(self.props["dst-ip"])

    # -- parsing ---------------------------------------------------------

    def _u32(self, data: bytes, off: int) -> int:
        return struct.unpack_from(">I" if self.swap_endian else "<I",
                                  data, off)[0]

    def _scan_frame(self, buf: bytes) -> Optional[tuple]:
        """gst_pcap_parse_scan_frame: (payload_offset, payload_size) or
        None to drop the record."""
        if self.linktype == LINKTYPE_ETHER:
            if len(buf) < ETH_HEADER_LEN + IP_HEADER_MIN_LEN \
                    + UDP_HEADER_LEN:
                return None
            eth_type = struct.unpack_from(
                ">H", buf, ETH_MAC_ADDRESSES_LEN)[0]
            if eth_type == 0x8100:  # 802.1q VLAN
                if len(buf) < (ETH_HEADER_LEN + ETH_VLAN_HEADER_LEN
                               + IP_HEADER_MIN_LEN + UDP_HEADER_LEN):
                    return None
                eth_type = struct.unpack_from(
                    ">H", buf,
                    ETH_MAC_ADDRESSES_LEN + ETH_VLAN_HEADER_LEN)[0]
                ip_off = ETH_HEADER_LEN + ETH_VLAN_HEADER_LEN
            else:
                ip_off = ETH_HEADER_LEN
        elif self.linktype == LINKTYPE_SLL:
            if len(buf) < SLL_HEADER_LEN + IP_HEADER_MIN_LEN \
                    + UDP_HEADER_LEN:
                return None
            eth_type = struct.unpack_from(">H", buf, 14)[0]
            ip_off = SLL_HEADER_LEN
        elif self.linktype == LINKTYPE_RAW:
            if len(buf) < IP_HEADER_MIN_LEN + UDP_HEADER_LEN:
                return None
            eth_type = 0x800
            ip_off = 0
        else:
            return None

        if eth_type != 0x800:
            return None
        b = buf[ip_off]
        if (b >> 4) & 0x0F != 4:  # IPv4 only
            return None
        ip_header_size = (b & 0x0F) * 4
        if ip_off + ip_header_size > len(buf):
            return None
        flags = buf[ip_off + 6] >> 5
        fragment_offset = (struct.unpack_from(">H", buf, ip_off + 6)[0]
                           & 0x1FFF) * 8
        if flags & 0x1 or fragment_offset > 0:
            return None
        ip_protocol = buf[ip_off + 9]
        if ip_protocol not in (IP_PROTO_UDP, IP_PROTO_TCP):
            return None
        ip_src_addr = struct.unpack_from("<I", buf, ip_off + 12)[0]
        ip_dst_addr = struct.unpack_from("<I", buf, ip_off + 16)[0]
        proto_off = ip_off + ip_header_size
        ip_packet_len = struct.unpack_from(">H", buf, ip_off + 2)[0]
        src_port = struct.unpack_from(">H", buf, proto_off)[0]
        dst_port = struct.unpack_from(">H", buf, proto_off + 2)[0]

        if ip_protocol == IP_PROTO_UDP:
            length = struct.unpack_from(">H", buf, proto_off + 4)[0]
            if length < UDP_HEADER_LEN or proto_off + length > len(buf):
                return None
            payload_off = proto_off + UDP_HEADER_LEN
            payload_size = length - UDP_HEADER_LEN
        else:
            if proto_off + 12 >= len(buf):
                return None
            length = (buf[proto_off + 12] >> 4) * 4
            if proto_off + length > len(buf):
                return None
            payload_off = proto_off + length
            payload_size = ip_packet_len - ip_header_size - length

        if self.src_ip >= 0 and ip_src_addr != self.src_ip:
            return None
        if self.dst_ip >= 0 and ip_dst_addr != self.dst_ip:
            return None
        if self.props["src-port"] >= 0 \
                and src_port != self.props["src-port"]:
            return None
        if self.props["dst-port"] >= 0 \
                and dst_port != self.props["dst-port"]:
            return None
        return payload_off, payload_size

    def chain(self, data: bytes) -> List[Dict]:
        """gst_pcap_parse_chain: returns the emitted payload packets."""
        self._buf += data
        out: List[Dict] = []
        while True:
            if not self.initialized:
                if len(self._buf) < 24:
                    break
                magic = struct.unpack_from("<I", self._buf, 0)[0]
                if magic in (MAGIC_MS, MAGIC_NS):
                    self.swap_endian = False
                    self.nanosecond_timestamp = magic == MAGIC_NS
                elif magic in (MAGIC_MS_SWAP, MAGIC_NS_SWAP):
                    self.swap_endian = True
                    self.nanosecond_timestamp = magic == MAGIC_NS_SWAP
                else:
                    raise PcapError(
                        f"File is not a libpcap file, magic is "
                        f"{magic:X}")
                major = struct.unpack_from(
                    ">H" if self.swap_endian else "<H", self._buf, 4)[0]
                if major != 2:
                    raise PcapError(
                        f"File is not a libpcap major version 2, "
                        f"but {major}")
                linktype = self._u32(self._buf, 20)
                if linktype not in (LINKTYPE_ETHER, LINKTYPE_SLL,
                                    LINKTYPE_RAW):
                    raise PcapError(f"linktype {linktype} not understood")
                self.linktype = linktype
                self._buf = self._buf[24:]
                self.initialized = True
            elif self.cur_packet_size < 0:
                if len(self._buf) < 16:
                    break
                ts_sec = self._u32(self._buf, 0)
                ts_usec = self._u32(self._buf, 4)
                incl_len = self._u32(self._buf, 8)
                self._buf = self._buf[16:]
                self.cur_ts = ts_sec * NSEC + ts_usec * (
                    1 if self.nanosecond_timestamp else USEC)
                self.cur_packet_size = incl_len
            else:
                if len(self._buf) < self.cur_packet_size:
                    break
                record = self._buf[:self.cur_packet_size]
                self._buf = self._buf[self.cur_packet_size:]
                if self.cur_packet_size > 0:
                    found = self._scan_frame(record)
                    if found is not None:
                        off, size = found
                        ts = self.cur_ts
                        if ts >= 0:
                            if self.base_ts < 0:
                                self.base_ts = ts
                            if self.props["ts-offset"] >= 0:
                                ts = (ts - self.base_ts
                                      + self.props["ts-offset"])
                        out.append(dict(
                            data=record[off:off + size], pts=ts,
                            discont=self.first_packet))
                        self.first_packet = False
                self.cur_packet_size = -1
        return out

    def event_flush_stop(self) -> None:
        self.__init__(**self.props)

    def process(self, params, state, batch):
        return state, batch


@register
class IRtspParse(Element):
    NAME = "irtspparse"
    KIND = "host-source"
    PROPERTIES = (
        Property("channel-id", int, 0, 0, 255, static=True),
    )

    MAGIC = 0x24

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = b""
        self._discont = True

    def chain(self, data: bytes, discont: bool = False) -> List[Dict]:
        """The gstirtspparse.c:137-227 state machine, drained greedily
        over buffered bytes."""
        if discont:
            self._discont = True
        self._buf += data
        out: List[Dict] = []
        while True:
            idx = self._buf.find(b"\x24")
            if idx < 0:
                self._buf = b""
                break
            self._buf = self._buf[idx:]
            if len(self._buf) < 4:
                break
            channel = self._buf[1]
            size = struct.unpack_from(">H", self._buf, 2)[0]
            if len(self._buf) < 4 + size:
                break
            frame = self._buf[4:4 + size]
            self._buf = self._buf[4 + size:]
            if channel == self.props["channel-id"]:
                out.append(dict(data=frame, discont=self._discont))
                self._discont = False
        return out

    def process(self, params, state, batch):
        return state, batch
