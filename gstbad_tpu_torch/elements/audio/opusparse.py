"""opusparse (ext/opus/gstopusparse.c) over io/opus.py.

Byte-stream framing per gst_opus_parse_handle_frame
(gstopusparse.c:140-266):
  - OpusHead / OpusTags header packets are detected first (the
    gstopusheader.c validation rules) and HELD — they surface as caps
    streamheaders, not buffers (GST_BASE_PARSE_FLOW_DROPPED);
  - otherwise opus_packet_parse frames the packet; the packet length
    is the sum of the parsed frame sizes plus the TOC/size bytes;
  - if that fails, the libopus TEST VECTOR framing is tried: u32 BE
    packet length (capped at MAX_PAYLOAD_BYTES=1500) + u32 enc_final
    range + packet, and the declared length is heeded so padding is
    eaten (gstopusparse.c:182-210);
  - un-parseable bytes are skipped one at a time;
  - once the first data packet arrives, caps are emitted: from the
    held ID header when there was one, else "blindly canonical
    stereo" (gstopusparse.c:383-397) — a synthesized family-0 header;
  - buffers are stamped with accumulated pts and the TOC duration
    table; offset_end is the 48 kHz sample offset
    (gstopusparse.c:436-444).

A copy of the JAX package's elements/audio/opusparse.py: only its imports
differ.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import opus as opus_io


def _packet_parse(data: bytes):
    if opus_io.libopus_available():
        return opus_io.packet_parse_libopus(data)
    return opus_io.packet_parse(data)


@register
class OpusParse(Element):
    NAME = "opusparse"
    KIND = "host-source"

    def __init__(self, **props):
        super().__init__(**props)
        self.header_sent = False
        self.got_headers = False
        self.pre_skip = 0
        self.next_ts = 0
        self.id_header: Optional[bytes] = None
        self.comment_header: Optional[bytes] = None
        self.src_caps: Optional[Dict] = None
        self._buf = b""

    # -- caps ---------------------------------------------------------

    def _emit_caps(self) -> None:
        pre_skip = 0
        gain = 0
        if self.id_header is not None:
            pre_skip, = struct.unpack_from("<H", self.id_header, 10)
            gain, = struct.unpack_from("<h", self.id_header, 16)
            parse = opus_io.parse_id_header(self.id_header)
            header = opus_io.build_id_header(
                parse.sample_rate, parse.channels,
                parse.channel_mapping_family, parse.n_streams,
                parse.n_stereo_streams, parse.channel_mapping,
                pre_skip, gain)
        else:
            # "blindly setting up canonical stereo"
            header = opus_io.build_id_header(48000, 2, 0, 1, 1, (0, 1),
                                             pre_skip, gain)
        self.src_caps = opus_io.caps_from_header(header)
        if self.comment_header is not None:
            self.src_caps["streamheader"] = \
                [header, self.comment_header]
        self.id_header = None
        self.comment_header = None
        self.header_sent = True

    # -- framing --------------------------------------------------------

    def _try_frame(self):
        """(skip, packet, heeded_size) for the front of the buffer, or
        None when more data is needed."""
        data = self._buf
        if not data:
            return None
        if opus_io.is_id_header(data) or opus_io.is_comment_header(data):
            # headers arrive packetized: take the whole buffer
            return 0, data, len(data)
        try:
            toc, frames, payload_offset = _packet_parse(data)
            # TOC/size header bytes + the frame bytes
            # (gstopusparse.c:211-216)
            size = payload_offset + sum(len(f) for f in frames)
            return 0, data[:size], size
        except opus_io.OpusError:
            pass
        # test-vector framing: u32 BE size + u32 final range + packet
        if len(data) < 4:
            return None
        packet_size = struct.unpack_from(">I", data)[0]
        if packet_size > opus_io.MAX_PAYLOAD_BYTES:
            return "skip", None, None
        if packet_size > len(data) - 4:
            return None  # truncated: wait
        if len(data) < 8:
            return None
        try:
            _packet_parse(data[8:8 + packet_size])
        except opus_io.OpusError:
            return "skip", None, None
        # heed the declared framing so padding is eaten
        return 8, data[8:8 + packet_size], 8 + packet_size

    # -- push -----------------------------------------------------------

    def chain(self, data: bytes, packetized: bool = False
              ) -> List[Dict]:
        """Push bytes.  packetized=True treats each call as one
        complete packet (ogg-style input); otherwise the byte stream
        is framed incrementally."""
        out: List[Dict] = []
        if packetized:
            self._buf = b""
            out += self._handle_packet(data)
            return out
        self._buf += data
        while True:
            got = self._try_frame()
            if got is None:
                return out
            skip, packet, consumed = got
            if skip == "skip":
                self._buf = self._buf[1:]
                continue
            self._buf = self._buf[consumed:]
            out += self._handle_packet(packet)

    def _handle_packet(self, packet: bytes) -> List[Dict]:
        if not self.got_headers or not self.header_sent:
            if opus_io.is_id_header(packet):
                self.id_header = packet
                return []  # FLOW_DROPPED
            if opus_io.is_comment_header(packet):
                self.comment_header = packet
                return []
            self.got_headers = True
            self._emit_caps()
        duration = opus_io.packet_duration_opus(packet)
        buf = {
            "data": packet,
            "pts": self.next_ts,
            "duration": duration,
            "caps": self.src_caps,
        }
        self.next_ts += duration
        buf["offset_end"] = self.next_ts * 48000 // opus_io.GST_SECOND
        buf["offset"] = self.next_ts
        return [buf]
