"""Kate stream elements (ext/kate/): kateenc, katedec, kateparse,
katetag.

The reference wraps libkate; this family runs on the io/kate.py native
codec.  These are packet-domain host elements (the siren/festival
host-source pattern): Kate packets are tiny control-plane byte strings,
the decoded payloads (text / DVD SPU) flow onward to the device
elements that consume them (textoverlay-style renderers, dvdspu).

Behavioral transcription of the upstream unit test
(tests/check/elements/kate.c):
  - kateenc emits 9 header packets (0x80..0x88) before the first data
    packet, then one data packet per input buffer and a 0x7f EOS packet
    on EOS; category must be set or it errors (gstkateenc.c:577-583).
  - kateenc generates keepalive packets on segment updates when the gap
    since the last packet reaches keepalive-min-time
    (gstkateenc.c:1282-1292; test_kate_encode_keepalives).
  - kateenc accepts subpicture/x-dvd buffers, decoding the SPU into a
    paletted kate bitmap (gstkateenc.c:783-930); SPUs with no hide time
    are delayed until the next event (gstkateenc.c:884-895).
  - katedec consumes headers silently, emits a tag event right after
    the comment header (language lowercased and truncated at '_' -
    gstkateutil.c:358-370, title from the vorbiscomments, encoder
    vendor, subtitle-codec "Kate"), then text buffers with
    start/duration from the packet times (gstkatedec.c:242-310);
    empty packets are a flow error.
  - kateparse collects the headers, exposes them as streamheaders, and
    retimestamps data packets from their granulepos
    (gstkateparse.c:249-266).
  - katetag is a kateparse subclass that rewrites language (offset 32),
    category (offset 48) and canvas sizes (offsets 16/18) in the ID
    header and remuxes the comment header (gstkatetag.c:264-345);
    with no properties set the stream passes through byte-exact.

A port of the JAX package's elements/kate.py, on the host as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import kate as kate_io

NSEC = 1_000_000_000

DEFAULT_KEEPALIVE_MIN_TIME = 2.5   # gstkateenc.c:115
DEFAULT_DEFAULT_SPU_DURATION = 1.5  # gstkateenc.c:116


class KatePacket(dict):
    """A produced Kate packet: data + the ogg-style decorations the
    reference puts on the buffer (gstkateenc.c:390-418)."""

    @property
    def data(self) -> bytes:
        return self["data"]


def _packet(data: bytes, granulepos: int, pts_ns: int, dur_ns: int,
            header: bool = False) -> KatePacket:
    return KatePacket(data=data, granulepos=granulepos, pts=pts_ns,
                      duration=dur_ns, header=header)


@register
class KateEnc(Element):
    """Kate stream encoder (gstkateenc.c).

    Host packet API: set_caps() -> push_text()/push_spu() or the
    generic chain(); event_segment(); event_eos().  Every call returns
    the list of KatePackets produced.
    """

    NAME = "kateenc"
    KIND = "host-source"
    PROPERTIES = (
        Property("language", str, "", static=True),
        Property("category", str, "", static=True),
        Property("granule-rate-numerator", int, 1000, 1, 2 ** 31 - 1,
                 static=True),
        Property("granule-rate-denominator", int, 1, 1, 2 ** 31 - 1,
                 static=True),
        Property("granule-shift", int, 32, 0, 64, static=True),
        Property("original-canvas-width", int, 0, 0, 2 ** 31 - 1,
                 static=True),
        Property("original-canvas-height", int, 0, 0, 2 ** 31 - 1,
                 static=True),
        Property("keepalive-min-time", float, DEFAULT_KEEPALIVE_MIN_TIME,
                 0.0, None, static=True),
        Property("default-spu-duration", float,
                 DEFAULT_DEFAULT_SPU_DURATION, 0.0, None, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._enc: Optional[kate_io.KateEncoder] = None
        self.headers_sent = False
        self.last_timestamp = 0
        self.latest_end_time = 0
        self.format = None          # 'utf8' | 'pango-markup' | 'spu'
        self.spu_clut = list(kate_io.DEFAULT_CLUT)
        self.tags: List[str] = []   # vorbiscomment strings
        self._delayed_spu = None    # (start_ns, region, bitmap, palette)
        self.src_caps: Optional[str] = None

    # -- setup ---------------------------------------------------------

    def _info(self) -> kate_io.KateInfo:
        return kate_io.KateInfo(
            language=self.props["language"],
            category=self.props["category"],
            gps_numerator=self.props["granule-rate-numerator"],
            gps_denominator=self.props["granule-rate-denominator"],
            granule_shift=self.props["granule-shift"],
            original_canvas_width=self.props["original-canvas-width"],
            original_canvas_height=self.props["original-canvas-height"])

    def set_caps(self, caps: str) -> None:
        """gst_kate_enc_setcaps (gstkateenc.c:512-553)."""
        if caps.startswith("text/x-raw"):
            self.format = ("pango-markup" if "pango-markup" in caps
                           else "utf8")
        elif caps.startswith("subpicture/x-dvd"):
            self.format = "spu"
        else:
            raise ValueError(f"unexpected input caps {caps}")

    # -- header flush ---------------------------------------------------

    def _flush_headers(self) -> List[KatePacket]:
        if self.headers_sent:
            return []
        category = self.props["category"]
        if not category:
            raise kate_io.KateError(
                "The 'category' property must be set. For subtitles, set "
                "it to either 'SUB' (text subtitles) or 'K-SPU' "
                "(dvd-style subtitles)")  # gstkateenc.c:577-583
        self._enc = kate_io.KateEncoder(self._info(), self.tags)
        out = [_packet(h, 0, 0, 0, header=True)
               for h in self._enc.encode_headers()]
        # simple subtitle categories ride subtitle/x-kate caps
        # (gstkateenc.c:585-600, 640-647)
        simple = category in ("subtitles", "SUB", "spu-subtitles", "K-SPU")
        self.src_caps = ("subtitle/x-kate" if simple
                         else "application/x-kate")
        self.headers_sent = True
        return out

    def _push(self, data: bytes, pts_ns: int, dur_ns: int) -> KatePacket:
        self.last_timestamp = pts_ns
        if pts_ns + dur_ns > self.latest_end_time:
            self.latest_end_time = pts_ns + dur_ns
        return _packet(data, self._enc.get_granule(), pts_ns, dur_ns)

    # -- data ------------------------------------------------------------

    def chain(self, data: bytes, pts_ns: int,
              dur_ns: int) -> List[KatePacket]:
        """gst_kate_enc_chain (gstkateenc.c:976-1005)."""
        out = self._flush_headers()
        out += self._flush_waiting(pts_ns)
        if self.format == "spu":
            out += self._chain_spu(data, pts_ns)
        else:
            out += self._chain_text(data, pts_ns, dur_ns)
        return out

    def push_text(self, text: bytes, pts_ns: int,
                  dur_ns: int) -> List[KatePacket]:
        return self.chain(text, pts_ns, dur_ns)

    def push_spu(self, spu: bytes, pts_ns: int,
                 dur_ns: int = 0) -> List[KatePacket]:
        return self.chain(spu, pts_ns, dur_ns)

    def _chain_text(self, text: bytes, pts_ns: int,
                    dur_ns: int) -> List[KatePacket]:
        t0 = pts_ns / NSEC
        t1 = (pts_ns + dur_ns) / NSEC
        markup = (kate_io.MARKUP_SIMPLE if self.format == "pango-markup"
                  else kate_io.MARKUP_NONE)
        pkt = self._enc.encode_text(t0, t1, text, markup)
        # duration = stop - start + 1 ns (gstkateenc.c:971)
        return [self._push(pkt, pts_ns, dur_ns + 1)]

    def _chain_spu(self, spu: bytes, pts_ns: int) -> List[KatePacket]:
        """gst_kate_enc_chain_spu (gstkateenc.c:783-930)."""
        region, bitmap, palette, show_stm, hide_stm = kate_io.spu_decode(
            spu, self.spu_clut, self.props["original-canvas-width"],
            self.props["original-canvas-height"])
        if bitmap.width == 0 or bitmap.height == 0:
            return []  # wholly transparent SPU (gstkateenc.c:825-830)
        start = pts_ns + kate_io.stm_to_ns(show_stm)
        stop = pts_ns + kate_io.stm_to_ns(hide_stm)
        if hide_stm <= show_stm:
            # no hide time: delay until the next suitable event
            # (gstkateenc.c:884-895)
            self._delayed_spu = (start, region, bitmap, palette)
            return []
        pkt = self._enc.encode_text(start / NSEC, stop / NSEC, b"",
                                    kate_io.MARKUP_NONE,
                                    region, palette, bitmap)
        return [self._push(pkt, start, stop - start + 1)]

    def _flush_waiting(self, now_ns: int) -> List[KatePacket]:
        """gst_kate_enc_flush_waiting (gstkateenc.c:719-780)."""
        if self._delayed_spu is None:
            return []
        start, region, bitmap, palette = self._delayed_spu
        self._delayed_spu = None
        pkt = self._enc.encode_text(start / NSEC, now_ns / NSEC, b"",
                                    kate_io.MARKUP_NONE,
                                    region, palette, bitmap)
        out = [self._push(pkt, start, now_ns - start + 1)]
        # trailing keepalives over the delayed span (gstkateenc.c:768-778)
        ka = self.props["keepalive-min-time"]
        if ka > 0.0 and now_ns > start:
            t = start
            while True:
                t += int(ka * NSEC)
                if t >= now_ns:
                    break
                out.append(self._keepalive(t))
        return out

    def _keepalive(self, ts_ns: int) -> KatePacket:
        pkt = self._enc.encode_keepalive(ts_ns / NSEC)
        return self._push(pkt, ts_ns, 0)

    # -- events ------------------------------------------------------------

    def event_segment(self, start_ns: int) -> List[KatePacket]:
        """Segment-update keepalive logic (gstkateenc.c:1259-1300)."""
        out = self._flush_headers()
        t = start_ns / NSEC
        if (self._delayed_spu is not None
                and t - self._delayed_spu[0] / NSEC
                >= self.props["default-spu-duration"]):
            out += self._flush_waiting(start_ns)
        ka = self.props["keepalive-min-time"]
        if (ka > 0.0 and t - self.last_timestamp / NSEC >= ka
                and self._delayed_spu is None):
            out.append(self._keepalive(start_ns))
        return out

    def event_tag(self, comments: List[str]) -> None:
        """Upstream tag events merge into the comment header
        (gstkateenc.c:1344-1356); only effective before headers flush."""
        self.tags.extend(comments)

    def event_eos(self) -> List[KatePacket]:
        """EOS: flush delayed SPU then the 0x7f packet
        (gstkateenc.c:1358-1390)."""
        out = self._flush_headers()
        if self._delayed_spu is not None:
            delayed_end = (self._delayed_spu[0]
                           + int(self.props["default-spu-duration"] * NSEC))
            out += self._flush_waiting(delayed_end)
        pkt = self._enc.encode_finish()
        out.append(_packet(pkt, self._enc.get_granule(),
                           self.latest_end_time, 0))
        return out

    def set_clut(self, clut: List[int]) -> None:
        """dvd-spu-clut-change custom event (gstkateenc.c:1311-1334)."""
        for i, v in enumerate(clut[:16]):
            self.spu_clut[i] = v

    def process(self, params, state, batch):
        return state, batch


class _DecodedText(dict):
    @property
    def text(self) -> str:
        return self["text"]


@register
class KateDec(Element):
    """Kate stream decoder (gstkatedec.c + gstkateutil.c decoder base).

    chain(packet) returns a list of outputs:
      {"kind": "text", "text", "format", "pts", "duration"}
      {"kind": "spu", "data", "clut_event", "pts", "duration"}
    Tag events accumulate in .tag_events; caps updates in .src_caps.
    """

    NAME = "katedec"
    KIND = "host-source"
    PROPERTIES = (
        Property("remove-markup", bool, False, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._dec = kate_io.KateDecoder()
        self.tag_events: List[Dict] = []
        self._tags: Dict[str, object] = {}
        self.src_caps: Optional[str] = None
        self.output_format: Optional[str] = None
        # read-only properties mirrored from the stream
        # (gstkateutil.c:79-90)
        self.language = ""
        self.category = ""

    def chain(self, packet: bytes) -> List[Dict]:
        try:
            kind, payload = self._dec.packetin(packet)
        except kate_io.KateError as e:
            raise  # -> GST_FLOW_ERROR (test_kate_empty_identification_header)
        if kind == "header":
            self._handle_header(payload, packet)
            return []
        if kind in ("keepalive", "eos"):
            return []
        return self._handle_event(payload)

    def _handle_header(self, header_type: int, packet: bytes) -> None:
        """gstkateutil.c:331-421."""
        if header_type == 0x80:
            ki = self._dec.info
            self.language, self.category = ki.language, ki.category
            if ki.category in ("K-SPU", "spu-subtitles"):
                self.src_caps = "subpicture/x-dvd"
            elif ki.text_markup_type == kate_io.MARKUP_NONE:
                self.src_caps = "text/x-raw, format=utf8"
            else:
                self.src_caps = "text/x-raw, format=pango-markup"
            if ki.language:
                # en_GB -> en (gstkateutil.c:358-366: lowercase then
                # cut at the first delimiter)
                code = ki.language.lower()
                for d in "_-|> <.":
                    code = code.split(d, 1)[0]
                self._tags["language-code"] = code
        elif header_type == 0x81:
            # vorbiscomments + ENCODER + SUBTITLE_CODEC + ENCODER_VERSION
            # tags, pushed immediately (gstkateutil.c:385-411)
            for c in self._dec.comments:
                if "=" in c:
                    k, v = c.split("=", 1)
                    self._tags[k.lower()] = v
            if self._dec.vendor:
                self._tags["encoder"] = self._dec.vendor
            self._tags["subtitle-codec"] = "Kate"
            self._tags["encoder-version"] = \
                self._dec.info.bitstream_version_major
            self.tag_events.append(dict(self._tags))

    def _handle_event(self, ev: kate_io.KateEvent) -> List[Dict]:
        """gst_kate_dec_handle_kate_event (gstkatedec.c:242-355)."""
        out: List[Dict] = []
        text = ev.text
        if (self.props["remove-markup"]
                and ev.text_markup_type != kate_io.MARKUP_NONE):
            text = kate_io.remove_markup(text)
            plain = True
        else:
            plain = ev.text_markup_type == kate_io.MARKUP_NONE
        if len(text) > 0:
            fmt = "utf8" if plain else "pango-markup"
            if fmt != self.output_format:
                self.src_caps = f"text/x-raw, format={fmt}"
                self.output_format = fmt
            out.append(_DecodedText(
                kind="text", text=text, format=fmt,
                pts=int(ev.start_time * NSEC),
                duration=int((ev.end_time - ev.start_time) * NSEC)))
        if ev.bitmap is not None and ev.palette is not None:
            spu, clut = kate_io.spu_encode(ev)
            if spu is None:
                raise kate_io.KateError(
                    "failed to create SPU from paletted bitmap")
            if self.output_format != "spu":
                self.src_caps = "subpicture/x-dvd"
                self.output_format = "spu"
            out.append(dict(kind="spu", data=spu, clut_event=clut,
                            pts=int(ev.start_time * NSEC),
                            duration=int((ev.end_time - ev.start_time)
                                         * NSEC)))
        return out

    def process(self, params, state, batch):
        return state, batch


@register
class KateParse(Element):
    """Kate stream parser (gstkateparse.c): buffers the headers, then
    forwards everything, retimestamping data packets from granulepos."""

    NAME = "kateparse"
    KIND = "host-source"
    PROPERTIES = ()

    def __init__(self, **props):
        super().__init__(**props)
        self.info: Optional[kate_io.KateInfo] = None
        self._streamheader: List[bytes] = []
        self._headers_sent = False
        self.streamheaders: List[bytes] = []  # exposed on caps

    def _parse_packet(self, packet: bytes, granulepos: int,
                      pts_ns: int, dur_ns: int) -> List[KatePacket]:
        """Hook for katetag (gst_kate_parse_parse_packet)."""
        return [self._push_buffer(packet, granulepos, pts_ns, dur_ns)]

    def _push_buffer(self, packet: bytes, granulepos: int,
                     pts_ns: int, dur_ns: int) -> KatePacket:
        """gst_kate_parse_push_buffer (gstkateparse.c:249-266)."""
        if granulepos < 0 and self.info is not None:
            # synthesize from the timestamp
            granulepos = (self.info.duration_granule(pts_ns / NSEC)
                          << self.info.granule_shift)
        ts = pts_ns
        if self.info is not None and granulepos >= 0:
            ts = int(self.info.granule_time(granulepos) * NSEC)
        return _packet(packet, granulepos, ts, dur_ns)

    def chain(self, packet: bytes, granulepos: int = -1,
              pts_ns: int = 0, dur_ns: int = 0) -> List[KatePacket]:
        if kate_io.is_header(packet) and not self._headers_sent:
            if packet and packet[0] == 0x80:
                self.info = kate_io.parse_id_header(packet)
            self._streamheader.append(packet)
            need = self.info.num_headers if self.info else kate_io.NUM_HEADERS
            if len(self._streamheader) < need:
                return []
            return self._push_headers()
        out: List[KatePacket] = []
        if not self._headers_sent and self._streamheader:
            out += self._push_headers()
        out += self._parse_packet(packet, granulepos, pts_ns, dur_ns)
        return out

    def _push_headers(self) -> List[KatePacket]:
        """gst_kate_parse_push_headers (gstkateparse.c:157-226): headers
        go onto the caps AND downstream."""
        out = []
        for h in self._streamheader:
            processed = self._parse_header(h)
            self.streamheaders.append(processed)
            out.append(_packet(processed, 0, 0, 0, header=True))
        self._streamheader = []
        self._headers_sent = True
        return out

    def _parse_header(self, header: bytes) -> bytes:
        """Hook: katetag rewrites headers here; kateparse passes through."""
        return header

    def event_eos(self) -> List[KatePacket]:
        out = []
        if not self._headers_sent and self._streamheader:
            out += self._push_headers()
        return out

    def process(self, params, state, batch):
        return state, batch


@register
class KateTag(KateParse):
    """Kate tagger (gstkatetag.c): a kateparse that rewrites the ID
    header's language/category/canvas fields and remuxes the comment
    header."""

    NAME = "katetag"
    PROPERTIES = (
        Property("language", str, "", static=True),
        Property("category", str, "", static=True),
        Property("original-canvas-width", int, -1, -1, 2 ** 31 - 1,
                 static=True),
        Property("original-canvas-height", int, -1, -1, 2 ** 31 - 1,
                 static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.merge_tags: List[str] = []  # user tag-setter comments

    def _parse_header(self, header: bytes) -> bytes:
        """gst_kate_tag_parse_packet (gstkatetag.c:264-345)."""
        if len(header) >= 64 and header[0] == 0x80:
            buf = bytearray(header)
            lang = self.props["language"]
            if lang:
                raw = lang.encode()[:15]
                buf[32:48] = raw + b"\x00" * (16 - len(raw))
                buf[47] = 0
            cat = self.props["category"]
            if cat:
                raw = cat.encode()[:15]
                buf[48:64] = raw + b"\x00" * (16 - len(raw))
                buf[63] = 0
            if self.props["original-canvas-width"] >= 0:
                v = kate_io.encode_canvas_size(
                    self.props["original-canvas-width"])
                buf[16], buf[17] = v & 0xFF, (v >> 8) & 0xFF
            if self.props["original-canvas-height"] >= 0:
                v = kate_io.encode_canvas_size(
                    self.props["original-canvas-height"])
                buf[18], buf[19] = v & 0xFF, (v >> 8) & 0xFF
            return bytes(buf)
        if len(header) >= 9 and header[0] == 0x81:
            # remux the comment header, merging user tags; with no user
            # tags this round-trips byte-exact
            # (gstkatetag.c:314-341; test_kate_tag_passthrough)
            vendor, comments = kate_io.parse_comment_header(header)
            if self.merge_tags:
                comments = list(self.merge_tags) + comments
            return kate_io.serialize_comment_header(vendor, comments)
        return header
