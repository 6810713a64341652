"""JPEG2000 codestream decimation (gst/jp2kdecimator/jp2kcodestream.c,
gstjp2kdecimator.c).

The jp2kdecimator element strips quality layers and resolution levels
from a JPEG2000 codestream WITHOUT re-encoding: it walks the marker
structure (SOC/SIZ/COD/QCD/QCC/COM/CRG, per-tile SOT..SOD), recovers the
packet sequence through the five progression-order iterators, replaces
packets beyond max-layers / max-decomposition-levels with EMPTY packets
(a single zero byte + optional EPH), regenerates PLTs and tile-part
sizes, and re-serializes.  Packet BODIES are never decoded — packet
boundaries come from SOP markers or a PLT, exactly like the reference
(parse_packet, jp2kcodestream.c:842-1003; streams with neither are
rejected).

Unsupported markers raise, matching the reference's errors: COC, POC,
RGN, TLM, PLM, PPM, PPT; multiple PLTs or tile-parts per tile.  One
reference BUG is fixed rather than reproduced: parse_cod with
user-defined precincts writes cod->PPy[i] without ever allocating PPy
(jp2kcodestream.c:601-607 allocates only PPx) — a guaranteed crash
upstream; we allocate both.
A copy of the JAX package's io/jp2k.py: only its imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

MARKER_SOC = 0xFF4F
MARKER_SOT = 0xFF90
MARKER_SOD = 0xFF93
MARKER_EOC = 0xFFD9
MARKER_SIZ = 0xFF51
MARKER_COD = 0xFF52
MARKER_QCD = 0xFF5C
MARKER_QCC = 0xFF5D
MARKER_PLT = 0xFF58
MARKER_SOP = 0xFF91
MARKER_EPH = 0xFF92
MARKER_CRG = 0xFF63
MARKER_COM = 0xFF64
_UNSUPPORTED = {0xFF53: "COC", 0xFF5F: "POC", 0xFF5E: "RGN",
                0xFF55: "TLM", 0xFF57: "PLM", 0xFF60: "PPM",
                0xFF61: "PPT"}

LRCP, RLCP, RPCL, PCRL, CPRL = range(5)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def peek_u16(self) -> int:
        if self.remaining() < 2:
            raise ValueError("jp2k: truncated")
        return (self.data[self.pos] << 8) | self.data[self.pos + 1]

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        v = self.peek_u16()
        self.pos += 2
        return v

    def u32(self) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + 4], "big")
        self.pos += 4
        return v

    def take(self, n: int) -> bytes:
        v = self.data[self.pos:self.pos + n]
        if len(v) < n:
            raise ValueError("jp2k: truncated")
        self.pos += n
        return v


@dataclass
class Siz:
    caps: int
    x: int
    y: int
    xo: int
    yo: int
    xt: int
    yt: int
    xto: int
    yto: int
    components: List[Tuple[int, int, int]]   # (s, xr, yr)


@dataclass
class Cod:
    sop: bool
    eph: bool
    progression_order: int
    n_layers: int
    multi_component_transform: int
    n_decompositions: int
    xcb: int
    ycb: int
    code_block_style: int
    transformation: int
    ppx: Optional[List[int]] = None
    ppy: Optional[List[int]] = None


@dataclass
class Packet:
    sop: bool
    eph: bool
    seqno: int
    data: Optional[bytes]
    length: int


@dataclass
class Tile:
    tile_index: int = 0
    tile_part_size: int = 0
    tile_part_index: int = 0
    n_tile_parts: int = 0
    tx0: int = 0
    tx1: int = 0
    ty0: int = 0
    ty1: int = 0
    cod: Optional[Cod] = None
    qcd: Optional[bytes] = None
    qcc: List[bytes] = field(default_factory=list)
    com: List[bytes] = field(default_factory=list)
    plt: Optional[List[int]] = None
    packets: List[Packet] = field(default_factory=list)


@dataclass
class MainHeader:
    siz: Siz
    cod: Cod
    qcd: bytes
    qcc: List[bytes]
    crg: List[bytes]
    com: List[bytes]
    tiles: List[Tile]
    n_tiles_x: int
    n_tiles_y: int


def _parse_siz(r: _Reader, length: int) -> Siz:
    if length < 38:
        raise ValueError("jp2k: invalid SIZ")
    caps = r.u16()
    vals = [r.u32() for _ in range(8)]
    n = r.u16()
    if length < 38 + 3 * n:
        raise ValueError("jp2k: invalid SIZ")
    comps = [(r.u8(), r.u8(), r.u8()) for _ in range(n)]
    return Siz(caps, *vals, comps)


def _write_siz(siz: Siz) -> bytes:
    out = MARKER_SIZ.to_bytes(2, "big")
    out += (38 + 3 * len(siz.components)).to_bytes(2, "big")
    out += siz.caps.to_bytes(2, "big")
    for v in (siz.x, siz.y, siz.xo, siz.yo, siz.xt, siz.yt, siz.xto,
              siz.yto):
        out += v.to_bytes(4, "big")
    out += len(siz.components).to_bytes(2, "big")
    for s, xr, yr in siz.components:
        out += bytes([s, xr, yr])
    return out


def _parse_cod(r: _Reader, length: int) -> Cod:
    if length < 12:
        raise ValueError("jp2k: invalid COD")
    scod = r.u8()
    cod = Cod(sop=bool(scod & 0x02), eph=bool(scod & 0x04),
              progression_order=r.u8(), n_layers=r.u16(),
              multi_component_transform=r.u8(),
              n_decompositions=r.u8(), xcb=r.u8() + 2, ycb=r.u8() + 2,
              code_block_style=r.u8(), transformation=r.u8())
    if scod & 0x01:
        if length < 12 + cod.n_decompositions + 1:
            raise ValueError("jp2k: invalid COD")
        cod.ppx, cod.ppy = [], []
        for _ in range(cod.n_decompositions + 1):
            v = r.u8()
            cod.ppx.append(v & 0x0F)
            cod.ppy.append(v >> 4)
    return cod


def _write_cod(cod: Cod) -> bytes:
    length = 12 + (cod.n_decompositions + 1 if cod.ppx else 0)
    out = MARKER_COD.to_bytes(2, "big") + length.to_bytes(2, "big")
    scod = (0x01 if cod.ppx else 0) | (0x02 if cod.sop else 0) \
        | (0x04 if cod.eph else 0)
    out += bytes([scod, cod.progression_order])
    out += cod.n_layers.to_bytes(2, "big")
    out += bytes([cod.multi_component_transform, cod.n_decompositions,
                  cod.xcb - 2, cod.ycb - 2, cod.code_block_style,
                  cod.transformation])
    if cod.ppx:
        out += bytes([(cod.ppx[i]) | (cod.ppy[i] << 4)
                      for i in range(cod.n_decompositions + 1)])
    return out


def _parse_plt(r: _Reader, length: int) -> Tuple[int, List[int]]:
    if length < 3:
        raise ValueError("jp2k: invalid PLT")
    index = r.u8()
    lengths = []
    n = 0
    b = 0
    for _ in range(length - 3):
        b = r.u8()
        if n & 0xFE000000:
            raise ValueError("jp2k: PLT element overflow")
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            lengths.append(n)
            n = 0
    if b & 0x80:
        raise ValueError("jp2k: truncated PLT")
    return index, lengths


def _plt_payload(lengths: List[int]) -> bytes:
    out = bytearray()
    for v in lengths:
        chunk = [v & 0x7F]
        v >>= 7
        while v:
            chunk.append(0x80 | (v & 0x7F))
            v >>= 7
        out += bytes(reversed(chunk))
    return bytes(out)


def _write_plt(index: int, lengths: List[int]) -> bytes:
    payload = _plt_payload(lengths)
    if 3 + len(payload) > 65535:
        raise ValueError("jp2k: too big PLT")
    return (MARKER_PLT.to_bytes(2, "big")
            + (3 + len(payload)).to_bytes(2, "big")
            + bytes([index]) + payload)


def _marker_buffer(marker: int, payload: bytes) -> bytes:
    return marker.to_bytes(2, "big") + (len(payload) + 2
                                        ).to_bytes(2, "big") + payload


# ---------------------------------------------------------------------------
# Packet iterators (jp2kcodestream.c:43-460)
# ---------------------------------------------------------------------------


class PacketIterator:
    """Yields (layer, resolution, component, precinct) in the tile's
    progression order."""

    def __init__(self, header: MainHeader, tile: Tile):
        self.header = header
        self.tile = tile
        cod = tile.cod or header.cod
        self.cod = cod
        self.n_layers = cod.n_layers
        self.n_resolutions = 1 + cod.n_decompositions
        self.n_components = len(header.siz.components)
        self.tx0, self.tx1 = tile.tx0, tile.tx1
        self.ty0, self.ty1 = tile.ty0, tile.ty1
        self.cur_layer = self.cur_resolution = self.cur_component = 0
        self.cur_precinct = 0
        self.cur_x, self.cur_y = self.tx0, self.ty0
        self.first = True
        # position-step for RPCL/PCRL/CPRL (jp2kcodestream.c:424-448)
        self.x_step = self.y_step = 0
        for i in range(self.n_components):
            _, xr, yr = header.siz.components[i]
            for j in range(self.n_resolutions):
                ppx = cod.ppx[j] if cod.ppx else 15
                ppy = cod.ppy[j] if cod.ppy else 15
                xs = xr * (1 << (ppx + self.n_resolutions - j - 1))
                ys = yr * (1 << (ppy + self.n_resolutions - j - 1))
                if self.x_step == 0 or self.x_step > xs:
                    self.x_step = xs
                if self.y_step == 0 or self.y_step > ys:
                    self.y_step = ys
        self._next = {LRCP: self._next_lrcp, RLCP: self._next_rlcp,
                      RPCL: self._next_rpcl, PCRL: self._next_pcrl,
                      CPRL: self._next_cprl}.get(cod.progression_order)
        if self._next is None:
            raise ValueError(
                f"jp2k: progression order {cod.progression_order} "
                "not supported")
        self._changed()

    def _changed(self):
        """packet_iterator_changed_resolution_or_component."""
        it = self
        it.two_nl_r = 1 << (it.n_resolutions - it.cur_resolution - 1)
        cod = it.cod
        it.two_ppx = 1 << (cod.ppx[it.cur_resolution] if cod.ppx else 15)
        it.two_ppy = 1 << (cod.ppy[it.cur_resolution] if cod.ppy else 15)
        _, it.xr, it.yr = it.header.siz.components[it.cur_component]
        tcx0 = -(-it.tx0 // it.xr)
        tcx1 = -(-it.tx1 // it.xr)
        tcy0 = -(-it.ty0 // it.yr)
        tcy1 = -(-it.ty1 // it.yr)
        it.trx0 = -(-tcx0 // it.two_nl_r)
        it.trx1 = -(-tcx1 // it.two_nl_r)
        it.try0 = -(-tcy0 // it.two_nl_r)
        it.try1 = -(-tcy1 // it.two_nl_r)
        tpx0 = it.two_ppx * (it.trx0 // it.two_ppx)
        tpx1 = it.two_ppx * (-(-it.trx1 // it.two_ppx))
        tpy0 = it.two_ppy * (it.try0 // it.two_ppy)
        tpy1 = it.two_ppy * (-(-it.try1 // it.two_ppy))
        it.n_precincts_w = 0 if it.trx0 == it.trx1 \
            else (tpx1 - tpx0) // it.two_ppx
        it.n_precincts_h = 0 if it.try0 == it.try1 \
            else (tpy1 - tpy0) // it.two_ppy
        it.n_precincts = it.n_precincts_w * it.n_precincts_h

    def next(self) -> bool:
        return self._next()

    def _next_lrcp(self) -> bool:
        it = self
        if it.first:
            it._changed()
            it.first = False
            return True
        it.cur_precinct += 1
        if it.cur_precinct >= it.n_precincts:
            it.cur_precinct = 0
            it.cur_component += 1
            if it.cur_component >= it.n_components:
                it.cur_component = 0
                it.cur_resolution += 1
                if it.cur_resolution >= it.n_resolutions:
                    it.cur_resolution = 0
                    it.cur_layer += 1
                    if it.cur_layer >= it.n_layers:
                        return False
            it._changed()
        return True

    def _next_rlcp(self) -> bool:
        it = self
        if it.first:
            it._changed()
            it.first = False
            return True
        it.cur_precinct += 1
        if it.cur_precinct >= it.n_precincts:
            it.cur_precinct = 0
            it.cur_component += 1
            if it.cur_component >= it.n_components:
                it.cur_component = 0
                it.cur_layer += 1
                if it.cur_layer >= it.n_layers:
                    it.cur_layer = 0
                    it.cur_resolution += 1
                    if it.cur_resolution >= it.n_resolutions:
                        return False
            it._changed()
        return True

    def _at_precinct_origin(self) -> bool:
        it = self
        return (((it.cur_y % (it.yr * it.two_ppy * it.two_nl_r) == 0)
                 or (it.cur_y == it.ty0
                     and (it.try0 * it.two_nl_r)
                     % (it.two_ppy * it.two_nl_r) != 0))
                and ((it.cur_x % (it.xr * it.two_ppx * it.two_nl_r) == 0)
                     or (it.cur_x == it.tx0
                         and (it.trx0 * it.two_nl_r)
                         % (it.two_ppx * it.two_nl_r) != 0)))

    def _precinct_of_pos(self) -> int:
        it = self
        return ((-(-it.cur_x // (it.xr * it.two_nl_r)) // it.two_ppx)
                - (it.trx0 // it.two_ppx)
                + it.n_precincts_w
                * (-(-it.cur_y // (it.yr * it.two_nl_r)) // it.two_ppy))

    def _advance_x(self) -> bool:
        """cur_x += x_step - cur_x % x_step; True when wrapped."""
        it = self
        it.cur_x += it.x_step - (it.cur_x % it.x_step)
        if it.cur_x >= it.tx1:
            it.cur_x = it.tx0
            return True
        return False

    def _advance_y(self) -> bool:
        it = self
        it.cur_y += it.y_step - (it.cur_y % it.y_step)
        if it.cur_y >= it.ty1:
            return True
        return False

    def _next_rpcl(self) -> bool:
        it = self
        if it.first:
            it._changed()
            it.first = False
            return True
        it.cur_layer += 1
        if it.cur_layer >= it.n_layers:
            it.cur_layer = 0
            while True:
                it.cur_component += 1
                if it.cur_component >= it.n_components:
                    it.cur_component = 0
                    if it._advance_x():
                        if it._advance_y():
                            it.cur_y = it.ty0
                            it.cur_resolution += 1
                            if it.cur_resolution >= it.n_resolutions:
                                return False
                it._changed()
                if it._at_precinct_origin():
                    k = it._precinct_of_pos()
                    assert k < it.n_precincts
                    it.cur_precinct = k
                    break
        return True

    def _next_pcrl(self) -> bool:
        it = self
        if it.first:
            it.first = False
            return True
        it.cur_layer += 1
        if it.cur_layer >= it.n_layers:
            it.cur_layer = 0
            while True:
                it.cur_resolution += 1
                if it.cur_resolution >= it.n_resolutions:
                    it.cur_resolution = 0
                    it.cur_component += 1
                    if it.cur_component >= it.n_components:
                        if it._advance_x():
                            if it._advance_y():
                                return False
                it._changed()
                if it._at_precinct_origin():
                    k = it._precinct_of_pos()
                    assert k < it.n_precincts
                    it.cur_precinct = k
                    break
        return True

    def _next_cprl(self) -> bool:
        it = self
        if it.first:
            it._changed()
            it.first = False
            return True
        it.cur_layer += 1
        if it.cur_layer >= it.n_layers:
            it.cur_layer = 0
            while True:
                it.cur_resolution += 1
                if it.cur_resolution >= it.n_resolutions:
                    it.cur_resolution = 0
                    if it._advance_x():
                        if it._advance_y():
                            it.cur_y = it.ty0
                            it.cur_component += 1
                            if it.cur_component >= it.n_components:
                                return False
                it._changed()
                if it._at_precinct_origin():
                    k = it._precinct_of_pos()
                    assert k < it.n_precincts
                    it.cur_precinct = k
                    break
        return True


# ---------------------------------------------------------------------------
# Packet + tile + main header parsing
# ---------------------------------------------------------------------------


def _sizeof_packet(p: Packet) -> int:
    return p.length + (6 if p.sop else 0) \
        + (2 if (p.eph and p.data is None) else 0)


def _parse_packets(r: _Reader, header: MainHeader, tile: Tile) -> None:
    marker = r.u16()
    if marker != MARKER_SOD:
        raise ValueError("jp2k: no SOD in tile")
    cod = tile.cod or header.cod
    sop, eph = cod.sop, cod.eph
    plt = tile.plt
    it = PacketIterator(header, tile)
    idx = 0
    while it.next():
        if plt is not None:
            if len(plt) <= idx:
                raise ValueError("jp2k: truncated PLT")
            length = plt[idx]
            if r.remaining() < length:
                raise ValueError("jp2k: truncated file")
            p = None
            if sop and length > 6 and r.peek_u16() == MARKER_SOP:
                r.u16()
                r.u16()                       # SOP length (4)
                seqno = r.u16()
                p = Packet(True, eph, seqno, r.take(length - 6),
                           length - 6)
            if p is None:
                p = Packet(False, eph, 0, r.take(length), length)
            tile.packets.append(p)
        elif sop:
            if r.peek_u16() != MARKER_SOP:
                raise ValueError("jp2k: no SOP marker")
            r.u16()
            r.u16()
            seqno = r.u16()
            start = r.pos
            while True:
                m = r.peek_u16()
                if m in (MARKER_SOP, MARKER_EOC, MARKER_SOT):
                    tile.packets.append(Packet(
                        True, eph, seqno, r.data[start:r.pos],
                        r.pos - start))
                    break
                r.pos += 1
            if m in (MARKER_EOC, MARKER_SOT):
                return
        else:
            raise ValueError("jp2k: either PLT or SOP are required "
                             "(jp2kcodestream.c:989)")
        idx += 1


def _parse_tile(r: _Reader, header: MainHeader) -> Tile:
    if r.u16() != MARKER_SOT:
        raise ValueError("jp2k: expected SOT")
    if r.u16() != 10:
        raise ValueError("jp2k: invalid SOT length")
    tile = Tile(tile_index=r.u16(), tile_part_size=r.u32(),
                tile_part_index=r.u8(), n_tile_parts=r.u8())
    siz = header.siz
    tile_x = tile.tile_index % header.n_tiles_x
    tile_y = tile.tile_index // header.n_tiles_x
    tile.tx0 = max(siz.xto + tile_x * siz.xt, siz.xo)
    tile.ty0 = max(siz.yto + tile_y * siz.yt, siz.yo)
    tile.tx1 = min(siz.xto + (tile_x + 1) * siz.xt, siz.x)
    tile.ty1 = min(siz.yto + (tile_y + 1) * siz.yt, siz.y)
    while True:
        marker = r.peek_u16()
        if marker == MARKER_SOD:
            break
        if marker >> 8 != 0xFF:
            raise ValueError("jp2k: lost synchronization")
        if marker in _UNSUPPORTED:
            raise ValueError(
                f"jp2k: {_UNSUPPORTED[marker]} marker not supported")
        r.u16()
        length = r.u16()
        if marker == MARKER_COD:
            if tile.cod:
                raise ValueError("jp2k: only one COD allowed")
            tile.cod = _parse_cod(r, length)
        elif marker == MARKER_PLT:
            if tile.plt is not None:
                raise ValueError(
                    "jp2k: multiple PLT per tile not supported")
            tile.plt_index, tile.plt = _parse_plt(r, length)
        elif marker == MARKER_QCD:
            if tile.qcd is not None:
                raise ValueError("jp2k: multiple QCD markers")
            tile.qcd = r.take(length - 2)
        elif marker == MARKER_QCC:
            tile.qcc.append(r.take(length - 2))
        elif marker == MARKER_COM:
            tile.com.append(r.take(length - 2))
        else:
            r.take(length - 2)               # skip unknown
    _parse_packets(r, header, tile)
    return tile


def parse_main_header(data: bytes) -> MainHeader:
    r = _Reader(data)
    if r.u16() != MARKER_SOC:
        raise ValueError("jp2k: frame does not start with SOC")
    siz = cod = None
    qcd = None
    qcc: List[bytes] = []
    crg: List[bytes] = []
    com: List[bytes] = []
    while True:
        marker = r.peek_u16()
        if marker == MARKER_SOT:
            break
        if marker == MARKER_EOC:
            raise ValueError("jp2k: EOC before SOT")
        if marker >> 8 != 0xFF:
            raise ValueError("jp2k: lost synchronization")
        if marker in _UNSUPPORTED:
            raise ValueError(
                f"jp2k: {_UNSUPPORTED[marker]} marker not supported")
        r.u16()
        length = r.u16()
        if marker == MARKER_SIZ:
            if siz is not None:
                raise ValueError("jp2k: multiple SIZ marker")
            siz = _parse_siz(r, length)
        elif marker == MARKER_COD:
            if siz is None:
                raise ValueError("jp2k: require SIZ before COD")
            if cod is not None:
                raise ValueError("jp2k: multiple COD")
            cod = _parse_cod(r, length)
        elif marker == MARKER_QCD:
            if qcd is not None:
                raise ValueError("jp2k: multiple QCD markers")
            qcd = r.take(length - 2)
        elif marker == MARKER_QCC:
            qcc.append(r.take(length - 2))
        elif marker == MARKER_COM:
            com.append(r.take(length - 2))
        elif marker == MARKER_CRG:
            crg.append(r.take(length - 2))
        else:
            r.take(length - 2)
    if siz is None or cod is None:
        raise ValueError("jp2k: no SIZ or COD before SOT")
    n_tiles_x = -(-(siz.x - siz.xto) // siz.xt)
    n_tiles_y = -(-(siz.y - siz.yto) // siz.yt)
    header = MainHeader(siz, cod, qcd or b"", qcc, crg, com, [],
                        n_tiles_x, n_tiles_y)
    for _ in range(n_tiles_x * n_tiles_y):
        header.tiles.append(_parse_tile(r, header))
    if r.u16() != MARKER_EOC:
        raise ValueError("jp2k: frame does not end with EOC")
    return header


def _write_packet(p: Packet) -> bytes:
    out = b""
    if p.sop:
        out += MARKER_SOP.to_bytes(2, "big") + (4).to_bytes(2, "big") \
            + p.seqno.to_bytes(2, "big")
    if p.data is not None:
        out += p.data
    else:
        out += b"\x00"
        if p.eph:
            out += MARKER_EPH.to_bytes(2, "big")
    return out


def _write_tile(tile: Tile) -> bytes:
    out = MARKER_SOT.to_bytes(2, "big") + (10).to_bytes(2, "big")
    out += tile.tile_index.to_bytes(2, "big")
    out += tile.tile_part_size.to_bytes(4, "big")
    out += bytes([tile.tile_part_index, tile.n_tile_parts])
    if tile.cod:
        out += _write_cod(tile.cod)
    if tile.qcd:
        out += _marker_buffer(MARKER_QCD, tile.qcd)
    for q in tile.qcc:
        out += _marker_buffer(MARKER_QCC, q)
    if tile.plt is not None:
        out += _write_plt(getattr(tile, "plt_index", 0), tile.plt)
    for c in tile.com:
        out += _marker_buffer(MARKER_COM, c)
    out += MARKER_SOD.to_bytes(2, "big")
    for p in tile.packets:
        out += _write_packet(p)
    return out


def write_main_header(header: MainHeader) -> bytes:
    out = MARKER_SOC.to_bytes(2, "big")
    out += _write_siz(header.siz)
    out += _write_cod(header.cod)
    out += _marker_buffer(MARKER_QCD, header.qcd)
    for q in header.qcc:
        out += _marker_buffer(MARKER_QCC, q)
    for c in header.crg:
        out += _marker_buffer(MARKER_CRG, c)
    for c in header.com:
        out += _marker_buffer(MARKER_COM, c)
    for t in header.tiles:
        out += _write_tile(t)
    out += MARKER_EOC.to_bytes(2, "big")
    return out


def decimate_main_header(header: MainHeader,
                         max_decomposition_levels: int = -1,
                         max_layers: int = 0) -> None:
    """decimate_main_header (jp2kcodestream.c:1754-1817): packets beyond
    the limits become empty; PLTs and tile-part sizes regenerate."""
    for tile in header.tiles:
        it = PacketIterator(header, tile)
        new_plt: Optional[List[int]] = [] if tile.plt is not None else None
        i = 0
        while it.next():
            if i >= len(tile.packets):
                raise ValueError("jp2k: not enough packets")
            p = tile.packets[i]
            if ((max_layers != 0 and it.cur_layer >= max_layers)
                    or (max_decomposition_levels != -1
                        and it.cur_resolution > max_decomposition_levels)):
                p.data = None
                p.length = 1
            if new_plt is not None:
                new_plt.append(_sizeof_packet(p))
            i += 1
        if new_plt is not None:
            tile.plt = new_plt
            tile.plt_index = 0
        tile.tile_part_size = len(_write_tile(tile))


def decimate(codestream: bytes, max_decomposition_levels: int = -1,
             max_layers: int = 0) -> bytes:
    """The jp2kdecimator element: parse, decimate, re-serialize."""
    header = parse_main_header(codestream)
    decimate_main_header(header, max_decomposition_levels, max_layers)
    return write_main_header(header)
