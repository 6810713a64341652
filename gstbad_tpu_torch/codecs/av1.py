"""AV1 stateless-decoder base layer
(gst-libs/gst/codecs/gstav1decoder.c + gstav1picture.c).

The AV1 bitstream parser (io/av1obu.py) already owns the 8-slot
reference STATE update (reference_frame_update); the decoder layer on
top manages the PICTURE slots: refresh_frame_flags slot replacement
(gstav1picture.c:167-194 gst_av1_dpb_add), show_existing_frame
duplication from a slot (gstav1decoder.c:356-392; only KEY frames
re-enter the DPB on show-existing, :540-551), and
show_frame/showable-gated output (:603-640).

Temporal units flow as OBU lists from io/av1obu.py; the engine walks
sequence headers, frame headers, frames and tile groups the same way
gst_av1_decoder_decode_obu does.
A copy of the JAX package's codecs/av1.py: only its imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from gstbad_tpu_torch.io import av1obu as av1

NUM_REF_FRAMES = 8


@dataclass(eq=False)
class Av1Picture:
    """gstav1picture.h GstAV1Picture."""
    system_frame_number: int = 0
    frame_hdr: Optional[av1.FrameHeader] = None
    show_frame: bool = False
    showable_frame: bool = False
    apply_grain: bool = False
    duplicate_of: Optional["Av1Picture"] = None


@dataclass
class OutputPicture:
    picture: Av1Picture
    system_frame_number: int


class Av1Decoder:
    """GstAV1Decoder over io/av1obu.py."""

    def __init__(self) -> None:
        self.state = av1.ParserState()
        self.seq: Optional[av1.SequenceHeader] = None
        self.dpb: List[Optional[Av1Picture]] = [None] * NUM_REF_FRAMES
        self.current_picture: Optional[Av1Picture] = None
        self._frame_counter = 0

    def push_tu(self, data: bytes, system_frame_number: int = -1,
                annexb: bool = False) -> List[OutputPicture]:
        """One temporal unit (low-overhead or annex-b framing)."""
        if system_frame_number < 0:
            system_frame_number = self._frame_counter
        self._frame_counter = max(self._frame_counter,
                                  system_frame_number) + 1
        if annexb:
            obus = [o for tu in av1.split_annexb(data)
                    for frame in tu for o in frame]
        else:
            obus = av1.split_obu_stream(data)
        outs: List[OutputPicture] = []
        for obu in obus:
            outs += self._decode_obu(obu, system_frame_number)
        # end of the TU finishes the picture (gstav1decoder.c:603-640
        # handle_frame tail — covers bare show_existing frame headers)
        outs += self._finish_picture()
        return outs

    def _decode_obu(self, obu: av1.Obu, sfn: int) -> List[OutputPicture]:
        """gstav1decoder.c:418-520 decode_obu dispatch."""
        t = obu.obu_type
        if t == av1.OBU_SEQUENCE_HEADER:
            self.seq = av1.parse_sequence_header(obu.payload)
            return []
        if t in (av1.OBU_FRAME_HEADER, av1.OBU_FRAME,
                 av1.OBU_REDUNDANT_FRAME_HEADER):
            if self.seq is None:
                raise ValueError("frame header before sequence header")
            outs: List[OutputPicture] = []
            if self.current_picture is not None:
                # The reference base class requires frame alignment
                # (gstav1decoder.c:352 errors on a second frame header
                # per buffer); we accept multi-frame TUs by finishing
                # the open picture first — a documented superset.
                outs += self._finish_picture()
            fh = av1.parse_frame_header(obu, self.seq, self.state)
            outs += self._process_frame_header(fh, sfn)
            if t == av1.OBU_FRAME:
                # the embedded tile group completes the frame
                # (tile_start_and_end_present_flag == 0, 5.10.1)
                self.state.seen_frame_header = False
                outs += self._finish_picture()
            return outs
        if t == av1.OBU_TILE_GROUP:
            tg = av1.parse_tile_group(obu.payload, self.state)
            if tg.tg_end == tg.num_tiles - 1:
                return self._finish_picture()
            return []
        return []

    def _process_frame_header(self, fh: av1.FrameHeader,
                              sfn: int) -> List[OutputPicture]:
        """gstav1decoder.c:322-416 decode_frame_header."""
        if fh.show_existing_frame:
            ref = self.dpb[fh.frame_to_show_map_idx]
            if ref is None:
                raise ValueError(
                    "show_existing_frame on empty slot "
                    f"{fh.frame_to_show_map_idx}")
            pic = Av1Picture(system_frame_number=sfn,
                             frame_hdr=fh, show_frame=True,
                             duplicate_of=ref)
            self.current_picture = pic
            return []
        pic = Av1Picture(
            system_frame_number=sfn, frame_hdr=fh,
            show_frame=bool(fh.show_frame),
            showable_frame=bool(fh.showable_frame))
        self.current_picture = pic
        return []

    def _finish_picture(self) -> List[OutputPicture]:
        """gstav1decoder.c:530-640 update_state + output."""
        pic, self.current_picture = self.current_picture, None
        if pic is None:
            return []
        fh = pic.frame_hdr
        # update_state: show_existing only re-enters for KEY frames
        # (gstav1decoder.c:540-551: parser reference_frame_update +
        # dpb_add, both skipped for non-KEY show-existing)
        if not fh.show_existing_frame or fh.frame_type == av1.FRAME_KEY:
            av1.reference_frame_update(self.state, fh)
            self._dpb_add(pic if not fh.show_existing_frame
                          else pic.duplicate_of, fh)
        if fh.show_frame or fh.show_existing_frame:
            return [OutputPicture(pic, pic.system_frame_number)]
        return []

    def _dpb_add(self, picture: Av1Picture,
                 fh: av1.FrameHeader) -> None:
        """gstav1picture.c:167-194."""
        for i in range(NUM_REF_FRAMES):
            if (fh.refresh_frame_flags >> i) & 1:
                self.dpb[i] = picture

    def flush(self) -> None:
        self.dpb = [None] * NUM_REF_FRAMES
        self.current_picture = None
        self.state = av1.ParserState()
