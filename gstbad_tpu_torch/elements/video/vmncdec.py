"""vmncdec (gst/vmnc/vmncdec.c): decode VMware capture (VMnc / RFB
FramebufferUpdate) packets to raw video.

io/vmnc.py is the byte-level decoder spec (RAW/COPY/HEXTILE rectangle
renderers, the WMVi format descriptor, the WMVd/e/f colour-cursor
pseudo-encodings composited onto the output copy only).  The element is
a host-source: `push_packet(bytes)` feeds the encoded buffers (one
FramebufferUpdate per output frame, the reference's parse framing)
before the run, and decoded frames stream out at `framerate`.

Output format mapping: 32-bit truecolour streams map onto the packed
format whose byte order matches the WMVi masks/shifts (RGBx/BGRx/
xRGB/xBGR; channels must be full 8-bit), 8-bit streams onto GRAY8,
and 16-bit 565/555 bit-field streams onto RGB16/BGR16/RGB15/BGR15
(u16 planes in native order; the WMVi endianness flag picks the
stream byte order).  Other 16-bit mask layouts decode at the io layer
but have no VideoFormat
in this framework — rejected with a clear error (documented; the
reference emits GStreamer's RGB15/16 formats there).

A port of the JAX package's elements/video/vmncdec.py: the decode runs on
the host as there, and each window goes to the pipeline's device in one
copy (core/frame.upload_frames)."""

from __future__ import annotations

import fractions

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require


@register
class VMncDec(Element):
    NAME = "vmncdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._packets = []
        self._pos = 0
        self._dec = None
        self._last = None

    def push_packet(self, data: bytes) -> None:
        self._packets.append(bytes(data))

    def process(self, params, state, batch: FrameBatch):
        return state, batch          # frames come from pull_window

    def _format_from_wmvi(self, dec) -> str:
        if dec.bytes_per_pixel == 1:
            return VideoFormat.GRAY8
        if dec.bytes_per_pixel == 2:
            # 16-bit bit-field layouts map onto the RGB16/RGB15 family
            key = (dec.red_mask, dec.green_mask, dec.blue_mask,
                   dec.red_shift, dec.green_shift, dec.blue_shift)
            fmt = {
                (31, 63, 31, 11, 5, 0): VideoFormat.RGB16,
                (31, 63, 31, 0, 5, 11): VideoFormat.BGR16,
                (31, 31, 31, 10, 5, 0): VideoFormat.RGB15,
                (31, 31, 31, 0, 5, 10): VideoFormat.BGR15,
            }.get(key)
            require(fmt is not None,
                    f"vmncdec: no 16-bit VideoFormat for masks/shifts "
                    f"{key}")
            return fmt
        require(dec.bytes_per_pixel == 4,
                "vmncdec: unsupported bytes-per-pixel "
                f"{dec.bytes_per_pixel}")
        require(dec.red_mask == 255 and dec.green_mask == 255
                and dec.blue_mask == 255,
                "vmncdec: only 8-bit-per-channel 32-bit streams map "
                "onto the packed formats")
        if dec.big_endian:
            offs = {3 - dec.red_shift // 8: "r",
                    3 - dec.green_shift // 8: "g",
                    3 - dec.blue_shift // 8: "b"}
        else:
            offs = {dec.red_shift // 8: "r",
                    dec.green_shift // 8: "g",
                    dec.blue_shift // 8: "b"}
        # the 4th byte is padding -> x-formats, not alpha formats
        for fmt in (VideoFormat.RGBx, VideoFormat.BGRx,
                    VideoFormat.xRGB, VideoFormat.xBGR):
            r, g, b, _x = VideoFormat.rgb_offsets(fmt)
            if offs.get(r) == "r" and offs.get(g) == "g" \
                    and offs.get(b) == "b":
                return fmt
        require(False, f"vmncdec: no packed format for byte layout "
                       f"{offs}")

    def negotiate(self, in_spec):
        from gstbad_tpu_torch.io.vmnc import VMncDecoder
        require(self._packets, "vmncdec: push_packet() some VMnc "
                               "buffers before negotiating")
        probe = VMncDecoder()
        ret = probe.feed_packet(self._packets[0])
        require(ret >= 0 and probe.have_format,
                "vmncdec: first packet must carry a WMVi descriptor")
        fmt = self._format_from_wmvi(probe)
        self._dec = VMncDecoder()
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=fmt, width=probe.width,
                         height=probe.height, framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._packets):
            return None
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._packets):
                ret = self._dec.feed_packet(self._packets[self._pos])
                require(ret >= 0,
                        f"vmncdec: bad packet {self._pos} ({ret})")
                out = self._dec.output_frame()
                if out.shape[-1] == 1:
                    out = out[..., 0]
                elif out.shape[-1] == 2:
                    # raw stream bytes -> native u16 plane per the WMVi
                    # endianness flag
                    order = ">u2" if self._dec.big_endian else "<u2"
                    out = np.ascontiguousarray(out).view(order)[..., 0] \
                        .astype(np.uint16)
                self._last = out
                frames.append(out)
                pts.append(self._pos * dur)
                valid.append(True)
                self._pos += 1
            else:
                frames.append(self._last)
                pts.append(pts[-1] if pts else 0)
                valid.append(False)
        return upload_frames(self.device, frames,
                             pts=np.asarray(pts, np.int64),
                             flags=np.zeros(len(frames), np.int32),
                             valid=np.asarray(valid, bool))

    def save_position(self):
        return self._pos

    def restore_position(self, pos) -> None:
        # decoder state is sequential: replay up to the position
        from gstbad_tpu_torch.io.vmnc import VMncDecoder
        self._dec = VMncDecoder()
        for i in range(pos):
            self._dec.feed_packet(self._packets[i])
        self._pos = pos
