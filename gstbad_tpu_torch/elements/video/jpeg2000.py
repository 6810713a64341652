"""openjpegenc / openjpegdec (ext/openjpeg/gstopenjpegenc.c,
gstopenjpegdec.c) over libopenjp2 — the exact codec library the
reference wraps, reached through Pillow's binding (the environment
ships no OpenJPEG dev surface; Pillow 12 links libopenjp2.so.7).

Property mapping onto the reference's encoder parameters:
num-resolutions -> numresolution, progression-order -> prog_order
(LRCP/RLCP/RPCL/PCRL/CPRL), num-layers -> tcp_numlayers (lossless
rate-allocated layers like the reference's cp_disto_alloc=1 with
zero rates), tile-width/height/-offset -> cp_tdx/tdy/tx0/ty0, and the
x-j2c (raw codestream, the reference's default subtype) vs jp2
container choice.  Lossless 5/3 wavelets by default exactly like
gstopenjpegenc.c (tcp_rates[0]=0).

Formats: packed RGB/RGBA/GRAY8 map to JPEG2000 components here; the
reference's planar-YUV component mapping needs per-component
subsampling that the Pillow surface does not expose — route through
videoconvert (documented divergence).

A port of the JAX package's elements/video/jpeg2000.py: openjpegenc encodes
the windows the runner downloads, as there; openjpegdec decodes on the host,
and each window goes to the pipeline's device in one copy
(core/frame.upload_frames).
"""

from __future__ import annotations

import fractions
import io as _io

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.frame import FrameBatch, upload_frames
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.core.spec import MediaSpec, VideoFormat, require

PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _pil():
    try:
        from PIL import Image
        from PIL import features
        if not features.check("jpg_2000"):
            return None
        return Image
    except Exception:  # noqa: BLE001
        return None


def available() -> bool:
    return _pil() is not None


@register
class OpenJpegEnc(Element):
    NAME = "openjpegenc"
    HOST = True
    PROPERTIES = (
        Property("num-layers", int, 1, 1, 10, static=True),
        Property("num-resolutions", int, 6, 1, 10, static=True),
        Property("progression-order", str, "LRCP", static=True),
        Property("tile-width", int, 0, 0, 65535, static=True,
                 doc="0 = no tiling (cp_tdx)"),
        Property("tile-height", int, 0, 0, 65535, static=True),
        Property("tile-offset-x", int, 0, 0, 65535, static=True),
        Property("tile-offset-y", int, 0, 0, 65535, static=True),
        Property("container", str, "j2c", static=True,
                 doc="j2c = raw codestream (the reference's default "
                     "image/x-j2c) | jp2"),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.packets = []            # (pts_ns, bytes)

    def negotiate(self, in_spec):
        require(available(), "openjpegenc: libopenjp2 (via Pillow) "
                             "not available")
        require(in_spec.kind == "video"
                and in_spec.format in (VideoFormat.RGB,
                                       VideoFormat.RGBA,
                                       VideoFormat.GRAY8),
                "openjpegenc: needs RGB/RGBA/GRAY8 input here (the "
                "planar-YUV component mapping is not exposed by this "
                "binding — use videoconvert)")
        require(self.props["progression-order"] in PROGRESSIONS,
                "openjpegenc: bad progression-order")
        require(self.props["container"] in ("j2c", "jp2"),
                "openjpegenc: container must be j2c|jp2")
        # num-resolutions must fit the image (opj requirement)
        import math
        maxres = int(math.log2(max(1, min(in_spec.width,
                                          in_spec.height)))) + 1
        require(self.props["num-resolutions"] <= maxres,
                f"openjpegenc: num-resolutions > log2(min dim)+1 "
                f"({maxres})")
        return in_spec

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _encode(self, frame: np.ndarray) -> bytes:
        Image = _pil()
        if frame.ndim == 3 and frame.shape[-1] == 4:
            img = Image.fromarray(frame, "RGBA")
        elif frame.ndim == 3 and frame.shape[-1] == 3:
            img = Image.fromarray(frame, "RGB")
        else:
            img = Image.fromarray(frame.reshape(frame.shape[:2]), "L")
        buf = _io.BytesIO()
        kw = dict(
            irreversible=False,              # tcp_rates[0]=0 lossless
            num_resolutions=self.props["num-resolutions"],
            progression=self.props["progression-order"],
            no_jp2=self.props["container"] == "j2c",
        )
        if self.props["num-layers"] > 1:
            kw["quality_mode"] = "rates"
            kw["quality_layers"] = [0] * self.props["num-layers"]
        if self.props["tile-width"] and self.props["tile-height"]:
            kw["tile_size"] = (self.props["tile-width"],
                               self.props["tile-height"])
            kw["tile_offset"] = (self.props["tile-offset-x"],
                                 self.props["tile-offset-y"])
        img.save(buf, "JPEG2000", **kw)
        return buf.getvalue()

    def host_process(self, np_batch: FrameBatch, bus) -> None:
        from gstbad_tpu_torch.core.bus import Message
        for i in range(np_batch.batch):
            if not bool(np.asarray(np_batch.valid)[i]):
                continue
            pts = int(np.asarray(np_batch.pts)[i])
            data = self._encode(np.asarray(np_batch.data[i]))
            self.packets.append((pts, data))
            if bus is not None:
                bus.post(Message(self.NAME, "j2k-image", pts,
                                 {"data": data}))


@register
class OpenJpegDec(Element):
    NAME = "openjpegdec"
    KIND = "host-source"
    PROPERTIES = (
        Property("framerate", str, "30/1", static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self._images = []
        self._pos = 0
        self._last = None

    def push_packet(self, data: bytes) -> None:
        """One j2c codestream or jp2 file = one frame."""
        self._images.append(bytes(data))

    def process(self, params, state, batch: FrameBatch):
        return state, batch

    def _decode(self, data: bytes) -> np.ndarray:
        Image = _pil()
        img = Image.open(_io.BytesIO(data))
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None] if self._fmt == VideoFormat.GRAY8 \
                else arr
        return arr

    def negotiate(self, in_spec):
        require(available(), "openjpegdec: libopenjp2 (via Pillow) "
                             "not available")
        require(self._images,
                "openjpegdec: push_packet() codestreams first")
        Image = _pil()
        first = Image.open(_io.BytesIO(self._images[0]))
        w, h = first.size
        mode = first.mode
        if mode == "RGBA":
            self._fmt = VideoFormat.RGBA
        elif mode == "RGB":
            self._fmt = VideoFormat.RGB
        else:
            self._fmt = VideoFormat.GRAY8
        self._fr = fractions.Fraction(self.props["framerate"])
        return MediaSpec(kind="video", format=self._fmt, width=w,
                         height=h, framerate=self._fr)

    def pull_window(self, window: int):
        if self._pos >= len(self._images):
            return None
        dur = self.out_spec.frame_duration_ns
        frames, pts, valid = [], [], []
        for _ in range(window):
            if self._pos < len(self._images):
                arr = self._decode(self._images[self._pos])
                if self._fmt == VideoFormat.GRAY8 and arr.ndim == 3:
                    arr = arr[..., 0]
                self._last = arr
                frames.append(arr)
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
        self._pos = pos
