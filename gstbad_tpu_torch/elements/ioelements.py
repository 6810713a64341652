"""Element facades for io-layer codecs whose reference counterparts
are elements: aesenc/aesdec (ext/aes), id3mux (gst/id3tag),
pnmenc/pnmdec (gst/pnm), aiffparse (gst/aiff) and autovideoconvert
(gst/autoconvert's video specialization).

The byte/tag machinery lives in io/ (aes.py, id3.py, pnm.py, aiff.py);
these register the reference element names over it so registry parity
holds (a gst-launch user finds the same names).  They work on bytes on
the host, as the JAX package's do: AES-CBC encryption chains block by
block, so it stays serial there."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.elements.misc import AutoConvert
from gstbad_tpu_torch.io import aes as aes_io
from gstbad_tpu_torch.io import aiff as aiff_io
from gstbad_tpu_torch.io import id3 as id3_io
from gstbad_tpu_torch.io import pnm as pnm_io


class _AesBase(Element):
    KIND = "host-source"
    PROPERTIES = (
        Property("key", str, "", static=True),
        Property("iv", str, "", static=True),
        Property("cipher", str, "aes-128-cbc", static=True),
        Property("serialize-iv", bool, False, static=True),
        Property("per-buffer-padding", bool, True, static=True),
    )
    _IO = None

    def __init__(self, **props):
        super().__init__(**props)
        self._impl = None

    @property
    def impl(self):
        if self._impl is None:
            self._impl = self._IO(
                key=self.props["key"], iv=self.props["iv"],
                cipher=self.props["cipher"],
                serialize_iv=self.props["serialize-iv"],
                per_buffer_padding=self.props["per-buffer-padding"])
        return self._impl

    def chain(self, data: bytes) -> bytes:
        return self.impl.push(data)

    def finish(self) -> bytes:
        return self.impl.finish()


@register
class AesEncElement(_AesBase):
    NAME = "aesenc"
    _IO = aes_io.AesEnc


@register
class AesDecElement(_AesBase):
    NAME = "aesdec"
    _IO = aes_io.AesDec


@register
class Id3Mux(Element):
    """id3mux (gst/id3tag): buffer the payload, emit ID3v2 + payload
    (+ ID3v1 trailer) at EOS."""

    NAME = "id3mux"
    KIND = "host-source"
    PROPERTIES = (
        Property("write-v1", bool, False, static=True),
        Property("write-v2", bool, True, static=True),
        Property("v2-version", int, 3, 3, 4, static=True),
    )

    def __init__(self, **props):
        super().__init__(**props)
        self.tags: Dict = {}
        self._buf = bytearray()

    def set_tags(self, **tags) -> None:
        self.tags.update(tags)

    def chain(self, data: bytes) -> None:
        self._buf += data

    def finish(self) -> bytes:
        return id3_io.mux_stream(
            bytes(self._buf), self.tags,
            write_v1=self.props["write-v1"],
            write_v2=self.props["write-v2"],
            v2_version=self.props["v2-version"])


@register
class PnmEnc(Element):
    """pnmenc (gst/pnm): one image in, one P5/P6 document out."""

    NAME = "pnmenc"
    KIND = "host-source"

    def chain(self, image: np.ndarray) -> bytes:
        img = np.asarray(image, np.uint8)
        h, w = img.shape[:2]
        if img.ndim == 2:
            head = f"P5\n{w} {h}\n255\n".encode()
        elif img.shape[2] == 3:
            head = f"P6\n{w} {h}\n255\n".encode()
        else:
            raise ValueError("pnmenc wants [H,W] or [H,W,3]")
        return head + img.tobytes()


@register
class PnmDec(Element):
    """pnmdec (gst/pnm): P5/P6 bytes in, image out."""

    NAME = "pnmdec"
    KIND = "host-source"

    def chain(self, data: bytes) -> np.ndarray:
        spec, img = pnm_io.read_pnm(bytes(data))
        self.src_caps = {"media": "video/x-raw",
                         "format": spec.format,
                         "width": spec.width, "height": spec.height}
        return img


@register
class AiffParse(Element):
    """aiffparse (gst/aiff): FORM/COMM/SSND walk; buffers until EOS
    then emits caps + samples (io/aiff.py does the chunk walk incl.
    the IEEE-80 rate and AIFC little-endian 'sowt' quirk)."""

    NAME = "aiffparse"
    KIND = "host-source"

    def __init__(self, **props):
        super().__init__(**props)
        self._buf = bytearray()
        self.src_caps: Optional[Dict] = None

    def chain(self, data: bytes) -> None:
        self._buf += data

    def finish(self) -> Dict:
        spec, samples = aiff_io.read_aiff(bytes(self._buf))
        self.src_caps = {"media": "audio/x-raw",
                         "format": spec.format,
                         "rate": spec.rate,
                         "channels": spec.channels}
        return {"caps": self.src_caps, "data": samples}


@register
class AutoVideoConvert(AutoConvert):
    """autovideoconvert (gst/autoconvert): autoconvert preloaded with
    the video converter factories (gstautovideoconvert.c wraps the
    same base with a videoconvert-scoped factory list)."""

    NAME = "autovideoconvert"

    def _select(self, in_spec):
        if not self.props["factories"]:
            self.props = dict(self.props)
            self.props["factories"] = "videoconvert,identity"
        return super()._select(in_spec)
