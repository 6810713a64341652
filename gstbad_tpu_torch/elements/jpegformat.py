"""jpegparse + jifmux elements (gst/jpegformat/).

jpegparse frames a JPEG byte stream into single complete images with
width/height/format caps from the SOF header (gstjpegparse.c, via
io/jpeg.JpegParse).

jifmux remuxes a JPEG's header markers and injects tag metadata
(gstjifmux.c gst_jif_mux_mangle_markers, lines 365-470):
  - marker order: JFIF APP0 first (synthesized when the image has none
    and is YUV/grayscale), then the Exif APP1, then the XMP APP1, then
    a COM, then the remaining segments and the scan;
  - the Exif APP1 is built from the element's tag list through the
    gstexiftag.c serializer (io/exif.build_exif) and REPLACES any
    existing Exif APP1;
  - the XMP APP1 comes from the gstxmptag.c serializer
    (io/xmp.build_xmp) and replaces any existing XMP packet;
  - the COM text comes from comment, else description, else title
    (gstjifmux.c:545-549 fallback chain).

The upstream unit test (tests/check/elements/jifmux.c) verifies the
produced Exif by re-parsing it with libexif and comparing rendered tag
values; tests/test_jifmux.py does exactly the same through the
io/exif.read_exif ctypes binding.

A port of the JAX package's elements/jpegformat.py, on the host as there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gstbad_tpu_torch.core.element import Element, Property
from gstbad_tpu_torch.core.registry import register
from gstbad_tpu_torch.io import jpeg as jpeg_io
from gstbad_tpu_torch.io.exif import build_exif
from gstbad_tpu_torch.io.xmp import build_xmp


@register
class JpegParseElement(Element):
    NAME = "jpegparse"
    KIND = "host-source"

    def __init__(self, **props):
        super().__init__(**props)
        self._parser = jpeg_io.JpegParse()

    def chain(self, data: bytes) -> List[Dict]:
        out = []
        for img in self._parser.push(data):
            out.append({
                "data": img.data,
                "caps": {
                    "media": "image/jpeg",
                    "width": img.width,
                    "height": img.height,
                    "format": img.format,
                    "parsed": True,
                },
            })
        return out


@register
class JifMux(Element):
    NAME = "jifmux"
    KIND = "host-source"

    def __init__(self, **props):
        super().__init__(**props)
        self.tags: Dict = {}

    # the GstTagSetter interface analog
    def set_tags(self, **tags) -> None:
        self.tags.update(tags)

    def merge_tags(self, tags: Dict) -> None:
        self.tags.update(tags)

    def chain(self, jpeg: bytes) -> bytes:
        exif: Optional[bytes] = None
        xmp: Optional[bytes] = None
        comment: Optional[str] = None
        if self.tags:
            blob = build_exif(self.tags)
            # APP1 length field caps the payload (gstjifmux.c:532-536)
            if len(blob) + 4 < 65536:
                exif = blob[6:]  # jif_mux re-adds the "Exif\0\0" id
            xblob = build_xmp(self.tags)
            xmp = xblob if xblob else None
            comment = (self.tags.get("comment")
                       or self.tags.get("description")
                       or self.tags.get("title"))
        return jpeg_io.jif_mux(jpeg, comment=comment, exif=exif,
                               xmp=xmp)
