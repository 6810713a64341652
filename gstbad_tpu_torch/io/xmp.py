"""XMP packet serialization (gst-libs/gst/tag/gstxmptag.c subset).

The reference serializes a GstTagList into an RDF/XML XMP packet that
jifmux embeds as the second APP1 ("http://ns.adobe.com/xap/1.0/\\0").
This writes the same schema mapping for the tags jifmux exercises:

  artist                 -> dc:creator (rdf:Seq)
  copyright              -> dc:rights
  description            -> dc:description
  keywords               -> dc:subject (rdf:Bag)
  device-manufacturer    -> tiff:Make
  device-model           -> tiff:Model
  application-name       -> xmp:CreatorTool
  user-rating            -> xmp:Rating
  datetime               -> exif:DateTimeOriginal
  geo-location-latitude  -> exif:GPSLatitude  ("D,M.mmmmmmN" notation,
  geo-location-longitude -> exif:GPSLongitude  gstxmptag.c geo writer)
  image-orientation      -> tiff:Orientation

and parses them back (read side of the same table) for the depayloader
tests.  The packet wrapper is the standard xpacket begin/end pair.

A copy of the JAX package's io/xmp.py: only its imports differ.
"""

from __future__ import annotations

import re
from typing import Dict

from gstbad_tpu_torch.io.exif import ORIENTATIONS

_NS = {
    "dc": "http://purl.org/dc/elements/1.1/",
    "exif": "http://ns.adobe.com/exif/1.0/",
    "tiff": "http://ns.adobe.com/tiff/1.0/",
    "xmp": "http://ns.adobe.com/xap/1.0/",
}

XMP_HEADER = b"http://ns.adobe.com/xap/1.0/\x00"


def _geo(value: float, pos_ref: str, neg_ref: str) -> str:
    ref = pos_ref if value >= 0 else neg_ref
    value = abs(value)
    deg = int(value)
    minutes = (value - deg) * 60
    return f"{deg},{minutes:.6f}{ref}"


def _esc(s: str) -> str:
    return (str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def build_xmp(tags: Dict) -> bytes:
    simple = []
    seqs = []

    def prop(name, value):
        simple.append(f"<{name}>{_esc(value)}</{name}>")

    if "artist" in tags:
        seqs.append(("dc:creator", "Seq", [tags["artist"]]))
    if "copyright" in tags:
        prop("dc:rights", tags["copyright"])
    if "description" in tags:
        prop("dc:description", tags["description"])
    if "keywords" in tags:
        seqs.append(("dc:subject", "Bag", list(tags["keywords"])))
    if "device-manufacturer" in tags:
        prop("tiff:Make", tags["device-manufacturer"])
    if "device-model" in tags:
        prop("tiff:Model", tags["device-model"])
    if "image-orientation" in tags:
        prop("tiff:Orientation", ORIENTATIONS[tags["image-orientation"]])
    if "application-name" in tags:
        prop("xmp:CreatorTool", tags["application-name"])
    if "user-rating" in tags:
        prop("xmp:Rating", tags["user-rating"])
    if "datetime" in tags:
        # EXIF "YYYY:MM:DD hh:mm:ss" -> ISO 8601
        d = tags["datetime"]
        prop("exif:DateTimeOriginal",
             d[:10].replace(":", "-") + "T" + d[11:])
    if "geo-location-latitude" in tags:
        prop("exif:GPSLatitude",
             _geo(tags["geo-location-latitude"], "N", "S"))
    if "geo-location-longitude" in tags:
        prop("exif:GPSLongitude",
             _geo(tags["geo-location-longitude"], "E", "W"))

    if not simple and not seqs:
        return b""

    body = "".join(simple)
    for name, kind, items in seqs:
        lis = "".join(f"<rdf:li>{_esc(i)}</rdf:li>" for i in items)
        body += f"<{name}><rdf:{kind}>{lis}</rdf:{kind}></{name}>"

    nsdecl = " ".join(f'xmlns:{k}="{v}"' for k, v in _NS.items())
    xml = (
        '<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>'
        '<x:xmpmeta xmlns:x="adobe:ns:meta/">'
        '<rdf:RDF xmlns:rdf='
        '"http://www.w3.org/1999/02/22-rdf-syntax-ns#">'
        f'<rdf:Description rdf:about="" {nsdecl}>'
        f"{body}"
        "</rdf:Description></rdf:RDF></x:xmpmeta>"
        '<?xpacket end="r"?>'
    )
    return xml.encode("utf-8")


_ORIENT_REV = {v: k for k, v in ORIENTATIONS.items()}
_PROP_RE = re.compile(r"<(dc:rights|dc:description|tiff:Make|tiff:Model"
                      r"|tiff:Orientation|xmp:CreatorTool|xmp:Rating"
                      r"|exif:DateTimeOriginal|exif:GPSLatitude"
                      r"|exif:GPSLongitude)>([^<]*)</\1>")
_SEQ_RE = re.compile(r"<(dc:creator|dc:subject)><rdf:(?:Seq|Bag)>(.*?)"
                     r"</rdf:(?:Seq|Bag)></\1>", re.S)
_LI_RE = re.compile(r"<rdf:li>([^<]*)</rdf:li>")


def _ungeo(s: str) -> float:
    ref = s[-1]
    deg, minutes = s[:-1].split(",")
    v = int(deg) + float(minutes) / 60
    return -v if ref in "SW" else v


def parse_xmp(blob: bytes) -> Dict:
    """Read back the tag subset build_xmp writes (gstxmptag.c read
    table)."""
    text = blob.decode("utf-8", "replace")
    out: Dict = {}
    rev = {
        "dc:rights": "copyright", "dc:description": "description",
        "tiff:Make": "device-manufacturer", "tiff:Model": "device-model",
        "xmp:CreatorTool": "application-name",
    }
    for name, val in _PROP_RE.findall(text):
        val = (val.replace("&lt;", "<").replace("&gt;", ">")
               .replace("&amp;", "&"))
        if name in rev:
            out[rev[name]] = val
        elif name == "tiff:Orientation":
            out["image-orientation"] = _ORIENT_REV[int(val)]
        elif name == "xmp:Rating":
            out["user-rating"] = int(val)
        elif name == "exif:DateTimeOriginal":
            out["datetime"] = (val[:10].replace("-", ":") + " "
                               + val[11:])
        elif name == "exif:GPSLatitude":
            out["geo-location-latitude"] = _ungeo(val)
        elif name == "exif:GPSLongitude":
            out["geo-location-longitude"] = _ungeo(val)
    for name, inner in _SEQ_RE.findall(text):
        items = _LI_RE.findall(inner)
        if name == "dc:creator":
            out["artist"] = items[0]
        else:
            out["keywords"] = items
    return out
