"""DASH MPD model + parser (ext/dash/gstmpdparser + gstmpd*node.c).

The reference's MPD stack is a libxml2 node-class framework; this is
the same model over ElementTree, transcribing the xml-helper value
semantics exactly (gstxmlhelper.c):

  - xs:duration -> milliseconds with the reference's NON-calendar
    conversion: year = 365 days, month = 30 days
    (gst_xml_helper_get_prop_duration; the unit test's duration_to_ms
    mirrors it);
  - xs:dateTime with optional fractional seconds and +HH:MM offsets;
  - byte ranges "first-last?", ratios "x:y", framerates "n" or "n/d",
    conditional uints ("false"/"true"/number), whitespace-preserving
    strings.

Node classes cover MPD, ProgramInformation, BaseURL, Location,
Metrics(+Range+Reporting), UTCTiming, Period, AdaptationSet (with the
full RepresentationBase attribute set, ContentComponent, descriptors),
Representation, SubRepresentation, SegmentBase, SegmentList,
SegmentTemplate, SegmentTimeline(S), SegmentURL and URLType.

The client layer (gstmpdclient.c subset) lives in MpdClient:
period setup/selection with start/duration resolution, stream setup,
representation selection by bandwidth, audio language listing and the
segment-template URL builder ($RepresentationID$ / $Number[%0Nd]$ /
$Bandwidth$ / $Time$ / $$ escaping — gst_mpd_client_parse_identifier).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

FILE_TYPE_STATIC = 0
FILE_TYPE_DYNAMIC = 1

NSEC_MS = 1_000_000


class MpdError(ValueError):
    pass


# ---------------------------------------------------------------- values

def parse_duration(s: str) -> int:
    """xs:duration -> ms, year=365d month=30d, transcribing
    _mpd_helper_parse_duration's validation exactly (gstxmlhelper.c):
    strict Y>M>D / H>M>S ordering without repeats, digits-only values
    (fraction — '.' or ',' — only on seconds), ranges year<585,
    month<15, day<35, hour<25, minute<65 (seconds unbounded), leading/
    trailing whitespace tolerated, 'P' / 'PT' alone are valid zeros."""
    s = s.strip()
    pos = 0
    sign = 1
    if s[:1] == "-":
        sign = -1
        pos = 1
    if s[pos:pos + 1] != "P":
        raise MpdError(f"bad duration {s!r}")
    pos += 1
    in_time = False
    seen = -1
    vals = {"Y": 0, "Mo": 0, "D": 0, "H": 0, "Mi": 0}
    seconds = 0.0
    while pos < len(s):
        if s[pos] == "T":
            if in_time:
                raise MpdError(f"bad duration {s!r}")
            in_time = True
            seen = -1
            pos += 1
            continue
        start = pos
        while pos < len(s) and s[pos].isdigit():
            pos += 1
        frac = ""
        if pos < len(s) and s[pos] in ".,":
            fpos = pos + 1
            while fpos < len(s) and s[fpos].isdigit():
                fpos += 1
            frac = s[pos + 1:fpos]
            pos = fpos
        if pos == start or pos >= len(s) or not s[start].isdigit():
            raise MpdError(f"bad duration {s!r}")
        unit = s[pos]
        pos += 1
        units = ("H", "M", "S") if in_time else ("Y", "M", "D")
        if unit not in units:
            raise MpdError(f"bad duration {s!r}")
        idx = units.index(unit)
        if idx <= seen:
            raise MpdError(f"bad duration {s!r}")
        seen = idx
        value = int(s[start:pos - 1].split(".")[0].split(",")[0])
        if frac and not (in_time and unit == "S"):
            raise MpdError(f"bad duration {s!r}")
        if in_time:
            if unit == "H":
                if value >= 25:
                    raise MpdError(f"bad duration {s!r}")
                vals["H"] = value
            elif unit == "M":
                if value >= 65:
                    raise MpdError(f"bad duration {s!r}")
                vals["Mi"] = value
            else:
                seconds = float(f"{value}.{frac or 0}")
        else:
            if unit == "Y":
                if value >= 585:  # u64 ms overflow guard
                    raise MpdError(f"bad duration {s!r}")
                vals["Y"] = value
            elif unit == "M":
                if value >= 15:
                    raise MpdError(f"bad duration {s!r}")
                vals["Mo"] = value
            else:
                if value >= 35:
                    raise MpdError(f"bad duration {s!r}")
                vals["D"] = value
    days = vals["Y"] * 365 + vals["Mo"] * 30 + vals["D"]
    minutes = (days * 24 + vals["H"]) * 60 + vals["Mi"]
    ms = minutes * 60 * 1000 + int(round(seconds * 1000))
    return sign * ms


_DT_RE = re.compile(
    r"^(\d{4})-(\d{1,2})-(\d{1,2})T(\d{1,2}):(\d{1,2}):(\d{1,2})"
    r"(?:\.(\d+))?(Z|[+-]\d{1,2}:\d{2})?$")


@dataclass
class DateTime:
    year: int = 0
    month: int = 0
    day: int = 0
    hour: int = 0
    minute: int = 0
    second: int = 0
    microsecond: int = 0
    tzoffset_minutes: int = 0  # signed


def parse_datetime(s: str) -> DateTime:
    m = _DT_RE.match(s.strip())
    if not m:
        raise MpdError(f"bad dateTime {s!r}")
    y, mo, d, h, mi, sec, frac, tz = m.groups()
    us = 0
    if frac:
        us = int(round(float("0." + frac) * 1_000_000))
    tzmin = 0
    if tz and tz != "Z":
        sign = -1 if tz[0] == "-" else 1
        th, tm = tz[1:].split(":")
        tzmin = sign * (int(th) * 60 + int(tm))
    return DateTime(int(y), int(mo), int(d), int(h), int(mi),
                    int(sec), us, tzmin)


def parse_range(s: str) -> Tuple[int, int]:
    """"first-last" / "first-" -> (first, last|-1)."""
    first, _, last = s.partition("-")
    return int(first), (int(last) if last else -1)


def parse_ratio(s: str) -> Tuple[int, int]:
    a, _, b = s.partition(":")
    return int(a), int(b)


def parse_framerate(s: str) -> Tuple[int, int]:
    n, _, d = s.partition("/")
    return int(n), (int(d) if d else 1)


def parse_cond_uint(s: str) -> Tuple[bool, int]:
    """ConditionalUintType: 'false' -> (False, 0), 'true' -> (True, 0),
    number -> (True, n)."""
    if s == "false":
        return False, 0
    if s == "true":
        return True, 0
    return True, int(s)


def _bool(s: str) -> bool:
    return s in ("true", "1")


def _uint_list(s: str) -> List[int]:
    return [int(x) for x in s.replace(",", " ").split()]


def _str_list(s: str) -> List[str]:
    return [x for x in s.split(",")]


def _strip_ns(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


# ---------------------------------------------------------------- nodes

@dataclass
class Descriptor:
    schemeIdUri: Optional[str] = None
    value: Optional[str] = None
    id: Optional[str] = None
    # contentProtection keeps the raw element text when the value
    # attribute is absent (the mspr:pro style payloads)
    text: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "Descriptor":
        d = cls(schemeIdUri=el.get("schemeIdUri"),
                value=el.get("value"), id=el.get("id"))
        if d.value is None:
            inner = b"".join(
                ET.tostring(c, encoding="utf-8") for c in el)
            txt = (el.text or "") + inner.decode("utf-8", "replace")
            d.text = txt if txt.strip() else None
        return d


@dataclass
class BaseURL:
    baseURL: Optional[str] = None
    serviceLocation: Optional[str] = None
    byteRange: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "BaseURL":
        return cls(baseURL=el.text,
                   serviceLocation=el.get("serviceLocation"),
                   byteRange=el.get("byteRange"))


@dataclass
class UrlType:
    sourceURL: Optional[str] = None
    range: Optional[Tuple[int, int]] = None

    @classmethod
    def parse(cls, el) -> "UrlType":
        rng = el.get("range")
        return cls(sourceURL=el.get("sourceURL"),
                   range=parse_range(rng) if rng else None)


@dataclass
class SNode:
    t: int = -1
    d: int = 0
    r: int = 0

    @classmethod
    def parse(cls, el) -> "SNode":
        return cls(t=int(el.get("t", -1)), d=int(el.get("d", 0)),
                   r=int(el.get("r", 0)))


@dataclass
class SegmentTimeline:
    S: List[SNode] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "SegmentTimeline":
        return cls(S=[SNode.parse(c) for c in el
                      if _strip_ns(c.tag) == "S"])


@dataclass
class SegmentBase:
    timescale: int = 0
    presentationTimeOffset: int = 0
    indexRange: Optional[Tuple[int, int]] = None
    indexRangeExact: bool = False
    Initialization: Optional[UrlType] = None
    RepresentationIndex: Optional[UrlType] = None

    @classmethod
    def parse(cls, el) -> "SegmentBase":
        sb = cls(
            timescale=int(el.get("timescale", 0)),
            presentationTimeOffset=int(
                el.get("presentationTimeOffset", 0)),
            indexRangeExact=_bool(el.get("indexRangeExact", "false")))
        rng = el.get("indexRange")
        if rng:
            sb.indexRange = parse_range(rng)
        for c in el:
            tag = _strip_ns(c.tag)
            # the reference accepts both spellings
            # (gstmpdsegmentbasenode.c parses "Initialisation" too)
            if tag in ("Initialization", "Initialisation"):
                sb.Initialization = UrlType.parse(c)
            elif tag == "RepresentationIndex":
                sb.RepresentationIndex = UrlType.parse(c)
        return sb


@dataclass
class _MultSegBase:
    duration: int = 0
    startNumber: int = 1
    timescale: int = 1
    presentationTimeOffset: int = 0
    SegmentTimeline: Optional[SegmentTimeline] = None
    BitstreamSwitching: Optional[UrlType] = None
    Initialization: Optional[UrlType] = None

    def _parse_mult(self, el) -> None:
        self.duration = int(el.get("duration", 0))
        self.startNumber = int(el.get("startNumber", 1))
        self.timescale = int(el.get("timescale", 1))
        self.presentationTimeOffset = int(
            el.get("presentationTimeOffset", 0))
        for c in el:
            tag = _strip_ns(c.tag)
            if tag == "SegmentTimeline":
                self.SegmentTimeline = SegmentTimeline.parse(c)
            elif tag == "BitstreamSwitching":
                self.BitstreamSwitching = UrlType.parse(c)
            elif tag == "Initialization":
                self.Initialization = UrlType.parse(c)


@dataclass
class SegmentURL:
    media: Optional[str] = None
    mediaRange: Optional[Tuple[int, int]] = None
    index: Optional[str] = None
    indexRange: Optional[Tuple[int, int]] = None

    @classmethod
    def parse(cls, el) -> "SegmentURL":
        mr, ir = el.get("mediaRange"), el.get("indexRange")
        return cls(media=el.get("media"),
                   mediaRange=parse_range(mr) if mr else None,
                   index=el.get("index"),
                   indexRange=parse_range(ir) if ir else None)


@dataclass
class SegmentList(_MultSegBase):
    SegmentURL: List[SegmentURL] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "SegmentList":
        sl = cls()
        sl._parse_mult(el)
        sl.SegmentURL = [SegmentURL.parse(c) for c in el
                         if _strip_ns(c.tag) == "SegmentURL"]
        return sl


@dataclass
class SegmentTemplate(_MultSegBase):
    media: Optional[str] = None
    index: Optional[str] = None
    initialization: Optional[str] = None
    bitstreamSwitching: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "SegmentTemplate":
        st = cls()
        st._parse_mult(el)
        st.media = el.get("media")
        st.index = el.get("index")
        st.initialization = el.get("initialization")
        st.bitstreamSwitching = el.get("bitstreamSwitching")
        return st


@dataclass
class RepresentationBase:
    profiles: Optional[str] = None
    width: int = 0
    height: int = 0
    sar: Optional[Tuple[int, int]] = None
    frameRate: Optional[Tuple[int, int]] = None
    minFrameRate: Optional[Tuple[int, int]] = None
    maxFrameRate: Optional[Tuple[int, int]] = None
    audioSamplingRate: Optional[str] = None
    mimeType: Optional[str] = None
    segmentProfiles: Optional[str] = None
    codecs: Optional[str] = None
    maximumSAPPeriod: float = 0.0
    startWithSAP: int = 0
    maxPlayoutRate: float = 0.0
    codingDependency: bool = False
    scanType: Optional[str] = None
    FramePacking: List[Descriptor] = dc_field(default_factory=list)
    AudioChannelConfiguration: List[Descriptor] = \
        dc_field(default_factory=list)
    ContentProtection: List[Descriptor] = dc_field(default_factory=list)

    def _parse_base(self, el) -> None:
        g = el.get
        self.profiles = g("profiles")
        self.width = int(g("width", 0))
        self.height = int(g("height", 0))
        if g("sar"):
            self.sar = parse_ratio(g("sar"))
        if g("frameRate"):
            self.frameRate = parse_framerate(g("frameRate"))
        if g("minFrameRate"):
            self.minFrameRate = parse_framerate(g("minFrameRate"))
        if g("maxFrameRate"):
            self.maxFrameRate = parse_framerate(g("maxFrameRate"))
        self.audioSamplingRate = g("audioSamplingRate")
        self.mimeType = g("mimeType")
        self.segmentProfiles = g("segmentProfiles")
        self.codecs = g("codecs")
        self.maximumSAPPeriod = float(g("maximumSAPPeriod", 0))
        self.startWithSAP = int(g("startWithSAP", 0))
        self.maxPlayoutRate = float(g("maxPlayoutRate", 0))
        self.codingDependency = _bool(g("codingDependency", "false"))
        self.scanType = g("scanType")
        for c in el:
            tag = _strip_ns(c.tag)
            if tag == "FramePacking":
                self.FramePacking.append(Descriptor.parse(c))
            elif tag == "AudioChannelConfiguration":
                self.AudioChannelConfiguration.append(
                    Descriptor.parse(c))
            elif tag == "ContentProtection":
                self.ContentProtection.append(Descriptor.parse(c))


@dataclass
class SubRepresentation(RepresentationBase):
    level: int = 0
    dependencyLevel: List[int] = dc_field(default_factory=list)
    bandwidth: int = 0
    contentComponent: List[str] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "SubRepresentation":
        s = cls()
        s._parse_base(el)
        s.level = int(el.get("level", 0))
        if el.get("dependencyLevel"):
            s.dependencyLevel = _uint_list(el.get("dependencyLevel"))
        s.bandwidth = int(el.get("bandwidth", 0))
        if el.get("contentComponent"):
            s.contentComponent = _str_list(el.get("contentComponent"))
        return s


@dataclass
class Representation(RepresentationBase):
    id: Optional[str] = None
    bandwidth: int = 0
    qualityRanking: int = 0
    dependencyId: List[str] = dc_field(default_factory=list)
    mediaStreamStructureId: List[str] = dc_field(default_factory=list)
    BaseURLs: List[BaseURL] = dc_field(default_factory=list)
    SubRepresentations: List[SubRepresentation] = \
        dc_field(default_factory=list)
    SegmentBase: Optional[SegmentBase] = None
    SegmentList: Optional[SegmentList] = None
    SegmentTemplate: Optional[SegmentTemplate] = None

    @classmethod
    def parse(cls, el) -> "Representation":
        r = cls()
        r._parse_base(el)
        r.id = el.get("id")
        r.bandwidth = int(el.get("bandwidth", 0))
        r.qualityRanking = int(el.get("qualityRanking", 0))
        if el.get("dependencyId"):
            r.dependencyId = _str_list(el.get("dependencyId"))
        if el.get("mediaStreamStructureId"):
            r.mediaStreamStructureId = _str_list(
                el.get("mediaStreamStructureId"))
        for c in el:
            tag = _strip_ns(c.tag)
            if tag == "BaseURL":
                r.BaseURLs.append(BaseURL.parse(c))
            elif tag == "SubRepresentation":
                r.SubRepresentations.append(SubRepresentation.parse(c))
            elif tag == "SegmentBase":
                r.SegmentBase = SegmentBase.parse(c)
            elif tag == "SegmentList":
                r.SegmentList = SegmentList.parse(c)
            elif tag == "SegmentTemplate":
                r.SegmentTemplate = SegmentTemplate.parse(c)
        return r


@dataclass
class ContentComponent:
    id: int = 0
    lang: Optional[str] = None
    contentType: Optional[str] = None
    par: Optional[Tuple[int, int]] = None
    Accessibility: List[Descriptor] = dc_field(default_factory=list)
    Role: List[Descriptor] = dc_field(default_factory=list)
    Rating: List[Descriptor] = dc_field(default_factory=list)
    Viewpoint: List[Descriptor] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "ContentComponent":
        cc = cls(id=int(el.get("id", 0)), lang=el.get("lang"),
                 contentType=el.get("contentType"))
        if el.get("par"):
            cc.par = parse_ratio(el.get("par"))
        for c in el:
            tag = _strip_ns(c.tag)
            if tag in ("Accessibility", "Role", "Rating", "Viewpoint"):
                getattr(cc, tag).append(Descriptor.parse(c))
        return cc


@dataclass
class AdaptationSet(RepresentationBase):
    id: int = 0
    group: int = 0
    lang: Optional[str] = None
    contentType: Optional[str] = None
    par: Optional[Tuple[int, int]] = None
    minBandwidth: int = 0
    maxBandwidth: int = 0
    minWidth: int = 0
    maxWidth: int = 0
    minHeight: int = 0
    maxHeight: int = 0
    segmentAlignment: Tuple[bool, int] = (False, 0)
    subsegmentAlignment: Tuple[bool, int] = (False, 0)
    subsegmentStartsWithSAP: int = 0
    bitstreamSwitching: bool = False
    Accessibility: List[Descriptor] = dc_field(default_factory=list)
    Role: List[Descriptor] = dc_field(default_factory=list)
    Rating: List[Descriptor] = dc_field(default_factory=list)
    Viewpoint: List[Descriptor] = dc_field(default_factory=list)
    ContentComponents: List[ContentComponent] = \
        dc_field(default_factory=list)
    BaseURLs: List[BaseURL] = dc_field(default_factory=list)
    Representations: List[Representation] = \
        dc_field(default_factory=list)
    SegmentBase: Optional[SegmentBase] = None
    SegmentList: Optional[SegmentList] = None
    SegmentTemplate: Optional[SegmentTemplate] = None
    xlink_href: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "AdaptationSet":
        a = cls()
        a._parse_base(el)
        g = el.get
        a.id = int(g("id", 0))
        a.group = int(g("group", 0))
        a.lang = g("lang")
        a.contentType = g("contentType")
        if g("par"):
            a.par = parse_ratio(g("par"))
        a.minBandwidth = int(g("minBandwidth", 0))
        a.maxBandwidth = int(g("maxBandwidth", 0))
        a.minWidth = int(g("minWidth", 0))
        a.maxWidth = int(g("maxWidth", 0))
        a.minHeight = int(g("minHeight", 0))
        a.maxHeight = int(g("maxHeight", 0))
        if g("segmentAlignment"):
            a.segmentAlignment = parse_cond_uint(g("segmentAlignment"))
        if g("subsegmentAlignment"):
            a.subsegmentAlignment = parse_cond_uint(
                g("subsegmentAlignment"))
        a.subsegmentStartsWithSAP = int(g("subsegmentStartsWithSAP", 0))
        a.bitstreamSwitching = _bool(g("bitstreamSwitching", "false"))
        a.xlink_href = g("{http://www.w3.org/1999/xlink}href")
        for c in el:
            tag = _strip_ns(c.tag)
            if tag in ("Accessibility", "Role", "Rating", "Viewpoint"):
                getattr(a, tag).append(Descriptor.parse(c))
            elif tag == "ContentComponent":
                a.ContentComponents.append(ContentComponent.parse(c))
            elif tag == "BaseURL":
                a.BaseURLs.append(BaseURL.parse(c))
            elif tag == "Representation":
                a.Representations.append(Representation.parse(c))
            elif tag == "SegmentBase":
                a.SegmentBase = SegmentBase.parse(c)
            elif tag == "SegmentList":
                a.SegmentList = SegmentList.parse(c)
            elif tag == "SegmentTemplate":
                a.SegmentTemplate = SegmentTemplate.parse(c)
        return a


@dataclass
class Subset:
    contains: List[int] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "Subset":
        return cls(contains=_uint_list(el.get("contains", "")))


@dataclass
class Period:
    id: Optional[str] = None
    start: int = -1          # ms, -1 = unset
    duration: int = -1       # ms, -1 = unset
    bitstreamSwitching: bool = False
    BaseURLs: List[BaseURL] = dc_field(default_factory=list)
    AdaptationSets: List[AdaptationSet] = dc_field(default_factory=list)
    Subsets: List[Subset] = dc_field(default_factory=list)
    SegmentBase: Optional[SegmentBase] = None
    SegmentList: Optional[SegmentList] = None
    SegmentTemplate: Optional[SegmentTemplate] = None
    xlink_href: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "Period":
        p = cls(id=el.get("id"))
        if el.get("start"):
            p.start = parse_duration(el.get("start"))
        if el.get("duration"):
            p.duration = parse_duration(el.get("duration"))
        p.bitstreamSwitching = _bool(
            el.get("bitstreamSwitching", "false"))
        p.xlink_href = el.get("{http://www.w3.org/1999/xlink}href")
        for c in el:
            tag = _strip_ns(c.tag)
            if tag == "BaseURL":
                p.BaseURLs.append(BaseURL.parse(c))
            elif tag == "AdaptationSet":
                p.AdaptationSets.append(AdaptationSet.parse(c))
            elif tag == "Subset":
                p.Subsets.append(Subset.parse(c))
            elif tag == "SegmentBase":
                p.SegmentBase = SegmentBase.parse(c)
            elif tag == "SegmentList":
                p.SegmentList = SegmentList.parse(c)
            elif tag == "SegmentTemplate":
                p.SegmentTemplate = SegmentTemplate.parse(c)
        return p


@dataclass
class ProgramInformation:
    lang: Optional[str] = None
    moreInformationURL: Optional[str] = None
    Title: Optional[str] = None
    Source: Optional[str] = None
    Copyright: Optional[str] = None

    @classmethod
    def parse(cls, el) -> "ProgramInformation":
        pi = cls(lang=el.get("lang"),
                 moreInformationURL=el.get("moreInformationURL"))
        for c in el:
            tag = _strip_ns(c.tag)
            if tag in ("Title", "Source", "Copyright"):
                setattr(pi, tag, c.text)
        return pi


@dataclass
class MetricsRange:
    starttime: int = 0  # ms
    duration: int = 0   # ms

    @classmethod
    def parse(cls, el) -> "MetricsRange":
        r = cls()
        if el.get("starttime"):
            r.starttime = parse_duration(el.get("starttime"))
        if el.get("duration"):
            r.duration = parse_duration(el.get("duration"))
        return r


@dataclass
class Reporting(Descriptor):
    pass


@dataclass
class Metrics:
    metrics: Optional[str] = None
    Range: List[MetricsRange] = dc_field(default_factory=list)
    Reporting: List[Descriptor] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> "Metrics":
        m = cls(metrics=el.get("metrics"))
        for c in el:
            tag = _strip_ns(c.tag)
            if tag == "Range":
                m.Range.append(MetricsRange.parse(c))
            elif tag == "Reporting":
                m.Reporting.append(Descriptor.parse(c))
        return m


UTC_TIMING_METHODS = {
    "urn:mpeg:dash:utc:ntp:2014": "ntp",
    "urn:mpeg:dash:utc:sntp:2014": "sntp",
    "urn:mpeg:dash:utc:http-head:2014": "http-head",
    "urn:mpeg:dash:utc:http-xsdate:2014": "http-xsdate",
    "urn:mpeg:dash:utc:http-iso:2014": "http-iso",
    "urn:mpeg:dash:utc:http-ntp:2014": "http-ntp",
    "urn:mpeg:dash:utc:direct:2014": "direct",
}


@dataclass
class UTCTiming:
    method: Optional[str] = None
    values: List[str] = dc_field(default_factory=list)

    @classmethod
    def parse(cls, el) -> Optional["UTCTiming"]:
        scheme = el.get("schemeIdUri")
        method = UTC_TIMING_METHODS.get(scheme or "")
        if method is None:
            return None  # invalid scheme: node dropped (mpdparser)
        value = el.get("value") or ""
        return cls(method=method,
                   values=[v for v in value.split() if v])


@dataclass
class MpdRoot:
    default_namespace: Optional[str] = None
    namespace_xsi: Optional[str] = None
    namespace_ext: Optional[str] = None
    schemaLocation: Optional[str] = None
    id: Optional[str] = None
    profiles: Optional[str] = None
    type: int = FILE_TYPE_STATIC
    availabilityStartTime: Optional[DateTime] = None
    availabilityEndTime: Optional[DateTime] = None
    mediaPresentationDuration: int = -1
    minimumUpdatePeriod: int = -1
    minBufferTime: int = -1
    timeShiftBufferDepth: int = -1
    suggestedPresentationDelay: int = -1
    maxSegmentDuration: int = -1
    maxSubsegmentDuration: int = -1
    BaseURLs: List[BaseURL] = dc_field(default_factory=list)
    Locations: List[str] = dc_field(default_factory=list)
    ProgramInfos: List[ProgramInformation] = \
        dc_field(default_factory=list)
    Periods: List[Period] = dc_field(default_factory=list)
    Metrics: List[Metrics] = dc_field(default_factory=list)
    UTCTimings: List[UTCTiming] = dc_field(default_factory=list)


def parse_mpd(xml_text: str) -> MpdRoot:
    """gst_mpd_client_parse's XML walk."""
    try:
        root = ET.fromstring(xml_text)
    except ET.ParseError as e:
        raise MpdError(str(e))
    if _strip_ns(root.tag) != "MPD":
        raise MpdError("root element is not MPD")
    mpd = MpdRoot()
    if root.tag.startswith("{"):
        mpd.default_namespace = root.tag[1:].split("}", 1)[0]
    # xmlns:* declarations aren't exposed by ElementTree; re-scan
    m = re.search(r'xmlns:xsi="([^"]*)"', xml_text)
    if m:
        mpd.namespace_xsi = m.group(1)
    m = re.search(r'xmlns:ext="([^"]*)"', xml_text)
    if m:
        mpd.namespace_ext = m.group(1)
    g = root.get
    mpd.schemaLocation = g("schemaLocation") \
        or g("{http://www.w3.org/2001/XMLSchema-instance}"
             "schemaLocation")
    mpd.id = g("id")
    mpd.profiles = g("profiles")
    mpd.type = FILE_TYPE_DYNAMIC if g("type") == "dynamic" \
        else FILE_TYPE_STATIC
    if g("availabilityStartTime"):
        mpd.availabilityStartTime = parse_datetime(
            g("availabilityStartTime"))
    if g("availabilityEndTime"):
        mpd.availabilityEndTime = parse_datetime(
            g("availabilityEndTime"))
    for attr in ("mediaPresentationDuration", "minimumUpdatePeriod",
                 "minBufferTime", "timeShiftBufferDepth",
                 "suggestedPresentationDelay", "maxSegmentDuration",
                 "maxSubsegmentDuration"):
        if g(attr):
            setattr(mpd, attr, parse_duration(g(attr)))
    for c in root:
        tag = _strip_ns(c.tag)
        if tag == "BaseURL":
            mpd.BaseURLs.append(BaseURL.parse(c))
        elif tag == "Location":
            mpd.Locations.append(c.text)
        elif tag == "ProgramInformation":
            mpd.ProgramInfos.append(ProgramInformation.parse(c))
        elif tag == "Period":
            mpd.Periods.append(Period.parse(c))
        elif tag == "Metrics":
            mpd.Metrics.append(Metrics.parse(c))
        elif tag == "UTCTiming":
            ut = UTCTiming.parse(c)
            if ut is not None:
                mpd.UTCTimings.append(ut)
    return mpd


# ---------------------------------------------------------------- client

_IDENT_RE = re.compile(r"^(Number|Bandwidth|Time)(%0\d*d[^%]*)?$")
_FMT_RE = re.compile(r"^%0(\d*)d([^%]*)$")


def build_url_from_template(template: str, rep_id: Optional[str],
                            number: int, bandwidth: int,
                            time: int) -> Optional[str]:
    """gst_mpdparser_build_URL_from_template with its full validation
    semantics (the upstream template_parsing table): $$ escape,
    $RepresentationID$ (no format allowed), $Number$/$Bandwidth$/$Time$
    with an optional zero-padded %0Nd format (+suffix text), None for
    any malformed template (unterminated $, unknown identifier, %d
    without 0-padding, %u/%x, second %)."""
    if not template:
        return None
    tokens = template.split("$")
    if len(tokens) % 2 == 0:  # odd number of '$'
        return None
    out = []
    for i, tok in enumerate(tokens):
        if i % 2 == 0:
            out.append(tok)
            continue
        if tok == "":
            out.append("$")
            continue
        if tok == "RepresentationID":
            out.append(rep_id or "")
            continue
        m = _IDENT_RE.match(tok)
        if not m:
            return None
        name, fmt = m.groups()
        val = {"Number": number, "Bandwidth": bandwidth,
               "Time": time}[name]
        if fmt:
            f = _FMT_RE.match(fmt)
            if not f:
                return None
            width = int(f.group(1) or 0)
            out.append(f"{val:0{width}d}" + f.group(2))
        else:
            out.append(str(val))
    return "".join(out)


@dataclass
class ActivePeriod:
    period: Period
    number: int
    start_ms: int
    duration_ms: int


class MpdClient:
    """gstmpdclient.c subset: period resolution/selection, stream
    representation picking, audio languages."""

    def __init__(self, xml_text: str):
        self.mpd = parse_mpd(xml_text)
        self.periods: List[ActivePeriod] = []
        self.period_idx = 0

    def setup_media_presentation(self) -> bool:
        """Resolve period start/duration
        (gst_mpd_client_setup_media_presentation): an explicit or
        derived NEGATIVE duration fails the whole setup (the
        negative_period_duration test)."""
        self.periods = []
        start = 0
        for i, p in enumerate(self.mpd.Periods):
            pstart = p.start if p.start >= 0 else start
            if p.duration != -1:
                dur = p.duration
            elif i + 1 < len(self.mpd.Periods) \
                    and self.mpd.Periods[i + 1].start >= 0:
                dur = self.mpd.Periods[i + 1].start - pstart
            elif self.mpd.mediaPresentationDuration >= 0:
                dur = self.mpd.mediaPresentationDuration - pstart
            elif self.mpd.type == FILE_TYPE_DYNAMIC:
                dur = -1  # open-ended live period
            else:
                return False
            if dur != -1 and dur < 0:
                return False
            self.periods.append(ActivePeriod(p, i, pstart, dur))
            if dur >= 0:
                start = pstart + dur
        return bool(self.periods)

    def get_period_at_time(self, time_ms: int) -> int:
        """-> period index, or -1 (the reference's G_MAXUINT) past the
        end; times before availabilityStartTime clamp into period 0
        (gst_mpd_client_get_period_index_at_time)."""
        if time_ms < 0:
            time_ms = 0
        for ap in self.periods:
            end = ap.start_ms + ap.duration_ms \
                if ap.duration_ms >= 0 else None
            if time_ms >= ap.start_ms and (end is None
                                           or time_ms < end):
                return ap.number
        return -1

    def has_next_period(self) -> bool:
        return self.period_idx + 1 < len(self.periods)

    def has_previous_period(self) -> bool:
        return self.period_idx > 0

    def set_period_index(self, idx: int) -> bool:
        for n, ap in enumerate(self.periods):
            if ap.number == idx:
                self.period_idx = n
                return True
        return False

    def current_period(self) -> Optional[ActivePeriod]:
        return self.periods[self.period_idx] if self.periods else None

    def get_audio_languages(self) -> List[str]:
        """gst_mpd_client_get_list_and_nb_of_audio_language."""
        ap = self.current_period()
        if ap is None:
            return []
        out = []
        for aset in ap.period.AdaptationSets:
            is_audio = (aset.contentType == "audio"
                        or (aset.mimeType or "").startswith("audio"))
            if not is_audio:
                for cc in aset.ContentComponents:
                    if cc.contentType == "audio":
                        is_audio = True
            if is_audio and aset.lang:
                out.append(aset.lang)
        return out

    @staticmethod
    def representation_index_with_min_bandwidth(
            reps: List[Representation]) -> int:
        """gst_mpd_client_get_rep_idx_with_min_bandwidth."""
        if not reps:
            return -1
        return min(range(len(reps)), key=lambda i: reps[i].bandwidth)

    @staticmethod
    def representation_index_with_max_bandwidth(
            reps: List[Representation], max_bw: int) -> int:
        """gst_mpd_client_get_rep_idx_with_max_bandwidth: max_bw 0 =
        lowest bandwidth; otherwise the best fit, -1 when NOTHING
        fits under the cap (the upstream representation_selection
        expectations)."""
        if not reps:
            return -1
        if max_bw <= 0:
            return MpdClient.representation_index_with_min_bandwidth(
                reps)
        best = -1
        best_bw = -1
        for i, r in enumerate(reps):
            if best_bw < r.bandwidth <= max_bw:
                best, best_bw = i, r.bandwidth
        return best
