"""(A copy of gstbad_tpu/io/haarcascade.py, numpy only.)

OpenCV Haar cascade XML parsing — both storage generations.

Old format (`opencv-haar-classifier`; the in-tree ext/opencv/fist.xml +
palm.xml models that gsthanddetect.cpp loads): a base window `size`,
then `stages`, each a list of `trees`; a tree is a list of nodes
carrying one haar `feature` (2-3 weighted rects, optional `tilted`), a
variance-normalized `threshold`, and either leaf values
(left_val/right_val) or child node indices (left_node/right_node —
palm.xml uses real trees, fist.xml is stumps only).

New format (`opencv-cascade-classifier`; the /usr/share/opencv4
haarcascades that gstfacedetect.cpp/gstfaceblur.cpp load by default):
height/width window, a flat `features` table of weighted rects, and
stages of weakClassifiers whose `internalNodes` are (left, right,
feature_idx, threshold) quadruples — a value <= 0 is a leaf index
-value into `leafValues`, > 0 an internal child index.  Both parse
into the same HaarCascade tree model."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class HaarNode:
    rects: List[Tuple[int, int, int, int, float]]   # x, y, w, h, weight
    tilted: bool
    threshold: float
    left_val: Optional[float]
    right_val: Optional[float]
    left_node: Optional[int]
    right_node: Optional[int]


@dataclass
class HaarTree:
    nodes: List[HaarNode]


@dataclass
class HaarStage:
    trees: List[HaarTree]
    threshold: float


@dataclass
class HaarCascade:
    window: Tuple[int, int]     # (w, h)
    stages: List[HaarStage]

    @property
    def n_features(self) -> int:
        return sum(len(t.nodes) for s in self.stages for t in s.trees)


def parse_cascade(path_or_xml) -> HaarCascade:
    if isinstance(path_or_xml, (bytes, str)) and "<" in str(path_or_xml):
        root = ET.fromstring(path_or_xml)
    else:
        root = ET.parse(path_or_xml).getroot()
    clf = None
    for child in root:
        if child.get("type_id") == "opencv-cascade-classifier":
            return _parse_new_format(child)
    for child in root:
        if child.get("type_id") == "opencv-haar-classifier":
            clf = child
            break
    if clf is None:
        raise ValueError("haar: no opencv-haar-classifier / "
                         "opencv-cascade-classifier entry")
    w, h = (int(v) for v in clf.findtext("size").split())
    stages = []
    for stage_el in clf.find("stages"):
        trees = []
        for tree_el in stage_el.find("trees"):
            nodes = []
            for node_el in tree_el:
                feat = node_el.find("feature")
                rects = []
                for rect_el in feat.find("rects"):
                    vals = rect_el.text.split()
                    rects.append((int(vals[0]), int(vals[1]), int(vals[2]),
                                  int(vals[3]), float(vals[4])))
                def _opt(tag):
                    t = node_el.findtext(tag)
                    return None if t is None else float(t)
                ln = node_el.findtext("left_node")
                rn = node_el.findtext("right_node")
                nodes.append(HaarNode(
                    rects=rects,
                    tilted=feat.findtext("tilted", "0").strip() == "1",
                    threshold=float(node_el.findtext("threshold")),
                    left_val=_opt("left_val"),
                    right_val=_opt("right_val"),
                    left_node=None if ln is None else int(ln),
                    right_node=None if rn is None else int(rn)))
            trees.append(HaarTree(nodes))
        stages.append(HaarStage(trees,
                                float(stage_el.findtext("stage_threshold"))))
    return HaarCascade((w, h), stages)


def _parse_new_format(clf) -> HaarCascade:
    """`opencv-cascade-classifier` -> the same HaarCascade tree model."""
    if (clf.findtext("featureType") or "HAAR").strip() != "HAAR":
        raise ValueError("haar: only HAAR featureType cascades supported")
    w = int(clf.findtext("width"))
    h = int(clf.findtext("height"))
    feats = []
    for feat_el in clf.find("features"):
        rects = []
        for rect_el in feat_el.find("rects"):
            vals = rect_el.text.split()
            rects.append((int(vals[0]), int(vals[1]), int(vals[2]),
                          int(vals[3]), float(vals[4])))
        tilted = (feat_el.findtext("tilted", "0").strip() == "1")
        feats.append((rects, tilted))
    stages = []
    for stage_el in clf.find("stages"):
        trees = []
        for weak_el in stage_el.find("weakClassifiers"):
            internal = weak_el.findtext("internalNodes").split()
            leaves = [float(v) for v in
                      weak_el.findtext("leafValues").split()]
            n_nodes = len(internal) // 4
            nodes = []
            for k in range(n_nodes):
                left = int(internal[4 * k])
                right = int(internal[4 * k + 1])
                fidx = int(internal[4 * k + 2])
                thr = float(internal[4 * k + 3])
                rects, tilted = feats[fidx]
                nodes.append(HaarNode(
                    rects=rects, tilted=tilted, threshold=thr,
                    left_val=leaves[-left] if left <= 0 else None,
                    right_val=leaves[-right] if right <= 0 else None,
                    left_node=left if left > 0 else None,
                    right_node=right if right > 0 else None))
            trees.append(HaarTree(nodes))
        stages.append(HaarStage(
            trees, float(stage_el.findtext("stageThreshold"))))
    return HaarCascade((w, h), stages)
