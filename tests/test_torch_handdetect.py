"""handdetect of the port against the JAX package on the CPU.  The JAX
element unrolls fist.xml and palm.xml node by node for every pyramid
scale, which takes minutes to compile, so the element runs here on the
first stage of each (fist's holds no tilted feature; palm's trees are
real trees); the full cascades, tilted features included, are held bit
exact at the op level (tests/test_torch_haar.py).  Frames, valid and the
hand-gesture messages are equal, and the walk finds gestures."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from helpers.torch_cv import assert_frames, assert_messages, push_both

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "gstbad_tpu_torch", "data", "")


def _first_stage(name, path):
    tree = ET.parse(DATA + name + ".xml")
    for clf in tree.getroot():
        stages = clf.find("stages")
        for s in list(stages)[1:]:
            stages.remove(s)
    tree.write(path)
    return str(path)


def test_handdetect_walk_messages_and_display(tmp_path):
    props = {"profile-fist": _first_stage("fist", tmp_path / "fist.xml"),
             "profile-palm": _first_stage("palm", tmp_path / "palm.xml")}
    # 34x36 frames: fewer pyramid scales to compile than at 40x44, and
    # the walk still posts a gesture a frame
    hand = np.random.default_rng(3).integers(0, 256, (4, 34, 36, 3)
                                             ).astype(np.uint8)
    (jr, jb), (tr, tb) = push_both("handdetect", "RGB", [hand[:2], hand[2:]],
                                   props)
    assert_frames(jr, tr)
    assert_messages(jb, tb)
    assert len(tb.messages) == 4
