"""facedetect and faceblur of the port against the JAX package on the CPU,
over alt2 (the port's copy, gstbad_tpu_torch/data/) and the face fixture
pasted into a seeded background: frames, valid and the facedetect
messages are equal (the display ellipses included)."""

import os

import numpy as np
import torch

from helpers.torch_cv import assert_frames, assert_messages, push_both

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "gstbad_tpu_torch", "data", "")
ALT2 = DATA + "haarcascade_frontalface_alt2.xml"


def _frames():
    face = np.load(DATA + "face_fixture.npz")["frame"][..., None]
    rng = np.random.default_rng(3)
    frames = rng.integers(40, 200, (2, 168, 176, 3)).astype(np.uint8)
    frames[0, 2:163, 5:166] = face
    frames[1, 7:168, 12:173] = face
    return frames


def test_facedetect_messages_and_display():
    # a coarser pyramid than the default 1.25 keeps the JAX element's
    # compile short; the face is found at it in both frames
    (jr, jb), (tr, tb) = push_both("facedetect", "RGB", [_frames()],
                                   {"profile": ALT2, "min-neighbors": 1,
                                    "scale-factor": 1.5})
    assert_frames(jr, tr)
    assert_messages(jb, tb)
    assert [m.fields["n_faces"] for m in tb.messages] == [1, 1]


def test_faceblur_blurs_the_face():
    frames = _frames()
    (jr, _), (tr, _) = push_both("faceblur", "RGB", [frames],
                                 {"profile": ALT2, "min-neighbors": 1,
                                  "scale-factor": 2.0})
    assert_frames(jr, tr)
    assert (tr[0].data != frames).any()
