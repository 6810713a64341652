"""More table-fusion chains (tests/test_tablefuse.py's cases) through
gstbad_tpu and gstbad_tpu_torch on the CPU, and which kernel wrapper each
fused path reaches.  Bit exact (see tests/test_torch_parity.py for the
harness)."""

import numpy as np
import pytest
import torch

import gstbad_tpu_torch as gtt
from gstbad_tpu_torch.core.frame import FrameBatch
from gstbad_tpu_torch.core.spec import MediaSpec
from gstbad_tpu_torch.ops import chainfuse, lut
from test_torch_parity import (GRAPHS, HEAD, N_FRAMES, SIZES, assert_same,
                               ball_exempt, run_both, source)

torch.set_num_threads(1)   # parallel test workers share the cores


@pytest.fixture
def img(rng):
    return rng.integers(0, 256, (4, 24, 128, 4), dtype=np.uint8)


# more fusion chains on input frames (tests/test_tablefuse.py's cases):
# word maps without a head, a stencil without a tail, an RGB permute, a
# per-channel head, erode, and an achromatic chromahold target
CHAINS = [
    "exclusion ! chromahold ! fakesink",
    "coloreffects preset=sepia ! burn ! dilate ! exclusion ! fakesink",
    ("coloreffects preset=sepia ! solarize ! dilate erode=true "
     "! videoconvert format=AYUV ! zebrastripe ! fakesink"),
    ("coloreffects preset=sepia ! burn ! videoconvert format=RGBx "
     "! exclusion ! fakesink"),
    ("coloreffects preset=xpro ! solarize ! exclusion ! dilate "
     "! chromahold ! fakesink"),
    ("coloreffects preset=sepia ! burn ! chromahold target-r=90 "
     "target-g=90 target-b=90 ! videoconvert format=AYUV "
     "! zebrastripe ! fakesink"),
]

# two stencils in one headed chain: the first moves the idx plane, so the
# fused tail (whose kernel recomputes idx from the source words) must not
# run.  The chain needs a source to start its index head, and solarize
# to make the X byte a table of idx too (sepia alone leaves it SRC)
TWO_STENCILS = ("coloreffects preset=sepia ! solarize ! dilate "
                "! dilate erode=true ! videoconvert format=AYUV "
                "! zebrastripe ! fakesink")


@pytest.mark.parametrize("chain", CHAINS)
def test_fusion_chains_on_inputs(img, chain):
    """The port fused and unfused, each against the JAX package's fused
    run (which its own tests hold equal to its unfused run)."""
    jr, tr = run_both(chain, fuse=True, img=img)
    assert_same(jr, tr)
    p = gtt.parse_launch(chain, device="cpu")
    p.negotiate(MediaSpec(kind="video", format="BGRx", width=img.shape[2],
                          height=img.shape[1]))
    p.compile(img.shape[0], fuse_luts=False)
    unfused = p.run(inputs=FrameBatch.make(torch.from_numpy(img.copy())))
    assert_same(jr, (unfused, []))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_two_stencils_in_one_chain(pattern, size, fuse):
    w, h = size
    jr, tr = run_both(source(pattern, w, h) + TWO_STENCILS, fuse=fuse)
    exempt = ball_exempt(w, h, N_FRAMES) if pattern == "ball" else None
    assert_same(jr, tr, exempt)


def test_tee_fan_out_leaves():
    """A tee feeds two fused branches; each leaf equals the JAX package's
    (the branch point is not fused through, and run() returns a dict)."""
    import gstbad_tpu as gt
    desc = ("videotestsrc pattern=ball width=64 height=16 format=BGRx "
            "! tee name=t  t. ! burn ! fakesink  t. ! coloreffects "
            "preset=sepia ! dilate ! videoconvert format=AYUV "
            "! zebrastripe ! fakesink")
    jout = gt.parse_launch(desc).run(n_frames=4, window=2)
    tout = gtt.parse_launch(desc, device="cpu").run(n_frames=4, window=2)
    assert sorted(jout) == sorted(tout) == [0, 1]
    for leaf in jout:
        assert_same((jout[leaf], []), (tout[leaf], []))


def test_kernel_routing_on_cpu(monkeypatch):
    """On the CPU the wrappers take their plain versions, on the same
    routes as on the card: the headline's fused tail calls
    dilate_zebra_fused once per window, the prefix calls apply_word_table
    twice per window (rank plane and output), two stencils in one chain
    keep the fused tail off (two rank planes and the output), and no
    launch is counted."""
    calls = {"k1": 0, "k2": 0}
    plain_k1, plain_k2 = chainfuse.dilate_zebra_plain, lut.apply_word_table_plain

    def spy_k1(*a):
        calls["k1"] += 1
        return plain_k1(*a)

    def spy_k2(*a):
        calls["k2"] += 1
        return plain_k2(*a)

    monkeypatch.setattr(chainfuse, "dilate_zebra_plain", spy_k1)
    monkeypatch.setattr(lut, "apply_word_table_plain", spy_k2)
    before = (chainfuse.dilate_zebra_fused.launches,
              lut.apply_word_table.launches)
    for graph, want in ((GRAPHS["headline"], {"k1": 3, "k2": 0}),
                        (GRAPHS["prefix"], {"k1": 0, "k2": 6}),
                        (GRAPHS["config1_sepia"], {"k1": 0, "k2": 0}),
                        (TWO_STENCILS, {"k1": 0, "k2": 9})):
        calls.update(k1=0, k2=0)
        p = gtt.parse_launch(source("bars", 64, 8) + graph, device="cpu")
        p.run(n_frames=6, window=2)
        assert calls == want, graph
    assert (chainfuse.dilate_zebra_fused.launches,
            lut.apply_word_table.launches) == before == (0, 0)


def test_head_plane_is_not_built_for_a_fused_tail(monkeypatch):
    """The chain's index plane is lazy: the fused tail reads the source
    words itself, so the headline step never builds the [B, H, W] plane
    (its plain form indexes the one [1, H, W] broadcast frame)."""
    from gstbad_tpu_torch.core import tablefuse
    built = []
    orig = tablefuse.LinearIndex.__call__

    def spy(self, word):
        built.append(tuple(word.shape))
        return orig(self, word)

    monkeypatch.setattr(tablefuse.LinearIndex, "__call__", spy)
    p = gtt.parse_launch(source("bars", 64, 8) + GRAPHS["headline"],
                         device="cpu")
    p.run(n_frames=4, window=4)
    assert built == [(1, 8, 64)]
    built.clear()
    p = gtt.parse_launch(source("bars", 64, 8) + HEAD + " ! fakesink",
                         device="cpu")
    p.run(n_frames=4, window=4)
    assert built == [(4, 8, 64)]
