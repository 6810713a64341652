"""The headline graph without zebrastripe (its nine-element prefix) through
gstbad_tpu and gstbad_tpu_torch: with no fused tail the chain materializes
through the whole-word lookup (kernel K2's path).  Bit exact; see
tests/test_torch_parity.py for the harness and its one stated exception."""

import pytest

from test_torch_parity import (GRAPHS, SIZES, TINY, assert_same, check_graph,
                               run_both, source)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_prefix_graph(pattern, size, fuse):
    check_graph("prefix", pattern, size, fuse)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("pattern", ["bars", "ball"])
def test_prefix_graph_tiny_frames(pattern, fuse):
    check_graph("prefix", pattern, TINY, fuse)


def _controls(p):
    """Per-frame solarize and exclusion curves: the fused chain's tables
    get a [B, 256] leading dim, so the output takes the per-frame lookup
    instead of the one whole-word table."""
    for el in p.elements:
        if el.NAME == "solarize":
            el.set_control("threshold", lambda pts: 60 + (pts // 33333333) % 80)
        if el.NAME == "exclusion":
            el.set_control("factor", lambda pts: 100 + (pts // 33333333) % 60)


@pytest.mark.parametrize("fuse", [True, False])
def test_prefix_controllable_params(fuse):
    jr, tr = run_both(source("bars", 64, 16) + GRAPHS["prefix"], fuse=fuse,
                      controls=_controls)
    assert_same(jr, tr)
