"""BASELINE configs 1 (coloreffects sepia) and 2 (the gaudieffects point-op
chain) through gstbad_tpu and gstbad_tpu_torch.  Bit exact; see
tests/test_torch_parity.py for the harness and its one stated exception."""

import pytest

from test_torch_parity import SIZES, check_graph


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pattern", ["bars", "ball"])
@pytest.mark.parametrize("graph", ["config1_sepia", "config2_gaudi"])
def test_config_graph(graph, pattern, size, fuse):
    check_graph(graph, pattern, size, fuse)

