"""Port parity on the frontier route under SP3 (label-setting: the
frontier is the set of newly fixed vertices): bitwise against the
reference ``Solver(backend="frontier")`` on 7 families, batched and
single solves, including ``edges_relaxed``."""
import pytest

from test_torch_frontier import FAMILIES, run_pair
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES)
def test_frontier_sp3_bitwise_vs_reference(family):
    run_pair(family, "sp3", single=True)
