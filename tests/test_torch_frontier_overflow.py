"""Port parity on the frontier route with ``frontier_cap=2``: nearly
every round's union frontier overflows the buffer and takes the dense
segment relax, which must stay bitwise the reference's, including the
``edges_relaxed`` meter (``e_pad`` per overflow round).  Batched solves
only: the single-solve route is the same code at B = 1 and is covered in
test_torch_frontier.py."""
import pytest

from test_torch_frontier import CFG, FAMILIES, run_pair
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg", list(CFG))
def test_frontier_overflow_bitwise_vs_reference(family, cfg):
    run_pair(family, cfg, single=False, n=200, frontier_cap=2)
