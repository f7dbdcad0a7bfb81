"""Port parity for targeted and landmark-seeded solves on the frontier
route (the target test in the shared-frontier lane predicate):
``solve``/``solve_batch`` with ``targets``/``C0`` bitwise against the
reference's ``backend="frontier"`` on 7 families, ``edges_relaxed``
included, each lane's target distance equal to the full solve's."""
import pytest

from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_p2p import FAMILIES, run_targeted_pair


@pytest.mark.parametrize("family", FAMILIES)
def test_targeted_and_seeded_bitwise_vs_reference(family):
    run_targeted_pair(family, "frontier")
