"""Port parity for fleet deltas on the frontier route: stacked
per-member deltas (``csr_pos`` carried) applied by ``FleetSolver.update``
with each member's warm shared-frontier re-solve, bitwise against the
reference's ``FleetSolver(backend="frontier")`` (weights, update stats,
resolved rows) and against cold per-graph solves of the mutated
members.  Two members a fleet, as in test_torch_fleet_frontier.py; the
first four families here, the other three in
test_torch_fleet_update_frontier2.py (the reference compiles a program a
family, which sets the file's time)."""
import pytest

from test_torch_fleet import FAMILIES
from test_torch_fleet_update import run_after_deltas
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES[:4])
def test_fleet_after_deltas_bitwise(family):
    run_after_deltas(family, "frontier", size=2)
