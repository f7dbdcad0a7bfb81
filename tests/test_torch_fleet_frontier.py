"""Port parity for graph fleets on the frontier route (each member's
shared-batch-frontier solve over its own CSR view): cold ``solve``,
``solve_batch`` and targeted/seeded member lanes bitwise against the
reference's ``FleetSolver(backend="frontier")``, ``edges_relaxed``
included, and against per-graph port solves.  Two members a fleet: the
reference unrolls its members into one program, so its compile time
grows with F."""
import pytest

from test_torch_fleet import (FAMILIES, run_batch, run_cold,
                              run_targeted)
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES)
def test_fleet_cold_bitwise(family):
    run_cold(family, "frontier", size=2)


@pytest.mark.parametrize("family", ["geometric", "grid", "power_law"])
def test_fleet_batch_bitwise(family):
    run_batch(family, "frontier", size=2)


def test_fleet_targeted_and_seeded_bitwise():
    run_targeted("frontier", size=2)
