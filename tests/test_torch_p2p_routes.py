"""Port parity for targeted and landmark-seeded solves on the pallas
route: ``solve``/``solve_batch`` with ``targets``/``C0`` bitwise against
the reference's ``backend="ell"`` on 7 families, each lane's target
distance equal to the full solve's; and the host reads of targeted
batches on the dense and frontier routes."""
import pytest

import repro_torch.sssp as P
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_p2p import (FAMILIES, SOURCES, TARGETS, _indexed,
                            run_targeted_pair)


@pytest.mark.parametrize("family", FAMILIES)
def test_targeted_and_seeded_bitwise_vs_reference(family):
    run_targeted_pair(family, "pallas")


def test_targeted_frontier_host_reads():
    """Three reads a frontier round (the target test rides the
    termination read), the final one and the result read."""
    _, pg, _, pi = _indexed("grid")
    solver = P.Solver(pg, backend="frontier", device="cpu")
    b = solver.solve_batch(SOURCES, targets=TARGETS,
                           C0=pi.seed_batch(SOURCES))
    assert b.host_syncs == 3 * int(b.rounds.max()) + 2
    d = P.Solver(pg, backend="segment", device="cpu").solve_batch(
        SOURCES, targets=TARGETS)
    assert d.host_syncs == int(d.rounds.max()) + 2
