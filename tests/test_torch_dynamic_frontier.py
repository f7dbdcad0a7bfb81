"""Port parity for warm re-solves on the frontier route (the shared batch
frontier seeded from the taint cones' in-boundary and the decreased
edges' tails): ``DynamicSolver.update`` + ``resolve`` bitwise against
the reference ``DynamicSolver(backend="frontier")`` on 7 families,
update stats and ``edges_relaxed`` of the cold solves included, at the
default cap and at a cap of 2 (every round overflows into the dense
relax), and the pinned host reads of one update."""
import numpy as np
import pytest
import torch

import repro.sssp as R
import repro_torch.sssp as P
from repro_torch.convert import delta_from_arrays
from test_torch_dynamic import FAMILIES, _graphs, run_update_pair
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES)
def test_warm_update_bitwise_vs_reference(family):
    _, pd, _, _ = run_update_pair(family, "frontier")
    cold = P.Solver(pd.graph, backend="frontier", device="cpu")
    a, b = cold.solve_batch([0, 5, 17]), pd.resolve([0, 5, 17])
    assert torch.equal(a.dist, b.dist) and torch.equal(a.fixed, b.fixed)


def test_warm_update_with_overflowing_cap():
    rg, pg = _graphs("grid", n=150, seed=4)
    rd = R.DynamicSolver(rg, backend="frontier", frontier_cap=2)
    pd = P.DynamicSolver(pg, backend="frontier", frontier_cap=2,
                         device="cpu")
    ra, pb = rd.solve_batch([0, 9]), pd.solve_batch([0, 9])
    assert np.array_equal(ra.edges_relaxed, pb.edges_relaxed)
    delta = R.random_delta(rd.graph, 10, seed=2, lo=0.3, hi=3.0)
    rs = rd.update(delta)
    ps = pd.update(delta_from_arrays(delta, device="cpu"))
    ps.pop("host_syncs")
    assert rs == ps
    a, b = rd.resolve([0, 9]), pd.resolve([0, 9])
    assert np.array_equal(np.asarray(a.dist), b.dist.numpy())
    assert np.array_equal(np.asarray(a.C), b.C.numpy())
    assert np.array_equal(a.rounds, b.rounds) and a.fixed_by == b.fixed_by


def test_update_host_reads_pinned():
    """A frontier warm update reads the host once a taint sweep plus once
    to end the sweeps, three times a warm round plus once to end them,
    and once for all the stats."""
    _, _, stats, syncs = run_update_pair("gnp", "frontier", n=200)
    assert (stats["sweeps"], max(stats["warm_rounds"])) == (2, 3)
    assert syncs == (stats["sweeps"] + 1) + (3 * max(stats["warm_rounds"])
                                             + 1) + 1
