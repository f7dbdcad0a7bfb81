"""Port parity for the Solver facade on the segment route: bitwise
``dist``/``C``/``fixed``/``rounds``/``fixed_by`` against the reference
``Solver`` on 7 families x SP1-SP4, single and batched (non-pow-2)
solves, checked against Dijkstra too; routing, parents and the errors
the facade raises."""
import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
import repro_torch.sssp as P
from repro_torch.convert import graph_from_arrays
from repro_torch.core.sssp import reference as pref
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
R_CFG = {"sp1": R.SSSPConfig(rules=R.SP1_RULES),
         "sp2": R.SSSPConfig(rules=R.SP2_RULES),
         "sp3": R.SP3_CONFIG, "sp4": R.SP4_CONFIG}
P_CFG = {"sp1": P.SSSPConfig(rules=P.SP1_RULES),
         "sp2": P.SSSPConfig(rules=P.SP2_RULES),
         "sp3": P.SP3_CONFIG, "sp4": P.SP4_CONFIG}


def _graphs(family, n=300, seed=7):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def assert_batch_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(ra.rounds, pb.rounds)
    assert ra.fixed_by == pb.fixed_by
    assert (ra.edges_relaxed is None) == (pb.edges_relaxed is None)
    if ra.edges_relaxed is not None:
        assert np.array_equal(ra.edges_relaxed, pb.edges_relaxed)


def assert_single_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert (ra.rounds, ra.fixed_by, ra.edges_relaxed) == (
        pb.rounds, pb.fixed_by, pb.edges_relaxed)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg", list(R_CFG))
def test_segment_bitwise_vs_reference(family, cfg):
    rg, pg = _graphs(family)
    rs = R.Solver(rg, R_CFG[cfg], backend="segment")
    ps = P.Solver(pg, P_CFG[cfg], backend="segment", device="cpu")
    sources = [0, 5, 17]                       # pads to 4 lanes
    assert_batch_bitwise(rs.solve_batch(sources), ps.solve_batch(sources))
    assert_single_bitwise(rs.solve(5), ps.solve(5))


@pytest.mark.parametrize("family", FAMILIES)
def test_auto_solve_batch_matches_dijkstra(family):
    nn, src, dst, w = rgen.make(family, 250, seed=3)
    hg = P.HostGraph(nn, src, dst, w)
    solver = P.Solver(hg, device="cpu")
    sources = [0, 9, 41, 77, 130]              # non-pow-2 batch
    batch = solver.solve_batch(sources)
    assert len(batch) == 5 and batch.dist.shape == (5, nn)
    for i, s in enumerate(sources):
        want = pref.dijkstra(hg, source=s).dist
        got = batch.dist[i].double().numpy()
        np.testing.assert_allclose(np.where(np.isinf(got), 1e18, got),
                                   np.where(np.isinf(want), 1e18, want),
                                   rtol=1e-5, atol=1e-4)
        assert batch[i].source == s
        assert torch.equal(batch[i].dist, solver.solve(s).dist)


def test_auto_routing_matches_reference():
    for family in FAMILIES:
        rg, pg = _graphs(family, n=200, seed=1)
        assert (P.Solver(pg, device="cpu").backend
                == R.Solver(rg).backend), family
    rg, pg = _graphs("grid", n=200)
    assert P.Solver(pg, P.SSSPConfig(use_pallas=True),
                    device="cpu").backend == "pallas"
    assert P.Solver(pg, backend="frontier",
                    device="cpu").frontier_cap == R.Solver(
                        rg, backend="frontier").frontier_cap
    assert P.Solver(pg, backend="frontier", frontier_cap=5,
                    device="cpu").frontier_cap == 8


def test_parents_and_paths_match_reference():
    rg, pg = _graphs("gnp", n=150, seed=7)
    ra = R.Solver(rg, backend="segment").solve(3)
    pb = P.Solver(pg, backend="segment", device="cpu").solve(3)
    assert np.array_equal(ra.parents(), pb.parents())
    for t in (0, 10, 77, 149):
        assert ra.path_to(t) == pb.path_to(t)


def test_unported_options_raise():
    _, pg = _graphs("chain", n=60)
    solver = P.Solver(pg, device="cpu")
    # the distributed backend is ported: it solves, at a world of one here
    dist = P.Solver(pg, backend="distributed", device="cpu")
    assert dist.world == 1
    assert torch.equal(dist.solve(3).dist, solver.solve(3).dist)
    with pytest.raises(ValueError, match="out of range"):
        solver.solve(pg.n)
    with pytest.raises(ValueError, match="unknown backend"):
        P.Solver(pg, backend="bogus", device="cpu")


def test_dense_route_reads_host_once_per_round():
    _, pg = _graphs("gnp", n=200, seed=2)
    res = P.Solver(pg, backend="segment", device="cpu").solve(0)
    # one termination read a round, the final one, and the result read
    assert res.host_syncs == res.rounds + 2
    batch = P.Solver(pg, backend="segment", device="cpu").solve_batch([0, 1])
    assert batch.host_syncs == int(batch.rounds.max()) + 2
