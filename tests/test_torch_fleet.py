"""Port parity for graph fleets (``repro_torch.core.sssp.fleet``): cold
``FleetSolver.solve``/``solve_batch`` on the segment route bitwise
against the reference's ``FleetSolver`` (the reference fleet carried
across by ``convert.fleet_from_arrays``) and against per-graph port
``Solver`` solves; targeted and seeded member lanes; ``build_fleet``
pad normalisation and the member round trip; ``GraphFleet.stack`` shape
errors; and the segment fleet's host reads, which do not grow with F.
The frontier route is in test_torch_fleet_frontier.py; deltas,
``update`` and ``state_dict`` are in test_torch_fleet_update.py.
"""
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core.sssp.fleet import FleetSolver as RFleetSolver
from repro.core.sssp.fleet import build_fleet as rbuild_fleet
import repro_torch.sssp as P
from repro_torch.convert import fleet_from_arrays
from repro_torch.core import generators as pgen
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


def _same(a, b):
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def fleets(family, n=160, size=3):
    """Both packages' fleets of same-family graphs differing by seed (and
    so by true edge count)."""
    rf = rbuild_fleet([rgen.make(family, n, seed=s) for s in range(size)])
    return rf, fleet_from_arrays(rf, device="cpu")


def assert_result_equal(ra, pb):
    """Reference and port fleet results (single or batch) bitwise."""
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(np.asarray(ra.rounds), pb.rounds)
    assert ra.fixed_by == pb.fixed_by
    assert (ra.edges_relaxed is None) == (pb.edges_relaxed is None)
    if ra.edges_relaxed is not None:
        assert np.array_equal(np.asarray(ra.edges_relaxed, np.int64),
                              pb.edges_relaxed)


def assert_member_equal(r, ref):
    assert torch.equal(r.dist, ref.dist) and torch.equal(r.C, ref.C)
    assert torch.equal(r.fixed, ref.fixed)
    assert r.rounds == ref.rounds and r.fixed_by == ref.fixed_by


def run_cold(family, backend, size=3):
    rf, pf = fleets(family, size=size)
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    sources = [0, pf.n - 1, 3 % pf.n][:size]
    res = ps.solve(sources)
    assert_result_equal(rs.solve(sources), res)
    for i in range(pf.size):
        ref = P.Solver(pf.member(i), backend="segment",
                       device="cpu").solve(sources[i])
        assert_member_equal(res.result(i), ref)
        assert res[i].graph.e == pf.es[i]


def run_batch(family, backend, size=3):
    rf, pf = fleets(family, size=size)
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    n = pf.n
    sources = np.asarray([[0, 5, 9], [7, 0, n - 1], [1, 2, 3]])[:size]
    res = ps.solve_batch(sources)
    assert_result_equal(rs.solve_batch(sources), res)
    for f in range(pf.size):
        solver = P.Solver(pf.member(f), backend="segment", device="cpu")
        per_graph = solver.solve_batch(sources[f])
        for i in range(sources.shape[1]):
            assert_member_equal(res.result(f, i), per_graph[i])


def run_targeted(backend, size=3):
    rf, pf = fleets("grid", size=size)
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    n = pf.n
    src, tgt = [0, 5, 9][:size], [n - 1, n // 2, 3][:size]
    rng = np.random.default_rng(1)
    full = ps.solve(src)
    C0 = full.dist.numpy() * rng.uniform(0.0, 1.0, (size, n)).astype(
        np.float32)
    for kw in (dict(targets=tgt), dict(targets=tgt, C0=C0)):
        res = ps.solve(src, **kw)
        assert_result_equal(rs.solve(src, **kw), res)
        for i, t in enumerate(tgt):
            assert torch.equal(res.dist[i, t], full.dist[i, t])
    # partial results are not tracked: resolve serves the full solve
    assert torch.equal(ps.resolve().dist, full.dist)
    tb = np.asarray([[n - 1, 4], [2, n // 3], [1, 1]])[:size]
    sb = np.asarray([[0, 1], [2, 3], [4, 5]])[:size]
    assert_result_equal(rs.solve_batch(sb, targets=tb),
                        ps.solve_batch(sb, targets=tb))


@pytest.mark.parametrize("family", FAMILIES)
def test_fleet_cold_bitwise(family):
    run_cold(family, "segment")


@pytest.mark.parametrize("family", ["geometric", "grid", "power_law"])
def test_fleet_batch_bitwise(family):
    run_batch(family, "segment")


def test_fleet_targeted_and_seeded_bitwise():
    run_targeted("segment")


def test_build_fleet_normalizes_pads_and_members_roundtrip():
    members = [pgen.make("power_law", 150, seed=s) for s in range(3)]
    fleet = P.build_fleet(members, device="cpu")
    assert fleet.es == tuple(len(m[1]) for m in members)
    assert fleet.g.src.shape == (3, fleet.e_pad)
    for i, (n, src, dst, w) in enumerate(members):
        g = fleet.member(i)
        assert g.e == len(src)
        direct = P.build_graph(n, src, dst, w, edge_pad_multiple=fleet.e_pad,
                               device="cpu")
        for name in ("src", "dst", "w", "in_deg", "out_deg", "in_weight",
                     "out_weight"):
            assert torch.equal(getattr(g, name), getattr(direct, name))
        assert torch.equal(g.src_l, direct.src_l)
        # padding rows are inert: src = dst = n, w = +inf
        assert (g.src[g.e:] == n).all() and torch.isinf(g.w[g.e:]).all()
    rf = rbuild_fleet(members)
    assert _same(rf.g.w, fleet.g.w) and rf.es == fleet.es
    # host graphs and built graphs stack the same way
    again = P.build_fleet([P.HostGraph(*m) for m in members[:2]]
                          + [fleet.member(2)], device="cpu")
    assert torch.equal(again.g.w, fleet.g.w)
    with pytest.raises(TypeError):
        P.build_fleet([object()], device="cpu")
    with pytest.raises(ValueError, match="share n"):
        P.build_fleet([members[0], pgen.make("gnp", 90, seed=0)],
                      device="cpu")


def test_stack_requires_matching_shapes():
    a = P.build_graph(*pgen.make("gnp", 100, seed=0), device="cpu")
    b = P.build_graph(*pgen.make("gnp", 140, seed=0), device="cpu")
    with pytest.raises(ValueError, match="share"):
        P.GraphFleet.stack([a, b])
    with pytest.raises(ValueError, match="empty"):
        P.GraphFleet.stack([])
    with pytest.raises(TypeError):
        P.GraphFleet.stack([a, "b"])
    with pytest.raises(IndexError):
        P.GraphFleet.stack([a]).member(1)
    with pytest.raises(TypeError):
        P.FleetSolver("fleet")
    with pytest.raises(ValueError, match="backend"):
        P.FleetSolver([a], backend="pallas")
    fs = P.FleetSolver([a, a])
    with pytest.raises(ValueError):
        fs.solve([0])
    with pytest.raises(ValueError):
        fs.solve([0, 100])
    with pytest.raises(ValueError):
        fs.solve_batch([[0, 1]])
    with pytest.raises(ValueError):
        fs.resolve()


def test_fleet_auto_route_matches_reference():
    for family in ("grid", "gnp", "chain"):
        rf, pf = fleets(family, n=80)
        assert (P.FleetSolver(pf, backend="auto").backend
                == RFleetSolver(rf, backend="auto").backend)


def test_segment_fleet_host_reads_do_not_grow_with_f():
    """F copies of one graph, one source each: the same rounds, and a
    solve's host reads are its rounds + 2 (one a round, one after the
    last, one for the stats) at every F."""
    g = P.build_graph(*pgen.make("grid", 160, seed=1), device="cpu")
    reads = {}
    for F in (1, 2, 4):
        fs = P.FleetSolver([g] * F)
        res = fs.solve([5] * F)
        assert len(set(res.rounds.tolist())) == 1
        assert res.host_syncs == int(res.rounds[0]) + 2
        reads[F] = res.host_syncs
        batch = fs.solve_batch(np.full((F, 3), 5))
        assert batch.host_syncs == reads[F]
    assert len(set(reads.values())) == 1
