"""Port parity for targeted queries and landmark seeds
(``repro_torch.core.sssp.landmarks``, ``Solver(target=, C0=)``):
targeted and seeded ``solve``/``solve_batch`` on the segment route
bitwise against the reference (dist, C, fixed, rounds, fixed_by),
``seed_lower_bounds`` with its inf semantics, landmark selection, the
tables, ``seed_pair`` and ``estimate_pairs``, ``Graph.reverse`` and the
delta remap, ``LandmarkIndex.apply_delta`` (refreshed and lazy), partial
results (not tracked, exact paths) and ``early_exit=False``.  The
pallas and frontier routes are in test_torch_p2p_routes.py and
test_torch_p2p_frontier.py."""
import functools

import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp.reference import dijkstra
import repro_torch.sssp as P
from repro_torch.convert import (delta_from_arrays, graph_from_arrays,
                                 landmark_tables_from_arrays)
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
SOURCES = [0, 5, 17]
TARGETS = [140, 3, 99]


def _same(a, b):
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _graphs(family, n=160, seed=11):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


@functools.lru_cache(maxsize=None)
def _indexed(family):
    """Both packages' graphs and 4-landmark indexes (seed 3)."""
    rg, pg = _graphs(family)
    return (rg, pg, R.LandmarkIndex(rg, k=4, seed=3),
            P.LandmarkIndex(pg, k=4, seed=3))


def assert_batch_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(ra.rounds, pb.rounds)
    assert ra.fixed_by == pb.fixed_by
    assert ra.partial == pb.partial
    assert np.array_equal(ra.targets, pb.targets)
    assert (ra.edges_relaxed is None) == (pb.edges_relaxed is None)
    if ra.edges_relaxed is not None:
        assert np.array_equal(ra.edges_relaxed, pb.edges_relaxed)


def assert_single_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert (ra.rounds, ra.fixed_by, ra.edges_relaxed, ra.partial,
            ra.target) == (pb.rounds, pb.fixed_by, pb.edges_relaxed,
                           pb.partial, pb.target)


def run_targeted_pair(family, backend):
    """Targeted, then seeded targeted, batch and single solves through
    both packages, each against the other bitwise and against the full
    solve at the target."""
    rg, pg, ri, pi = _indexed(family)
    rs = R.Solver(rg, backend="ell" if backend == "pallas" else backend)
    ps = P.Solver(pg, backend=backend, device="cpu")
    full = ps.solve_batch(SOURCES)
    for rc0, pc0 in ((None, None), (ri.seed_batch(SOURCES),
                                    pi.seed_batch(SOURCES))):
        ra = rs.solve_batch(SOURCES, targets=TARGETS, C0=rc0)
        pb = ps.solve_batch(SOURCES, targets=TARGETS, C0=pc0)
        assert_batch_bitwise(ra, pb)
        assert pb.partial and pb[1].target == TARGETS[1] and pb[1].partial
        for i, t in enumerate(TARGETS):
            assert torch.equal(pb.dist[i, t], full.dist[i, t])
            assert bool(pb.fixed[i, t]) or torch.isinf(full.dist[i, t])
        assert (pb.rounds <= full.rounds).all()
        assert_single_bitwise(
            rs.solve(5, target=99, C0=None if rc0 is None else rc0[1]),
            ps.solve(5, target=99, C0=None if pc0 is None else pc0[1]))


@pytest.mark.parametrize("family", FAMILIES)
def test_targeted_and_seeded_bitwise_vs_reference(family):
    run_targeted_pair(family, "segment")


@pytest.mark.parametrize("family", FAMILIES)
def test_landmark_index_matches_reference(family):
    """Same landmarks, tables, seeds (single, batch, pair) and pair
    estimates; every seed a valid lower bound, exact at the landmarks."""
    rg, pg, ri, pi = _indexed(family)
    assert np.array_equal(ri.landmarks, pi.landmarks)
    assert _same(ri.d_from, pi.d_from) and _same(ri.d_to, pi.d_to)
    assert _same(ri.seed(5), pi.seed(5))
    assert _same(ri.seed_batch(SOURCES), pi.seed_batch(SOURCES))
    assert _same(ri.seed_pair(5, 9), pi.seed_pair(5, 9))
    pairs = list(zip(SOURCES, TARGETS))
    assert np.array_equal(ri.estimate_pairs(pairs), pi.estimate_pairs(pairs))
    hg = pg.to_host()
    for s in SOURCES:
        C0 = pi.seed(s).double().numpy()
        d = dijkstra(hg, source=s).dist
        fin = np.isfinite(d)
        assert (C0[fin] <= d[fin] + 1e-3).all()
        assert np.isinf(d[np.isinf(C0)]).all()
    # the port's seeds from the reference's tables, carried across
    tables = landmark_tables_from_arrays(ri.d_from, ri.d_to, device="cpu")
    assert _same(ri.seed_batch(SOURCES), P.seed_lower_bounds(*tables,
                                                             SOURCES))


def test_seed_lower_bounds_inf_semantics():
    """Two components: inf - inf carries no information and drops out
    (no NaN); inf - finite proves unreachability."""
    src, dst = np.array([0, 1, 3, 4]), np.array([1, 2, 4, 5])
    w = np.ones(4, np.float32)
    rg = rbuild(6, src, dst, w)
    ri = R.LandmarkIndex(rg, k=2, seed=0)
    pi = P.LandmarkIndex(graph_from_arrays(rg, device="cpu"), k=2, seed=0)
    assert np.array_equal(ri.landmarks, pi.landmarks)
    got = P.seed_lower_bounds(pi.d_from, pi.d_to, list(range(6)))
    assert not torch.isnan(got).any()
    for s in range(6):
        assert _same(ri.seed(s), got[s])
        assert _same(ri.seed(s), P.seed_lower_bounds(pi.d_from, pi.d_to, s))


def test_select_landmarks_same_vertices():
    rg, pg = _graphs("geometric", n=120, seed=3)
    rs = R.Solver(rg, backend="segment")
    ps = P.Solver(pg, backend="segment", device="cpu")
    for seed, first in ((0, None), (5, 17)):
        a = R.select_landmarks(rs, 6, seed=seed, first=first)
        b = P.select_landmarks(ps, 6, seed=seed, first=first)
        assert np.array_equal(a, b)


def test_reverse_graph_and_delta_remap():
    rg, pg, ri, pi = _indexed("gnp")
    rr, pr = rg.reverse(), pg.reverse()
    for f in ("src", "dst", "w", "in_weight", "out_weight"):
        assert _same(getattr(rr, f), getattr(pr, f)), f
    assert np.array_equal(ri._rev_perm, pi._rev_perm)
    rdelta = R.make_delta(rg, [4, 10, 33], [9.0, 8.0, 0.5])
    pdelta = P.make_delta(pg, [4, 10, 33], [9.0, 8.0, 0.5])
    a, b = ri.reverse_delta(rdelta), pi.reverse_delta(pdelta)
    for f in ("edge_idx", "new_w", "ell_row", "ell_col", "csr_pos"):
        assert _same(getattr(a, f), getattr(b, f)), f
    # the remapped delta moves the same (u, v, w) triple
    g2, r2 = pg.apply_delta(pdelta), pr.apply_delta(b)
    e = pg.e
    fwd = sorted(zip(g2.src[:e].tolist(), g2.dst[:e].tolist(),
                     g2.w[:e].tolist()))
    bwd = sorted(zip(r2.dst[:e].tolist(), r2.src[:e].tolist(),
                     r2.w[:e].tolist()))
    assert fwd == bwd


@pytest.mark.parametrize("shared", [False, True])
def test_index_apply_delta_refreshes_tables(shared):
    """Owned mode updates both solvers; shared mode rides the owner's
    update.  Either way the refreshed tables equal the reference's and a
    cold solve of the mutated graph and of its reverse."""
    rg, pg = _graphs("grid", n=150, seed=2)
    kw = {}
    rkw = {}
    if shared:
        kw["solver"] = P.DynamicSolver(pg, backend="segment", device="cpu")
        rkw["solver"] = R.DynamicSolver(rg, backend="segment")
    ri = R.LandmarkIndex(rg, k=3, seed=1, **rkw)
    pi = P.LandmarkIndex(pg, k=3, seed=1, **kw)
    rdelta = R.random_delta(rg, 12, seed=6, lo=0.3, hi=3.0)
    pdelta = delta_from_arrays(rdelta, device="cpu")
    if shared:
        rkw["solver"].update(rdelta)
        kw["solver"].update(pdelta)
    rstats, pstats = ri.apply_delta(rdelta), pi.apply_delta(pdelta)
    pstats.pop("host_syncs")
    assert rstats == pstats
    assert _same(ri.d_from, pi.d_from) and _same(ri.d_to, pi.d_to)
    lms = [int(v) for v in pi.landmarks]
    g2 = pi._fwd.graph
    assert torch.equal(pi.d_from, P.Solver(g2, backend="segment",
                                           device="cpu").solve_batch(
                                               lms).dist)
    assert torch.equal(pi.d_to, P.Solver(g2.reverse(), backend="segment",
                                         device="cpu").solve_batch(lms).dist)


def test_lazy_tables_keep_seeding_until_a_decrease():
    rg, pg = _graphs("gnp", n=120, seed=4)
    ri = R.LandmarkIndex(rg, k=3, seed=0)
    pi = P.LandmarkIndex(pg, k=3, seed=0)
    old = np.asarray(rg.w[: rg.e])
    inc = R.make_delta(rg, [0, 1, 2], old[[0, 1, 2]] * 2.0)
    ri.apply_delta(inc, refresh=False)
    pi.apply_delta(delta_from_arrays(inc, device="cpu"), refresh=False)
    assert pi.stale and pi.seed_ok and ri.seed_ok
    assert _same(ri.seed(5), pi.seed(5))
    # stale seeds of a grown metric are still lower bounds
    C0 = pi.seed(5).double().numpy()
    d = dijkstra(pi._fwd.graph.to_host(), source=5).dist
    fin = np.isfinite(d)
    assert (C0[fin] <= d[fin] + 1e-3).all()
    dec = P.make_delta(pi._fwd.graph, [7], [float(pi._fwd.graph.w[7]) / 2])
    pi.apply_delta(dec, refresh=False)
    assert not pi.seed_ok and pi.seed(5) is None
    assert pi.seed_batch([5]) is None and pi.seed_pair(5, 6) is None
    assert pi.estimate_pairs([(5, 6)]) is None
    pi.refresh()
    assert pi.seed_ok and not pi.stale


def test_reselect_policy_matches_reference():
    rg, pg, ri, pi = _indexed("chain")
    ri2 = R.LandmarkIndex(rg, k=3, seed=2)
    pi2 = P.LandmarkIndex(pg, k=3, seed=2)
    policy = P.ReselectPolicy(threshold=0.6, min_observations=4,
                              cooldown_deltas=0)
    rpolicy = R.ReselectPolicy(threshold=0.6, min_observations=4,
                               cooldown_deltas=0)
    for idx, pol in ((ri2, rpolicy), (pi2, policy)):
        idx.record_tightness([0.1, 0.2, np.inf, 0.3])
        assert idx.tightness_count == 3 and not idx.maybe_reselect(pol)
        idx.record_tightness([0.2])
        assert idx.needs_reselect(0.6)
    assert ri2.maybe_reselect(rpolicy) and pi2.maybe_reselect(policy)
    assert np.array_equal(ri2.landmarks, pi2.landmarks)
    assert _same(ri2.d_from, pi2.d_from) and _same(ri2.d_to, pi2.d_to)
    assert pi2.tightness() is None and pi2.reselects == 1


def test_partial_results_not_tracked_and_paths_exact():
    rg, pg, _, pi = _indexed("grid")
    dyn = P.DynamicSolver(pg, backend="segment", device="cpu")
    res = dyn.solve(3, target=111, C0=pi.seed(3))
    assert res.partial and 3 not in dyn._states
    dyn.solve_batch([3, 4], targets=[111, 5])
    assert 3 not in dyn._states and 4 not in dyn._states
    dyn.solve(3)
    assert 3 in dyn._states
    hg = pg.to_host()
    wmap = {(int(a), int(b)): float(c)
            for a, b, c in zip(hg.src, hg.dst, hg.w)}
    ref = dijkstra(hg, source=3).dist
    rs = R.Solver(rg, backend="segment")
    for t in (0, 40, 111, pg.n - 1):
        part = dyn.solve(3, target=t, C0=pi.seed(3))
        path = part.path_to(t)
        if np.isinf(ref[t]):
            assert path is None
            continue
        assert path[0] == 3 and path[-1] == t
        cost = sum(wmap[(a, b)] for a, b in zip(path, path[1:]))
        np.testing.assert_allclose(cost, ref[t], rtol=1e-5, atol=1e-3)
        assert path == rs.solve(3, target=t).path_to(t)


def test_early_exit_off_runs_to_fixpoint():
    rg, pg = _graphs("grid", n=200)
    cfg = P.SSSPConfig(early_exit=False)
    solver = P.Solver(pg, cfg, backend="segment", device="cpu")
    full, res = solver.solve(0), solver.solve(0, target=5)
    assert not res.partial and res.rounds == full.rounds
    assert torch.equal(res.dist, full.dist)
    a = R.Solver(rg, R.SSSPConfig(early_exit=False),
                 backend="segment").solve_batch([0, 3], targets=[5, 6])
    b = solver.solve_batch([0, 3], targets=[5, 6])
    assert_batch_bitwise(a, b)


def test_target_and_seed_checks():
    _, pg = _graphs("chain", n=60)
    solver = P.Solver(pg, backend="segment", device="cpu")
    with pytest.raises(ValueError, match="target vertices"):
        solver.solve(0, target=pg.n)
    with pytest.raises(ValueError, match="target vertices"):
        solver.solve_batch([0, 1], targets=[1, -1])
    with pytest.raises(ValueError, match="must match"):
        solver.solve_batch([0, 1], targets=[1])
    with pytest.raises(ValueError, match="C0 shape"):
        solver.solve_batch([0, 1], C0=np.zeros((3, pg.n), np.float32))
    with pytest.raises(ValueError, match="C0 shape"):
        solver.solve(0, C0=np.zeros(pg.n + 1, np.float32))
    # padding lanes repeat the last target, so 3 lanes run as long as
    # the slowest of them, not to the full fixpoint
    b = solver.solve_batch([0, 1, 2], targets=[3, 4, 5])
    assert int(b.rounds.max()) < solver.solve(0).rounds
