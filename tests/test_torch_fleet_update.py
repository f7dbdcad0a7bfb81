"""Port parity for fleet deltas (``stack_deltas``, ``FleetSolver.update``
and ``resolve``): per-member deltas with a different k each, stacked and
applied with the warm refresh of every member's tracked solve, bitwise
against the reference's ``FleetSolver`` (weights, the update stats,
dist/C/fixed/rounds/fixed_by; the reference's stacked delta carried
across by ``convert.stacked_delta_from_arrays``) and against cold
per-graph solves of the mutated members, on the segment route (the
frontier route's in test_torch_fleet_update_frontier*.py).  Also
stacked-delta validation, ``refresh=False``, and ``state_dict`` round
trips, a reference state loaded through ``convert.fleet_state_from_
arrays`` included."""
import pytest
import torch

from repro.core.sssp.dynamic import random_delta as rrandom_delta
from repro.core.sssp.fleet import FleetSolver as RFleetSolver
from repro.core.sssp.fleet import stack_deltas as rstack_deltas
import repro_torch.sssp as P
from repro_torch.convert import (delta_from_arrays, fleet_state_from_arrays,
                                 stacked_delta_from_arrays)
from test_torch_fleet import FAMILIES, _same, assert_result_equal, fleets
from test_torch_graph import _one_torch_thread  # noqa: F401


def member_deltas(rf):
    """Reference per-member deltas of 3 + 2i edges (a different k each,
    which exercises the stacked padding)."""
    return [rrandom_delta(rf.member(i), 3 + 2 * i, seed=40 + i)
            for i in range(rf.size)]


def run_after_deltas(family, backend, size=3):
    rf, pf = fleets(family, size=size)
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    sources = [1 % pf.n, pf.n - 1, 0][:size]
    assert_result_equal(rs.solve(sources), ps.solve(sources))
    deltas = member_deltas(rf)
    rd = rstack_deltas(deltas)
    pd = stacked_delta_from_arrays(rd, device="cpu")
    # the port's own stacking of the same member deltas is the same
    own = P.stack_deltas([delta_from_arrays(d, device="cpu")
                          for d in deltas])
    for name in ("edge_idx", "new_w", "ell_row", "ell_col", "csr_pos"):
        assert torch.equal(getattr(own, name), getattr(pd, name))
    assert own.ks == pd.ks == tuple(3 + 2 * i for i in range(size))
    assert (own.edge_idx[0, 3:] >= pf.e_pad).all()
    r_stats, p_stats = rs.update(rd), ps.update(pd)
    assert p_stats.pop("host_syncs") > 0
    assert r_stats == p_stats and p_stats["warm_refreshed"] == pf.size
    assert _same(rs.fleet.g.w, ps.fleet.g.w)
    assert _same(rs.fleet.g.out_weight, ps.fleet.g.out_weight)
    assert _same(rs.fleet.g.in_weight, ps.fleet.g.in_weight)
    res = ps.resolve()
    assert_result_equal(rs.resolve(), res)
    for i in range(pf.size):
        g_i = pf.member(i).apply_delta(pd.row(i))
        assert torch.equal(g_i.w, ps.fleet.member(i).w)
        ref = P.Solver(g_i, backend="segment", device="cpu").solve(sources[i])
        r = res.result(i)
        assert torch.equal(r.dist, ref.dist) and torch.equal(r.C, ref.C)
        assert torch.equal(r.fixed, ref.fixed) and r.rounds <= ref.rounds
    # cold solves after the update agree too
    assert_result_equal(rs.solve(sources), ps.solve(sources))


@pytest.mark.parametrize("family", FAMILIES)
def test_fleet_after_deltas_bitwise(family):
    run_after_deltas(family, "segment")


def test_stacked_delta_validation():
    rf, pf = fleets("chain", n=100)
    fs = P.FleetSolver(pf)
    fs.solve([0, 0, 0])
    lone = delta_from_arrays(rrandom_delta(rf.member(0), 4, seed=1),
                             device="cpu")
    with pytest.raises(ValueError, match="k_pad"):
        fs.update(lone)
    two = P.stack_deltas([lone, lone])
    with pytest.raises(ValueError, match="k_pad"):
        fs.update(two)
    with pytest.raises(ValueError, match="at least one"):
        P.stack_deltas([])
    front = P.FleetSolver(pf, backend="frontier")
    no_csr = P.stack_deltas([P.GraphDelta(
        k=d.k, edge_idx=d.edge_idx, new_w=d.new_w, ell_row=d.ell_row,
        ell_col=d.ell_col) for d in (lone, lone, lone)])
    assert no_csr.csr_pos is None
    with pytest.raises(ValueError, match="csr_pos"):
        front.update(no_csr)


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_update_without_refresh_goes_stale(backend):
    rf, pf = fleets("grid")
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    rs.solve([0, 1, 2])
    ps.solve([0, 1, 2])
    rd = rstack_deltas(member_deltas(rf))
    pd = stacked_delta_from_arrays(rd, device="cpu")
    r_stats, p_stats = rs.update(rd, refresh=False), ps.update(pd,
                                                               refresh=False)
    assert p_stats.pop("host_syncs") == 0 and r_stats == p_stats
    assert ps.version == 1
    assert_result_equal(rs.resolve(), ps.resolve())   # re-solved cold


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_state_dict_round_trip(backend):
    rf, pf = fleets("geometric")
    rs, ps = RFleetSolver(rf, backend=backend), P.FleetSolver(
        pf, backend=backend)
    with pytest.raises(ValueError):
        ps.state_dict()
    rs.solve([0, 4, 8])
    ps.solve([0, 4, 8])
    rd = rstack_deltas(member_deltas(rf))
    rs.update(rd)
    ps.update(stacked_delta_from_arrays(rd, device="cpu"))
    saved = {k: v.clone() for k, v in ps.state_dict().items()}
    ref_state = rs.state_dict()
    for k, v in saved.items():
        assert _same(ref_state[k], v), k
    # a further update, then back to the saved state: bitwise resume
    ps.update(P.stack_deltas([P.random_delta(m, 5, seed=9)
                              for m in ps.fleet.members()]))
    fresh = P.FleetSolver(pf, backend=backend)
    for solver, state in ((ps, saved),
                          (fresh, fleet_state_from_arrays(ref_state,
                                                          device="cpu"))):
        solver.load_state_dict(state)
        assert solver.version == 1
        assert_result_equal(rs.resolve(), solver.resolve())
        assert _same(rs.fleet.g.w, solver.fleet.g.w)
        # and the restored solver goes on as the reference does
        d2 = rstack_deltas([rrandom_delta(rs.fleet.member(i), 4, seed=70 + i)
                            for i in range(3)])
        assert solver.update(stacked_delta_from_arrays(
            d2, device="cpu"))["warm_refreshed"] == 3
    rs.update(d2)
    for solver in (ps, fresh):
        res = solver.resolve()
        assert_result_equal(rs.resolve(), res)
        for i in range(3):
            cold = P.Solver(solver.fleet.member(i), backend="segment",
                            device="cpu").solve(int(res.sources[i]))
            assert torch.equal(res.dist[i], cold.dist)
            assert torch.equal(res.fixed[i], cold.fixed)
