"""Port parity for dynamic graphs (``repro_torch.core.sssp.dynamic``):
``make_delta``/``random_delta`` field for field against the reference's,
their validation, ``apply_delta`` on every layout against the reference
and a rebuild, and ``DynamicSolver.update`` + ``resolve`` on the segment
and pallas routes bitwise against the reference ``DynamicSolver`` (dist,
C, fixed, rounds, fixed_by and the update stats) and against a cold port
solve of the mutated graph.  The delta is the reference's, carried across
by ``convert.delta_from_arrays``.  The frontier route is in
test_torch_dynamic_frontier.py."""
import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_ell as rbuild_ell
from repro.core.graph import build_graph as rbuild
import repro_torch.sssp as P
from repro_torch.convert import (delta_from_arrays, ell_from_arrays,
                                 graph_from_arrays)
from repro_torch.core.sssp.dynamic import GraphDelta
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
DELTA_FIELDS = ("edge_idx", "new_w", "ell_row", "ell_col", "csr_pos")


def _graphs(family, n=120, seed=7):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def _same(a, b):
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = np.asarray(a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def assert_resolved_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(ra.rounds, pb.rounds)
    assert ra.fixed_by == pb.fixed_by


def run_update_pair(family, backend, lo=0.3, hi=3.0, n=120, k=9,
                    sources=(0, 5, 17)):
    """One warm update through both packages on the same graph and
    delta; returns the two solvers and the stats (host_syncs split off
    the port's, which the reference has no counterpart of)."""
    rg, pg = _graphs(family, n=n)
    rb = "ell" if backend == "pallas" else backend
    rd = R.DynamicSolver(rg, backend=rb)
    pd = P.DynamicSolver(pg, backend=backend, device="cpu")
    assert pd.backend == backend
    rd.solve_batch(list(sources))
    pd.solve_batch(list(sources))
    delta = R.random_delta(rd.graph, k, seed=3, lo=lo, hi=hi)
    rs = rd.update(delta)
    ps = pd.update(delta_from_arrays(delta, device="cpu"))
    syncs = ps.pop("host_syncs")
    assert rs == ps
    assert_resolved_bitwise(rd.resolve(list(sources)),
                            pd.resolve(list(sources)))
    return rd, pd, rs, syncs


@pytest.mark.parametrize("family", FAMILIES)
def test_make_delta_matches_reference(family):
    rg, pg = _graphs(family)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, rg.e, 13)            # duplicates: last one wins
    w = rng.uniform(0.1, 3.0, 13).astype(np.float32)
    for rd, pd in ((R.make_delta(rg, idx, w), P.make_delta(pg, idx, w)),
                   (R.random_delta(rg, 11, seed=4),
                    P.random_delta(pg, 11, seed=4))):
        assert (rd.k, rd.k_pad) == (pd.k, pd.k_pad)
        for f in DELTA_FIELDS:
            assert _same(getattr(rd, f), getattr(pd, f)), f
        carried = delta_from_arrays(rd, device="cpu")
        for f in DELTA_FIELDS:
            assert torch.equal(getattr(carried, f), getattr(pd, f)), f


def test_make_delta_validates_and_dedups():
    _, g = _graphs("gnp", n=80, seed=1)
    for bad_w in (0.0, -1.0, np.inf, np.nan):
        with pytest.raises(ValueError, match="positive"):
            P.make_delta(g, [0], [bad_w])
    for bad_i in (g.e, -1):
        with pytest.raises(ValueError, match="edge"):
            P.make_delta(g, [bad_i], [1.0])
    with pytest.raises(ValueError, match="empty"):
        P.make_delta(g, [], [])
    with pytest.raises(ValueError, match="match"):
        P.make_delta(g, [0, 1], [1.0])
    d = P.make_delta(g, [4, 4], [2.0, 3.0])
    assert d.k == 1 and d.k_pad == 8
    assert float(g.apply_delta(d).w[4]) == 3.0
    with pytest.raises(TypeError, match="GraphDelta"):
        P.DynamicSolver(g, device="cpu").update(None)


def test_handbuilt_nonpositive_delta_rejected():
    """A hand-built delta is validated when it is constructed, so it can
    reach no layout's apply_delta."""
    rg, g = _graphs("gnp", n=80, seed=1)

    def hand(w):
        return GraphDelta(k=1, edge_idx=torch.tensor([0], dtype=torch.int32),
                          new_w=torch.tensor([w]),
                          ell_row=torch.tensor([0], dtype=torch.int32),
                          ell_col=torch.tensor([0], dtype=torch.int32))
    for w in (-2.0, 0.0, float("inf")):
        with pytest.raises(ValueError, match="positive"):
            g.apply_delta(hand(w))
    assert float(g.apply_delta(hand(2.5)).w[0]) == 2.5
    bad = R.GraphDelta(k=1, edge_idx=np.array([0], np.int32),
                       new_w=np.array([-2.0], np.float32),
                       ell_row=np.array([0], np.int32),
                       ell_col=np.array([0], np.int32))
    with pytest.raises(ValueError, match="positive"):
        delta_from_arrays(bad, device="cpu")
    with pytest.raises(ValueError, match="csr_pos"):
        g.csr().apply_delta(hand(2.5))


def test_make_delta_from_endpoints_matches_reference():
    rg, pg = _graphs("grid", n=100, seed=2)
    u, v = int(pg.src[3]), int(pg.dst[3])
    rd = R.make_delta_from_endpoints(rg, [u], [v], [7.5])
    pd = P.make_delta_from_endpoints(pg, [u], [v], [7.5])
    for f in DELTA_FIELDS:
        assert _same(getattr(rd, f), getattr(pd, f)), f
    assert float(pg.apply_delta(pd).w[3]) == 7.5
    with pytest.raises(ValueError, match="not present"):
        P.make_delta_from_endpoints(pg, [u], [u], [1.0])


@pytest.mark.parametrize("family", FAMILIES)
def test_apply_delta_coherent_on_every_layout(family):
    """One delta leaves Graph, CsrGraph and EllGraph equal to the
    reference's mutated layouts and to a rebuild on the new weights;
    topology and the ELL table's row_len stay as they were."""
    rg, pg = _graphs(family)
    nn, e = rg.n, rg.e
    src, dst = np.asarray(rg.src[:e]), np.asarray(rg.dst[:e])
    rdelta = R.random_delta(rg, 17, seed=5)
    pdelta = delta_from_arrays(rdelta, device="cpu")
    rell = rbuild_ell(nn, src, dst, np.asarray(rg.w[:e]))
    pell = ell_from_arrays(rell, device="cpu")
    g2, c2, e2 = (pg.apply_delta(pdelta), pg.csr().apply_delta(pdelta),
                  pell.apply_delta(pdelta))
    rg2 = rg.apply_delta(rdelta)
    for f in ("w", "in_weight", "out_weight"):
        assert _same(getattr(rg2, f), getattr(g2, f)), f
    assert _same(rg.csr().apply_delta(rdelta).w, c2.w)
    assert _same(rell.apply_delta(rdelta).in_w, e2.in_w)
    rebuilt = P.build_graph(nn, src, dst, g2.w[:e].numpy(), device="cpu")
    for f in ("w", "in_weight", "out_weight"):
        assert torch.equal(getattr(rebuilt, f), getattr(g2, f)), f
    assert torch.equal(rebuilt.csr().w, c2.w)
    assert torch.equal(P.build_ell(nn, src, dst, g2.w[:e].numpy(),
                                   device="cpu").in_w, e2.in_w)
    assert g2.src is pg.src and g2.dst is pg.dst
    assert torch.equal(e2.row_len, pell.row_len)
    assert torch.equal(e2.in_src, pell.in_src)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_warm_update_bitwise_vs_reference(family, backend):
    _, pd, _, _ = run_update_pair(family, backend)
    cold = P.Solver(pd.graph, backend=backend, device="cpu").solve_batch(
        [0, 5, 17])
    assert torch.equal(pd.resolve([0, 5, 17]).dist, cold.dist)


@pytest.mark.parametrize("direction,lo,hi", [("increase", 1.5, 3.0),
                                             ("decrease", 0.2, 0.7)])
@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_pure_increase_and_decrease(direction, lo, hi, backend):
    rd, pd, stats, _ = run_update_pair("grid", backend, lo=lo, hi=hi, k=12)
    if direction == "increase":
        assert stats["decreased"] == 0 and stats["increased"] == 12
    else:
        assert stats["increased"] == 0 and max(stats["tainted"]) == 0
        assert stats["sweeps"] == 0


@pytest.mark.parametrize("family", ["chain", "grid"])
def test_warm_fewer_rounds_than_cold(family):
    _, pg = _graphs(family, n=400, seed=13)
    dyn = P.DynamicSolver(pg, backend="segment", device="cpu")
    dyn.solve(0)
    stats = dyn.update(P.random_delta(dyn.graph, max(1, pg.e // 100),
                                      seed=3))
    cold = P.Solver(dyn.graph, backend="segment", device="cpu").solve(0)
    assert max(stats["warm_rounds"]) < cold.rounds
    assert torch.equal(dyn.resolve([0]).dist[0], cold.dist)


def test_update_stats_and_refresh_routes():
    rg, pg = _graphs("gnp", seed=8)
    dyn = P.DynamicSolver(pg, backend="segment", device="cpu")
    dyn.solve_batch([0, 7])
    old_w = pg.w[: pg.e].numpy()
    stats = dyn.update(P.make_delta(dyn.graph, [1, 2, 3],
                                    [old_w[1] * 2, old_w[2] * 0.5,
                                     old_w[3]]))
    assert (stats["edges_changed"], stats["increased"],
            stats["decreased"]) == (3, 1, 1)
    assert (stats["warm_refreshed"], stats["cold_refreshed"]) == (2, 0)
    assert dyn.version == 1
    stats2 = dyn.update(P.random_delta(dyn.graph, 3, seed=1),
                        refresh=[0, 99])
    assert (stats2["warm_refreshed"], stats2["cold_refreshed"]) == (1, 1)
    # nothing tracked is current: the layouts still mutate
    stats3 = dyn.update(P.random_delta(dyn.graph, 3, seed=2), refresh=[])
    assert stats3["warm_refreshed"] == 0 and stats3["host_syncs"] == 1
    assert dyn.version == 3
    cold = P.Solver(dyn.graph, backend="segment", device="cpu")
    assert torch.equal(dyn.resolve([0, 7]).dist,
                       cold.solve_batch([0, 7]).dist)


def test_resolve_past_tracker_capacity():
    """resolve answers misses from its own batch and snapshots current
    rows before solving them, so a capacity below the request size only
    bounds what stays tracked."""
    _, pg = _graphs("gnp", seed=14)
    cold = P.Solver(pg, backend="segment", device="cpu").solve_batch(
        list(range(12)))
    dyn = P.DynamicSolver(pg, backend="segment", track_sources=4,
                          device="cpu")
    assert torch.equal(dyn.resolve(list(range(12))).dist, cold.dist)
    assert len(dyn._states) == 4
    dyn2 = P.DynamicSolver(pg, backend="segment", track_sources=4,
                           device="cpu")
    dyn2.solve(0)
    assert torch.equal(dyn2.resolve(list(range(9))).dist, cold.dist[:9])
    with pytest.raises(ValueError, match="at least one"):
        dyn2.resolve([])


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_update_host_reads_pinned(backend):
    """A dense warm update reads the host once a taint sweep plus once
    to end the sweeps, once a warm round plus once to end them, and once
    for all the stats (the k old weights' comparisons included)."""
    _, _, stats, syncs = run_update_pair("gnp", backend, n=200)
    assert (stats["sweeps"], max(stats["warm_rounds"])) == (2, 3)
    assert syncs == (stats["sweeps"] + 1) + (max(stats["warm_rounds"])
                                             + 1) + 1
