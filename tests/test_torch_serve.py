"""Port parity for the SSSP query service
(``repro_torch.runtime.sssp_service``): the reference's service and the
port's on the same graphs and queries, on the segment, pallas (the
reference's "ell", bitwise the same route) and frontier routes.  Every
answer is compared as f32 bits, every path and ``dist`` vector for
equality, and after every wave and delta every stat but the timers, the
LRU order of both caches, each entry's version, partial stamp and rows,
and the pair cache's distances, paths and lanes.

This file mirrors the service tests of ``test_solver.py`` (answers and
caching, full-vector queries, mid-wave eviction, stats accounting),
``test_frontier.py`` (the frontier service and its tightness telemetry)
and ``test_fleet.py`` (the full_vector route, the warm pair refresh),
and holds the port-only rules: out-of-range vertices raise, and the
service runs on the card unless ``device="cpu"`` is given.  Its helpers
serve the other ``test_torch_serve_*.py`` files."""
import numpy as np
import pytest
import torch

import repro.sssp as R
import repro_torch.sssp as P
from conftest import assert_dist_equal
from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp.landmarks import ReselectPolicy as RPolicy
from repro.core.sssp.reference import dijkstra
from repro.runtime.planner import WavePlanner as RPlanner
from repro.runtime.sssp_service import Query as RQuery
from repro.runtime.sssp_service import SSSPService as RService
from repro_torch.convert import delta_from_arrays, graph_from_arrays
from repro_torch.core.sssp.landmarks import ReselectPolicy as PPolicy
from repro_torch.runtime.planner import WavePlanner as PPlanner
from repro_torch.runtime.sssp_service import Query as PQuery
from repro_torch.runtime.sssp_service import SSSPService as PService
from test_torch_graph import _one_torch_thread  # noqa: F401

BACKENDS = ["segment", "pallas", "frontier"]
TIMERS = ("solve_seconds", "delta_seconds")


def _bits(x):
    return np.float32(x).tobytes()


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b) -> bool:
    a, b = _arr(a), _arr(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def assert_answers_equal(rq, pq):
    """Two waves answered alike: distances as f32 bits, paths, vectors."""
    assert len(rq) == len(pq)
    for a, b in zip(rq, pq):
        assert (a.source, a.target, a.done) == (b.source, b.target, b.done)
        assert (a.distance is None) == (b.distance is None), (a, b)
        if a.distance is not None:
            assert isinstance(b.distance, float)
            assert _bits(a.distance) == _bits(b.distance), (a, b)
        assert a.path == b.path, (a.source, a.target)
        assert (a.dist is None) == (b.dist is None)
        if a.dist is not None:
            assert isinstance(b.dist, np.ndarray) and _same(a.dist, b.dist)


def assert_service_state_equal(r, p):
    """Stats but the timers, both caches in LRU order with every entry's
    version, stamp and rows, and the planners' state."""
    rs = {k: v for k, v in r.stats.items() if k not in TIMERS}
    ps = {k: v for k, v in p.stats.items() if k not in TIMERS}
    assert rs == ps
    assert r.version == p.version
    assert list(r._cache) == list(p._cache)
    for s, (rv, rres, rpart) in r._cache.items():
        pv, pres, ppart = p._cache[s]
        assert (rv, rpart) == (pv, ppart)
        assert _same(rres.dist, pres.dist) and _same(rres.fixed, pres.fixed)
        assert (rres.rounds, rres.source, rres.partial) == (
            pres.rounds, pres.source, pres.partial)
    assert list(r._pairs) == list(p._pairs)
    for key, (rv, rd, rpath, rl) in r._pairs.items():
        pv, pd, ppath, pl = p._pairs[key]
        assert (rv, rpath) == (pv, ppath) and _bits(rd) == _bits(pd)
        assert (rl is None) == (pl is None)
        if rl is not None:
            assert _same(rl[0], pl[0]) and _same(rl[1], pl[1])
    if r.planner is not None:
        assert r.planner.waves_planned == p.planner.waves_planned
        assert r.planner._pop == p.planner._pop
    if r.landmarks is not None:
        assert np.array_equal(r.landmarks.landmarks, p.landmarks.landmarks)
        assert (r.landmarks.seed_ok, r.landmarks.stale) == (
            p.landmarks.seed_ok, p.landmarks.stale)


def graphs(family, n, seed):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


class Twin:
    """A reference and a port service built alike on one graph.

    ``planner="fixed"`` gives each a ``WavePlanner(margin=1e30)`` (the
    bidirectional route stays eligible whatever the clocks say, so the
    routes can be compared); ``reselect`` a dict of ``ReselectPolicy``
    fields.  ``strict=False`` (the default margin's timing-dependent
    routes) compares answers only."""

    def __init__(self, family, n=200, seed=9, backend="auto", *,
                 planner=None, reselect=None, strict=True, **kw):
        self.rg, self.pg = graphs(family, n, seed)
        self.n = self.rg.n
        self.strict = strict
        rkw, pkw = dict(kw), dict(kw)
        if planner == "fixed":
            rkw["planner"] = RPlanner(margin=1e30)
            pkw["planner"] = PPlanner(margin=1e30)
        elif planner is not None:
            rkw["planner"] = pkw["planner"] = planner
        if reselect is not None:
            rkw["reselect"] = RPolicy(**reselect)
            pkw["reselect"] = PPolicy(**reselect)
        self.r = RService(self.rg, backend="ell" if backend == "pallas"
                          else backend, **rkw)
        self.p = PService(self.pg, backend=backend, device="cpu", **pkw)
        self.check()

    def check(self):
        if self.strict:
            assert_service_state_equal(self.r, self.p)

    def serve(self, pairs):
        """One wave of (source, target) pairs (target None: a full
        vector) through both; the port's queries."""
        rq = [RQuery(int(s), None if t is None else int(t))
              for s, t in pairs]
        pq = [PQuery(int(s), None if t is None else int(t))
              for s, t in pairs]
        assert self.r.serve(rq) is rq and self.p.serve(pq) is pq
        assert_answers_equal(rq, pq)
        self.check()
        return pq

    def delta(self, rdelta, **kw):
        """A reference delta applied to both; the port's stats."""
        rs = self.r.apply_delta(rdelta, **kw)
        ps = self.p.apply_delta(delta_from_arrays(rdelta, device="cpu"),
                                **kw)
        assert ps.pop("host_syncs") >= 0
        assert rs == ps
        self.check()
        return ps

    def random_delta(self, k, seed, **kw):
        return self.delta(R.random_delta(self.r.solver.graph, k, seed=seed,
                                         lo=kw.pop("lo", 0.5),
                                         hi=kw.pop("hi", 2.0)), **kw)

    def host(self):
        return self.p.solver.graph.to_host()


def assert_near_dijkstra(hg, queries, rtol=1e-5, atol=1e-4):
    """The reference tests' own check of answers against Dijkstra."""
    for q in queries:
        exp = dijkstra(hg, source=q.source).dist[q.target]
        if np.isinf(exp):
            assert not np.isfinite(q.distance)
        else:
            np.testing.assert_allclose(q.distance, exp, rtol=rtol,
                                       atol=atol)
            assert q.path[0] == q.source and q.path[-1] == q.target


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_answers_and_caches(backend):
    tw = Twin("gnp", 200, 9, backend, batch=4)
    rng = np.random.default_rng(0)
    wave = [(s, int(rng.integers(0, tw.n))) for s in (3, 3, 17, 42, 3, 17)]
    assert_near_dijkstra(tw.host(), tw.serve(wave))
    assert tw.p.stats["sources_solved"] == 3     # coalesced unique sources
    tw.serve([(3, 5), (42, 7)])                  # pure cache
    assert tw.p.stats["sources_solved"] == 3
    assert tw.p.stats["cache_hits"] >= 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_full_vector_query(backend):
    tw = Twin("gnp", 150, 12, backend, batch=2)
    (q,) = tw.serve([(7, None)])
    assert q.done and q.distance is None and q.path is None
    assert q.dist.shape == (tw.n,) and q.dist.dtype == np.float32
    assert_dist_equal(q.dist, dijkstra(tw.host(), 7).dist)
    (q2,) = tw.serve([(7, 3)])
    assert q2.dist is None and q2.distance is not None
    assert _same(tw.r.distances(11), tw.p.distances(11))
    tw.check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_eviction_mid_wave_resolves(backend):
    """cache_sources < wave size: evicted sources re-solve mid-wave."""
    tw = Twin("gnp", 200, 21, backend, batch=3, cache_sources=2)
    out = tw.serve([(s, (s + 1) % 200) for s in [0, 11, 23, 37, 0, 11]])
    assert all(q.done for q in out)
    assert tw.p.stats["batches"] > 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_stats_accounting(backend):
    tw = Twin("gnp", 150, 22, backend, batch=2, cache_sources=64)
    tw.serve([(5, 1), (9, 2), (5, 3)])
    st = tw.p.stats
    assert (st["queries"], st["sources_solved"], st["batches"],
            st["cache_hits"]) == (3, 2, 1, 1)
    assert st["solve_seconds"] > 0.0
    tw.serve([(9, 8)])
    assert (st["queries"], st["cache_hits"], st["batches"]) == (4, 2, 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_end_to_end_and_tightness(backend):
    """The landmark-seeded service (the reference's frontier test, on
    every route): answers, then the tightness telemetry and its hooks."""
    tw = Twin("geometric", 220, 2, backend, batch=4, landmarks=4)
    rng = np.random.default_rng(1)
    wave = tw.serve([(int(rng.integers(tw.n)), int(rng.integers(tw.n)))
                     for _ in range(10)])
    assert_near_dijkstra(tw.host(), wave, rtol=0, atol=1e-3)
    svc = tw.p
    assert svc.stats["seed_tightness_count"] > 0
    m = svc.stats["seed_tightness_mean"]
    assert 0.0 <= m <= 1.0 + 1e-6 and svc.landmarks.tightness() == m
    assert not svc.landmarks.needs_reselect(threshold=0.0)
    svc.landmarks.reset_tightness()
    assert svc.landmarks.tightness() is None


def test_service_full_vector_route_accounting():
    tw = Twin("geometric", 150, 3, batch=8, planner=True)
    qs = tw.serve([(s, None) for s in (4, 8, 8, 4, 15)])
    routes = tw.p.stats["planner_routes"]
    assert routes["full_vector"] == 3 and routes["cache"] == 2
    assert tw.p.planner.cost("full_vector") is not None
    ref = P.Solver(tw.pg, backend="segment", device="cpu")
    for q in qs:
        assert _same(q.dist, ref.solve(q.source).dist)
    tw.serve([(4, None)])
    assert routes["full_vector"] == 3 and routes["cache"] == 3


def test_service_pair_warm_refresh():
    tw = Twin("geometric", 200, 4, batch=8, landmarks=4, planner="fixed",
              bidirectional=True)
    tw.serve([(0, 190), (3, 150)])
    hot = [k for k, v in tw.p._pairs.items() if v[3] is not None]
    assert hot
    tw.random_delta(5, 99)
    assert tw.p.stats["pair_warm_refreshed"] == len(hot)
    ref = P.Solver(tw.p.solver.graph, backend="segment", device="cpu")
    fresh = 0
    for (s, t), (ver, d, path, lanes) in tw.p._pairs.items():
        if ver != tw.p.version:
            continue
        fresh += 1
        assert lanes is not None
        assert _bits(d) == ref.solve(s).dist[t].numpy().tobytes()
    assert fresh >= len(hot)
    before = tw.p.stats["planner_routes"]["cache"]
    tw.serve([hot[0]])
    assert tw.p.stats["planner_routes"]["cache"] == before + 1


def test_service_rejects_out_of_range_vertices():
    """Checked on the host before any indexing (on the card an
    out-of-range index would be a device-side assert)."""
    _, pg = graphs("gnp", 120, 4)
    svc = PService(pg, batch=2, landmarks=2, device="cpu")
    for bad in ([PQuery(0, 120)], [PQuery(-1, 3)], [PQuery(120)],
                [PQuery(1, 2), PQuery(3, -5)]):
        with pytest.raises(ValueError, match="outside"):
            svc.serve(bad)
    assert svc.stats["queries"] == 0 and svc.host_reads == 0


def test_service_runs_on_the_card_unless_told(monkeypatch):
    """Without ``device="cpu"`` the service asks for CUDA, and with no
    card that raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rg, pg = graphs("gnp", 120, 4)
    host = pg.to_host()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PService(host, batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PService(host, batch=2, device="cuda")
    svc = PService(host, batch=2, device="cpu")
    (q,) = svc.serve([PQuery(0, 5)])
    assert svc.device.type == "cpu" and q.done


def test_parent_pointers_of_stacked_rows_equal_single_rows():
    """The service reads parent pointers a chunk of result rows at a
    time: ``parent_pointers`` over ``[B, n]`` rows equals it row by row."""
    from repro_torch.core.sssp.parents import parent_pointers
    _, pg = graphs("geometric", 150, 2)
    solver = P.Solver(pg, backend="segment", device="cpu")
    for targets in (None, [40, 7, 149]):
        rows = solver.solve_batch([0, 17, 99], targets=targets).dist
        stacked = parent_pointers(pg, rows)
        assert stacked.dtype == torch.int32 and stacked.shape == rows.shape
        for i in range(3):
            assert torch.equal(stacked[i], parent_pointers(pg, rows[i]))
