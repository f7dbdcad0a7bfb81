"""Port parity for query-engine v2 in the service: the wave planner's
routes (cache / targeted / bidirectional / full / full_vector) around a
delta with the warm pair refresh, the estimate cache, and the
re-selection policy and its wiring.  Mirrors the service tests of
``test_serve_v2.py`` (its cache tests are in test_torch_serve_cache.py,
its planner tests in test_torch_serve_planner.py).

Routes depend on measured wall time (the bidirectional route's
eligibility compares EMA costs), so the parity tests that compare routes
give both services a ``WavePlanner(margin=1e30)``, which keeps that route
eligible whatever the clocks say; the test that keeps the default margin
compares the answers and ``sum(routes.values())``, not the split."""
import numpy as np
import pytest

import repro.sssp as R
from repro.core.sssp.landmarks import LandmarkIndex as RIndex
from repro.core.sssp.landmarks import ReselectPolicy as RPolicy
import repro_torch.sssp as P
from repro_torch.convert import delta_from_arrays
from repro_torch.runtime.sssp_service import SSSPService as PService
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_serve import BACKENDS, Twin, assert_near_dijkstra, graphs


def test_estimate_pairs_cache_tracks_table_refresh():
    """The host copy of the tables follows every swap of the device
    tables (refresh, reselect), on both sides alike."""
    rg, pg = graphs("geometric", 120, 11)
    ri, pi = RIndex(rg, k=4, seed=3), P.LandmarkIndex(pg, k=4, seed=3)
    pairs = [(2, rg.n - 3), (5, rg.n // 2), (0, 17)]
    before = pi.estimate_pairs(pairs)
    assert np.array_equal(ri.estimate_pairs(pairs), before)
    assert np.array_equal(pi.estimate_pairs(pairs), before)   # cached
    delta = R.random_delta(rg, max(1, rg.e // 3), seed=0, lo=30.0, hi=60.0)
    ri.apply_delta(delta, refresh=True)
    pi.apply_delta(delta_from_arrays(delta, device="cpu"), refresh=True)
    after = pi.estimate_pairs(pairs)
    assert np.array_equal(ri.estimate_pairs(pairs), after)
    assert not np.array_equal(before, after)
    solver = P.Solver(pi._fwd.graph, backend="segment", device="cpu")
    for (s, t), e in zip(pairs, after):
        d = float(solver.solve(s).dist[t])
        assert e <= d + 1e-3 * max(1.0, abs(d))
    for idx, pol in ((ri, RPolicy), (pi, P.ReselectPolicy)):
        idx.record_tightness(np.full(64, 0.01))
        assert idx.maybe_reselect(pol(threshold=0.5, min_observations=32,
                                      cooldown_deltas=1))
    assert np.array_equal(ri.landmarks, pi.landmarks)
    assert np.array_equal(ri.estimate_pairs(pairs), pi.estimate_pairs(pairs))


def _reselect_record(index, policy, deltas):
    """The reference test's sequence on one index: no observations, too
    few, no delta yet, after a delta, then tight seeds after another."""
    fired = [index.maybe_reselect(policy)]
    index.record_tightness(np.full(4, 0.01))
    fired.append(index.maybe_reselect(policy))
    index.record_tightness(np.full(8, 0.01))
    fired.append(index.maybe_reselect(policy))
    index.apply_delta(deltas[0], refresh=True)
    fired.append(index.maybe_reselect(policy))
    state = (index.reselects, index.tightness_count)
    index.record_tightness(np.full(32, 0.99))
    index.apply_delta(deltas[1], refresh=True)
    fired.append(index.maybe_reselect(policy))
    return fired, state, np.asarray(index.landmarks).tolist()


def test_reselect_policy_hysteresis_and_cadence():
    rg, pg = graphs("grid", 120, 11)
    # both deltas drawn on the original weights: the same edges either way
    deltas = [R.random_delta(rg, 4, seed=s, lo=0.5, hi=2.0) for s in (0, 1)]
    kw = dict(threshold=0.5, min_observations=8, cooldown_deltas=1)
    ref = _reselect_record(RIndex(rg, k=3, seed=1), RPolicy(**kw), deltas)
    port = _reselect_record(
        P.LandmarkIndex(pg, k=3, seed=1), P.ReselectPolicy(**kw),
        [delta_from_arrays(d, device="cpu") for d in deltas])
    assert ref == port
    assert port[0] == [False, False, False, True, False]
    assert port[1] == (1, 0)


def test_planned_service_matches_dijkstra_with_route_accounting():
    """The default margin: routes follow the clocks, so the answers and
    the route total are compared, not the split."""
    tw = Twin("geometric", 150, 11, batch=4, landmarks=4,
              landmark_seed=0, planner=True, bidirectional=True,
              strict=False)
    rng = np.random.default_rng(7)
    total = 0
    for _ in range(3):
        pairs = [(9, int(t)) for t in rng.integers(0, tw.n, 3)]
        pairs += [(int(s), int(t)) for s, t in rng.integers(0, tw.n, (5, 2))]
        wave = tw.serve(pairs)
        total += len(wave)
        assert all(q.done for q in wave)
        assert_near_dijkstra(tw.host(), wave)
    for svc in (tw.r, tw.p):
        routes = svc.stats["planner_routes"]
        assert sum(routes.values()) == total == svc.stats["queries"]
        assert routes["full"] > 0 and routes["targeted"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_planned_service_bitwise_on_routes(backend):
    """Every route of the planner under the fixed margin, two waves
    around a delta:
    a hot source (full), the far tail (bidirectional), the rest
    (targeted), full vectors, and the warm pair refresh; everything
    bitwise, routes included."""
    tw = Twin("geometric", 150, 5, backend, batch=4, landmarks=4,
              planner="fixed", bidirectional=True)
    rng = np.random.default_rng(3)
    for wave in range(2):
        pairs = [(9, int(t)) for t in rng.integers(0, tw.n, 3)]
        pairs += [(int(s), int(t)) for s, t in rng.integers(0, tw.n, (6, 2))]
        pairs += [(int(rng.integers(tw.n)), None), (12, None)]
        tw.serve(pairs)
        if wave == 0:
            tw.random_delta(6, 40)
    routes = tw.p.stats["planner_routes"]
    assert all(routes[k] > 0 for k in ("cache", "targeted", "bidirectional",
                                       "full", "full_vector"))
    assert tw.p.stats["pair_warm_refreshed"] > 0


def test_service_reselect_wiring():
    tw = Twin("geometric", 120, 11, batch=4, landmarks=3,
              reselect=dict(threshold=0.5, min_observations=4,
                            cooldown_deltas=1))
    tw.r.landmarks.record_tightness(np.full(8, 0.01))
    tw.p.landmarks.record_tightness(np.full(8, 0.01))
    tw.random_delta(4, 0)
    assert tw.p.stats["reselects"] == 1 and tw.p.landmarks.reselects == 1
    _, pg = graphs("geometric", 120, 11)
    svc = PService(pg, batch=4, landmarks=3, reselect=0.5, device="cpu")
    assert svc.reselect_policy == P.ReselectPolicy(threshold=0.5)
