"""Port parity for the service across weight deltas: ``apply_delta``
warm-refreshes the hot sources and version-stamps the rest of the cache
stale (a stale entry is re-solved, never served), and the targeted path
stays exact across deltas with eager landmark tables and with lazy ones
(stale tables seed while deltas only increase weights; the first
decrease turns seeding off until a refresh).  Mirrors the service tests
of ``test_dynamic.py`` and the delta cases of ``test_p2p.py``; the
reference's service and the port's run side by side on the segment,
pallas and frontier routes, compared bitwise after every wave and delta
(``test_torch_serve.Twin``)."""
import numpy as np
import pytest

import repro.sssp as R
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_serve import BACKENDS, Twin, assert_near_dijkstra


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_apply_delta_serves_mutated_graph(backend):
    tw = Twin("gnp", 200, 9, backend, batch=4)
    rng = np.random.default_rng(1)
    tw.serve([(s, int(rng.integers(0, tw.n))) for s in (3, 17, 42, 63)])
    stats = tw.random_delta(9, 4, lo=0.3, hi=3.0)
    assert tw.p.version == 1
    assert stats["warm_refreshed"] + stats["cold_refreshed"] == 4
    wave = tw.serve([(s, int(rng.integers(0, tw.n))) for s in (3, 17, 99)])
    assert_near_dijkstra(tw.host(), wave)
    assert tw.p.stats["deltas"] == 1 and tw.p.stats["warm_refreshed"] >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_stale_entries_not_served(backend):
    tw = Twin("chain", 120, 3, backend, batch=2, cache_sources=64)
    for s in range(6):
        tw.serve([(s, tw.n - 1)])
    g = tw.r.solver.graph
    old_w = np.asarray(g.w[: g.e])
    tw.delta(R.make_delta(g, [0], [old_w[0] * 50.0]), refresh_hot=2)
    (q,) = tw.serve([(0, tw.n - 1)])      # stale entry: must re-solve
    assert_near_dijkstra(tw.host(), [q])


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_p2p_exact_across_deltas(backend):
    tw = Twin("grid", 150, 3, backend, batch=4, landmarks=4)
    tw.serve([(3, 140), (9, 0)])
    for seed in (1, 2):
        tw.random_delta(25, seed)
        assert tw.p.landmarks.seed_ok and not tw.p.landmarks.stale
        wave = tw.serve([(3, 140), (40, 7)])
        assert_near_dijkstra(tw.host(), wave, atol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lazy_landmarks_pure_increase_keeps_seeding_decrease_drops_it(
        backend):
    tw = Twin("gnp", 120, 4, backend, batch=2, landmarks=3,
              refresh_landmarks=False)
    g = tw.r.solver.graph
    old_w = np.asarray(g.w[: g.e])
    tw.delta(R.make_delta(g, [0, 1, 2], old_w[[0, 1, 2]] * 2.0))
    index = tw.p.landmarks
    assert index.stale and index.seed_ok
    assert_near_dijkstra(tw.host(), tw.serve([(5, 60)]), atol=1e-3)
    g = tw.r.solver.graph
    tw.delta(R.make_delta(g, [7], [float(np.asarray(g.w[7]) * 0.5)]))
    assert not index.seed_ok and index.seed(5) is None
    assert_near_dijkstra(tw.host(), tw.serve([(5, 60)]), atol=1e-3)
    tw.r.landmarks.refresh()
    index.refresh()
    assert index.seed_ok and not index.stale
    tw.serve([(5, 61), (6, 60)])
