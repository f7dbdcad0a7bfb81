"""Port parity for the service's goal-directed path (``landmarks=``):
targeted early-exit waves seeded by the landmark index, and partial
cache entries (stamped, never answering a full vector, never downgrading
a full entry, hitting on fixed targets).  Mirrors the service tests of
``test_p2p.py`` (its delta cases are in test_torch_serve_deltas.py); the
reference's service and the port's run side by side on the segment,
pallas and frontier routes, compared bitwise after every wave
(``test_torch_serve.Twin``)."""
import numpy as np
import pytest

from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_serve import BACKENDS, Twin, assert_near_dijkstra


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_p2p_answers_match_dijkstra(backend):
    tw = Twin("grid", 150, 9, backend, batch=4, landmarks=4)
    assert tw.p.p2p
    rng = np.random.default_rng(0)
    wave = tw.serve([(int(rng.integers(tw.n)), int(rng.integers(tw.n)))
                     for _ in range(10)])
    assert_near_dijkstra(tw.host(), wave, atol=1e-3)
    assert tw.p.stats["p2p_solves"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_partial_entries_never_poison_full_lookups(backend):
    tw = Twin("gnp", 150, 12, backend, batch=2, landmarks=3)
    tw.serve([(7, 3)])                           # partial entry for 7
    assert tw.p._cache[7][2] is True
    assert np.array_equal(tw.r.distances(7), tw.p.distances(7))
    tw.check()
    (q,) = tw.serve([(7, None)])
    assert q.dist is not None
    tw.serve([(7, 9)])                           # no downgrade
    assert tw.p._cache[7][2] is False


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_partial_cache_hits_on_fixed_targets(backend):
    tw = Twin("chain", 150, 2, backend, batch=1, landmarks=3)
    tw.serve([(0, 140)])
    solves = tw.p.stats["p2p_solves"]
    (q,) = tw.serve([(0, 5)])
    assert_near_dijkstra(tw.host(), [q], atol=1e-3)
    if bool(tw.p._cache[0][1].fixed[5]):
        assert tw.p.stats["p2p_solves"] == solves
        assert tw.p.stats["cache_hits"] >= 1
