"""Port parity for the service's partial and pair caches: entries stay
bitwise the reference's, and cold solves', across a landmark refresh and
a re-selection on 7 families (under ``WavePlanner(margin=1e30)``, so the
routes, and so the cache contents, can be compared), and the pair cache
is version-stamped and never answers a full-vector request.  Mirrors the
cache tests of ``test_serve_v2.py``."""
import numpy as np
import pytest

import repro_torch.sssp as P
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_serve import Twin, _bits, _same, assert_near_dijkstra

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


@pytest.mark.parametrize("family", FAMILIES)
def test_partial_cache_exact_across_landmark_refresh(family):
    """Partial and pair entries stay bitwise the reference's (and cold
    solves') across a landmark refresh and a re-selection; every repeat
    is served on both sides the same way."""
    tw = Twin(family, 120, 11, batch=4, landmarks=3, landmark_seed=5,
              planner="fixed", bidirectional=True)
    rng = np.random.default_rng(2)
    qs = [(int(s), int(t)) for s, t in rng.integers(0, tw.n, (8, 2))]
    tw.serve(qs)
    cold = P.Solver(tw.pg, backend="segment", device="cpu")

    def check():
        for s, t in qs:
            (q,) = tw.serve([(s, t)])
            exp = cold.solve(s).dist[t]
            assert _bits(q.distance) == exp.numpy().tobytes() or (
                not np.isfinite(q.distance) and not np.isfinite(exp))
            if np.isfinite(q.distance):
                assert q.path[0] == s and q.path[-1] == t

    check()
    tw.r.landmarks.refresh()
    tw.p.landmarks.refresh()
    check()
    tw.r.landmarks.reselect()
    tw.p.landmarks.reselect()
    check()
    tw.check()
    assert tw.p.stats["cache_hits"] > 0


def test_pair_cache_versioned_and_partial_never_poisons_full():
    tw = Twin("geometric", 120, 11, batch=4, landmarks=3, bidirectional=True)
    s, t = 2, tw.n - 3
    tw.serve([(s, t)])
    assert tw.p.stats["bidi_solves"] == 1
    tw.serve([(s, t)])                           # pair-cache hit
    assert tw.p.stats["bidi_solves"] == 1
    assert tw.p.stats["planner_routes"]["cache"] == 1
    assert _same(tw.r.distances(s), tw.p.distances(s))
    tw.check()
    tw.random_delta(4, 3, refresh_hot=0)
    (q,) = tw.serve([(s, t)])
    assert tw.p.stats["bidi_solves"] == 2
    assert_near_dijkstra(tw.host(), [q])
