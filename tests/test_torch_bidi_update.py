"""Port parity for bidirectional queries across weight deltas: both
lanes' graphs mutated by ``apply_delta`` (the reverse lane through the
forward->reverse permutation, or a given reverse delta), landmark tables
refreshed and re-selected, each bitwise against the reference's
``BidirectionalSolver`` (the reference's delta carried across by
``convert.delta_from_arrays``) and against cold solves of the mutated
graph.  The warm pair refresh is in test_torch_bidi_warm.py."""
import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core.sssp.bidirectional import BidirectionalSolver as RBidi
from repro.core.sssp.landmarks import LandmarkIndex as RIndex
import repro_torch.sssp as P
from repro_torch.convert import delta_from_arrays
from test_torch_bidi import (FAMILIES, _same, assert_bidi_equal,
                             check_pair, edge_mins, graphs)
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", FAMILIES)
def test_bidi_exact_after_deltas_and_reselect(family):
    rg, pg = graphs(family)
    ri, pi = RIndex(rg, k=4, seed=7), P.LandmarkIndex(pg, k=4, seed=7)
    rb = RBidi(rg, backend="segment", landmarks=ri)
    pb = P.BidirectionalSolver(pg, backend="segment", landmarks=pi,
                               device="cpu")
    for step in range(2):
        delta = R.random_delta(rb.graph, max(1, rg.e // 20), seed=step,
                               lo=0.2, hi=4.0)
        pd = delta_from_arrays(delta, device="cpu")
        rb.apply_delta(delta)
        ri.apply_delta(delta, refresh=True)
        pb.apply_delta(pd)
        pi.apply_delta(pd, refresh=True)
        assert _same(rb.graph.w, pb.graph.w)
        assert _same(rb.rgraph.w, pb.rgraph.w)
        assert _same(rb.rgraph.out_weight, pb.rgraph.out_weight)
    for idx, pkg in ((ri, R), (pi, P)):
        idx.record_tightness(np.full(40, 0.01))    # force the drift signal
        assert idx.maybe_reselect(pkg.ReselectPolicy(
            threshold=0.5, min_observations=10, cooldown_deltas=1))
    assert np.array_equal(ri.landmarks, pi.landmarks)
    full = P.Solver(pb.graph, backend="segment", device="cpu")
    s = 5 % pg.n
    fres = full.solve(s)
    wmap = edge_mins(pb.graph)
    for t in (1, pg.n // 3, pg.n - 1):
        res = pb.solve(s, t)
        assert_bidi_equal(rb.solve(s, t), res)
        check_pair(res, fres, t, wmap)


def test_bidi_update_takes_a_given_reverse_delta():
    rg, pg = graphs("grid")
    rb = RBidi(rg, backend="segment")
    pb = P.BidirectionalSolver(pg, backend="segment", device="cpu")
    ri = P.LandmarkIndex(pg, k=2, seed=1)
    delta = delta_from_arrays(R.random_delta(rb.graph, 9, seed=4),
                              device="cpu")
    rdelta = ri.reverse_delta(delta)
    derived = pb.reverse_delta(delta)
    for name in ("edge_idx", "new_w", "ell_row", "ell_col", "csr_pos"):
        assert torch.equal(getattr(rdelta, name), getattr(derived, name))
    assert pb.update(delta, rdelta) == {}
    rb.apply_delta(R.random_delta(rb.graph, 9, seed=4))
    assert _same(rb.rgraph.w, pb.rgraph.w)
    assert_bidi_equal(rb.solve(2, 100), pb.solve(2, 100))
