"""Port parity for the bidirectional warm pair refresh,
``update(delta, warm=[(s, t, D, fixed), ...])``: each cached pair's two
lanes re-solved warm to their full fixpoints, bitwise against the
reference's ``BidirectionalSolver.update`` field for field and against a
cold solve of the mutated graph, on the segment and frontier routes."""
import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core.sssp.bidirectional import BidirectionalSolver as RBidi
import repro_torch.sssp as P
from repro_torch.convert import delta_from_arrays
from test_torch_bidi import _bits, assert_bidi_equal, graphs
from test_torch_graph import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", ["geometric", "grid", "gnp", "chain"])
@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_bidi_update_warm_pairs_bitwise(family, backend):
    rg, pg = graphs(family, n=150, seed=2)
    rb = RBidi(rg, backend=backend)
    pb = P.BidirectionalSolver(pg, backend=backend, device="cpu")
    pairs = [(0, pg.n - 1), (3, 77)]
    rwarm, pwarm = [], []
    for s, t in pairs:
        ra, res = rb.solve(s, t), pb.solve(s, t)
        assert_bidi_equal(ra, res)
        rwarm.append((s, t, ra.D, ra.fixed))
        pwarm.append((s, t, res.D, res.fixed))
    delta = R.random_delta(rb.graph, 6, seed=30)
    rout = rb.update(delta, warm=rwarm)
    pout = pb.update(delta_from_arrays(delta, device="cpu"), warm=pwarm)
    assert set(pout) == set(rout) == set(pairs)
    assert pb.warm_solves == rb.warm_solves == 2
    cold = P.Solver(pb.graph, backend="segment", device="cpu")
    for (s, t), res in pout.items():
        assert_bidi_equal(rout[(s, t)], res)
        assert res.edges_relaxed is None
        full = cold.solve(s)
        # warm lanes run to their full fixpoints: the forward lane is a
        # cold solve of the new graph, the distance refolds to its bits
        assert torch.equal(res.D[0], full.dist)
        assert _bits(res.distance) == np.float32(full.dist[t]).tobytes()
    # the next cold pair solves run on the mutated graphs
    for s, t in pairs:
        assert_bidi_equal(rb.solve(s, t), pb.solve(s, t))
