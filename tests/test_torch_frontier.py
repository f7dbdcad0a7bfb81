"""Port parity on the frontier route (the shared batch frontier and its
scatter-min kernel's plain version): bitwise against the reference
``Solver(backend="frontier")`` on 7 families under SP4 at the default
cap, batched and single solves, including ``edges_relaxed``.  SP3 is in
test_torch_frontier_sp3.py, the overflow fallback in
test_torch_frontier_overflow.py."""
import numpy as np
import pytest

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
import repro_torch.sssp as P
from repro_torch.convert import graph_from_arrays
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
CFG = {"sp3": (R.SP3_CONFIG, P.SP3_CONFIG), "sp4": (R.SP4_CONFIG,
                                                    P.SP4_CONFIG)}


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def run_pair(family, cfg, single, n=300, **kw):
    # power_law's hubs make the in-neighbourhood gathers of the cone
    # walks [B, cap, max_out_deg, max_in_deg]; n = 200 keeps them small
    n = min(n, 200) if family == "power_law" else n
    nn, src, dst, w = rgen.make(family, n, seed=7)
    rg = rbuild(nn, src, dst, w)
    pg = graph_from_arrays(rg, device="cpu")
    rcfg, pcfg = CFG[cfg]
    rs = R.Solver(rg, rcfg, backend="frontier", **kw)
    ps = P.Solver(pg, pcfg, backend="frontier", device="cpu", **kw)
    sources = [0, 5, 17]
    ra, pb = rs.solve_batch(sources), ps.solve_batch(sources)
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(ra.rounds, pb.rounds)
    assert ra.fixed_by == pb.fixed_by
    assert np.array_equal(ra.edges_relaxed, pb.edges_relaxed)
    # three reads a round (termination+frontier count, the two lb
    # walk counts, the inWeight_nf walk count), the final termination
    # read and the result read
    assert pb.host_syncs == 3 * int(pb.rounds.max()) + 2
    if single:
        a, b = rs.solve(5), ps.solve(5)
        assert _same(a.dist, b.dist) and _same(a.C, b.C)
        assert _same(a.fixed, b.fixed)
        assert (a.rounds, a.fixed_by, a.edges_relaxed) == (
            b.rounds, b.fixed_by, b.edges_relaxed)


@pytest.mark.parametrize("family", FAMILIES)
def test_frontier_bitwise_vs_reference(family):
    run_pair(family, "sp4", single=True)
