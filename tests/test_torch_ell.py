"""Port parity on the pallas route (the ELL layout through the plain
versions of the fused ELL relax and masked min): bitwise against the
reference's ``backend="ell"`` on 7 families x SP3/SP4, and against the
reference's Pallas kernels in interpret mode on one small case."""
import numpy as np
import pytest

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_ell as rbuild_ell
from repro.core.graph import build_graph as rbuild
import repro_torch.sssp as P
from repro_torch.convert import ell_from_arrays, graph_from_arrays
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
CFG = {"sp3": (R.SP3_CONFIG, P.SP3_CONFIG), "sp4": (R.SP4_CONFIG,
                                                    P.SP4_CONFIG)}


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def _check(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(ra.rounds, pb.rounds)
    assert ra.fixed_by == pb.fixed_by
    assert ra.edges_relaxed is None and pb.edges_relaxed is None


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg", list(CFG))
def test_pallas_route_bitwise_vs_reference_ell(family, cfg):
    nn, src, dst, w = rgen.make(family, 300, seed=7)
    rg = rbuild(nn, src, dst, w)
    pg = graph_from_arrays(rg, device="cpu")
    rcfg, pcfg = CFG[cfg]
    rs = R.Solver(rg, rcfg, backend="ell")
    ps = P.Solver(pg, pcfg, backend="pallas", device="cpu")
    assert ps.cfg.use_pallas and ps.ell.deg_pad == rs.ell.deg_pad
    _check(rs.solve_batch([0, 5, 17]), ps.solve_batch([0, 5, 17]))
    a, b = rs.solve(5), ps.solve(5)
    assert _same(a.dist, b.dist) and _same(a.C, b.C)
    assert (a.rounds, a.fixed_by) == (b.rounds, b.fixed_by)


def test_pallas_route_vs_reference_pallas_interpret():
    nn, src, dst, w = rgen.make("gnp", 64, seed=5)
    rg = rbuild(nn, src, dst, w)
    rell = rbuild_ell(nn, src, dst, w)
    rs = R.Solver(rg, R.SP4_CONFIG, backend="pallas", ell=rell)
    ps = P.Solver(graph_from_arrays(rg, device="cpu"), P.SP4_CONFIG,
                  backend="pallas", ell=ell_from_arrays(rell, device="cpu"),
                  device="cpu")
    a, b = rs.solve(3), ps.solve(3)
    assert _same(a.dist, b.dist) and _same(a.C, b.C)
    assert (a.rounds, a.fixed_by) == (b.rounds, b.fixed_by)


def test_ell_and_pallas_names_run_the_same_route():
    nn, src, dst, w = rgen.make("grid", 100, seed=2)
    pg = P.build_graph(nn, src, dst, w, device="cpu")
    a = P.Solver(pg, backend="ell", device="cpu").solve_batch([0, 3])
    b = P.Solver(pg, backend="pallas", device="cpu").solve_batch([0, 3])
    assert np.array_equal(a.dist.numpy(), b.dist.numpy())
    assert a.fixed_by == b.fixed_by
