"""Port parity for the legacy single-source entry points
(``repro_torch.sssp.run_sssp``, ``run_sssp_ell``, ``run_sssp_traced``,
``run_sssp_distributed``): bitwise the reference's, the traced run's
per-round trace key by key and round by round; the bounds invariants of
every traced round (C <= cost <= D, C rising, D falling) as the
reference's engine test checks them; the reference's compatibility-shim
test; and the host reads."""
import numpy as np
import pytest

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_ell as rbuild_ell
from repro.core.graph import build_graph as rbuild
from repro.core.sssp.engine import run_sssp_traced as r_traced
import repro_torch.sssp as P
from repro_torch.convert import ell_from_arrays, graph_from_arrays
from repro_torch.core.sssp import reference as pref
from test_torch_graph import _one_torch_thread  # noqa: F401

R_CFG = {"sp1": R.SSSPConfig(rules=R.SP1_RULES), "sp3": R.SP3_CONFIG,
         "sp4": R.SP4_CONFIG,
         "sp4_cprop3": R.SSSPConfig(rules=R.SP3_RULES, label_correcting=True,
                                    c_prop_iters=3)}
P_CFG = {"sp1": P.SSSPConfig(rules=P.SP1_RULES), "sp3": P.SP3_CONFIG,
         "sp4": P.SP4_CONFIG,
         "sp4_cprop3": P.SSSPConfig(rules=P.SP3_RULES, label_correcting=True,
                                    c_prop_iters=3)}


def _graphs(family, n=200, seed=3):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    re_ = rbuild_ell(nn, src, dst, w)
    return (rg, re_), (graph_from_arrays(rg, device="cpu"),
                       ell_from_arrays(re_, device="cpu"))


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def assert_result_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert (ra.rounds, ra.fixed_by, ra.source) == (pb.rounds, pb.fixed_by,
                                                   pb.source)


@pytest.mark.parametrize("family", ["gnp", "grid", "power_law", "dag"])
@pytest.mark.parametrize("cfg", list(R_CFG))
def test_run_sssp_and_ell_bitwise_vs_reference(family, cfg):
    (rg, re_), (pg, pe) = _graphs(family)
    ra = R.run_sssp(rg, 5, R_CFG[cfg])
    pb = P.run_sssp(pg, 5, P_CFG[cfg])
    assert_result_bitwise(ra, pb)
    assert pb.host_syncs == pb.rounds + 2
    assert_result_bitwise(R.run_sssp_ell(rg, re_, 5, R_CFG[cfg]),
                          P.run_sssp_ell(pg, pe, 5, P_CFG[cfg]))


@pytest.mark.parametrize("family", ["gnp", "grid", "chain"])
def test_run_sssp_traced_bitwise_vs_reference(family):
    (rg, _), (pg, _) = _graphs(family, n=150, seed=7)
    ra, pb = r_traced(rg, 2), P.run_sssp_traced(pg, 2)
    assert_result_bitwise(ra, pb)
    assert len(ra.trace) == len(pb.trace) == pb.rounds > 0
    for t, (a, b) in enumerate(zip(ra.trace, pb.trace)):
        assert list(a) == list(b), t
        for key in a:
            x, y = a[key], b[key]
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), (t, key)
            else:
                assert type(x) is type(y) and x == y, (t, key)
    # three host reads a round, the first state's and the last predicate
    assert pb.host_syncs == 3 * pb.rounds + 2


def test_run_sssp_traced_round_cap_matches_reference():
    (rg, _), (pg, _) = _graphs("grid", n=150, seed=7)
    ra, pb = r_traced(rg, 0, max_rounds=4), P.run_sssp_traced(
        pg, 0, max_rounds=4)
    assert len(pb.trace) == len(ra.trace) == 4
    assert_result_bitwise(ra, pb)


@pytest.mark.parametrize("family", ["gnp", "grid"])
def test_invariants_every_round(family):
    """C <= cost <= D at every round; C monotone up, D monotone down (the
    reference engine test's check, on the port's trace)."""
    nn, src, dst, w = rgen.make(family, 200, seed=7)
    hg = P.HostGraph(nn, src, dst, w)
    cost = pref.dijkstra(hg).dist
    res = P.run_sssp_traced(hg.to_device("cpu"), 0, P.SP4_CONFIG)
    assert res.trace
    for t in res.trace:
        assert (t["C"] <= cost + 1e-4).all(), "C must lower-bound cost"
        assert (cost <= t["D"] + 1e-3).all()
        assert (t["C"] >= t["prev_C"] - 1e-6).all()
        assert (t["D"] <= t["prev_D"] + 1e-6).all()


def test_compatibility_entry_points_answer():
    """The counterpart of the reference's deprecation-shim test."""
    nn, src, dst, w = rgen.make("grid", 100, seed=3)
    hg = P.HostGraph(nn, src, dst, w)
    expected = pref.dijkstra(hg).dist
    g = hg.to_device("cpu")

    def close(got):
        got = np.asarray(got.cpu(), np.float64)
        np.testing.assert_allclose(np.where(np.isinf(got), 1e18, got),
                                   np.where(np.isinf(expected), 1e18,
                                            expected),
                                   rtol=1e-5, atol=1e-4)
    close(P.run_sssp(g).dist)
    close(P.run_sssp_ell(g, hg.to_ell("cpu")).dist)
    D, C, fixed, rounds = P.run_sssp_distributed(g)
    close(D)
    assert int(rounds) > 0


def test_out_of_range_source_raises():
    _, (pg, pe) = _graphs("chain", n=40)
    for fn in (lambda: P.run_sssp(pg, pg.n),
               lambda: P.run_sssp_ell(pg, pe, -1),
               lambda: P.run_sssp_traced(pg, pg.n),
               lambda: P.run_sssp_distributed(pg, pg.n)):
        with pytest.raises(ValueError, match="out of range"):
            fn()
