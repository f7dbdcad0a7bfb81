"""Port parity for the baselines (``repro_torch.core.sssp.bellman_ford``,
``delta_stepping``): Bellman-Ford and Δ-stepping on the same graphs as
the reference, ``dist`` bitwise and ``rounds`` / ``phases`` /
``light_iters`` equal, on every family and for several sources a graph;
Δ's extremes (Bellman-Ford-like and Dijkstra-like); the host reads
pinned to one a loop condition; the cut-offs.  Mirrors
``test_sssp_baselines.py`` and the per-source baseline runs of
``test_p2p.py`` (the reference's trace counts have no counterpart)."""
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp.bellman_ford import run_bellman_ford as rbf
from repro.core.sssp.delta_stepping import run_delta_stepping as rds
from repro.core.sssp.reference import dijkstra
import repro_torch.sssp as P
from conftest import assert_dist_equal
from repro_torch.convert import graph_from_arrays
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


def _graphs(family, n, seed):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def _same(ref, port: torch.Tensor) -> bool:
    ref = np.asarray(ref)
    got = port.numpy()
    return ref.dtype == got.dtype and np.array_equal(ref, got)


def check_bf(rg, pg, source, **kw):
    ra, pa = rbf(rg, source, **kw), P.run_bellman_ford(pg, source, **kw)
    assert _same(ra.dist, pa.dist) and ra.rounds == pa.rounds
    assert pa.host_syncs == pa.rounds          # one read a round
    return pa


def check_ds(rg, pg, source, delta, **kw):
    ra = rds(rg, source, delta=delta, **kw)
    pa = P.run_delta_stepping(pg, source, delta=delta, **kw)
    assert _same(ra.dist, pa.dist)
    assert (ra.phases, ra.light_iters) == (pa.phases, pa.light_iters)
    return pa


@pytest.mark.parametrize("family", FAMILIES)
def test_bellman_ford_bitwise(family):
    rg, pg = _graphs(family, 250, 0)
    for s in (0, 7, 123):
        res = check_bf(rg, pg, s)
        assert_dist_equal(res.dist, dijkstra(pg.to_host(), s).dist)


@pytest.mark.parametrize("delta", [0.1, 0.3, 1.0, 100.0])
def test_delta_stepping_bitwise(delta):
    rg, pg = _graphs("gnp", 250, 1)
    res = check_ds(rg, pg, 0, delta)
    assert_dist_equal(res.dist, dijkstra(pg.to_host(), 0).dist)
    # each loop condition one read: the phase condition once a phase and
    # once at the end, the light fixpoint's once a sweep
    assert res.host_syncs == res.phases + 1 + res.light_iters


@pytest.mark.parametrize("family", ["grid", "chain", "power_law", "dag"])
def test_delta_stepping_families_bitwise(family):
    rg, pg = _graphs(family, 250, 2)
    for delta in (0.05, 0.25, 1.0):
        check_ds(rg, pg, 3, delta)


def test_delta_extremes_match_paper_remark():
    """Δ = 1e9 ~ Bellman-Ford (few phases); small Δ ~ Dijkstra (many)."""
    rg, pg = _graphs("gnp", 300, 2)
    big = check_ds(rg, pg, 0, 1e9)
    small = check_ds(rg, pg, 0, 0.05)
    assert big.phases <= 3 and small.phases > big.phases
    bf = check_bf(rg, pg, 0)
    assert torch.equal(big.dist, bf.dist) and torch.equal(small.dist, bf.dist)


def test_baselines_across_sources():
    """Several sources on one graph (the reference's no-retrace runs),
    every answer bitwise the reference's and the SP4 solver's."""
    rg, pg = _graphs("gnp", 100, 5)
    sp4 = P.Solver(pg, backend="segment", device="cpu")
    for s in (0, 1, 2, 3, 4):
        ds = check_ds(rg, pg, s, 0.25)
        bf = check_bf(rg, pg, s)
        full = sp4.solve(s).dist
        assert torch.equal(ds.dist, full) and torch.equal(bf.dist, full)


def test_baselines_cut_offs_and_checks():
    rg, pg = _graphs("chain", 200, 3)
    full = check_bf(rg, pg, 0)
    cut = check_bf(rg, pg, 0, max_rounds=5)
    assert cut.rounds == 5 and cut.host_syncs == 5 and full.rounds > 5
    ds = check_ds(rg, pg, 0, 0.3, max_phases=4)
    assert ds.phases == 4 and ds.host_syncs == 4 + ds.light_iters
    for run in (P.run_bellman_ford, P.run_delta_stepping):
        with pytest.raises(ValueError, match="out of range"):
            run(pg, pg.n)
