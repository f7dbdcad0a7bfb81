"""Port parity for the distributed backend in one process, at a world of
one (``repro_torch.core.sssp.distributed``): the shard-padded arrays are
the reference's; ``Solver(backend="distributed")`` is bitwise the
reference's distributed Solver (its default mesh of one CPU device) on
``dist``/``C``/``fixed``/``rounds``/``fixed_by``, cold, batched,
targeted, seeded and warm; the all-reduce count is pinned (``1 +
c_prop_iters`` a round, one a taint sweep) and so are the host reads;
a one-rank gloo group runs the real all-reduce; the launcher serves
through the backend."""
import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp import distributed as rdist
from repro.core.sssp.distributed import shard_graph_edges as rshard
import repro_torch.sssp as P
from repro_torch.convert import graph_from_arrays
from repro_torch.core.sssp import distributed as pdist
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "grid", "chain", "power_law"]
R_CFG = {"sp4": R.SP4_CONFIG, "sp3": R.SP3_CONFIG}
P_CFG = {"sp4": P.SP4_CONFIG, "sp3": P.SP3_CONFIG}


def _graphs(family, n=150, seed=4):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def assert_rows_bitwise(ra, pb):
    assert _same(ra.dist, pb.dist) and _same(ra.C, pb.C)
    assert _same(ra.fixed, pb.fixed)
    assert np.array_equal(np.asarray(ra.rounds), np.asarray(pb.rounds))
    assert ra.fixed_by == pb.fixed_by


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_graph_edges_matches_reference(shards):
    rg, pg = _graphs("gnp", n=300)
    a, b = rshard(rg, shards), pdist.shard_graph_edges(pg, shards)
    assert (a.n, a.e, a.e_pad) == (b.n, b.e, b.e_pad)
    assert b.e_pad % (shards * 128) == 0
    for f in ("src", "dst", "w", "in_weight", "out_weight"):
        assert _same(getattr(a, f), getattr(b, f)), f
    blocks = [pdist.local_block(b, r, shards) for r in range(shards)]
    assert torch.equal(torch.cat([blk.src for blk in blocks]), b.src)
    assert torch.equal(torch.cat([blk.w for blk in blocks]), b.w)
    assert all(blk.e_pad == b.e_pad // shards for blk in blocks)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg", list(R_CFG))
def test_distributed_solver_bitwise_vs_reference(family, cfg):
    rg, pg = _graphs(family)
    rs = R.Solver(rg, R_CFG[cfg], backend="distributed")
    ps = P.Solver(pg, P_CFG[cfg], backend="distributed", device="cpu")
    assert (ps.world, ps.rank, ps.group) == (1, 0, None)
    assert ps.graph.e_pad == rs.graph.e_pad
    assert ps.graph.device.type == "cpu"
    sources = [0, 7, 33]                         # pads to 4 lanes
    ra = rs.solve_batch(sources)
    assert_rows_bitwise(ra, ps.solve_batch(sources))
    # the reference's distributed solve is its batch of one: lane 0
    assert_rows_bitwise(ra[0], ps.solve(0))


def test_targeted_and_seeded_distributed():
    """The counterpart of the reference's targeted distributed test, with
    landmark seeds."""
    rg, pg = _graphs("gnp", n=120)
    rs = R.Solver(rg, backend="distributed")
    ps = P.Solver(pg, backend="distributed", device="cpu")
    ra, pb = rs.solve(9, target=50), ps.solve(9, target=50)
    assert_rows_bitwise(ra, pb)
    assert pb.partial and pb.target == 50
    ra = rs.solve_batch([9, 0], targets=[50, 100])
    pb = ps.solve_batch([9, 0], targets=[50, 100])
    assert_rows_bitwise(ra, pb)
    c0 = np.asarray(R.LandmarkIndex(rg, k=4).seed_batch([9, 0]))
    ra = rs.solve_batch([9, 0], targets=[50, 100], C0=c0)
    pb = ps.solve_batch([9, 0], targets=[50, 100], C0=torch.from_numpy(c0))
    assert_rows_bitwise(ra, pb)
    full = P.Solver(pg, backend="segment", device="cpu").solve(9)
    assert float(pb.dist[0, 50]) == float(full.dist[50])


@pytest.mark.parametrize("family", ["gnp", "grid"])
def test_warm_update_bitwise_vs_reference(family):
    """The counterpart of the reference's distributed warm update."""
    rg, pg = _graphs(family, n=120)
    rd = R.DynamicSolver(rg, backend="distributed")
    pd = P.DynamicSolver(pg, backend="distributed", device="cpu")
    rd.solve_batch([0, 9])
    pd.solve_batch([0, 9])
    rst = rd.update(R.random_delta(rd.graph, 6, seed=1))
    pst = pd.update(P.random_delta(pd.graph, 6, seed=1))
    for k in ("sweeps", "warm_rounds", "tainted", "increased", "decreased"):
        assert rst[k] == pst[k], k
    ra, pb = rd.resolve([0, 9]), pd.resolve([0, 9])
    assert_rows_bitwise(ra, pb)
    cold = P.Solver(pd.graph, device="cpu").solve_batch([0, 9])
    assert torch.equal(pb.dist, cold.dist)


def test_collectives_and_host_reads_pinned():
    _, pg = _graphs("gnp", n=200, seed=2)
    cfg = P.SSSPConfig(rules=P.SP3_RULES, label_correcting=True,
                       c_prop_iters=3)
    ps = P.Solver(pg, cfg, backend="distributed", device="cpu")
    res = ps.solve(0)
    assert ps.collectives.calls == res.rounds * (1 + cfg.c_prop_iters)
    assert ps.collectives.bytes == (
        res.rounds * (2 + cfg.c_prop_iters) * pg.n * 4)
    seg = P.Solver(pg, cfg, backend="segment", device="cpu").solve(0)
    assert res.host_syncs == seg.host_syncs == res.rounds + 2
    ps.collectives.reset()
    batch = ps.solve_batch([0, 1, 2])
    rounds = int(batch.rounds.max())
    assert ps.collectives.calls == rounds * (1 + cfg.c_prop_iters)
    assert batch.host_syncs == rounds + 2

    dyn = P.DynamicSolver(pg, backend="distributed", device="cpu")
    dyn.solve_batch([0, 5])
    dyn.collectives.reset()
    st = dyn.update(P.random_delta(dyn.graph, 40, seed=3, lo=1.5, hi=3.0))
    # one all-reduce a taint sweep, two a warm SP4 round
    assert st["sweeps"] > 0
    assert dyn.collectives.calls == st["sweeps"] + 2 * max(
        st["warm_rounds"])
    seg = P.DynamicSolver(pg, backend="segment", device="cpu")
    seg.solve_batch([0, 5])
    delta = P.random_delta(seg.graph, 40, seed=3, lo=1.5, hi=3.0)
    assert seg.update(delta)["host_syncs"] == st["host_syncs"]


def test_one_rank_group_runs_the_collective(tmp_path):
    """Under an initialized one-rank gloo group the backend picks the
    default group and really all-reduces (timed), bitwise the same."""
    _, pg = _graphs("grid", n=150)
    want = P.Solver(pg, backend="segment", device="cpu").solve_batch([0, 3])
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        ps = P.Solver(pg, backend="distributed", device="cpu")
        assert ps.group is not None and (ps.rank, ps.world) == (0, 1)
        ps.collectives.timed = True
        got = ps.solve_batch([0, 3])
        assert ps.collectives.calls == 2 * int(got.rounds.max())
        assert ps.collectives.ms() > 0.0
        D, C, fixed, rounds = P.run_sssp_distributed(pg, 3)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.dist, want.dist) and torch.equal(got.C, want.C)
    assert got.fixed_by == want.fixed_by
    assert torch.equal(D, want.dist[1]) and int(rounds) == want.rounds[1]


def test_group_needs_the_distributed_backend():
    _, pg = _graphs("chain", n=60)
    with pytest.raises(ValueError, match="group="):
        P.Solver(pg, backend="segment", group=object(), device="cpu")
    with pytest.raises(ValueError, match="shard-padded"):
        pdist.local_block(pg, 0, 3)


@pytest.mark.parametrize("family", ["gnp", "grid"])
def test_run_sssp_distributed_bitwise_vs_reference(family):
    """The legacy entry point is the distributed Solver's ``solve``, bitwise
    the reference's ``run_sssp_distributed`` on its default mesh."""
    rg, pg = _graphs(family)
    ra = rdist.run_sssp_distributed(rg, 7)
    pb = P.run_sssp_distributed(pg, 7)
    for a, b in zip(ra[:3], pb[:3]):
        assert _same(a, b)
    assert int(ra[3]) == pb[3]
    assert pb[0].device.type == "cpu"


def test_launcher_serves_through_the_distributed_backend(capsys):
    from repro_torch.launch import serve_sssp
    rc = serve_sssp.main(["--device", "cpu", "--n", "300", "--queries",
                          "24", "--backend", "distributed", "--verify",
                          "--landmarks", "4", "--deltas", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "backend=distributed" in out and "OK" in out
