"""Port parity for the distributed backend across processes: gloo groups
of 2, 3 and 4 spawned ranks (``repro_torch.distributed.ranks``), each
with a deadline, run ``solve`` (SP4 and SP3), a batch of 3 (padded to
4), a targeted ``solve``, ``DynamicSolver.update``/``resolve`` and
``run_sssp_distributed``.  Every answer is bitwise the reference's
single-device solve (which the reference's own 8-device test holds
bitwise to its sharded one), and every rank's bitwise every other's.
This module imports no JAX at its top: the ranks import it."""
import numpy as np
import pytest
import torch

N = 160
SOURCES = [9, 0, 77]
DELTA = dict(k=12, seed=1, lo=0.4, hi=2.5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(res) -> dict:
    return dict(dist=res.dist.numpy(), C=res.C.numpy(),
                fixed=res.fixed.numpy(),
                rounds=np.asarray(res.rounds).tolist(),
                fixed_by=res.fixed_by)


def rank_work(rank, world):
    """One rank's solves on the CPU; host values only."""
    import repro_torch.sssp as P
    from repro_torch.core import generators as pgen
    g = P.build_graph(*pgen.make("gnp", N, seed=4), device="cpu")
    out = {}
    for name, cfg in (("sp4", P.SP4_CONFIG), ("sp3", P.SP3_CONFIG)):
        s = P.Solver(g, cfg, backend="distributed", device="cpu")
        assert (s.rank, s.world) == (rank, world)
        out[name] = _rows(s.solve(SOURCES[0]))
        out[name + "/batch"] = _rows(s.solve_batch(SOURCES))
        out[name + "/calls"] = s.collectives.calls
    s = P.Solver(g, backend="distributed", device="cpu")
    out["targeted"] = _rows(s.solve(9, target=50))
    dyn = P.DynamicSolver(g, backend="distributed", device="cpu")
    dyn.solve_batch(SOURCES[:2])
    st = dyn.update(P.random_delta(dyn.graph, **DELTA))
    out["stats"] = {k: st[k] for k in ("sweeps", "warm_rounds", "tainted",
                                       "host_syncs")}
    out["resolve"] = _rows(dyn.resolve(SOURCES[:2]))
    D, C, fixed, rounds = P.run_sssp_distributed(g, SOURCES[0])
    out["legacy"] = dict(dist=D.numpy(), C=C.numpy(), fixed=fixed.numpy(),
                         rounds=int(rounds))
    return out


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device (segment) answers to ``rank_work``."""
    import repro.sssp as R
    from repro.core import generators as rgen

    def rows(res):
        return dict(dist=np.asarray(res.dist), C=np.asarray(res.C),
                    fixed=np.asarray(res.fixed),
                    rounds=np.asarray(res.rounds).tolist(),
                    fixed_by=res.fixed_by)
    g = R.build_graph(*rgen.make("gnp", N, seed=4))
    out = {}
    for name, cfg in (("sp4", R.SP4_CONFIG), ("sp3", R.SP3_CONFIG)):
        s = R.Solver(g, cfg, backend="segment")
        out[name] = rows(s.solve(SOURCES[0]))
        out[name + "/batch"] = rows(s.solve_batch(SOURCES))
    out["targeted"] = rows(R.Solver(g, backend="segment").solve(
        9, target=50))
    dyn = R.DynamicSolver(g, backend="segment")
    dyn.solve_batch(SOURCES[:2])
    st = dyn.update(R.random_delta(dyn.graph, **DELTA))
    out["stats"] = {k: st[k] for k in ("sweeps", "warm_rounds", "tainted")}
    out["resolve"] = rows(dyn.resolve(SOURCES[:2]))
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_ranks_bitwise_vs_reference(world, reference, tmp_path):
    from repro_torch.distributed.ranks import spawn_ranks
    outs = spawn_ranks(rank_work, world, init_dir=str(tmp_path),
                       timeout=60.0, deadline=150.0)
    for rank, out in enumerate(outs):
        assert _same(out, outs[0]), f"rank {rank} differs from rank 0"
    out = outs[0]
    for key in ("sp4", "sp4/batch", "sp3", "sp3/batch", "targeted",
                "resolve"):
        assert _same(out[key], reference[key]), key
    for key in ("sweeps", "warm_rounds", "tainted"):
        assert out["stats"][key] == reference["stats"][key], key
    assert out["sp4/calls"] == 2 * (out["sp4"]["rounds"] + max(
        out["sp4/batch"]["rounds"]))
    legacy = {k: reference["sp4"][k] for k in ("dist", "C", "fixed",
                                                "rounds")}
    assert _same(out["legacy"], legacy)


def stall(rank, world, seconds):
    """Rank 0 stops short of the collective rank 1 waits in."""
    import time
    import torch.distributed as dist
    if rank:
        dist.barrier()
    time.sleep(seconds)


def fail(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def test_a_hung_group_hits_its_deadline(tmp_path):
    from repro_torch.distributed.ranks import spawn_ranks
    with pytest.raises(TimeoutError, match="deadline"):
        spawn_ranks(stall, 2, (120,), init_dir=str(tmp_path), timeout=120.0,
                    deadline=5.0)


def test_a_failing_rank_fails_the_group(tmp_path):
    from repro_torch.distributed.ranks import spawn_ranks
    with pytest.raises(RuntimeError, match="on purpose"):
        spawn_ranks(fail, 2, init_dir=str(tmp_path), deadline=60.0)
