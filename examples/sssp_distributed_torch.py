"""Distributed SP4 on the PyTorch/CUDA port: the edge list sharded over the
ranks of one ``torch.distributed`` process group, vertex state
replicated, MIN all-reduces every round, bitwise identical to the
single-device engine.

The ranks are processes on this host (``distributed.ranks.spawn_ranks``:
a gloo group; on the card the ranks share it).

  python examples/sssp_distributed_torch.py --n 20000          # 8 ranks
  python examples/sssp_distributed_torch.py --ci               # n 2000, 2
  python examples/sssp_distributed_torch.py --device cpu --world 4

Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
# the spawned ranks import ``rank_solve`` from this file by its module
# name: they start with this process's sys.path
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402


def graph(n: int, deg: float):
    from repro_torch.core import generators as gen
    return gen.gnp(n, avg_deg=deg, seed=0)


def rank_solve(rank: int, world: int, n: int, deg: float, device: str,
               source: int) -> dict:
    """One rank: builds the graph from the generator (no tensor crosses
    processes) and solves ``source`` through the distributed backend
    over the spawned group; host values back."""
    import torch

    from repro_torch.core.graph import build_graph
    from repro_torch.sssp import SP4_CONFIG, Solver
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    g = build_graph(*graph(n, deg), device=dev)
    solver = Solver(g, SP4_CONFIG, backend="distributed", device=dev)
    solver.solve(source)                     # first call: warm-up
    solver.collectives.reset()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(source)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(rank=solver.rank, world=solver.world,
                ms=(time.perf_counter() - t0) * 1e3,
                dist=res.dist.cpu().numpy(), rounds=res.rounds,
                all_reduces=solver.collectives.calls)


def solve_single(n: int, deg: float, device, source: int = 0):
    """The one-device segment solve: ``(result, ms)``."""
    import torch

    from repro_torch.core.graph import build_graph
    from repro_torch.sssp import SP4_CONFIG, Solver
    local = Solver(build_graph(*graph(n, deg), device=device), SP4_CONFIG,
                   backend="segment", device=device)
    local.solve(source)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    res = local.solve(source)
    sync()
    return res, (time.perf_counter() - t0) * 1e3


def solve_sharded(n: int, deg: float, world: int, device,
                  source: int = 0) -> list[dict]:
    """``rank_solve`` on ``world`` spawned gloo ranks, in rank order."""
    from repro_torch.distributed.ranks import spawn_ranks
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_ranks(rank_solve, world,
                           (n, deg, str(device), source), init_dir=tmp,
                           timeout=120, deadline=600)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default 20000, --ci 2000)")
    ap.add_argument("--deg", type=float, default=8.0)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default 8, --ci 2)")
    ap.add_argument("--ci", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.graph import resolve_device
    device = resolve_device(args.device)
    n = args.n or (2000 if args.ci else 20000)
    world = args.world or (2 if args.ci else 8)
    print(f"ranks: {world} (gloo, spawned) on {device}")
    single, t_single = solve_single(n, args.deg, device)
    ranks = solve_sharded(n, args.deg, world, device)
    want = single.dist.cpu().numpy()
    for r in ranks:
        if not np.array_equal(r["dist"], want) or r["world"] != world:
            raise AssertionError(
                f"rank {r['rank']} of {r['world']}: distributed must be "
                "bitwise identical to one device (min is associative)")
    reach = int(np.isfinite(want).sum())
    print(f"graph n={n} e~{int(n * args.deg)}: rounds={single.rounds}  "
          f"reachable={reach}/{n}, {ranks[0]['all_reduces']} all-reduces")
    print(f"single-device {t_single:.0f} ms | {world}-rank sharded "
          f"{max(r['ms'] for r in ranks):.0f} ms (gloo ranks on one "
          "host)")
    print("bitwise identical on every rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
