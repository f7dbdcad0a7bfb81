"""Quickstart on the PyTorch/CUDA port: the paper's four algorithms on one
graph.

  python examples/quickstart_torch.py [--n 2000] [--family gnp]
  python examples/quickstart_torch.py --ci             # n = 300
  python examples/quickstart_torch.py --device cpu

Runs the sequential references (heap-op counters), the bulk-synchronous
engine in SP1..SP4 configurations (rounds + per-rule attribution),
verifies everything against Dijkstra, and extracts one shortest path.
Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


def configs():
    """The engine configurations the example runs, by name."""
    from repro_torch.sssp import SP1_RULES, SP2_RULES, SP3_RULES, SSSPConfig
    return {
        "SP1": SSSPConfig(rules=SP1_RULES),
        "SP2": SSSPConfig(rules=SP2_RULES),
        "SP3": SSSPConfig(rules=SP3_RULES),
        "SP4": SSSPConfig(rules=SP3_RULES, label_correcting=True),
        "SP4+cprop4": SSSPConfig(rules=SP3_RULES, label_correcting=True,
                                 c_prop_iters=4),
    }


def engine_runs(g, device) -> dict:
    """``{name: SSSPResult}``: source 0 through ``Solver(g, cfg)`` (backend
    "auto") for every configuration of ``configs()``."""
    from repro_torch.sssp import Solver
    return {name: Solver(g, cfg, device=device).solve(0)
            for name, cfg in configs().items()}


def _close(got, want) -> bool:
    got = np.asarray(got, np.float64)
    return np.allclose(np.where(np.isinf(got), 1e18, got),
                       np.where(np.isinf(want), 1e18, want),
                       rtol=1e-5, atol=1e-4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default 2000, --ci 300)")
    ap.add_argument("--family", default="gnp", choices=FAMILIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ci", action="store_true", help="small graph (n=300)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import generators as gen
    from repro_torch.core.graph import HostGraph, resolve_device
    from repro_torch.sssp import Solver, dijkstra, sp1, sp2, sp3

    device = resolve_device(args.device)
    n = args.n or (300 if args.ci else 2000)
    n, src, dst, w = gen.make(args.family, n, seed=args.seed)
    hg = HostGraph(n, src, dst, w)
    g = hg.to_device(device)
    print(f"graph: {args.family} n={n} e={hg.e} on {device}\n")

    print("sequential references (heap ops | outer rounds | max |R|):")
    base = None
    for name, algo in (("dijkstra", dijkstra), ("SP1", sp1),
                       ("SP2", sp2), ("SP3", sp3)):
        r = algo(hg)
        if base is None:
            base = r.dist
        if not _close(r.dist, base):
            raise AssertionError(f"{name} disagrees with Dijkstra")
        print(f"  {name:9s} heap_ops={r.heap_ops:7d} "
              f"rounds={r.stats['rounds']:5d} "
              f"maxR={r.stats['max_frontier']:5d}")

    print(f"\nbulk-synchronous engine on {device} (rounds | fixed-by-rule):")
    for name, res in engine_runs(g, device).items():
        if not _close(res.dist.cpu().numpy(), base):
            raise AssertionError(f"{name} disagrees with Dijkstra")
        print(f"  {name:11s} rounds={res.rounds:4d}  "
              f"(Dijkstra needs {n})  fixed_by={res.fixed_by}")

    # one Solver, many sources: the layouts are built once, and a batch
    # of sources is one run of the round loop
    solver = Solver(g, configs()["SP4"], device=device)
    res = solver.solve(0)
    dist = res.dist.cpu().numpy()
    far = int(np.argmax(np.where(np.isinf(dist), -1, dist)))
    path = res.path_to(far)
    print(f"\nfarthest vertex {far}: cost={dist[far]:.4f} "
          f"path({len(path)} hops)={path[:8]}"
          f"{'...' if len(path) > 8 else ''}")

    sources = list(range(0, n, max(n // 8, 1)))[:8]
    batch = solver.solve_batch(sources)
    got = batch.dist.cpu().numpy()
    for i, s in enumerate(sources):
        if not _close(got[i], dijkstra(hg, source=s).dist):
            raise AssertionError(f"solve_batch lane {i} (source {s}) "
                                 "disagrees with Dijkstra")
    print(f"solve_batch({len(sources)} sources): rounds per source = "
          f"{batch.rounds.tolist()}  (sources solved: {solver.solves}; "
          f"host reads of the batch: {batch.host_syncs})")
    print("\nall configurations agree with Dijkstra.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
