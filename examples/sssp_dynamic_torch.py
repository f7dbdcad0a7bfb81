"""Dynamic-graph walkthrough on the PyTorch/CUDA port: streaming weight
updates, warm re-solve.

A road-network-style serving loop: solve once, then stream weight
deltas (congestion) and watch the warm-started engine repair the
solution in a handful of rounds instead of re-paying the cold round
count, and the query service answer against the newest graph version
throughout.

  python examples/sssp_dynamic_torch.py --family grid --n 1600
  python examples/sssp_dynamic_torch.py --ci           # n = 400, 2 deltas
  python examples/sssp_dynamic_torch.py --device cpu

Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code; ``run(args)`` returns the distances it checked.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="grid", choices=FAMILIES)
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default 1600, --ci 400)")
    ap.add_argument("--deltas", type=int, default=None,
                    help="deltas streamed (default 5, --ci 2)")
    ap.add_argument("--delta-edges", type=int, default=None,
                    help="edges touched per delta (default: 1%% of edges)")
    ap.add_argument("--backend", default="segment")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ci", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.n = args.n or (400 if args.ci else 1600)
    args.deltas = args.deltas if args.deltas is not None else (
        2 if args.ci else 5)
    return args


def run(args, log=print) -> dict:
    """The walkthrough; returns ``sources``, the warm and cold distances
    on the final graph (``warm``, ``cold``: numpy [3, n]) and the
    service's post-delta answer (``served``: distance and path)."""
    from repro_torch.core import generators as gen
    from repro_torch.core.graph import HostGraph, resolve_device
    from repro_torch.runtime.sssp_service import Query, SSSPService
    from repro_torch.sssp import DynamicSolver, Solver, random_delta

    device = resolve_device(args.device)
    n, src, dst, w = gen.make(args.family, args.n, seed=args.seed)
    hg = HostGraph(n, src, dst, w)
    log(f"graph: {args.family} n={n} e={hg.e} on {device}")

    # --- 1. the DynamicSolver: solve once, then stream deltas ---------
    dyn = DynamicSolver(hg.to_device(device), backend=args.backend,
                        device=device)
    sources = [0, n // 3, (2 * n) // 3]
    base = dyn.solve_batch(sources)
    log(f"cold solve: rounds={base.rounds.tolist()}")

    k = args.delta_edges or max(1, hg.e // 100)
    for step in range(args.deltas):
        delta = random_delta(dyn.graph, k, seed=args.seed + 7 * step,
                             lo=0.5, hi=2.0)
        stats = dyn.update(delta)
        cold_rounds = Solver(dyn.graph, backend=args.backend,
                             device=device).solve(sources[0]).rounds
        log(f"delta {step}: {stats['edges_changed']} edges "
            f"(+{stats['increased']}/-{stats['decreased']})  "
            f"taint sweeps={stats['sweeps']}  "
            f"tainted={stats['tainted']}  "
            f"warm rounds={stats['warm_rounds']} vs cold {cold_rounds}  "
            f"(graph v{dyn.version}, host reads {stats['host_syncs']})")

    # warm answers == cold answers on the final graph, bit for bit
    warm = dyn.resolve(sources).dist.cpu().numpy()
    cold = Solver(dyn.graph, backend=args.backend,
                  device=device).solve_batch(sources).dist.cpu().numpy()
    if not np.array_equal(warm, cold):
        raise AssertionError("warm distances differ from a cold solve")
    log("warm distances match a cold solve on the mutated graph exactly")

    # --- 2. the serving loop: deltas mid-traffic ----------------------
    service = SSSPService(hg.to_device(device), backend=args.backend,
                          batch=4, device=device)
    rng = np.random.default_rng(args.seed)
    hot = [int(s) for s in rng.choice(n, size=4, replace=False)]
    service.serve([Query(source=s, target=int(rng.integers(0, n)))
                   for s in hot for _ in range(4)])
    st = service.apply_delta(random_delta(service.solver.graph, k, seed=123))
    log(f"service delta: warm-refreshed {st['warm_refreshed']} hot "
        f"sources (version {service.version}); stale tail re-solves "
        "lazily")
    q = Query(source=hot[0], target=int(rng.integers(0, n)))
    service.serve([q])
    log(f"post-delta query answered: dist={q.distance:.4f} "
        f"path_len={len(q.path) if q.path else None}  "
        f"stats={ {x: service.stats[x] for x in ('queries', 'batches', 'cache_hits', 'deltas')} }")
    return dict(sources=sources, warm=warm, cold=cold,
                served=(q.distance, q.path))


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
