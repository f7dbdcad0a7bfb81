"""SSSP serving launcher: batched shortest-path queries over one graph
(port of ``repro/launch/serve_sssp.py``, the same flags plus
``--device``).

  python -m repro_torch.launch.serve_sssp --family gnp --n 5000 \\
      --queries 256 --batch 8 --backend segment
  python -m repro_torch.launch.serve_sssp --device cpu --n 1500 \\
      --queries 64 --verify

Generates a graph, stands up the continuous-batching
:class:`~repro_torch.runtime.sssp_service.SSSPService` on ``--device``
(default ``cuda``), fires a synthetic query stream with a repeated-source
distribution (a pool of ``--hot-sources`` popular origins, uniform
targets), and reports queries/sec, batch count and cache hit rate.
``--verify`` re-checks up to 16 answers of the final wave against the
port's host Dijkstra on the current graph version and exits 1 on a
mismatch.

``--deltas K`` interleaves K random weight deltas (``--delta-edges``
edges each) between query waves; ``--landmarks K`` builds a K-landmark
index and routes scalar-target queries through seeded targeted solves;
``--planner`` turns on the cost-based wave planner, ``--bidirectional``
attaches the meet-in-the-middle solver, and ``--reselect-threshold T``
re-selects landmarks when seed tightness drops below T.
``--backend distributed`` shards the edges over the default process
group when the caller initialized one (every rank runs the launcher
with the same flags), else over a world of one.

``main(argv)`` returns the exit code, so the launcher can also be run in
process.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve_sssp")
    ap.add_argument("--family", default="gnp",
                    choices=["gnp", "dag", "unweighted", "grid",
                             "power_law", "chain", "geometric"])
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--hot-sources", type=int, default=32,
                    help="size of the popular-origin pool queries draw from")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "segment", "ell", "pallas",
                             "distributed", "frontier"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--deltas", type=int, default=0,
                    help="weight deltas interleaved between query waves")
    ap.add_argument("--delta-edges", type=int, default=None,
                    help="edges per delta (default: 1%% of edges)")
    ap.add_argument("--landmarks", type=int, default=0,
                    help="landmark count for the goal-directed fast path "
                         "(0 = full solves)")
    ap.add_argument("--planner", action="store_true",
                    help="cost-based wave planner: route each wave's "
                         "misses to cache/targeted/bidirectional/full")
    ap.add_argument("--bidirectional", action="store_true",
                    help="attach the meet-in-the-middle point-to-point "
                         "solver (the planner's 'bidirectional' route; "
                         "without --planner, every scalar-target miss)")
    ap.add_argument("--reselect-threshold", type=float, default=None,
                    help="re-select landmark positions when mean seed "
                         "tightness drops below this (needs --landmarks)")
    ap.add_argument("--device", default="cuda",
                    help="where the service runs (cuda or cpu)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.core import generators as gen
    from repro_torch.core.graph import HostGraph
    from repro_torch.runtime.sssp_service import Query, SSSPService
    from repro_torch.sssp import random_delta

    n, src, dst, w = gen.make(args.family, args.n, seed=args.seed)
    hg = HostGraph(n, src, dst, w)
    print(f"graph: {args.family} n={n} e={hg.e}  backend={args.backend}  "
          f"device={args.device}")

    service = SSSPService(hg.to_device(args.device), backend=args.backend,
                          batch=args.batch,
                          landmarks=args.landmarks or None,
                          planner=args.planner,
                          bidirectional=args.bidirectional,
                          reselect=args.reselect_threshold,
                          device=args.device)
    rng = np.random.default_rng(args.seed)
    hot = rng.choice(n, size=min(args.hot_sources, n), replace=False)
    queries = [Query(source=int(rng.choice(hot)),
                     target=int(rng.integers(0, n)))
               for _ in range(args.queries)]

    waves = max(1, args.deltas + 1)
    per_wave = -(-len(queries) // waves)   # ceil: exactly `waves` waves
    t0 = time.time()
    final_wave: list[Query] = queries
    for i in range(0, len(queries), per_wave):
        wave = queries[i: i + per_wave]
        service.serve(wave)
        final_wave = wave
        if args.deltas and i + per_wave < len(queries):
            k = (max(1, hg.e // 100) if args.delta_edges is None
                 else args.delta_edges)
            dstats = service.apply_delta(
                random_delta(service.solver.graph, k,
                             seed=args.seed + 31 * i))
            print(f"  delta v{service.version}: {k} edges, "
                  f"warm-refreshed {dstats['warm_refreshed']} hot sources "
                  f"in <= {max(dstats['warm_rounds'] or [0])} rounds "
                  f"({dstats['sweeps']} taint sweeps)")
    dt = time.time() - t0

    st = service.stats
    answered = sum(q.done for q in queries)
    reachable = sum(q.path is not None for q in queries)
    print(f"answered {answered} queries in {dt:.2f}s "
          f"({answered / dt:.1f} queries/s)")
    print(f"  solve batches: {st['batches']}  sources solved: "
          f"{st['sources_solved']}  targeted solves: {st['p2p_solves']}  "
          f"cache hits: {st['cache_hits']}  deltas: {st['deltas']}")
    print(f"  device solve time: {st['solve_seconds']:.2f}s  "
          f"reachable targets: {reachable}/{answered}")
    routes = st["planner_routes"]
    tight = st["seed_tightness_mean"]
    print(f"stats: routes cache={routes['cache']} "
          f"targeted={routes['targeted']} "
          f"bidirectional={routes['bidirectional']} full={routes['full']}  "
          f"bidi_solves={st['bidi_solves']} reselects={st['reselects']}  "
          f"seed_tightness_mean="
          f"{'n/a' if tight is None else f'{tight:.3f}'}")

    if args.verify:
        # verify against the CURRENT (post-delta) graph version; only the
        # final wave's answers are guaranteed to reflect it.
        from repro_torch.core.sssp.reference import dijkstra
        hg_now = service.solver.graph.to_host()
        bad = 0
        for q in final_wave[:16]:
            exp = dijkstra(hg_now, source=q.source).dist[q.target]
            got = q.distance if q.distance is not None else float("inf")
            exp = exp if np.isfinite(exp) else float("inf")
            if not np.isclose(got, exp, rtol=1e-5, atol=1e-4):
                bad += 1
        print(f"  verified {min(len(final_wave), 16)} answers against "
              f"dijkstra: {'OK' if bad == 0 else f'{bad} MISMATCHES'}")
        if bad:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
