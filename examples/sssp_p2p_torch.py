"""Goal-directed queries walkthrough on the PyTorch/CUDA port: landmarks +
early-exit solves.

A navigation-style workload: preprocess a few landmarks once, then
answer point-to-point queries without paying for full single-source
fixpoints: the landmark tables seed the engine's lower bounds (the lb
rule fixes vertices rounds earlier) and the solve early-exits the moment
the target's distance is certified exact.  Streams a weight delta at the
end to show the index riding the dynamic subsystem.

  python examples/sssp_p2p_torch.py --family geometric --n 1600
  python examples/sssp_p2p_torch.py --ci        # n = 400, 4 landmarks
  python examples/sssp_p2p_torch.py --device cpu

Runs on CUDA unless ``--device`` names another device.  ``main(argv)``
returns the exit code; ``run(args)`` returns the answers it checked.
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
    ap.add_argument("--family", default="geometric", choices=FAMILIES)
    ap.add_argument("--n", type=int, default=None,
                    help="vertices (default 1600, --ci 400)")
    ap.add_argument("--landmarks", type=int, default=None,
                    help="landmarks (default 8, --ci 4)")
    ap.add_argument("--queries", type=int, default=None,
                    help="solver queries (default 6, --ci 3)")
    ap.add_argument("--backend", default="segment")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ci", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.n = args.n or (400 if args.ci else 1600)
    args.landmarks = args.landmarks or (4 if args.ci else 8)
    args.queries = args.queries or (3 if args.ci else 6)
    return args


def run(args, log=print) -> dict:
    """The walkthrough; returns ``landmarks``, ``pairs`` (``(s, t,
    full dist[t], seeded dist[t])`` per solver query), ``full`` (the
    untargeted distance vectors, numpy) and ``served`` (the service's
    answers, the post-delta one last)."""
    from repro_torch.core import generators as gen
    from repro_torch.core.graph import HostGraph, resolve_device
    from repro_torch.runtime.sssp_service import Query, SSSPService
    from repro_torch.sssp import LandmarkIndex, Solver, random_delta

    device = resolve_device(args.device)
    n, src, dst, w = gen.make(args.family, args.n, seed=args.seed)
    hg = HostGraph(n, src, dst, w)
    log(f"graph: {args.family} n={n} e={hg.e} on {device}")

    # --- 1. raw Solver API: full vs targeted vs seeded ----------------
    g = hg.to_device(device)
    solver = Solver(g, backend=args.backend, device=device)
    index = LandmarkIndex(g, args.landmarks, backend=args.backend,
                          seed=args.seed)
    log(f"landmarks: {index.landmarks.tolist()}")

    rng = np.random.default_rng(args.seed)
    pairs, full_dists = [], []
    for _ in range(args.queries):
        s = int(rng.integers(n))
        d = solver.solve(s).dist.cpu().numpy()
        reach = np.flatnonzero(np.isfinite(d) & (d > 0))
        if not reach.size:
            continue
        t = int(rng.choice(reach))
        full = solver.solve(s)
        exit_ = solver.solve(s, target=t)
        seed_ = solver.solve(s, target=t, C0=index.seed(s))
        want = float(full.dist[t])
        if float(exit_.dist[t]) != want or float(seed_.dist[t]) != want:
            raise AssertionError(f"({s} -> {t}): targeted "
                                 f"{float(exit_.dist[t])}, seeded "
                                 f"{float(seed_.dist[t])}, full {want}")
        path = seed_.path_to(t)
        log(f"  ({s:>5} -> {t:>5})  dist={want:.4f}  "
            f"rounds: full={full.rounds} exit={exit_.rounds} "
            f"seeded={seed_.rounds}  path_len={len(path) if path else 0}")
        pairs.append((s, t, want, float(seed_.dist[t])))
        full_dists.append(full.dist.cpu().numpy())
    log(f"all modes share one Solver ({solver.solves} sources solved)")

    # --- 2. the service: Query(target=t) takes the fast path ----------
    service = SSSPService(hg.to_device(device), backend=args.backend,
                          batch=4, landmarks=args.landmarks, device=device)
    queries = [Query(source=int(rng.integers(n)),
                     target=int(rng.integers(n))) for _ in range(12)]
    service.serve(queries)
    log(f"service: {service.stats['p2p_solves']} targeted solves for "
        f"{len(queries)} queries, {service.stats['cache_hits']} hits")

    # a weight delta: landmark tables warm-refresh as k more sources
    delta = random_delta(service.solver.graph, max(1, hg.e // 100),
                         seed=args.seed + 1)
    st = service.apply_delta(delta)
    q = Query(source=queries[0].source, target=queries[0].target)
    service.serve([q])
    log(f"post-delta (v{service.version}, warm-refreshed "
        f"{st['warm_refreshed']} incl. landmarks): "
        f"dist={q.distance:.4f}  seeding live={service.landmarks.seed_ok}")
    return dict(landmarks=index.landmarks.tolist(), pairs=pairs,
                full=full_dists,
                served=[x.distance for x in queries] + [q.distance])


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
