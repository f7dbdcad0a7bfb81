#!/usr/bin/env python3
"""Time the SSSP main path of one checkout of the port on one CUDA card,
with nothing else in the process.

    python3 tools/sssp_route_times.py [--src DIR] [--reps 6] [--pallas]

Runs ``chip_smoke.py``'s main-path solves in its order and on its inputs:
the grid side 1024 through "auto" (``solve``, ``solve_batch`` of 8) and
its segment and pallas ``solve``, then gnp 2^20 through "auto" (segment)
and "pallas" (``solve``, ``solve_batch``).  There is no kernel phase and
no check, and only the ``Solver`` interface is used, so the same script
times two checkouts of the port (``--src``: a checkout's ``src``, by
default this one's).  The gnp segment ``solve_batch`` runs ``--reps``
times, then once more under torch.profiler for its device busy time.
``--pallas`` times the pallas route alone, on both graphs: ``solve`` and
``solve_batch`` of 8, each ``--reps`` times.  Prints the card's name and
power limit, then one line a solve: host-clock ms around work that ends
in a synchronize.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--pallas", action="store_true",
                    help="time only the pallas route, on both graphs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sssp_route_times: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch import sssp
    from repro_torch.core import generators as gen
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"src {Path(sssp.__file__).parents[1]}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"  {what}: {(time.perf_counter() - t0) * 1e3:.1f} ms",
              flush=True)

    if args.pallas:
        for what, make in (
                ("grid", lambda: gen.grid(cs.GRID_SIDE, seed=0)),
                ("gnp", lambda: gen.gnp(cs.GNP_N, avg_deg=8.0, seed=0))):
            n, src, dst, w = make()
            g = sssp.build_graph(n, src, dst, w, device=dev)
            batch = [int(s) for s in rng.choice(n, 8, replace=False)]
            solver = sssp.Solver(g, backend="pallas")
            for i in range(args.reps):
                timed(f"{what} pallas solve #{i + 1}",
                      lambda: solver.solve(batch[0]))
                timed(f"{what} pallas solve_batch #{i + 1}",
                      lambda: solver.solve_batch(batch))
            del solver, g
        return 0

    n, src, dst, w = gen.grid(cs.GRID_SIDE, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    batch = [int(s) for s in rng.choice(n, 8, replace=False)]
    solver = sssp.Solver(g, backend="auto")
    timed(f"grid {solver.backend} solve", lambda: solver.solve(batch[0]))
    timed(f"grid {solver.backend} solve_batch",
          lambda: solver.solve_batch(batch))
    for be in ("segment", "pallas"):
        other = sssp.Solver(g, backend=be)
        timed(f"grid {be} solve", lambda: other.solve(batch[0]))
    del solver, other, g

    n, src, dst, w = gen.gnp(cs.GNP_N, avg_deg=8.0, seed=0)
    g = sssp.build_graph(n, src, dst, w, device=dev)
    batch = [int(s) for s in rng.choice(n, 8, replace=False)]
    for be in ("auto", "pallas"):
        solver = sssp.Solver(g, backend=be)
        timed(f"gnp {solver.backend} solve", lambda: solver.solve(batch[0]))
        reps = args.reps if be == "auto" else 1
        for i in range(reps):
            timed(f"gnp {solver.backend} solve_batch #{i + 1}",
                  lambda: solver.solve_batch(batch))
        if be == "auto":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                timed(f"gnp {solver.backend} solve_batch, profiled",
                      lambda: solver.solve_batch(batch))
            busy = sum(cs._self_device_us(e)
                       for e in cs._device_events(prof)) / 1e3
            print(f"  gnp {solver.backend} solve_batch device busy: "
                  f"{busy:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
