#!/usr/bin/env python3
"""The control of ``correct``: the reference in bfloat16, put in the
program's place, must come out not correct through a whole run at the
cell's own size.

    python3 portbench/control.py --workload kron.batch8 --seeds 1,2,3 \\
        --seconds 10

For each seed, one run of the cell as ``portbench/run.py`` makes it (the
set-up, the window at the cell's own load, the check), all seeds in one
process, with every request, the warm one too, answered by
``reference.distances(..., precision="bfloat16")`` on the benchmark's own
arrays instead of by the port.  Prints the run's ``correct``, its request
count and its ``checks`` as one JSON line a seed.  The benchmark's runs do
not run this; the CPU test runs it at a small size.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def in_programs_place(precision: str = "bfloat16"):
    """Within the block, ``harness.run`` answers every request by the
    reference in ``precision`` on the arrays the run generated."""
    import torch

    from portbench import harness, reference, traffic as mix
    made, sent = harness.make_inputs, mix.send
    graph = {}

    def make_inputs(cell, device):
        host, cands = made(cell, device)
        n, *arrays = host
        graph["arrays"] = (n, *(torch.from_numpy(a).to(device)
                                for a in arrays))
        return host, cands

    def send(solver, traffic, roots):
        n, s, d, w = graph["arrays"]
        return reference.distances(n, s, d, w, roots,
                                   precision=precision), 0, 0

    harness.make_inputs, mix.send = make_inputs, send
    try:
        yield
    finally:
        harness.make_inputs, mix.send = made, sent


def run(cell, seed: int, seconds: float, device) -> dict:
    """One run of ``cell`` with the control in the program's place."""
    from portbench import harness
    with in_programs_place():
        return harness.run(cell, seed, seconds, False, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import bench
    cell = bench.cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run(cell, seed, args.seconds, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
