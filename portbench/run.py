#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one CUDA card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the cell's route on an earlier line and, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers ``correct`` compared, each with its limit (also
the last lines of standard error).  Exits non-zero, printing no result,
without enough CUDA cards, where the port (``src/repro_torch``) is
missing, or where a module of ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import bench, harness
    cell = bench.cell(args.workload, ROOT)
    import repro_torch.core.sssp.solver  # noqa: F401  (the port, or exit)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card: no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{cell.name} needs {cell.chips} cards, have "
                    f"{torch.cuda.device_count()}: no result")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules loaded that must not be: {found}: no result")
        return 3
    print(json.dumps(result), flush=True)
    print(harness.checks_text(result), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
