#!/usr/bin/env python3
"""Run cells of the benchmark in sets, one process a run, and report the
spread of each metric.

    python3 portbench/sets.py --workload kron.batch8 --seeds 11,12,13 \\
        --repeat 2 --seconds 30 [--trace 0|1] [--out chiprun_out/runs.jsonl]

For each workload, ``--repeat`` sets run one after another, each of one
run a seed; every run is ``portbench/run.py`` in a process of its own,
as the benchmark's command runs.  Each run's result line (or its exit
code and the end of its standard error) is appended to ``--out``.  Then,
for each metric of each set: the median and the spread, the distance
between the first and third quartiles (``statistics.quantiles(values,
n=4)``) as a share of the median; and the widest spread over the sets.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values) -> float:
    """Interquartile distance over the median (0 for fewer than two)."""
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def trimmed_spread(values) -> float:
    """The spread with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"),
           "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": p.returncode, "wall_s": time.perf_counter() - t,
           "stderr_tail": p.stderr[-3000:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
        rec["earlier"] = lines[:-1][-3:]
    return rec


def report(workload: str, sets: list[list[dict]]) -> None:
    names = sorted({k for s in sets for r in s if "result" in r
                    for k in r["result"]["metrics"]})
    for name in names:
        cols = [[r["result"]["metrics"][name]["value"] for r in s
                 if "result" in r and name in r["result"]["metrics"]]
                for s in sets]
        line = []
        for vals in cols:
            if vals:
                line.append(f"median {statistics.median(vals):.6g} spread "
                            f"{spread(vals):.4f} (trimmed "
                            f"{trimmed_spread(vals) if len(vals) > 2 else 0:.4f})")
        widest = max((spread(v) for v in cols if v), default=0.0)
        print(f"  {workload} {name}: " + " | ".join(line)
              + f" | widest {widest:.4f}, 5x {5 * widest:.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each in a set")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "runs.jsonl"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    for w in args.workload:
        sets = []
        for rep in range(args.repeat):
            runs = []
            for seed in seeds:
                rec = one(w, seed, args.seconds, args.trace)
                rec["set"] = rep
                runs.append(rec)
                with out.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
                res = rec.get("result")
                bad += res is None or not res["correct"]
                print(f"{w} set {rep} seed {seed}: rc {rec['rc']} wall "
                      f"{rec['wall_s']:.1f} s "
                      + (json.dumps({k: v["value"] for k, v in
                                     res["metrics"].items()})
                         + f" correct {res['correct']} attempted "
                         f"{res['attempted']} peak "
                         f"{res['device']['memory_peak_bytes']}"
                         if res else rec["stderr_tail"][-1500:]),
                      flush=True)
            sets.append(runs)
        report(w, sets)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
