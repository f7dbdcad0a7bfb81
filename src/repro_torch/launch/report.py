"""Tabulate the dry-run's records (port of ``repro/launch/report.py``).

``PYTHONPATH=src python -m repro_torch.launch.report`` prints the
dry-run matrix and the roofline tables (single-pod 16x16 and multi-pod
2x16x16) of ``experiments/dryrun_torch/*.json`` as markdown.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(out_dir: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_si(x) -> str:
    if x is None:
        return "-"
    for unit, div in (("P", 1e15), ("T", 1e12), ("G", 1e9), ("M", 1e6)):
        if abs(x) >= div:
            return f"{x / div:.2f}{unit}"
    return f"{x:.0f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | run s | args/chip | "
        "peak/chip | fits 80 GB | flops/chip | collective B/chip | "
        "bottleneck |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        ro = r.get("roofline", {})
        fits = ro.get("fits")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
            f"| {r.get('run_s', '-')} "
            f"| {fmt_bytes(r.get('argument_size_in_bytes'))} "
            f"| {fmt_bytes(r.get('peak_size_in_bytes'))} "
            f"| {'-' if fits is None else ('yes' if fits else 'no')} "
            f"| {fmt_si(ro.get('flops_per_chip'))} "
            f"| {fmt_bytes(ro.get('collective_bytes_per_chip'))} "
            f"| {ro.get('bottleneck', '-')} |")
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "single") -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | "
        "bottleneck | MODEL_FLOPS | useful ratio | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {ro['t_compute_s']:.4f}s | {ro['t_memory_s']:.4f}s "
            f"| {ro['t_collective_s']:.4f}s | **{ro['bottleneck']}** "
            f"| {fmt_si(ro['model_flops'])} "
            f"| {ro['useful_ratio']:.3f} "
            f"| {ro['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import OUT_DIR
    ap = argparse.ArgumentParser(prog="report")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    recs = load(args.out)
    ok = [r for r in recs if r.get("status") == "ok"]
    fail = [r for r in recs if r.get("status") != "ok"]
    print(f"## Dry-run matrix ({len(ok)} ok / {len(fail)} failed)\n")
    print(dryrun_table(recs))
    print("\n## Roofline on H100 (single-pod 16x16)\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline on H100 (multi-pod 2x16x16)\n")
    print(roofline_table(recs, "multi"))
    if fail:
        print("\n### Failures\n")
        for r in fail:
            print(f"- {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r.get('error', '?')[:300]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
