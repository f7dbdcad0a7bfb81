"""The contract gate: ``python -m repro_torch.analysis.check --ci``
(port of ``repro/analysis/check.py``).

Runs every program check over the port and writes
``experiments/analysis/contracts_torch.json``:

  1. imports the governed modules (their ``@contract`` decorators fill
     the registry), runs and records every solver route on the probe
     graph (``routes.build_routes``) on ``--device`` (cuda, the default
     as for every entry point of the port: it raises without a card, and
     runs every route under torch's sync debug mode "error"; or cpu),
     and verdicts each against the declared
     contracts (``op_lint``);
  2. audits the waiver list: an *expired* waiver lets its violation
     FAIL, a *stale* one (matches nothing: the gap was fixed) fails the
     gate until it is deleted;
  3. checks composition contracts (the service has no rounds of its
     own: it rides solver routes, which must exist and not FAIL);
  4. runs the AST rules over the round scopes (``astlint``);
  5. runs ruff over ``src/repro_torch``, ``tests/test_torch_*.py`` and
     ``examples/*_torch.py`` when ruff is installed.  Ruff output is
     ADVISORY: recorded in the JSON and printed, never gating.

``--mutate host_sync`` / ``--mutate f64`` seed a defect into a copy of a
real round (an ``.item()`` in it; a float64 value in it) and MUST make
the gate exit non-zero; the tests pin that.

Exit status: 0 iff every route is PASS or KNOWN_VIOLATION, no stale or
expired waivers, no AST findings, and composition holds.
"""
from __future__ import annotations

import argparse
import datetime
import json
import shutil
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis import astlint
from repro_torch.analysis.contracts import KNOWN_VIOLATIONS, REGISTRY
from repro_torch.analysis.op_lint import LintReport, Recorder, lint_route
from repro_torch.analysis.routes import (PROBE, PROBE_EDGE_PAD, Route,
                                         build_routes)


def _repo_root() -> Path:
    # src/repro_torch/analysis/check.py -> the checkout's root
    return Path(__file__).resolve().parents[3]


def _import_governed_modules() -> None:
    """Populate the contract registry: specs live next to the code."""
    import repro_torch.core.sssp.backends    # noqa: F401
    import repro_torch.core.sssp.bidirectional  # noqa: F401
    import repro_torch.core.sssp.dynamic     # noqa: F401
    import repro_torch.core.sssp.engine      # noqa: F401
    import repro_torch.core.sssp.fleet       # noqa: F401
    import repro_torch.core.sssp.solver      # noqa: F401
    import repro_torch.runtime.sssp_service  # noqa: F401


def _mutant_route(kind: str, device) -> Route:
    """Seed a defect into a copy of the segment cold route's round.

    ``host_sync``: the round reads its result's minimum with ``.item()``
    (an uncounted host read).  ``f64``: the round makes its distances
    float64 (and back).  Both must FAIL the gate.  The copy stands in for
    ``engine._round`` for this one recorded solve (under the recorder's
    round scope) and the real round is restored after it.
    """
    import torch

    from repro_torch.analysis.routes import _probe_graph
    from repro_torch.core.graph import build_graph, resolve_device
    from repro_torch.core.sssp import engine
    from repro_torch.core.sssp.solver import Solver

    if kind not in ("host_sync", "f64"):
        raise SystemExit(f"unknown mutation {kind!r} "
                         "(choose: host_sync, f64)")
    dev = resolve_device(device)
    nn, src, dst, w = _probe_graph()
    g = build_graph(nn, src, dst, w, edge_pad_multiple=PROBE_EDGE_PAD,
                    device=dev)
    real_round = engine._round

    def bad_round(g, cfg, state, prims, warm=False):
        out = real_round(g, cfg, state, prims, warm)
        if kind == "host_sync":
            out.D.min().item()
        else:
            out.D = out.D.to(torch.float64).to(torch.float32)
        return out

    engine._round = bad_round       # under the recorder's round scope
    try:
        with Recorder() as rec:
            sv = Solver(g, backend="segment", device=dev)
            with rec.record() as trace:
                sv.solve(0)
    finally:
        engine._round = real_round
    return Route(f"mutant.{kind}", trace, frozenset({g.e_pad}),
                 dict(n=nn, e_pad=g.e_pad, mutation=kind))


def _waiver_status(report: LintReport) -> list[dict]:
    """active / stale / expired verdict for every declared waiver."""
    used = {
        (v.waiver.route, v.waiver.rule)
        for rv in report.routes.values() for v in rv.violations
        if v.waiver is not None
    }
    out = []
    for w in KNOWN_VIOLATIONS:
        if w.expired():
            status = "expired"
        elif (w.route, w.rule) in used:
            status = "active"
        else:
            status = "stale"
        out.append(dict(route=w.route, rule=w.rule, reason=w.reason,
                        expires=w.expires, status=status))
    return out


def _check_compositions(report: LintReport) -> list[str]:
    """Composition contracts: every composed route pattern must match
    at least one linted route, and none of the matches may FAIL."""
    from fnmatch import fnmatch
    problems = []
    for spec in REGISTRY.values():
        for pat in spec.composes:
            hits = [r for r in report.routes if fnmatch(r, pat)]
            if not hits:
                problems.append(
                    f"[{spec.name}] composes {pat!r} but no such route "
                    "was run — the surface rides a route that no longer "
                    "exists")
            for r in hits:
                if report.routes[r].verdict == "FAIL":
                    problems.append(
                        f"[{spec.name}] composed route {r} FAILED")
    return problems


def _run_ruff(root: Path) -> dict:
    exe = shutil.which("ruff")
    if exe is None:
        return dict(available=False, ok=True,
                    note="ruff not installed; skipped")
    targets = (["src/repro_torch"]
               + sorted(str(p.relative_to(root)) for p in
                        (root / "tests").glob("test_torch_*.py"))
               + sorted(str(p.relative_to(root)) for p in
                        (root / "examples").glob("*_torch.py")))
    proc = subprocess.run([exe, "check", *targets], cwd=root,
                          capture_output=True, text=True)
    return dict(available=True, ok=proc.returncode == 0,
                output=(proc.stdout + proc.stderr).strip()[-4000:])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="program-contract gate over every solver route")
    ap.add_argument("--ci", action="store_true",
                    help="write contracts_torch.json and use the exit "
                         "status as the gate (also the default behavior; "
                         "the flag documents intent in workflows)")
    ap.add_argument("--device", default="cuda",
                    help="where the routes run: cuda (the default; raises "
                         "without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default "
                         "experiments/analysis/contracts_torch.json)")
    ap.add_argument("--routes", nargs="*", default=["*"],
                    help="fnmatch patterns selecting routes to lint")
    ap.add_argument("--mutate", choices=("host_sync", "f64"),
                    help="seed a defect into a copy of a round; the gate "
                         "MUST fail (mutation-tests the linter)")
    ap.add_argument("--no-astlint", action="store_true")
    ap.add_argument("--no-ruff", action="store_true")
    args = ap.parse_args(argv)

    root = _repo_root()
    _import_governed_modules()

    full_sweep = args.routes == ["*"] and args.mutate is None
    if args.mutate:
        # mutation runs lint the mutant alone: fast and exact
        mut = _mutant_route(args.mutate, args.device)
        routes = {mut.name: mut}
    else:
        routes = build_routes(args.device, include=tuple(args.routes))

    verdicts = {name: lint_route(name, route.trace,
                                 dense_dims=route.dense_dims)
                for name, route in sorted(routes.items())}
    report = LintReport(verdicts)

    waivers = _waiver_status(report) if full_sweep else []
    comp_problems = _check_compositions(report) if full_sweep else []
    findings = [] if args.no_astlint else astlint.run(root)
    ruff = dict(available=False, ok=True, note="skipped (--no-ruff)") \
        if args.no_ruff else _run_ruff(root)

    bad_waivers = [w for w in waivers if w["status"] != "active"]
    failed = report.failed
    # ruff is ADVISORY: its findings land in the JSON and the console but
    # do not flip the exit code
    ok = (not failed and not bad_waivers and not comp_problems
          and not findings)

    doc = dict(
        generated=datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        gate="pass" if ok else "fail",
        device=args.device,
        probe=dict(PROBE, edge_pad=PROBE_EDGE_PAD),
        routes=report.to_json(),
        summary=dict(
            routes=len(report.routes),
            passed=sum(1 for v in report.routes.values()
                       if v.verdict == "PASS"),
            known_violations=len(report.waived),
            failed=len(failed),
        ),
        waivers=waivers,
        composition=comp_problems,
        astlint=[f.format() for f in findings],
        ruff=ruff,
    )

    default_name = ("contracts_torch.json" if args.mutate is None
                    else f"contracts_torch.mutant-{args.mutate}.json")
    out = Path(args.out) if args.out else (
        root / "experiments" / "analysis" / default_name)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")

    # ---- human summary ------------------------------------------------
    for name, v in sorted(report.routes.items()):
        flag = {"PASS": "ok ", "KNOWN_VIOLATION": "KV ",
                "FAIL": "FAIL"}[v.verdict]
        budget = ("-" if v.dense_budget is None
                  else f"{v.dense_passes}/{v.dense_budget}")
        reads = ("-" if v.read_budget is None
                 else f"{v.host_reads}/{v.read_budget}")
        launches = " ".join(f"{k} {n}" for k, n in sorted(v.launches.items()))
        print(f"  [{flag}] {name:<24} rounds {v.rounds:<3} dense {budget:<5}"
              f" reads {reads:<4} ops {v.round_ops:<4}"
              + (f" launches {launches}" if launches else ""))
        for viol in v.violations:
            mark = "waived" if viol.waiver else "VIOLATION"
            print(f"         {mark}: {viol.rule} — {viol.detail}")
    for w in bad_waivers:
        print(f"  [FAIL] waiver {w['route']}/{w['rule']} is {w['status']}"
              + (" — the excused gap was fixed; delete the waiver"
                 if w["status"] == "stale" else
                 " — fix the gap or renew the expiry"))
    for p in comp_problems:
        print(f"  [FAIL] composition: {p}")
    for f in findings:
        print(f"  [FAIL] astlint: {f.format()}")
    if ruff["available"] and not ruff["ok"]:
        print("  [warn] ruff (advisory, does not gate):\n"
              + ruff.get("output", ""))
    elif not ruff["available"]:
        print("  [skip] " + ruff.get("note", "ruff unavailable"))
    print(f"contract gate: {'PASS' if ok else 'FAIL'} "
          f"({doc['summary']['passed']} pass, "
          f"{doc['summary']['known_violations']} known-violation, "
          f"{doc['summary']['failed']} fail) -> {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
