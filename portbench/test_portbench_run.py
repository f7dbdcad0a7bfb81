"""Whole runs of each cell on the CPU at a small size (the harness's look
for a card skipped): the last line's format, ``correct`` true on the
sound program, and false under each fault a cell can have, planted in
the program underneath the timed path."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import harness, traffic as mix

CELLS = ("kron.batch8", "rand4.batch32", "kron.roots1")
SECONDS = 0.5


def run(cell, seed=2**31 + 99, trace=False):
    return harness.run(cell, seed, SECONDS, trace, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_prints_the_contract_line(name, tiny):
    cell = tiny(name)
    res = run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {m.name for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert res["checks"]["mismatched_distances"] == {"value": 0, "limit": 0}
    line = json.loads(json.dumps(res))
    assert line == res
    assert "check mismatched_distances: 0 (limit 0)" in \
        harness.checks_text(res)


@pytest.mark.parametrize("name", CELLS)
def test_every_request_of_the_window_is_checked(name, tiny, monkeypatch):
    sent = []
    real = mix.send

    def send(solver, traffic, roots):
        sent.append(len(roots))
        return real(solver, traffic, roots)

    monkeypatch.setattr(mix, "send", send)
    res = run(tiny(name))
    assert res["attempted"] == len(sent) - 1        # the warm request
    assert res["checks"]["checked_lanes"]["value"] == sum(sent[1:])


def test_traced_run_reports_the_per_layer_counters(tiny):
    cell = tiny("kron.roots1")
    res = run(cell, trace=True)
    assert res["correct"] is True
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    # the CPU run has no device operations: the trace readers stay silent
    assert set(res["metrics"]) == {"layout_build_s",
                                   "rounds_per_request.latency",
                                   "host_reads_per_round.latency"}


def test_the_seed_fixes_the_requests_and_the_configuration_the_graph(tiny):
    cell = tiny("kron.batch8")
    a, b, c = harness.seeds(5), harness.seeds(5), harness.seeds(6)
    assert a == b and a != c and len(set(a.values())) == 2
    assert harness.seeds(2**33)["roots"] < 2**63
    cpu = torch.device("cpu")
    (n, src, _, _), cands = harness.make_inputs(cell, cpu)
    (_, src2, _, _), _ = harness.make_inputs(cell, cpu)
    assert (src == src2).all()     # graph_seed: one graph for every run
    reqs = [mix.Requests(cell.traffic, cands, np.random.default_rng(
        s["roots"])).next() for s in (a, b, c)]
    assert (reqs[0] == reqs[1]).all() and not (reqs[0] == reqs[2]).all()
    other = dataclasses.replace(cell, config={**cell.config,
                                              "graph_seed": 2})
    (_, src3, _, _), _ = harness.make_inputs(other, cpu)
    assert src3.shape != src.shape or not (src3 == src).all()


# --- faults, planted in the port -------------------------------------

def unchanged_step(monkeypatch):
    """Every round returns its state unchanged (the round count still
    advances, so the loop ends at its cap)."""
    from repro_torch.core.sssp import engine

    def dense(g, cfg, state, prims, warm=False):
        return dataclasses.replace(state, round=state.round + 1)

    def shared(g, cfg, state, f_idx, f_cnt, prims, sync, warm=False):
        return (dataclasses.replace(state, round=state.round + 1),
                torch.zeros_like(state.fixed))

    monkeypatch.setattr(engine, "_round", dense)
    monkeypatch.setattr(engine, "_round_shared", shared)


def half_batch(monkeypatch):
    """The second half of a batch's lanes solve the first half's
    sources instead of their own."""
    from repro_torch.core.sssp import solver
    orig = solver._solve

    def solve(g, cfg, sources, *args, **kw):
        b = sources.numel()
        s = sources.clone()
        s[b // 2:] = sources[:b - b // 2]
        return orig(g, cfg, s, *args, **kw)

    monkeypatch.setattr(solver, "_solve", solve)


def altered_answer(monkeypatch):
    """One distance of every request is one float32 step off."""
    from repro_torch.core.sssp import solver
    orig = solver._solve

    def solve(*args, **kw):
        state = orig(*args, **kw)
        D = state.D.clone()
        k = int(torch.nonzero(torch.isfinite(D[0]) & (D[0] > 0))[0])
        D[0, k] = torch.nextafter(D[0, k], torch.tensor(float("inf")))
        return dataclasses.replace(state, D=D)

    monkeypatch.setattr(solver, "_solve", solve)


FAULTS = {"unchanged_step": unchanged_step, "half_batch": half_batch,
          "altered_answer": altered_answer}
CASES = [(c, f) for c in CELLS for f in FAULTS
         if not (f == "half_batch" and c == "kron.roots1")]   # B = 1


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_makes_correct_false(name, fault, tiny, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run(tiny(name))
    assert res["correct"] is False
    assert res["checks"]["mismatched_distances"]["value"] > 0
    assert res["failed"] >= 1


HANGING = """
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench import conftest, harness
from repro_torch.core.sssp import solver
harness.HANG_GRACE_S = 1.0
real, calls = solver.Solver.solve_batch, []


def hang_after_warm_up(self, roots):
    calls.append(1)
    if len(calls) > 1:          # the window's first request never returns
        time.sleep(3600)
    return real(self, roots)


solver.Solver.solve_batch = hang_after_warm_up
harness.run(conftest.tiny_cell("kron.batch8"), 1, 0.2, False, device="cpu")
print("result")
"""


def test_an_answer_that_never_comes_ends_the_run_without_a_result():
    import os
    import subprocess
    import sys

    from portbench import bench
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = HANGING.format(root=str(bench.ROOT), src=str(bench.ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 4 and "result" not in p.stdout
    assert "did not return" in p.stderr
