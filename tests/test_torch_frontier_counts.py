"""The port's frontier route reproduces the work counts the reference
recorded in ``experiments/bench/frontier.json`` (``bench_frontier``, last
entry): cold rounds and edges relaxed from sources 0, 3, 9 and the
batched edges relaxed from sources 0, 3, 9, 17 on the n = 2000
generator graphs at the default cap.  The counts depend only on graph,
sources and cap, so they must match exactly."""
import json
import pathlib

import numpy as np
import pytest

import repro_torch.sssp as P
from repro_torch.core import generators as gen
from test_torch_graph import _one_torch_thread  # noqa: F401

RECORD = (pathlib.Path(__file__).resolve().parents[1] / "experiments"
          / "bench" / "frontier.json")


def _rows():
    return {r["family"]: r for r in json.loads(RECORD.read_text())[-1]["rows"]}


@pytest.mark.parametrize("family", ["chain", "grid", "gnp", "geometric"])
def test_frontier_counts_match_recorded_reference(family):
    row = _rows()[family]
    nn, src, dst, w = gen.make(family, 2000, seed=0)
    g = P.build_graph(nn, src, dst, w, device="cpu")
    solver = P.Solver(g, backend="frontier", device="cpu")
    assert (g.n, g.e_pad, solver.frontier_cap, solver.csr.max_out_deg) == (
        row["n"], row["e_pad"], row["cap"], row["max_out_deg"])
    cold = [solver.solve(s % nn) for s in (0, 3, 9)]
    assert int(np.mean([r.rounds for r in cold])) == row["rounds_cold"]
    assert sum(r.edges_relaxed for r in cold) == row["edges_frontier"]
    batch = solver.solve_batch([s % nn for s in (0, 3, 9, 17)])
    assert int(np.sum(batch.edges_relaxed)) == row["edges_frontier_batched"]
