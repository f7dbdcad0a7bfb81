"""Bellman-Ford baseline (port of ``repro/core/sssp/bellman_ford.py``),
the paper's label-correcting comparison point.

Pure bulk-synchronous: every round relaxes every edge whose source is
discovered, until ``D`` reaches a fixpoint (the paper's ``changed``
early termination).  No fixing rules, no lower bounds: SP4 with
everything stripped away, the control for what the C/threshold machinery
buys.  The state is batch-first (``[1, n]``) over ``Graph.gather_src`` /
``seg_min_at_dst``; the loop condition is one counted host read a round
(``host_syncs == rounds``).  The reference's ``trace_count`` has no
counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import INF, Graph
from repro_torch.core.sssp.engine import SyncCounter


@dataclasses.dataclass
class BFResult:
    dist: torch.Tensor          # float32[n]
    rounds: int
    host_syncs: int | None = None


def run_bellman_ford(g: Graph, source: int = 0,
                     max_rounds: int | None = None) -> BFResult:
    """Distances from ``source`` by rounds of relaxing every edge."""
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source {source} out of range [0, {g.n})")
    max_rounds = max_rounds or g.n + 1
    sync = SyncCounter()
    D = torch.full((1, g.n), INF, dtype=torch.float32, device=g.device)
    D[0, int(source)].fill_(0.0)    # a fill kernel: no host copy
    rounds = 0
    while rounds < max_rounds:
        Dsrc = g.gather_src(D)
        cand = torch.where(Dsrc < INF, Dsrc + g.w, INF)
        D_new = torch.minimum(D, g.seg_min_at_dst(cand))
        changed = (D_new < D).any()
        D = D_new
        rounds += 1
        if not sync.read(changed):
            break
    return BFResult(dist=D[0], rounds=rounds, host_syncs=sync.count)
