"""Δ-stepping baseline (Meyer & Sanders; port of
``repro/core/sssp/delta_stepping.py``), bulk-synchronous with dense
masks:

  * bucket(v) = floor(D[v] / Δ) for discovered, unsettled v;
  * a phase picks the minimum non-empty bucket i, relaxes light edges
    (w <= Δ) from bucket-i members to a fixpoint, then heavy edges
    (w > Δ) once, and marks bucket-i members settled.

Δ -> ∞ degenerates to Bellman-Ford, Δ -> 0 to Dijkstra.  ``phases``
counts outer phases, ``light_iters`` the inner fixpoint sweeps.

Δ is a float32 0-d tensor, as the reference's ``jnp.float32(delta)``, so
``floor(D / Δ)``, the bucket minimum and the light/heavy split take the
same f32 bits.  The state is batch-first (``[1, n]``); each loop
condition is one counted host read: ``host_syncs == phases + 1 +
light_iters`` when the run ends by emptying the buckets.  The
reference's ``trace_count`` has no counterpart.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.graph import INF, Graph
from repro_torch.core.sssp.engine import SyncCounter


@dataclasses.dataclass
class DeltaResult:
    dist: torch.Tensor          # float32[n]
    phases: int
    light_iters: int
    host_syncs: int | None = None


def run_delta_stepping(g: Graph, source: int = 0, delta: float = 0.25,
                       max_phases: int | None = None) -> DeltaResult:
    """Distances from ``source`` by bucketed label-correcting phases."""
    if not 0 <= int(source) < g.n:
        raise ValueError(f"source {source} out of range [0, {g.n})")
    max_phases = max_phases or g.n + 1
    sync = SyncCounter()
    delta = torch.full((), delta, dtype=torch.float32, device=g.device)
    D = torch.full((1, g.n), INF, dtype=torch.float32, device=g.device)
    D[0, int(source)].fill_(0.0)    # a fill kernel: no host copy
    settled = torch.zeros((1, g.n), dtype=torch.bool, device=g.device)
    light = g.w <= delta                   # static edge partition

    def relax_from(D, frontier, edge_mask):
        src_ok = g.gather_src(frontier, fill=False) & edge_mask
        Dsrc = g.gather_src(D)
        cand = torch.where(src_ok, Dsrc + g.w, INF)
        return torch.minimum(D, g.seg_min_at_dst(cand))

    def bucket_of(D, i):
        return (D < INF) & ~settled & (torch.floor(D / delta) == i)

    phases = liters = 0
    while phases < max_phases and sync.read(((D < INF) & ~settled).any()):
        bkt = torch.where((D < INF) & ~settled, torch.floor(D / delta), INF)
        i = bkt.amin(dim=-1, keepdim=True)
        # inner fixpoint over light edges of bucket-i members
        D_prev, D_cur = D, relax_from(D, bucket_of(D, i), light)
        it = 1
        while sync.read((D_cur < D_prev).any()):
            D_prev, D_cur = D_cur, relax_from(D_cur, bucket_of(D_cur, i),
                                              light)
            it += 1
        members = bucket_of(D_cur, i)
        D = relax_from(D_cur, members, ~light)
        settled = settled | members
        phases += 1
        liters += it
    return DeltaResult(dist=D[0], phases=phases, light_iters=liters,
                       host_syncs=sync.count)
