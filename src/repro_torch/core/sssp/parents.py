"""Shortest-path-tree extraction via backward parent pointers (port of
``repro/core/sssp/parents.py``): an edge (u, v) is a tree edge iff
``D[u] + w == D[v]`` (within ``atol``); each vertex keeps the
smallest-index such parent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import INF, Graph

_INT32_MAX = 2 ** 31 - 1


def parent_pointers(g: Graph, D: torch.Tensor, *,
                    atol: float = 1e-5) -> torch.Tensor:
    """int32[..., n] parent vertex per node (-1 for source/unreachable);
    leading dims of ``D`` are lanes on the same graph."""
    Dsrc = g.gather_src(D)
    Ddst = g.gather_dst(D)
    feasible = (Dsrc < INF) & ((Dsrc + g.w - Ddst).abs()
                               <= atol * (1 + Ddst))
    key = torch.where(feasible, g.src, g.n + 1)
    best = torch.full(D.shape[:-1] + (g.n + 1,), _INT32_MAX,
                      dtype=torch.int32, device=D.device)
    best.scatter_reduce_(-1, g.dst_l.expand_as(key), key, "amin")
    best = best[..., : g.n]
    parent = torch.where(best <= g.n, best, -1)
    return torch.where(D < INF, parent, -1).to(torch.int32)


def extract_path(parent: np.ndarray, target: int, source: int = 0):
    """Host-side path walk (list of vertices source..target), or None."""
    parent = np.asarray(parent)
    path = [target]
    seen = set()
    v = target
    while v != source:
        p = int(parent[v])
        if p < 0 or p in seen:
            return None
        seen.add(p)
        path.append(p)
        v = p
    return path[::-1]
