"""Graph500's Kronecker graph (specification v3, kernel 3: SSSP).

The generator of the specification's reference code: each of ``scale``
bits of an edge's endpoints falls in a quadrant of the initiator
``[[A, B], [C, D]]``; vertex labels and the edge order are then permuted
at random.  ``edgefactor * 2**scale`` edges are drawn with a weight each;
the graph is undirected, so each edge is stored in both directions, self
loops are dropped and of parallel edges the lightest is kept.
"""
from __future__ import annotations

import torch


def _uniform_open(m: int, g: torch.Generator, device) -> torch.Tensor:
    """float32[m] uniform on the 2**24 - 1 multiples of 2**-24 in (0, 1):
    the specification's [0, 1) without 0 (the solver needs w > 0)."""
    k = torch.randint(1, 1 << 24, (m,), generator=g, device=device)
    return k.to(torch.float32) * (2.0 ** -24)


def edges(scale: int, edgefactor: int, initiator, g: torch.Generator,
          device):
    """The specification's ``kronecker_generator``: int64 endpoints of
    ``edgefactor << scale`` edges, labels and order permuted."""
    a, b, c, _ = (float(x) for x in initiator)
    n, m = 1 << scale, edgefactor << scale
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=g, device=device) > ab
        thr = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=g, device=device) > thr
        i += ii.long() << bit
        j += jj.long() << bit
    perm = torch.randperm(n, generator=g, device=device)
    order = torch.randperm(m, generator=g, device=device)
    return perm[i][order], perm[j][order]


def lightest_undirected(n: int, i: torch.Tensor, j: torch.Tensor,
                        w: torch.Tensor):
    """Both directions of every non-loop edge, one edge per ordered pair:
    the lightest of its parallel copies (ties: the first drawn)."""
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep]
    u, v, w = torch.cat([i, j]), torch.cat([j, i]), torch.cat([w, w])
    by_w = torch.argsort(w, stable=True)
    u, v, w = u[by_w], v[by_w], w[by_w]
    key = u * n + v
    by_key = torch.argsort(key, stable=True)
    key, w = key[by_key], w[by_key]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key, w = key[first], w[first]
    return key // n, key % n, w


def make(config: dict, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    scale, ef = int(config["scale"]), int(config["edgefactor"])
    i, j = edges(scale, ef, config["initiator"], g, device)
    w = _uniform_open(i.numel(), g, device)
    n = 1 << scale
    src, dst, w = lightest_undirected(n, i, j, w)
    order = torch.randperm(src.numel(), generator=g, device=device)
    return n, src[order], dst[order], w[order]
