"""The plain reference that decides ``correct``: Bellman-Ford in plain
PyTorch over the benchmark's own edge arrays.

Every distance is the least fixpoint of ``D[v] = min(D[v], D[u] + w)``
over the edges, with each sum one IEEE float32 add, as a float32 Dijkstra
computes it; the program's distances of a lane must equal it bit for bit
(``+inf`` where a vertex is unreachable).  The reference imports nothing
of the program and takes nothing the program made: it works from the
``(n, src, dst, w)`` arrays the benchmark generated and the roots it sent.

``precision="bfloat16"`` is the control: the same iteration with every
weight and every stored distance rounded to bfloat16, the nearest
precision below the float32 the port states for distances.
"""
from __future__ import annotations

import torch

INF = float("inf")
PRECISIONS = ("float32", "bfloat16")


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision {precision!r}: have {PRECISIONS}")


def distances(n: int, src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              roots, *, precision: str = "float32",
              lanes: int = 8) -> torch.Tensor:
    """float32[len(roots), n] shortest-path distances from ``roots``, on
    the device of ``src``, ``lanes`` roots at a time."""
    rnd = _rounder(precision)
    src, dst = src.long(), dst.long()
    w = rnd(w.to(torch.float32))
    roots = torch.as_tensor(roots, dtype=torch.int64, device=src.device)
    out = []
    for lo in range(0, roots.numel(), lanes):
        r = roots[lo:lo + lanes]
        D = torch.full((r.numel(), n), INF, device=src.device)
        D[torch.arange(r.numel(), device=src.device), r] = 0.0
        at = dst.expand(r.numel(), -1)
        while True:
            cand = rnd(D.index_select(1, src) + w)
            new = D.scatter_reduce(1, at, cand, "amin", include_self=True)
            if torch.equal(new, D):
                break
            D = new
        out.append(D)
    return torch.cat(out)


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Distances of ``got`` that are not bitwise ``want``'s (inf equals
    inf); a shape that differs counts every distance."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got.to(want.device, torch.float32) != want).sum())
