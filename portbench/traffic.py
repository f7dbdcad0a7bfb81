"""The one generator of requests, driven by a traffic file.

A traffic file (``traffic/<name>.json``) holds:

  * ``call``: ``"solve"`` (one root a request) or ``"solve_batch"``;
  * ``sources``: roots a request (distinct within a request).

Every mix is one client in a closed loop (the next request is sent when
the last one has returned), and its roots are vertices with an out-edge,
Graph500's rule for a search key.  Roots are drawn from the seed, so the
same seed sends the same requests in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

CALLS = ("solve", "solve_batch")


def validate(traffic: dict) -> None:
    if traffic["call"] not in CALLS:
        raise ValueError(f"call {traffic['call']!r}: have {CALLS}")
    if traffic["call"] == "solve" and int(traffic["sources"]) != 1:
        raise ValueError("a solve call takes one source")


def root_candidates(n: int, src: torch.Tensor) -> np.ndarray:
    """int64 vertices with an out-edge, ascending (host)."""
    deg = torch.bincount(src, minlength=n)
    return torch.nonzero(deg > 0).flatten().cpu().numpy()


class Requests:
    """The roots of successive requests: ``sources`` distinct vertices
    of ``candidates`` a request, uniformly, from ``rng``."""

    def __init__(self, traffic: dict, candidates: np.ndarray,
                 rng: np.random.Generator):
        validate(traffic)
        self.k = int(traffic["sources"])
        if candidates.size < self.k:
            raise ValueError(f"{candidates.size} root candidates for "
                             f"{self.k} sources a request")
        self.candidates = candidates
        self.rng = rng

    def next(self) -> np.ndarray:
        pick = self.rng.choice(self.candidates.size, self.k, replace=False)
        return self.candidates[pick]


def send(solver, traffic: dict, roots: np.ndarray):
    """One request through the call the traffic names: ``(distances
    float32[k, n], rounds, host reads)``, rounds the most of its lanes."""
    if traffic["call"] == "solve":
        r = solver.solve(int(roots[0]))
        return r.dist[None], int(r.rounds), int(r.host_syncs)
    r = solver.solve_batch(roots)
    return r.dist, int(np.max(r.rounds)), int(r.host_syncs)
