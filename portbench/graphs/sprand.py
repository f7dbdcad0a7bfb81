"""SPRAND's random graphs (9th DIMACS Implementation Challenge, shortest
paths, families Random4-n and Random4-C).

A directed Hamiltonian cycle ``0 -> 1 -> ... -> n-1 -> 0`` makes the
graph strongly connected; the other ``m - n`` arcs join a tail drawn
uniformly to a head drawn uniformly among the other vertices (no self
loops; parallel arcs may occur).  Every arc's length is an integer drawn
uniformly from ``[lmin, lmax]``, stored as float32 (exact below 2**24).
"""
from __future__ import annotations

import torch


def make(config: dict, seed: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = int(config["n"])
    m = int(config["arcs_per_vertex"]) * n
    lo, hi = int(config["length_min"]), int(config["length_max"])
    ring = torch.arange(n, dtype=torch.int64, device=device)
    tail = torch.randint(0, n, (m - n,), generator=g, device=device)
    step = torch.randint(1, n, (m - n,), generator=g, device=device)
    src = torch.cat([ring, tail])
    dst = torch.cat([(ring + 1) % n, (tail + step) % n])
    w = torch.randint(lo, hi + 1, (m,), generator=g, device=device)
    return n, src, dst, w.to(torch.float32)
