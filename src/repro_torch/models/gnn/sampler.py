"""Layer-wise neighbour sampler (GraphSAGE-style fanout 15-10), a copy of
``repro/models/gnn/sampler.py``.

Host-side numpy: per minibatch of seed nodes, sample a fixed fanout of
in-neighbours per hop, relabel into a compact padded subgraph whose
shapes are STATIC functions of (batch_nodes, fanouts): the reference's
``minibatch_lg`` cell.  Given the same ``np.random.Generator`` the
arrays equal the reference's.

Frontier expansion is BFS, the unweighted specialization of the paper's
SP2 (Theorem 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    batch_nodes: int = 1024
    fanouts: tuple[int, ...] = (15, 10)

    @property
    def max_nodes(self) -> int:
        n, total = 1, 1
        for f in self.fanouts:
            n *= f
            total += n
        return self.batch_nodes * total

    @property
    def max_edges(self) -> int:
        n, total = 1, 0
        for f in self.fanouts:
            n *= f
            total += n
        return self.batch_nodes * total


class CSRGraph:
    """Compressed in-neighbour lists for sampling."""

    def __init__(self, n: int, src, dst):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        order = np.argsort(dst, kind="stable")
        self.nbr = src[order]
        self.indptr = np.zeros(n + 1, np.int64)
        np.add.at(self.indptr, dst + 1, 1)
        self.indptr = np.cumsum(self.indptr)
        self.n = n


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, spec: SamplerSpec,
                    rng: np.random.Generator):
    """Returns (nodes, src, dst, n_nodes, n_edges) padded to spec maxima.

    Edge direction: sampled neighbour -> target (message-passing order).
    Node ids are subgraph-local; `nodes` maps local -> global.
    """
    node_list = list(seeds)
    node_pos = {int(v): i for i, v in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in spec.fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = g.nbr[lo + rng.choice(deg, size=take, replace=False)]
            for u in picks:
                u = int(u)
                if u not in node_pos:
                    node_pos[u] = len(node_list)
                    node_list.append(u)
                src_l.append(node_pos[u])
                dst_l.append(node_pos[int(v)])
            nxt.extend(int(u) for u in picks)
        frontier = nxt
    n_nodes, n_edges = len(node_list), len(src_l)
    nodes = np.full(spec.max_nodes, -1, np.int64)
    nodes[:n_nodes] = node_list
    src = np.full(spec.max_edges, spec.max_nodes, np.int32)
    dst = np.full(spec.max_edges, spec.max_nodes, np.int32)
    src[:n_edges] = src_l
    dst[:n_edges] = dst_l
    return nodes, src, dst, n_nodes, n_edges
