"""Seeded graph generators (port of ``repro/core/generators.py``).

The same seed gives the same arrays as the reference; ``power_law`` and
``geometric`` build them with array operations instead of per-edge
Python appends.

Every generator returns ``(n, src, dst, w)`` numpy arrays with strictly
positive weights and no self-loops.  Families:

  * ``gnp``        — directed Erdős–Rényi G(n, p): the general case.
  * ``dag``        — random DAG whose only zero-in-degree vertex is the
                     source (Theorem 2's O(e) regime for SP1).
  * ``unweighted`` — all weights 1 (Theorem 3's BFS regime for SP2).
  * ``grid``       — 2D grid with random weights (high diameter ⇒ many
                     rounds; the hard case for bulk-synchronous engines).
  * ``power_law``  — preferential-attachment-ish in-degree skew (the ELL
                     worst case; exercises the edge-list path).
  * ``chain``      — long path + noise edges: adversarial for Dijkstra's
                     one-vertex-per-iteration bottleneck, best case for the
                     paper's multi-fix rules.
  * ``geometric``  — random geometric kNN digraph (road-network-like).
"""
from __future__ import annotations

import numpy as np


def _dedup(n, src, dst, w):
    """Drop duplicate (src,dst) pairs (keep first) and self loops."""
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx], w[idx]


def _weights(rng, e, kind="uniform"):
    if kind == "uniform":
        return rng.uniform(0.05, 1.0, e).astype(np.float32)
    if kind == "integer":
        return rng.integers(1, 20, e).astype(np.float32)
    if kind == "unit":
        return np.ones(e, np.float32)
    raise ValueError(kind)


def gnp(n: int, avg_deg: float = 8.0, seed: int = 0, weights="uniform"):
    rng = np.random.default_rng(seed)
    e = int(n * avg_deg)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    w = _weights(rng, e, weights)
    src, dst, w = _dedup(n, src, dst, w)
    return n, src, dst, w[: len(src)]


def dag(n: int, avg_deg: float = 6.0, seed: int = 0, weights="uniform"):
    """Random DAG; vertex 0 is the unique zero-in-degree source.

    Edges only go from lower to higher topological index; every vertex i>0
    gets a guaranteed in-edge from a random smaller vertex.
    """
    rng = np.random.default_rng(seed)
    e_extra = int(n * (avg_deg - 1))
    base_dst = np.arange(1, n)
    base_src = np.array([rng.integers(0, i) for i in range(1, n)])
    xs = rng.integers(0, n - 1, e_extra)
    xd = rng.integers(1, n, e_extra)
    lo, hi = np.minimum(xs, xd), np.maximum(xs, xd)
    ok = lo < hi
    src = np.concatenate([base_src, lo[ok]])
    dst = np.concatenate([base_dst, hi[ok]])
    w = _weights(rng, len(src), weights)
    src, dst, w = _dedup(n, src, dst, w)
    return n, src, dst, w[: len(src)]


def unweighted(n: int, avg_deg: float = 8.0, seed: int = 0):
    n, src, dst, w = gnp(n, avg_deg, seed)
    return n, src, dst, np.ones(len(src), np.float32)


def grid(side: int, seed: int = 0, weights="uniform"):
    """Directed 2D grid (4-neighbour, both directions)."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).ravel()
    srcs, dsts = [], []
    for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        ni, nj = ii + di, jj + dj
        ok = ((ni >= 0) & (ni < side) & (nj >= 0) & (nj < side)).ravel()
        srcs.append(vid[ok])
        dsts.append((ni * side + nj).ravel()[ok])
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    w = _weights(rng, len(src), weights)
    return n, src, dst, w


def power_law(n: int, m: int = 4, seed: int = 0, weights="uniform"):
    """Preferential attachment: new vertex points at m popular old ones.

    The pool of targets lives in a preallocated array rather than a
    growing list (which ``rng.choice`` would copy on every call): the
    draws, and so the arrays, are the same, in linear time.
    """
    rng = np.random.default_rng(seed)
    pool = np.zeros(max(1, (m + 1) * n), np.int64)
    size = 1                          # pool[:size] holds the targets
    src_l, dst_l = [], []
    for v in range(1, n):
        picks = rng.choice(pool[:size], size=min(m, size))
        k = len(picks)
        # new -> old, and a forward edge old -> new so everything is
        # reachable from 0, interleaved as (v, t), (t, v) per pick
        src_l.append(np.stack([np.full(k, v), picks], 1).ravel())
        dst_l.append(np.stack([picks, np.full(k, v)], 1).ravel())
        pool[size:size + k] = picks
        pool[size + k] = v
        size += k + 1
    src = np.concatenate(src_l) if src_l else np.zeros(0, np.int64)
    dst = np.concatenate(dst_l) if dst_l else np.zeros(0, np.int64)
    w = _weights(rng, len(src), weights)
    src, dst, w = _dedup(n, src, dst, w)
    return n, src, dst, w[: len(src)]


def chain(n: int, noise_deg: float = 2.0, seed: int = 0):
    """Long weighted path 0→1→…→n-1 plus random shortcut noise.

    Dijkstra needs n removeMin's; the paper's rules fix long runs per round.
    """
    rng = np.random.default_rng(seed)
    src = np.arange(n - 1)
    dst = np.arange(1, n)
    w = rng.uniform(0.5, 1.0, n - 1).astype(np.float32)
    e_noise = int(n * noise_deg)
    xs = rng.integers(0, n, e_noise)
    xd = rng.integers(0, n, e_noise)
    # shortcuts are expensive so the chain stays the shortest path
    wn = rng.uniform(5.0, 50.0, e_noise).astype(np.float32)
    src = np.concatenate([src, xs])
    dst = np.concatenate([dst, xd])
    w = np.concatenate([w, wn])
    src, dst, w = _dedup(n, src, dst, w)
    return n, src, dst, w[: len(src)]


def geometric(n: int, k: int = 6, seed: int = 0):
    """kNN digraph over random 2D points, weight = euclidean distance."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 2))
    # brute-force kNN in blocks (n is test-scale)
    src_l, dst_l, w_l = [], [], []
    for i0 in range(0, n, 512):
        blk = pts[i0:i0 + 512]
        # the two squared coordinate gaps, added in the order the
        # reference's sum over the last axis adds them
        d2 = ((blk[:, 0, None] - pts[None, :, 0]) ** 2
              + (blk[:, 1, None] - pts[None, :, 1]) ** 2)
        for r in range(blk.shape[0]):
            d2[r, i0 + r] = np.inf
        nbr = np.argpartition(d2, k, axis=1)[:, :k]
        rows = np.arange(blk.shape[0])[:, None]
        src_l.append(np.repeat(i0 + np.arange(blk.shape[0]), k))
        dst_l.append(nbr.ravel())
        w_l.append(np.maximum(np.sqrt(d2[rows, nbr]), 1e-4).ravel())
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    w = np.concatenate(w_l).astype(np.float32)
    src, dst, w = _dedup(n, src, dst, w)
    return n, src, dst, w[: len(src)]


FAMILIES = {
    "gnp": gnp,
    "dag": dag,
    "unweighted": unweighted,
    "grid": lambda n, seed=0, **kw: grid(int(np.sqrt(n)), seed=seed),
    "power_law": power_law,
    "chain": chain,
    "geometric": geometric,
}


def make(family: str, n: int, seed: int = 0, **kw):
    return FAMILIES[family](n, seed=seed, **kw)
