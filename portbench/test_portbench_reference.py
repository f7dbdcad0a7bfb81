"""The plain reference against scipy's Dijkstra and a float32 heap
Dijkstra, and its bfloat16 control against the reference (the control
must come out wrong)."""
import heapq

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from portbench import reference
from portbench.graphs import kronecker, sprand

GRAPHS = {
    "kron": (kronecker.make, {"scale": 9, "edgefactor": 16,
                              "initiator": [0.57, 0.19, 0.19, 0.05]}),
    "rand4": (sprand.make, {"n": 1024, "arcs_per_vertex": 4,
                            "length_min": 1, "length_max": 1024}),
}


def graph(name, seed=5):
    make, cfg = GRAPHS[name]
    return make(cfg, seed, "cpu")


def roots_of(n, src, k=6, seed=0):
    live = np.unique(src.numpy())
    return np.random.default_rng(seed).choice(live, k, replace=False)


def dijkstra_f32(n, src, dst, w, root):
    """Heap Dijkstra with every sum one float32 add."""
    out = [[] for _ in range(n)]
    for u, v, x in zip(src.tolist(), dst.tolist(), w.numpy()):
        out[u].append((v, x))
    D = np.full(n, np.inf, np.float32)
    D[root] = 0
    heap, done = [(np.float32(0), root)], np.zeros(n, bool)
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for v, x in out[u]:
            c = np.float32(d + x)
            if c < D[v]:
                D[v] = c
                heapq.heappush(heap, (c, v))
    return D


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reference_matches_scipy_dijkstra(name):
    n, src, dst, w = graph(name)
    roots = roots_of(n, src)
    got = reference.distances(n, src, dst, w, roots, lanes=4).numpy()
    want = _scipy(n, src, dst, w, roots)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


def _scipy(n, src, dst, w, roots):
    """scipy's Dijkstra (float64 sums) over the lightest of each pair's
    parallel edges (a sparse matrix would add them)."""
    s, d, x = src.numpy(), dst.numpy(), w.numpy().astype(np.float64)
    best = {}
    for a, b, c in zip(s.tolist(), d.tolist(), x.tolist()):
        if (a, b) not in best or c < best[(a, b)]:
            best[(a, b)] = c
    keys = np.array(list(best), np.int64).reshape(-1, 2)
    m = csr_matrix((np.array(list(best.values())), (keys[:, 0], keys[:, 1])),
                   shape=(n, n))
    return dijkstra(m, indices=roots)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_reference_is_float32_dijkstra_bit_for_bit(name):
    n, src, dst, w = graph(name)
    roots = roots_of(n, src, k=3)
    got = reference.distances(n, src, dst, w, roots)
    for i, r in enumerate(roots):
        want = torch.from_numpy(dijkstra_f32(n, src, dst, w, int(r)))
        assert reference.mismatches(got[i:i + 1], want[None]) == 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfloat16_control_comes_out_wrong(name):
    n, src, dst, w = graph(name)
    roots = roots_of(n, src)
    want = reference.distances(n, src, dst, w, roots)
    ctl = reference.distances(n, src, dst, w, roots, precision="bfloat16")
    assert reference.mismatches(ctl, want) > 0


def test_mismatches_counts_values_and_shapes():
    a = torch.tensor([[0.0, 1.0, float("inf")]])
    assert reference.mismatches(a, a.clone()) == 0
    b = a.clone()
    b[0, 1] = torch.nextafter(b[0, 1], torch.tensor(2.0))
    assert reference.mismatches(b, a) == 1
    assert reference.mismatches(a[:, :2], a) == 3
    with pytest.raises(ValueError):
        reference.distances(2, torch.tensor([0]), torch.tensor([1]),
                            torch.tensor([1.0]), [0], precision="float16")
