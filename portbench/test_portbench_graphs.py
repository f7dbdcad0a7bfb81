"""The generators at small scales: sizes, loops, weights, Kronecker's
degree skew, Random4's strong connectivity, and that the seed fixes the
graph."""
import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from portbench.graphs import kronecker, sprand

KRON = {"scale": 10, "edgefactor": 16, "initiator": [0.57, 0.19, 0.19, 0.05]}
RAND4 = {"n": 4096, "arcs_per_vertex": 4, "length_min": 1,
         "length_max": 4096}


def host(n, src, dst, w):
    return n, src.numpy(), dst.numpy(), w.numpy()


@pytest.fixture(scope="module")
def kron():
    return host(*kronecker.make(KRON, 123, "cpu"))


@pytest.fixture(scope="module")
def rand4():
    return host(*sprand.make(RAND4, 123, "cpu"))


def test_kronecker_sizes_loops_and_weights(kron):
    n, src, dst, w = kron
    assert n == 1 << KRON["scale"]
    assert src.min() >= 0 and max(src.max(), dst.max()) < n
    assert (src != dst).all()
    assert ((w > 0) & (w < 1)).all() and w.dtype == np.float32
    # both directions, fewer than 2 * edgefactor * n after de-duplication
    assert src.size % 2 == 0 and src.size < 2 * (KRON["edgefactor"] << 10)


def test_kronecker_is_undirected_with_one_weight_a_pair(kron):
    n, src, dst, w = kron
    fwd = dict(zip((src * n + dst).tolist(), w.tolist()))
    assert len(fwd) == src.size   # no parallel edges left
    back = dict(zip((dst * n + src).tolist(), w.tolist()))
    assert fwd == back


def test_kronecker_keeps_the_lightest_parallel_edge():
    i = np.array([0, 0, 1, 2, 2])
    j = np.array([1, 1, 0, 2, 3])
    w = np.array([0.5, 0.25, 0.75, 0.1, 0.3], np.float32)
    import torch
    u, v, ww = kronecker.lightest_undirected(
        4, torch.from_numpy(i), torch.from_numpy(j), torch.from_numpy(w))
    got = {(a, b): c for a, b, c in zip(u.tolist(), v.tolist(),
                                         ww.tolist())}
    assert got == {(0, 1): 0.25, (1, 0): 0.25, (2, 3): 0.30000001192092896,
                   (3, 2): 0.30000001192092896}


def test_kronecker_degrees_are_skewed(kron, rand4):
    n, src, _, _ = kron
    deg = np.bincount(src, minlength=n)
    live = deg[deg > 0]
    # hubs: the largest degree is many times the mean, unlike Random4's
    assert live.max() > 10 * live.mean()
    assert (deg == 0).any()           # Kronecker leaves vertices isolated
    n4, src4, _, _ = rand4
    deg4 = np.bincount(src4, minlength=n4)
    assert deg4.max() < 5 * deg4.mean()


def test_random4_sizes_lengths_and_strong_connectivity(rand4):
    n, src, dst, w = rand4
    assert n == RAND4["n"] and src.size == 4 * n
    assert (src != dst).all()
    assert (w == np.round(w)).all() and w.min() >= 1 and w.max() <= n
    assert np.bincount(src, minlength=n).min() >= 1
    g = sp.csr_matrix((np.ones(src.size), (src, dst)), shape=(n, n))
    k, _ = connected_components(g, directed=True, connection="strong")
    assert k == 1


@pytest.mark.parametrize("make,cfg", [(kronecker.make, KRON),
                                      (sprand.make, RAND4)])
def test_the_seed_fixes_the_graph(make, cfg):
    a = host(*make(cfg, 2**31 + 17, "cpu"))
    b = host(*make(cfg, 2**31 + 17, "cpu"))
    c = host(*make(cfg, 2**31 + 18, "cpu"))
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    assert not all(x.shape == y.shape and (x == y).all()
                   for x, y in zip(a[1:], c[1:]))
