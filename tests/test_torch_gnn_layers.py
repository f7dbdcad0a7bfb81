"""Port parity for the GNN substrate (``repro_torch.models.gnn.layers``)
and ``cora_like``: every segment op against the reference's on graphs
with isolated nodes, padding edges and empty segments (forward rtol 1e-4,
atol 1e-5; the max/min and degree counts exactly), the gradients of
the max/min with ties split as ``jax.grad`` splits them, ``seg_softmax``
summing to 1 over each destination, and ``build_batch`` and
``cora_like`` array for array equal to the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import cora_like as ref_cora_like
from repro.models.gnn import layers as RL
from repro_torch import convert
from repro_torch.data.synthetic import cora_like
from repro_torch.models.gnn import layers as PL
from test_torch_graph import _one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def graph_arrays(seed, n=30, e=70, d=6, classes=5, sinks=20):
    """Random edges whose destinations are the first ``sinks`` nodes
    only, so the rest have no in-edge (empty segments at "dst"), and a
    node touching no edge at all (isolated); padding to 128 edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 1, e)
    dst = rng.integers(0, sinks, e)
    keep = src != dst
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, classes, n)
    return n, src[keep], dst[keep], x, y


def batches(seed, **kw):
    """(reference batch, port batch) of ``graph_arrays``."""
    n, src, dst, x, y = graph_arrays(seed, **kw)
    return (RL.build_batch(n, src, dst, x, y),
            PL.build_batch(n, src, dst, x, y, device="cpu"))


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def edge_values(batch, width, seed, ties=False):
    rng = np.random.default_rng(seed)
    shape = (batch.src.shape[0],) + ((width,) if width else ())
    v = rng.normal(size=shape).astype(np.float32)
    if ties:                      # few distinct values: ties in every segment
        v = np.round(v).astype(np.float32)
    return v


@pytest.mark.parametrize("seed", [0, 1])
def test_build_batch_equal_and_convert(seed):
    n, src, dst, x, y = graph_arrays(seed)
    ref = RL.build_batch(n, src, dst, x, y)
    port = PL.build_batch(n, src, dst, x, y, device="cpu")
    conv = convert.graph_batch_from_arrays(ref, device="cpu")
    for b in (port, conv):
        assert (b.n_nodes, b.n_graphs, b.n_seg) == (ref.n_nodes, ref.n_graphs,
                                                    ref.n_seg)
        for f in ("x", "src", "dst", "node_mask", "graph_id", "pos", "y"):
            assert np.array_equal(to_np(getattr(b, f)),
                                  np.asarray(getattr(ref, f))), f
    assert port.src.dtype == torch.int64 and int(port.src[-1]) == n_pad(n)


def n_pad(n):
    return -(-n // 8) * 8


def test_build_batch_graph_labels_equal():
    """Block-diagonal molecules: graph-level labels and positions."""
    rng = np.random.default_rng(4)
    n, g = 21, 3
    src = rng.integers(0, n, 40)
    dst = rng.integers(0, n, 40)
    gid = np.repeat(np.arange(g), n // g)
    pos = rng.normal(size=(n, 3))
    y = rng.normal(size=g).astype(np.float32)
    x = rng.normal(size=(n, 4))
    ref = RL.build_batch(n, src, dst, x, y, pos=pos, graph_id=gid,
                         n_graphs=g, e_pad_multiple=16)
    port = PL.build_batch(n, src, dst, x, y, pos=pos, graph_id=gid,
                          n_graphs=g, e_pad_multiple=16, device="cpu")
    for f in ("x", "src", "dst", "node_mask", "graph_id", "pos", "y"):
        assert np.array_equal(to_np(getattr(port, f)),
                              np.asarray(getattr(ref, f))), f
    assert port.y.dtype == torch.float32
    np.testing.assert_allclose(
        to_np(PL.graph_readout(port, port.x, "mean")),
        np.asarray(RL.graph_readout(ref, ref.x, "mean")), **FWD_TOL)


@pytest.mark.parametrize("at", ["dst", "src"])
@pytest.mark.parametrize("width", [0, 3])
@pytest.mark.parametrize("op", ["seg_sum", "seg_max", "seg_min", "seg_mean"])
def test_segment_ops_match_reference(op, width, at):
    ref_b, port_b = batches(2)
    if op == "seg_mean" and width == 0:
        width = 1                 # the reference's mean needs a feature dim
    v = edge_values(ref_b, width, seed=3)
    want = np.asarray(getattr(RL, op)(ref_b, jnp.asarray(v), at=at))
    got = to_np(getattr(PL, op)(port_b, torch.from_numpy(v), at=at))
    assert got.shape == want.shape
    if op in ("seg_max", "seg_min"):
        assert np.array_equal(got, want)       # -inf / +inf where empty
        assert np.isinf(got).any()
    else:
        np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("op", ["seg_max", "seg_min"])
def test_max_min_tie_gradients_match_jax(op):
    ref_b, port_b = batches(5)
    v = edge_values(ref_b, 2, seed=6, ties=True)
    ct = np.random.default_rng(7).normal(
        size=(ref_b.n_nodes, 2)).astype(np.float32)

    def ref_f(x):
        out = getattr(RL, op)(ref_b, x)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * ct)
    want = np.asarray(jax.grad(ref_f)(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    out = getattr(PL, op)(port_b, x)
    (torch.where(torch.isfinite(out), out, 0.0)
     * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(to_np(x.grad), want, **GRAD_TOL)
    assert np.any((want != 0) & (np.abs(want) < np.abs(ct).max()))  # split


@pytest.mark.parametrize("seed", [0, 8])
def test_seg_softmax_matches_and_sums_to_one(seed):
    ref_b, port_b = batches(seed)
    logits = edge_values(ref_b, 4, seed=seed + 1)
    want = np.asarray(RL.seg_softmax(ref_b, jnp.asarray(logits)))
    got = to_np(PL.seg_softmax(port_b, torch.from_numpy(logits)))
    np.testing.assert_allclose(got, want, **FWD_TOL)
    sums = to_np(PL.seg_sum(port_b, torch.from_numpy(got)))
    deg = to_np(PL.in_degrees(port_b))
    assert np.array_equal(deg, np.asarray(RL.in_degrees(ref_b)))
    assert (deg == 0).any() and (deg > 0).any()
    np.testing.assert_allclose(sums[deg > 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(sums[deg == 0], 0.0, atol=1e-6)
    pad = to_np(port_b.dst) == port_b.n_nodes
    assert pad.any() and np.all(got[pad] == 0.0)


@pytest.mark.parametrize("fill", [0.0, -1.5])
def test_gather_nodes_and_readout(fill):
    ref_b, port_b = batches(9)
    vals = np.random.default_rng(10).normal(
        size=(ref_b.n_nodes, 2, 3)).astype(np.float32)
    for idx in ("src", "dst"):
        want = np.asarray(RL.gather_nodes(ref_b, jnp.asarray(vals),
                                          getattr(ref_b, idx), fill))
        got = to_np(PL.gather_nodes(port_b, torch.from_numpy(vals),
                                    getattr(port_b, idx), fill))
        assert np.array_equal(got, want)
    for op in ("sum", "mean"):
        np.testing.assert_allclose(
            to_np(PL.graph_readout(port_b, port_b.x, op)),
            np.asarray(RL.graph_readout(ref_b, ref_b.x, op)), **FWD_TOL)


@pytest.mark.parametrize("args", [dict(n=120, e=400, d=35, seed=0),
                                  dict(n=80, e=150, d=14, classes=4, seed=3)])
def test_cora_like_equal(args):
    got, want = cora_like(**args), ref_cora_like(**args)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:], strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
