"""Port parity for the kernel layer: the plain PyTorch versions of B1-B4
and the ops around them, bitwise against the reference's Pallas kernels
(interpret mode) and jnp oracles on the same numpy inputs; the wrappers'
argument checks; and the C bindings declared for the CUDA sources.  The
CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py (tolerance 0)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core import graph as rgraph
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.relax import relax_ell as pallas_relax_ell
from repro.kernels.segment_min import masked_min as pallas_masked_min
from repro_torch import convert
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.frontier_relax import (frontier_scatter_min,
                                                frontier_scatter_min_batch)
from repro_torch.kernels.relax import relax_ell
from repro_torch.kernels.segment_min import masked_min
from test_torch_graph import _one_torch_thread  # noqa: F401


def _bitwise(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _values(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.0, 9.0, shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


@pytest.mark.parametrize("family", ["gnp", "grid", "power_law", "chain"])
@pytest.mark.parametrize("B", [1, 3])
def test_relax_ell_vs_pallas_interpret_and_oracle(family, B):
    n, src, dst, w = rgen.make(family, 180, seed=2)
    rell = rgraph.build_ell(n, src, dst, w)
    pell = convert.ell_from_arrays(rell, device="cpu")
    rng = np.random.default_rng(B)
    x = _values(rng, (B, n))
    mask = rng.random((B, n)) < 0.6
    got = ops.relax_ell(torch.from_numpy(x), pell, torch.from_numpy(mask))
    for b in range(B):
        want_k = rops.relax_ell(jnp.asarray(x[b]), rell, jnp.asarray(mask[b]),
                                use_pallas=True)
        want_o = rops.relax_ell(jnp.asarray(x[b]), rell, jnp.asarray(mask[b]),
                                use_pallas=False)
        assert _bitwise(want_k, got[b]) and _bitwise(want_o, got[b])


def test_relax_ell_plain_rowmin_vs_pallas_kernel():
    """The fused plain version equals the Pallas row-min applied to the
    gathered operands, padding rows and an all-padding row included."""
    rng = np.random.default_rng(5)
    n, n_pad, deg = 13, 16, 128
    in_src = np.full((n_pad, deg), n, np.int32)
    in_w = np.full((n_pad, deg), np.inf, np.float32)
    for i in range(n - 1):                       # row n-1: all padding
        k = rng.integers(1, 9)
        in_src[i, :k] = rng.integers(0, n, k)
        in_w[i, :k] = rng.uniform(0.05, 1.0, k)
    x = _values(rng, (2, n))
    mask = rng.random((2, n)) < 0.7
    got = ref.relax_ell_ref(torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(in_src), torch.from_numpy(in_w),
                            n)
    idx = np.minimum(in_src, n - 1)
    for b in range(2):
        d_src = x[b][idx]
        m = (in_src < n) & mask[b][idx]
        want = pallas_relax_ell(jnp.asarray(d_src), jnp.asarray(in_w),
                                jnp.asarray(m), interpret=True)[:n]
        oracle = rref.relax_ell_ref(jnp.asarray(d_src), jnp.asarray(in_w),
                                    jnp.asarray(m))[:n]
        assert _bitwise(want, got[b]) and _bitwise(oracle, got[b])
    assert np.isinf(got[:, n - 1].numpy()).all()


@pytest.mark.parametrize("n", [1, 130, 4096, 5000])
def test_masked_min_vs_pallas_interpret(n):
    rng = np.random.default_rng(n)
    x = _values(rng, (3, n), inf_frac=0.1)
    mask = rng.random((3, n)) < 0.5
    mask[1] = False                               # an empty mask
    got = masked_min(torch.from_numpy(x), torch.from_numpy(mask))
    for b in range(3):
        want = pallas_masked_min(jnp.asarray(x[b]), jnp.asarray(mask[b]),
                                 interpret=True)
        assert _bitwise(want, got[b])
        assert _bitwise(rref.masked_min_ref(jnp.asarray(x[b]),
                                            jnp.asarray(mask[b])), got[b])
    assert np.isinf(got[1].item())


@pytest.mark.parametrize("n,cap,deg,B", [(50, 8, 3, 2), (130, 16, 5, 4),
                                         (7, 4, 9, 1), (260, 2, 1, 3)])
def test_frontier_scatter_min_vs_oracles(n, cap, deg, B):
    rng = np.random.default_rng(n + B)
    tgt = rng.integers(0, n + 1, (cap, deg)).astype(np.int32)
    cand = rng.uniform(0.0, 9.0, (B, cap, deg)).astype(np.float32)
    cand = np.where(tgt[None] == n, np.inf, cand).astype(np.float32)
    got = frontier_scatter_min_batch(torch.from_numpy(tgt),
                                     torch.from_numpy(cand), n)
    want = rref.frontier_scatter_min_batch_ref(jnp.asarray(tgt),
                                               jnp.asarray(cand), n)
    assert _bitwise(want, got)
    one = frontier_scatter_min(torch.from_numpy(tgt),
                               torch.from_numpy(cand[0]), n)
    assert _bitwise(rref.frontier_scatter_min_ref(
        jnp.asarray(tgt), jnp.asarray(cand[0]), n), one)


def test_frontier_scatter_min_edge_cases():
    n = 9
    tgt = np.full((4, 3), n, np.int32)            # all padding
    cand = np.full((2, 4, 3), np.inf, np.float32)
    got = frontier_scatter_min_batch(torch.from_numpy(tgt),
                                     torch.from_numpy(cand), n)
    assert got.shape == (2, n) and torch.isinf(got).all()
    tgt[0, 0], cand[:, 0, 0] = 3, np.inf          # +inf candidate only
    got = frontier_scatter_min_batch(torch.from_numpy(tgt),
                                     torch.from_numpy(cand), n)
    assert torch.isinf(got).all()


@pytest.mark.parametrize("family", ["grid", "chain", "geometric",
                                    "power_law"])
def test_frontier_ops_vs_reference(family):
    n, src, dst, w = rgen.make(family, 200, seed=8)
    rg = rgraph.build_graph(n, src, dst, w)
    rcsr = rg.csr()
    pg = convert.graph_from_arrays(rg, device="cpu")
    pcsr = convert.csr_from_arrays(rcsr, device="cpu")
    rng = np.random.default_rng(1)
    cap, B = 16, 3
    f_idx = np.sort(rng.choice(n, 11, replace=False)).astype(np.int32)
    f_idx = np.concatenate([f_idx, np.full(cap - 11, n, np.int32)])
    x = _values(rng, (B, n))
    smask = rng.random((B, n)) < 0.6
    tf = torch.from_numpy
    got = ops.frontier_relax_b(tf(x), pcsr, tf(f_idx), tf(smask))
    want = rops.frontier_relax_b(jnp.asarray(x), rcsr, jnp.asarray(f_idx),
                                 jnp.asarray(smask), use_pallas=False)
    assert _bitwise(want, got)
    one = ops.frontier_relax(tf(x[0]), pcsr, tf(f_idx), tf(smask[0]))
    assert _bitwise(rops.frontier_relax(
        jnp.asarray(x[0]), rcsr, jnp.asarray(f_idx), jnp.asarray(smask[0]),
        use_pallas=False), one)
    tg = ops.out_nbrs(pcsr, tf(f_idx))
    assert _bitwise(rops.out_nbrs(rcsr, jnp.asarray(f_idx)), tg)
    for xx, mm in ((x, smask), (None, smask), (x, None)):
        got_m = ops.in_min_at(pg, pcsr, None if xx is None else tf(xx), tg,
                              None if mm is None else tf(mm))
        want_m = rops.in_min_at(rg, rcsr,
                                None if xx is None else jnp.asarray(xx),
                                jnp.asarray(tg.numpy()),
                                None if mm is None else jnp.asarray(mm))
        assert _bitwise(want_m, got_m)


def test_wrappers_check_arguments():
    t = torch.zeros((2, 3), dtype=torch.int32)
    c = torch.zeros((1, 2, 3))
    with pytest.raises(TypeError):
        frontier_scatter_min_batch(t.float(), c, 4)
    with pytest.raises(ValueError):
        frontier_scatter_min_batch(t, torch.zeros((1, 3, 2)), 4)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_scatter_min_batch(t.t().contiguous().t(), c, 4)
    with pytest.raises(ValueError, match="no kernel"):
        frontier_scatter_min_batch(t.to("meta"), c.to("meta"), 4)
    x, m = torch.zeros((2, 5)), torch.ones((2, 5), dtype=torch.bool)
    with pytest.raises(TypeError):
        masked_min(x.double(), m)
    with pytest.raises(ValueError):
        masked_min(x, m[:, :4])
    with pytest.raises(ValueError, match="no kernel"):
        masked_min(x.to("meta"), m.to("meta"))
    src = torch.full((8, 4), 5, dtype=torch.int32)
    w = torch.full((8, 4), float("inf"))
    with pytest.raises(TypeError):
        relax_ell(x, m.float(), src, w, 5)
    with pytest.raises(ValueError):
        relax_ell(x, m, src[:3], w[:3], 5)
    assert torch.isinf(relax_ell(x, m, src, w, 5)).all()


def test_cpu_calls_launch_no_kernel():
    before = _build.launch_counts()
    masked_min(torch.zeros((1, 4)), torch.ones((1, 4), dtype=torch.bool))
    frontier_scatter_min(torch.zeros((1, 1), dtype=torch.int32),
                         torch.zeros((1, 1)), 2)
    assert _build.launch_counts() == before


_C_TYPES = {"int": "int", "long long": "longlong"}


def test_c_bindings_match_sources():
    """Every exported function exists in its .cu, returns int, and is
    built for sm_90a; its C parameters, in order, match its ctypes
    argtypes: pointers (and the stream) as c_void_p, int as c_int, long
    long as c_longlong."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for fn, (src, argtypes) in _build.SIGNATURES.items():
        text = (_build.CSRC / f"{src}.cu").read_text()
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), fn
        for p, t in zip(params, argtypes):
            decl = p.rsplit(" ", 1)[0].replace("const ", "")
            if "*" in p:
                assert t is _build.ctypes.c_void_p, (fn, p)
            else:
                assert t is getattr(_build.ctypes, "c_" + _C_TYPES[decl]), \
                    (fn, p)
    assert set(_build.LAUNCHES) >= set(_build.SIGNATURES)
