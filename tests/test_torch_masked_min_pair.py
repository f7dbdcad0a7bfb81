"""B4's pair form on the CPU: the plain version of ``masked_min_pair``
(what the wrapper and the engine's jnp-style backends run on a CPU tensor)
bitwise against two calls of the reference's Pallas ``masked_min``
(interpret mode) and of its jnp oracle, on ``x`` and ``x + add``; a CPU
emulation of ``csrc/segment_min.cu``'s index arithmetic (scalar head,
float4 groups, tail) showing that every element is read once and every
vector load is aligned; and the pallas route's solves for SP1-SP4
bitwise against the reference engine, with one pair call a round on
every route.  The CUDA kernel is held against the plain version on the
card by chip_smoke.py (tolerance 0)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sssp as R
from repro.core import generators as rgen
from repro.core.graph import build_ell as rbuild_ell
from repro.core.graph import build_graph as rbuild
from repro.kernels import ref as rref
from repro.kernels.segment_min import masked_min as pallas_masked_min
import repro_torch.sssp as P
from repro_torch.convert import ell_from_arrays, graph_from_arrays
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.segment_min import MAX_BLOCKS, masked_min_pair
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_split_precision import _constexprs

R_CFG = {"sp1": R.SSSPConfig(rules=R.SP1_RULES),
         "sp2": R.SSSPConfig(rules=R.SP2_RULES),
         "sp3": R.SP3_CONFIG, "sp4": R.SP4_CONFIG}
P_CFG = {"sp1": P.SSSPConfig(rules=P.SP1_RULES),
         "sp2": P.SSSPConfig(rules=P.SP2_RULES),
         "sp3": P.SP3_CONFIG, "sp4": P.SP4_CONFIG}


def _bitwise(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _add(rng, n, kind):
    if kind == "none":
        return None
    if kind == "all inf":
        return np.full(n, np.inf, np.float32)
    a = rng.uniform(0.05, 2.0, n).astype(np.float32)
    a[::3] = np.inf
    return a


@pytest.mark.parametrize("add_kind", ["inf cells", "all inf", "none"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [1, 3, 1001, 4096])
def test_pair_plain_vs_pallas_interpret_and_oracle(n, B, add_kind):
    rng = np.random.default_rng(n * 7 + B)
    x = rng.uniform(0.0, 9.0, (B, n)).astype(np.float32)
    x[rng.random((B, n)) < 0.1] = np.inf
    mask = rng.random((B, n)) < 0.5
    mask[0, 0] = True
    if B > 1:
        mask[-1] = False                            # an empty lane
    add = _add(rng, n, add_kind)
    tf = torch.from_numpy
    ta = None if add is None else tf(add)
    got = masked_min_pair(tf(x), tf(mask), ta)
    assert got.shape == (B, 2) and got.dtype == torch.float32
    # the pallas route's op; the segment and frontier routes bind the
    # plain version itself
    assert torch.equal(ops.masked_min_pair(tf(x), tf(mask), ta), got)
    assert torch.equal(ref.masked_min_pair_ref(tf(x), tf(mask), ta), got)
    for b in range(B):
        xb, mb = jnp.asarray(x[b]), jnp.asarray(mask[b])
        for col, xs in ((0, xb), (1, None if add is None
                                  else xb + jnp.asarray(add))):
            if xs is None:
                assert np.isposinf(got[b, 1].item())
                continue
            want = pallas_masked_min(xs, mb, interpret=True)
            assert _bitwise(want, got[b, col]), (b, col)
            assert _bitwise(rref.masked_min_ref(xs, mb), got[b, col])
    if B > 1:
        assert torch.isinf(got[-1]).all()


def emulate_reads(n, lanes, off_x, off_m, off_a, pair):
    """csrc/segment_min.cu's index arithmetic for ``[lanes, n]`` x and
    mask starting ``off_x`` / ``off_m`` elements into a 256-byte-aligned
    allocation (add ``off_a``): how often each element is read, and the
    byte addresses of the x, mask and add vector loads."""
    c = _constexprs((_build.CSRC / "segment_min.cu").read_text())
    threads, unroll = c["kThreads"], c["kUnroll"]
    bx = min(max(-(-n // c["kBlockElems"]), 1), MAX_BLOCKS)
    stride = bx * threads
    reads = np.zeros((lanes, n), np.int64)
    vec_addrs = []
    for b in range(lanes):
        ax, am, aa = 4 * (off_x + b * n), off_m + b * n, 4 * off_a
        h = ((16 - (ax & 15)) & 15) >> 2
        vec = h == ((4 - (am & 3)) & 3)
        if pair:
            vec = vec and h == (((16 - (aa & 15)) & 15) >> 2)
        if not vec or h > n:
            h = n
        nvec = (n - h) >> 2
        tail = h + 4 * nvec
        for tid in range(stride):
            reads[b, tid:h:stride] += 1
            reads[b, tail + tid:n:stride] += 1
            for v in range(tid, nvec, stride * unroll):
                for u in range(unroll):
                    j = v + u * stride
                    if j < nvec:
                        e = h + 4 * j
                        reads[b, e:e + 4] += 1
                        vec_addrs.append((ax + 4 * e, am + e,
                                          aa + 4 * e if pair else 0))
    return reads, np.array(vec_addrs, np.int64).reshape(-1, 3), bx


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (1, 0, 0),
                                     (0, 0, 1), (3, 3, 3)])
@pytest.mark.parametrize("n", [1, 3, 1001, 4099, 12_289])
def test_kernel_reads_each_element_once_aligned(n, offsets):
    for pair in (False, True):
        reads, addrs, bx = emulate_reads(n, 3, *offsets, pair=pair)
        assert (reads == 1).all(), (pair, np.argwhere(reads != 1)[:5])
        assert 1 <= bx <= MAX_BLOCKS
        assert (addrs[:, 0] % 16 == 0).all() and (addrs[:, 1] % 4 == 0).all()
        assert (addrs[:, 2] % 16 == 0).all()
        if len(set(offsets)) == 1 and n >= 7:
            # the first row's x, mask and add in step: float4 groups
            assert len(addrs) >= (n - 3) // 4


def _graphs(family, n=300, seed=7):
    nn, src, dst, w = rgen.make(family, n, seed=seed)
    rg = rbuild(nn, src, dst, w)
    return rg, graph_from_arrays(rg, device="cpu")


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def _counting(solver):
    """Wrap the solver's bound ``masked_min_pair`` in a call counter."""
    calls = []
    inner = solver.prims.masked_min_pair

    def pair(x, mask, add):
        calls.append(add is not None)
        return inner(x, mask, add)
    solver.prims = dataclasses.replace(solver.prims, masked_min_pair=pair)
    return calls


@pytest.mark.parametrize("cfg", list(R_CFG))
@pytest.mark.parametrize("family", ["gnp", "grid", "power_law"])
def test_pallas_route_bitwise_one_pair_a_round(family, cfg):
    rg, pg = _graphs(family)
    rs = R.Solver(rg, R_CFG[cfg], backend="ell")
    ps = P.Solver(pg, P_CFG[cfg], backend="pallas", device="cpu")
    calls = _counting(ps)
    ra, pa = rs.solve_batch([0, 5, 17]), ps.solve_batch([0, 5, 17])
    assert _same(ra.dist, pa.dist) and _same(ra.C, pa.C)
    assert _same(ra.fixed, pa.fixed)
    assert np.array_equal(ra.rounds, pa.rounds)
    assert ra.fixed_by == pa.fixed_by
    assert len(calls) == int(pa.rounds.max())
    assert set(calls) == {"out" in P_CFG[cfg].rules}
    calls.clear()
    a, b = rs.solve(5), ps.solve(5)
    assert _same(a.dist, b.dist) and _same(a.C, b.C) and _same(a.fixed,
                                                               b.fixed)
    assert (a.rounds, a.fixed_by) == (b.rounds, b.fixed_by)
    assert len(calls) == b.rounds
    assert _build.launch_counts()["masked_min_pair"] == 0   # no kernel here


@pytest.mark.parametrize("backend", ["segment", "frontier"])
def test_other_routes_one_pair_a_round(backend):
    rg, pg = _graphs("grid", n=400, seed=3)
    rs = R.Solver(rg, R.SP4_CONFIG, backend=backend)
    ps = P.Solver(pg, P.SP4_CONFIG, backend=backend, device="cpu")
    calls = _counting(ps)
    a, b = rs.solve_batch([0, 9]), ps.solve_batch([0, 9])
    assert _same(a.dist, b.dist) and a.fixed_by == b.fixed_by
    assert np.array_equal(a.rounds, b.rounds)
    assert len(calls) == int(b.rounds.max()) and all(calls)


def test_pallas_route_sp2_vs_reference_pallas_interpret():
    """No out rule: the pair's add is None; against the reference's
    Pallas kernels in interpret mode."""
    nn, src, dst, w = rgen.make("gnp", 64, seed=5)
    rg = rbuild(nn, src, dst, w)
    rell = rbuild_ell(nn, src, dst, w)
    rs = R.Solver(rg, R_CFG["sp2"], backend="pallas", ell=rell)
    ps = P.Solver(graph_from_arrays(rg, device="cpu"), P_CFG["sp2"],
                  backend="pallas", ell=ell_from_arrays(rell, device="cpu"),
                  device="cpu")
    calls = _counting(ps)
    a, b = rs.solve(3), ps.solve(3)
    assert _same(a.dist, b.dist) and _same(a.C, b.C)
    assert (a.rounds, a.fixed_by) == (b.rounds, b.fixed_by)
    assert calls == [False] * b.rounds


def test_pair_wrapper_checks_arguments():
    x, m = torch.zeros((2, 5)), torch.ones((2, 5), dtype=torch.bool)
    a = torch.zeros(5)
    assert torch.equal(masked_min_pair(x, m, a), torch.zeros((2, 2)))
    assert torch.isinf(masked_min_pair(x, m, None)[:, 1]).all()
    with pytest.raises(TypeError):
        masked_min_pair(x, m, a.double())
    with pytest.raises(ValueError):
        masked_min_pair(x, m, a[:4])
    with pytest.raises(ValueError, match="contiguous"):
        masked_min_pair(x, m, torch.zeros((5, 2))[:, 0])
    with pytest.raises(ValueError, match="no kernel"):
        masked_min_pair(x.to("meta"), m.to("meta"), a.to("meta"))
    before = _build.launch_counts()
    masked_min_pair(x, m, a)
    assert _build.launch_counts() == before          # the CPU launches nothing
    assert torch.equal(ref.masked_min_pair_ref(x, m, a), torch.zeros((2, 2)))
