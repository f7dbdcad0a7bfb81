"""Port parity for the legacy round's single-lane frontier branch
(``engine._round`` with ``backends.lane_frontier_prims``): the two lanes
of a bidirectional pair (a graph and its reverse, a ``GraphStack``) held
round by round against the reference's vmapped ``_round`` on the stacked
pair: D, C, fixed, explored, the buffers ``f_idx``/``f_cnt``, ``edges``
(int64 here, int32 there), rounds and fixed_by; label-correcting and
label-setting, with the buffer at ``next_pow2(n)`` and below n (the
dense fallback of an overflowing lane).  Also the B1 wrapper's plain
path and its one call a lane a round."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core.graph import build_graph as rbuild
from repro.core.sssp import backends as rbackends
from repro.core.sssp.bidirectional import _stack2
from repro.core.sssp.engine import SP3_CONFIG as R_SP3
from repro.core.sssp.engine import SP4_CONFIG as R_SP4
from repro.core.sssp.engine import _init_state as r_init
from repro.core.sssp.engine import _round as r_round
from repro_torch.convert import csr_from_arrays, graph_from_arrays
from repro_torch.core.graph import stack_graphs
from repro_torch.core.sssp import backends
from repro_torch.core.sssp.engine import (SP3_CONFIG, SP4_CONFIG, _cond,
                                          _init_state, _round)
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import frontier_relax as fr
from test_torch_graph import _one_torch_thread  # noqa: F401

FAMILIES = ["gnp", "dag", "unweighted", "grid", "power_law", "chain",
            "geometric"]
CONFIGS = {"sp4": (R_SP4, SP4_CONFIG), "sp3": (R_SP3, SP3_CONFIG)}


def _same(a, b):
    return np.array_equal(np.asarray(a), b.cpu().numpy())


def pair(family, cap, n=120, seed=5):
    """Both packages' two-lane frontier setups for a graph and its
    reverse, the reference's CSR views widened as its bidirectional
    solver widens them."""
    rg = rbuild(*rgen.make(family, n, seed=seed))
    rr = rg.reverse()
    cf, cb = rg.csr(), rr.csr()
    wide = dict(max_out_deg=max(cf.max_out_deg, cb.max_out_deg),
                max_in_deg=max(cf.max_in_deg, cb.max_in_deg))
    g2 = _stack2(rg, rr)
    c2 = _stack2(dataclasses.replace(cf, **wide),
                 dataclasses.replace(cb, **wide))
    stack = stack_graphs([graph_from_arrays(rg, device="cpu"),
                          graph_from_arrays(rr, device="cpu")])
    prims = backends.lane_frontier_prims(
        stack, [csr_from_arrays(cf, device="cpu"),
                csr_from_arrays(cb, device="cpu")], cap)
    return rg, g2, c2, stack, prims


def check_state(rs, ps):
    for name in ("D", "C", "fixed", "explored", "round", "fixed_by",
                 "f_idx", "f_cnt"):
        assert _same(getattr(rs, name), getattr(ps, name)), name
    assert ps.edges.dtype == torch.int64
    assert np.array_equal(np.asarray(rs.edges, np.int64), ps.edges.numpy())


def run_rounds(family, cfg_name, cap, rounds=40):
    rcfg, pcfg = CONFIGS[cfg_name]
    rg, g2, c2, stack, prims = pair(family, cap)
    n = stack.n
    rcap = cap

    def prims_for(g, c):
        return rbackends.frontier_prims(g, c, rcap, False)
    s, t = 3 % n, n - 1
    ends = jnp.asarray([s, t], jnp.int32)
    C0 = jnp.zeros((2, n), jnp.float32)
    rst = jax.vmap(lambda g, c, v, c0: r_init(g, v, c0, prims_for(g, c)))(
        g2, c2, ends, C0)
    step = jax.jit(lambda st: jax.vmap(
        lambda g, c, x: r_round(g, rcfg, x, prims=prims_for(g, c)))(
            g2, c2, st))
    pst = _init_state(stack, torch.tensor([s, t]), None, prims)
    check_state(rst, pst)
    peak = 1
    for _ in range(rounds):
        if not bool(_cond(pst, n + 2).any()):
            break
        rst, pst = step(rst), _round(stack, pcfg, pst, prims)
        check_state(rst, pst)
        peak = max(peak, int(pst.f_cnt.max()))
    return pst, peak


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg_name", ["sp4", "sp3"])
def test_legacy_frontier_round_bitwise(family, cfg_name):
    pst, _ = run_rounds(family, cfg_name, cap=128)    # next_pow2(120)
    assert int(pst.edges.sum()) > 0


@pytest.mark.parametrize("family", ["gnp", "grid", "power_law"])
def test_legacy_frontier_round_overflow_bitwise(family):
    """A buffer of 8 < n: a lane whose frontier outgrows it takes the
    dense relax that round and meters e_pad, as the reference's
    ``lax.cond`` branch under vmap."""
    pst, peak = run_rounds(family, "sp4", cap=8)
    assert peak > 8 and int(pst.edges.sum()) > 0


def test_b1_wrapper_plain_path_and_launch_key():
    rg = rbuild(*rgen.make("grid", 120, seed=5))
    g = graph_from_arrays(rg, device="cpu")
    csr = g.csr()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 9, g.n).astype(np.float32))
    mask = torch.from_numpy(rng.random(g.n) < 0.6)
    f_idx = torch.full((128,), g.n, dtype=torch.int32)
    f_idx[:40] = torch.from_numpy(np.sort(rng.choice(g.n, 40, False)))
    before = _build.launch_counts()
    got = ops.frontier_relax(x, csr, f_idx, mask)
    want = ref.frontier_relax_ref(x[None], mask[None], f_idx, csr.indptr,
                                  csr.dst, csr.w, csr.max_out_deg)[0]
    assert torch.equal(got, want)
    assert _build.launch_counts() == before       # the CPU launches nothing
    assert "frontier_relax" in _build.LAUNCHES
    with pytest.raises(ValueError, match="1-d"):
        fr.frontier_relax(x[None], mask[None], f_idx, csr.indptr, csr.dst,
                          csr.w, csr.max_out_deg)


def test_one_b1_call_a_lane_a_round(monkeypatch):
    calls = []
    real = ops.frontier_relax

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "frontier_relax", counting)
    _, _, _, stack, prims = pair("grid", 128)
    st = _init_state(stack, torch.tensor([0, stack.n - 1]), None, prims)
    for r in range(1, 6):
        st = _round(stack, SP4_CONFIG, st, prims)
        assert len(calls) == 2 * r
    with pytest.raises(ValueError, match="one CSR view a lane"):
        backends.lane_frontier_prims(stack.with_lanes(2),
                                     [None, None], 128)
