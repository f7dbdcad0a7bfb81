"""B3's redesign on the CPU: the ELL row extent (``EllGraph.row_len``)
and a CPU emulation of ``csrc/relax.cu``'s algorithm (each row read to
its extent, 8 threads a row, the lanes packed vertex-major with the mask
folded to +inf, the group's minima reduced), held bitwise against the
port's plain version and the reference's jnp and interpret-mode Pallas
relax on the same numpy inputs.  The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py (tolerance 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core import graph as rgraph
from repro.kernels import ops as rops
from repro_torch import convert
from repro_torch.core import graph as pgraph
from repro_torch.kernels import ops, ref
from repro_torch.kernels.relax import relax_ell, xm_stride
from test_torch_graph import FAMILIES, _one_torch_thread  # noqa: F401

KGROUP = 8        # threads a row in csrc/relax.cu


def _values(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.0, 9.0, shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def emulate_relax_ell(x, src_mask, in_src, in_w, row_len, n):
    """csrc/relax.cu's relax on the CPU in float32: the lanes packed
    vertex-major (``xm``, mask folded to +inf, padded to ``xm_stride``),
    row i read over cells ``[0, row_len[i])``, cell j taken by thread
    ``j % 8`` of the row's group, padding (``s >= n``) skipped, candidate
    ``xm[s] + w``; the threads' partial minima then reduced per lane.
    ``x`` None is the inWeight_nf form (zeros)."""
    B = src_mask.shape[0]
    if x is None:
        x = np.zeros(src_mask.shape, np.float32)
    xm = np.full((n, xm_stride(B)), np.inf, np.float32)
    xm[:, :B] = np.where(src_mask, x, np.float32(np.inf)).T
    out = np.empty((B, n), np.float32)
    for i in range(n):
        acc = np.full((KGROUP, B), np.inf, np.float32)
        for j in range(min(int(row_len[i]), in_src.shape[1])):
            s = int(in_src[i, j])
            if s < 0 or s >= n:
                continue
            g = j % KGROUP
            acc[g] = np.minimum(acc[g], xm[s, :B] + in_w[i, j])
        out[:, i] = acc.min(axis=0)
    return out


def test_reduce_scatter_leaves_lane_g_on_thread_g():
    """group_min<8> of csrc/relax.cu, step for step: after the xor
    exchanges over halves 4, 2, 1, thread g holds the group minimum of
    value g in acc[0]."""
    rng = np.random.default_rng(0)
    acc = rng.uniform(0, 9, (KGROUP, KGROUP)).astype(np.float32)  # [g, k]
    want = acc.min(axis=0)
    acc = acc.copy()
    half = KGROUP // 2
    while half >= 1:
        new = acc.copy()
        for g in range(KGROUP):
            upper = (g & half) != 0
            partner = g ^ half
            p_upper = (partner & half) != 0
            for k in range(half):
                keep = acc[g, k + half] if upper else acc[g, k]
                got = acc[partner, k] if p_upper else acc[partner, k + half]
                new[g, k] = min(keep, got)
        acc = new
        half //= 2
    assert np.array_equal(acc[:, 0], want)


@pytest.mark.parametrize("family", FAMILIES)
def test_row_len_same_from_build_and_convert(family):
    n, src, dst, w = rgen.make(family, 300, seed=4)
    built = pgraph.build_ell(n, src, dst, w, device="cpu")
    conv = convert.ell_from_arrays(rgraph.build_ell(n, src, dst, w),
                                   device="cpu")
    assert built.row_len.dtype == torch.int32
    assert built.row_len.shape == (built.n_pad,)
    assert torch.equal(built.row_len, conv.row_len)
    in_src, in_w = built.in_src.numpy(), built.in_w.numpy()
    j = np.arange(built.deg_pad)[None, :]
    beyond = j >= built.row_len.numpy()[:, None]
    assert (in_src[beyond] == n).all() and np.isinf(in_w[beyond]).all()
    rows = np.nonzero(built.row_len.numpy())[0]
    assert (in_src[rows, built.row_len.numpy()[rows] - 1] < n).all()
    assert (built.row_len.numpy()[n:] == 0).all()


def test_row_len_any_cell_order():
    """``ell_row_len`` on a table whose live cells are not left-packed:
    the extent ends after the last live cell, holes included."""
    n = 5
    in_src = np.full((8, 6), n, np.int32)
    in_src[0, [1, 4]] = [2, 3]
    in_src[1, 0] = 4
    in_src[3, 5] = 0
    got = pgraph.ell_row_len(in_src, n)
    assert got.dtype == np.int32
    assert got.tolist() == [5, 1, 0, 6, 0, 0, 0, 0]


def _hand_ell(rng, n, n_pad, deg):
    """An ELL table with holes: live cells scattered over each row,
    padding (``in_src = n``, +inf) between them; one all-padding row and
    one row longer than a thread group."""
    in_src = np.full((n_pad, deg), n, np.int32)
    in_w = np.full((n_pad, deg), np.inf, np.float32)
    for i in range(n):
        if i == 3:
            continue                               # all padding
        k = 2 * KGROUP + 3 if i == 5 else int(rng.integers(1, 7))
        cols = np.sort(rng.choice(deg, k, replace=False))
        in_src[i, cols] = rng.integers(0, n, k)
        in_w[i, cols] = rng.uniform(0.05, 1.0, k)
    return in_src, in_w


@pytest.mark.parametrize("family", ["gnp", "grid", "power_law", "chain"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_emulated_kernel_vs_plain_and_reference(family, B):
    n, src, dst, w = rgen.make(family, 180, seed=2)
    rell = rgraph.build_ell(n, src, dst, w)
    pell = convert.ell_from_arrays(rell, device="cpu")
    rng = np.random.default_rng(B)
    x = _values(rng, (B, n))
    mask = rng.random((B, n)) < 0.6
    in_src, in_w = pell.in_src.numpy(), pell.in_w.numpy()
    row_len = pell.row_len.numpy()
    for xx in (x, None):
        plain = ops.relax_ell(None if xx is None else torch.from_numpy(xx),
                              pell, torch.from_numpy(mask)).numpy()
        emu = emulate_relax_ell(xx, mask, in_src, in_w, row_len, n)
        assert np.array_equal(emu, plain), xx is None
        d = np.zeros((B, n), np.float32) if xx is None else xx
        for b in range(B):
            for use_pallas in (False, True):
                want = rops.relax_ell(jnp.asarray(d[b]), rell,
                                      jnp.asarray(mask[b]),
                                      use_pallas=use_pallas)
                assert np.array_equal(np.asarray(want), plain[b])


@pytest.mark.parametrize("B", [1, 3, 8])
def test_emulated_kernel_on_a_table_with_holes(B):
    rng = np.random.default_rng(10 + B)
    n, n_pad, deg = 13, 16, 128
    in_src, in_w = _hand_ell(rng, n, n_pad, deg)
    row_len = pgraph.ell_row_len(in_src, n)
    assert row_len[5] > KGROUP and row_len[3] == 0
    x = _values(rng, (B, n))
    mask = rng.random((B, n)) < 0.7
    for xx in (x, None):
        xt = None if xx is None else torch.from_numpy(xx)
        plain = relax_ell(xt, torch.from_numpy(mask), torch.from_numpy(in_src),
                          torch.from_numpy(in_w), n,
                          torch.from_numpy(row_len)).numpy()
        zeros = np.zeros((B, n), np.float32)
        want = ref.relax_ell_ref(torch.from_numpy(zeros if xx is None else xx),
                                 torch.from_numpy(mask),
                                 torch.from_numpy(in_src),
                                 torch.from_numpy(in_w), n).numpy()
        assert np.array_equal(plain, want)
        emu = emulate_relax_ell(xx, mask, in_src, in_w, row_len, n)
        assert np.array_equal(emu, want), xx is None
    assert np.isinf(want[:, 3]).all()


def test_xm_stride_keeps_a_vertex_in_one_sector():
    assert [xm_stride(b) for b in (1, 2, 3, 8, 9, 16, 17)] == \
        [1, 8, 8, 8, 16, 16, 24]


def test_relax_ell_checks_row_len_and_x_none():
    x = torch.zeros((2, 5))
    m = torch.ones((2, 5), dtype=torch.bool)
    src = torch.full((8, 4), 5, dtype=torch.int32)
    w = torch.full((8, 4), float("inf"))
    with pytest.raises(TypeError):
        relax_ell(x, m, src, w, 5, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="row_len"):
        relax_ell(x, m, src, w, 5, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        relax_ell(x[:1], m, src, w, 5)
    out = relax_ell(None, m, src, w, 5, torch.zeros(8, dtype=torch.int32))
    assert out.shape == (2, 5) and torch.isinf(out).all()
