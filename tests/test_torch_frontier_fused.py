"""B2 fused with its CSR gather, on the CPU: the plain version of the
fused entry (``ref.frontier_relax_ref``, what ``ops.frontier_relax_b``
and ``ops.frontier_relax`` run on the CPU) and a CPU emulation of
``csrc/frontier_relax.cu``'s fused kernel (one thread a (slot, out-edge,
lane), an int32 min on the candidates' bit patterns), bitwise against the
reference's jnp frontier relax on the same numpy inputs: all-padding and
overflow-sized buffers included.  The CUDA kernel is held against the
plain version on the card by chip_smoke.py (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generators as rgen
from repro.core import graph as rgraph
from repro.kernels import ops as rops
from repro_torch import convert
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.frontier_relax import frontier_relax_csr
from test_torch_graph import _one_torch_thread  # noqa: F401

INF_BITS = np.float32(np.inf).view(np.int32)


def emulate_frontier_relax_csr(x, src_mask, f_idx, indptr, dst, w,
                               max_deg):
    """csrc/frontier_relax.cu's fused relax on the CPU: thread i takes
    lane ``i % B`` of cell ``i // B`` (slot ``cell // max_deg``, out-edge
    ``cell % max_deg``) and folds ``x[b, u] + w`` (float32) into the
    output's int32 bit patterns with a min, skipping +inf."""
    B, n = x.shape
    bits = np.full((B, n), INF_BITS, np.int32)
    for i in range(len(f_idx) * max_deg * B):
        cell, b = divmod(i, B)
        slot, j = divmod(cell, max_deg)
        u = int(f_idx[slot])
        if u < 0 or u >= n:
            continue
        base = int(indptr[u])
        if j >= int(indptr[u + 1]) - base or not src_mask[b, u]:
            continue
        t = int(dst[base + j])
        if t < 0 or t >= n:
            continue
        c = (np.float32(x[b, u]) + np.float32(w[base + j])).view(np.int32)
        if c != INF_BITS:
            bits[b, t] = min(bits[b, t], c)
    return bits.view(np.float32)


def _values(rng, shape, inf_frac=0.3):
    x = rng.uniform(0.0, 9.0, shape).astype(np.float32)
    x[rng.random(shape) < inf_frac] = np.inf
    return x


def _buffers(rng, n, cap):
    """A partial buffer (padding ``n`` after the live slots), an
    all-padding one, an overflow-sized full one (every slot live) and,
    where cap > n, every vertex followed by padding."""
    k = min(cap, n) // 2
    part = np.concatenate([np.sort(rng.choice(n, k, replace=False)),
                           np.full(cap - k, n)])
    full = np.sort(rng.choice(n, min(cap, n), replace=False))
    full = np.concatenate([full, np.full(cap - len(full), n)])
    return {"partial": part, "all padding": np.full(cap, n),
            "full": full}


@pytest.mark.parametrize("family", ["grid", "chain", "geometric",
                                    "power_law", "gnp"])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_fused_plain_and_emulation_vs_reference(family, B):
    n, src, dst, w = rgen.make(family, 120, seed=8)
    rcsr = rgraph.build_graph(n, src, dst, w).csr()
    pcsr = convert.csr_from_arrays(rcsr, device="cpu")
    rng = np.random.default_rng(B)
    x = _values(rng, (B, n))
    smask = rng.random((B, n)) < 0.6
    tf = torch.from_numpy
    for cap in (16, 256):
        for what, f in _buffers(rng, n, cap).items():
            f_idx = f.astype(np.int32)
            got = ops.frontier_relax_b(tf(x), pcsr, tf(f_idx), tf(smask))
            want = rops.frontier_relax_b(jnp.asarray(x), rcsr,
                                         jnp.asarray(f_idx),
                                         jnp.asarray(smask),
                                         use_pallas=False)
            assert np.array_equal(np.asarray(want), got.numpy()), what
            emu = emulate_frontier_relax_csr(
                x, smask, f_idx, pcsr.indptr.numpy(), pcsr.dst.numpy(),
                pcsr.w.numpy(), pcsr.max_out_deg)
            assert np.array_equal(emu, got.numpy()), what
            one = ops.frontier_relax(tf(x[0]), pcsr, tf(f_idx), tf(smask[0]))
            want1 = rops.frontier_relax(jnp.asarray(x[0]), rcsr,
                                        jnp.asarray(f_idx),
                                        jnp.asarray(smask[0]),
                                        use_pallas=False)
            assert np.array_equal(np.asarray(want1), one.numpy()), what
            if what == "all padding":
                assert torch.isinf(got).all()


def test_fused_plain_is_gather_then_scatter_min():
    """``frontier_relax_ref`` equals the batched scatter-min of the
    tgt/cand table the gather builds (the tgt/cand entry's input)."""
    n, src, dst, w = rgen.make("grid", 150, seed=3)
    pcsr = convert.csr_from_arrays(rgraph.build_graph(n, src, dst, w).csr(),
                                   device="cpu")
    rng = np.random.default_rng(4)
    f_idx = torch.from_numpy(np.concatenate(
        [np.sort(rng.choice(n, 20, replace=False)), np.full(12, n)]
    ).astype(np.int32))
    x = torch.from_numpy(_values(rng, (2, n)))
    smask = torch.from_numpy(rng.random((2, n)) < 0.5)
    u, cell, epos = ref.out_cells(pcsr.indptr, f_idx, pcsr.max_out_deg,
                                  pcsr.e_pad)
    tgt = torch.where(cell, pcsr.dst[epos], n).to(torch.int32)
    cand = torch.where(cell[None] & smask[:, u][:, :, None],
                       x[:, u][:, :, None] + pcsr.w[epos][None],
                       float("inf"))
    want = ref.frontier_scatter_min_batch_ref(tgt, cand, n)
    got = frontier_relax_csr(x, smask, f_idx, pcsr.indptr, pcsr.dst,
                             pcsr.w, pcsr.max_out_deg)
    assert torch.equal(got, want)


def test_fused_wrapper_checks_arguments():
    n = 6
    x = torch.zeros((2, n))
    m = torch.ones((2, n), dtype=torch.bool)
    f = torch.full((4,), n, dtype=torch.int32)
    ip = torch.zeros(n + 1, dtype=torch.int32)
    d = torch.full((8,), n, dtype=torch.int32)
    w = torch.full((8,), float("inf"))
    assert torch.isinf(frontier_relax_csr(x, m, f, ip, d, w, 1)).all()
    with pytest.raises(ValueError, match="f_idx"):
        frontier_relax_csr(x, m, f.long(), ip, d, w, 1)
    with pytest.raises(ValueError, match="src_mask"):
        frontier_relax_csr(x, m.float(), f, ip, d, w, 1)
    with pytest.raises(ValueError, match="contiguous"):
        frontier_relax_csr(torch.zeros((n, 2)).t(), m, f, ip, d, w, 1)
    with pytest.raises(ValueError, match="fit"):
        frontier_relax_csr(x, m, f, ip[:n], d, w, 1)
    with pytest.raises(ValueError, match="no kernel"):
        frontier_relax_csr(*(t.to("meta") for t in (x, m, f, ip, d, w)), 1)
    before = _build.launch_counts()
    frontier_relax_csr(x, m, f, ip, d, w, 1)
    assert _build.launch_counts() == before        # the CPU launches nothing
