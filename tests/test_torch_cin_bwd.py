"""Port parity for B5's backward: the plain backward
``ref.cin_layer_bwd_ref``, the permuted-weight identity the card uses
for the input gradients (``dx_k = cin_layer(g, x_0, w^T)``, ``dx_0 =
cin_layer(g, x_k, w')`` split over ranges of at most ``MAX_FIELDS`` = 191
values of h), ``cin_weight_grad``'s plain version, and the autograd path
of ``cin_layer`` (layer 1's x_k = x_0 included), each against
``jax.grad`` of the reference's ``repro/kernels/ref.py::cin_layer_ref``
on the same numpy inputs.  Tolerance: the reference's CIN tolerance,
rtol = atol = 3e-4 (float32 sums of up to H*M = 7,800 products in
another order).  The CUDA kernels are held against the same plain
versions on the card by chip_smoke.py."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import _build, cin, ref
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_split_precision import _constexprs

TOL = dict(rtol=3e-4, atol=3e-4)
SHAPES = [(4, 3, 2, 5, 6), (9, 39, 39, 10, 16), (3, 200, 39, 10, 200),
          (2, 400, 7, 4, 5)]


def _inputs(B, H, M, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, D), (B, M, D), (K, H, M), (B, K, D))]


def _jax_grads(xk, x0, w, g):
    def f(xk, x0, w):
        return jnp.sum(rref.cin_layer_ref(xk, x0, w) * g)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (xk, x0, w)))


@pytest.mark.parametrize("B,H,M,D,K", SHAPES)
def test_plain_backward_vs_jax_grad(B, H, M, D, K):
    xk, x0, w, g = _inputs(B, H, M, D, K)
    got = ref.cin_layer_bwd_ref(*map(torch.from_numpy, (xk, x0, w, g)))
    for a, b in zip(got, _jax_grads(xk, x0, w, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("B,H,M,D,K", SHAPES)
def test_permuted_weight_identity_and_split(B, H, M, D, K, monkeypatch):
    """The input gradients as the card takes them, through the forward
    with permuted weights (the plain forward here); dx_0 in
    ceil(H / 191) calls of at most 191 values of h each."""
    xk, x0, w, g = _inputs(B, H, M, D, K, seed=1)
    txk, tx0, tw, tg = map(torch.from_numpy, (xk, x0, w, g))
    calls = []
    real = cin._forward

    def counting(a, b, c):
        calls.append(b.shape[1])
        return real(a, b, c)
    monkeypatch.setattr(cin, "_forward", counting)
    dx_k = cin._forward(tg, tx0, tw.permute(1, 0, 2).contiguous())
    calls.clear()
    dx_0 = cin.input_grad_x0(tg, txk, tw)
    parts = math.ceil(H / cin.MAX_FIELDS)
    assert len(calls) == parts and max(calls) <= cin.MAX_FIELDS
    assert sum(calls) == H
    assert cin.backward_launches(H, M) == {"cin_layer": 1 + parts,
                                           "cin_weight_grad": 1}
    want = _jax_grads(xk, x0, w, g)
    np.testing.assert_allclose(dx_k.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(dx_0.numpy(), np.asarray(want[1]), **TOL)
    dw = cin.cin_weight_grad(tg, txk, tx0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[2]), **TOL)


@pytest.mark.parametrize("B,H,M,D,K", SHAPES)
def test_autograd_path_vs_jax_grad(B, H, M, D, K):
    xk, x0, w, g = _inputs(B, H, M, D, K, seed=2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (xk, x0, w)]
    before = _build.launch_counts()
    out = cin.cin_layer(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    assert _build.launch_counts() == before       # the CPU launches nothing
    for a, b in zip(got, _jax_grads(xk, x0, w, g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_first_layer_sums_both_input_gradients():
    """Layer 1 takes x_0 as both inputs: its gradient is the sum of the
    x_k and the x_0 gradients."""
    _, x0, w, g = _inputs(5, 6, 6, 4, 3, seed=3)
    t0 = torch.from_numpy(x0).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(cin.cin_layer(t0, t0, tw), (t0, tw),
                              torch.from_numpy(g))

    def f(x0, w):
        return jnp.sum(rref.cin_layer_ref(x0, x0, w) * g)
    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("B,H,M,D,K", [
    (65536, 200, 39, 10, 200), (512, 200, 39, 10, 200),
    (512, 39, 39, 10, 200), (1, 7, 5, 3, 65), (100, 400, 7, 4, 5)])
def test_wgrad_plan_covers_the_reduction(B, H, M, D, K):
    """The parts cover the ceil(B * D / WG_COLS) column stages, none empty,
    and the grid (blocks of WG_ROWS values of j by WG_KROWS rows k, S
    parts each) stays within about four waves of the card."""
    S, cps, part = cin.wgrad_plan(B, H, M, D, K)
    stages = math.ceil(B * D / cin.WG_COLS)
    assert (S - 1) * cps < stages <= S * cps
    assert part == ((S, K, H * M) if S > 1 else None)
    tiles = math.ceil(H * M / cin.WG_ROWS) * math.ceil(K / cin.WG_KROWS)
    assert S <= max(1, math.ceil(4 * cin.SMS / tiles))
    if tiles >= cin.SMS:
        assert S == 1


def test_wgrad_checks_arguments():
    g = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        cin.cin_weight_grad(g, torch.zeros((2, 5, 3)), torch.zeros((2, 6, 4)))
    with pytest.raises(ValueError):
        cin.cin_weight_grad(g.double(), torch.zeros((2, 5, 4)),
                            torch.zeros((2, 6, 4)))
    assert cin.cin_weight_grad(g, torch.zeros((2, 5, 4)),
                               torch.zeros((2, 6, 4))).shape == (3, 5, 6)


def test_tile_constants_match_the_cuda_source():
    """The wrapper's tiles and flush interval F are the kernel's: j a block
    (the wgmma's M), rows k a block (two consumer warpgroups of N rows),
    columns a stage (four tf32 k-steps of 8), and F k-steps between two
    Kahan flushes; the stage ring fits the shared memory."""
    c = _constexprs((_build.CSRC / "cin.cu").read_text())
    assert c["kGJt"] == cin.WG_ROWS == 64
    assert c["kGKt"] == 2 * c["kGN"] == cin.WG_KROWS
    assert c["kGCols"] == cin.WG_COLS and cin.WG_COLS % 8 == 0
    assert c["kGFlush"] * c["kGCols"] // 8 == cin.WG_FLUSH
    assert c["kGStage"] == 2 * (c["kGJt"] + c["kGKt"]) * 4 * c["kGCols"]
    assert c["kGSmem"] <= c["kMaxSmem"]
    assert 2 * c["kGG"] // 4 == cin.WG_PREP
    assert cin.wgrad_prep_floats(65536, 10, 200) * 4 == 20480 * 2 * c["kGG"]
