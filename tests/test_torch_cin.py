"""Port parity for B5, the xDeepFM CIN layer: the port's ``ops.cin_layer``
on the CPU (its plain version) against the reference's Pallas kernel in
interpret mode and its einsum oracle, on the same numpy inputs, at
rtol = atol = 3e-4 (the reference's own CIN tolerance: a sum of up to
H*M = 7,800 products taken in another order).  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.cin import cin_layer as pallas_cin_layer
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.cin import cin_layer
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=3e-4, atol=3e-4)
SHAPES = [
    (32, 16, 8, 10, 24),
    (64, 200, 39, 10, 200),   # the paper config (xDeepFM CIN layer 2)
    (32, 39, 39, 10, 200),    # CIN layer 1 (H_0 = n_fields)
    (32, 24, 8, 16, 12),
]


def _inputs(B, H, M, D, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, D)).astype(np.float32),
            rng.normal(size=(B, M, D)).astype(np.float32),
            rng.normal(size=(K, H, M)).astype(np.float32))


@pytest.mark.parametrize("B,H,M,D,K", SHAPES)
def test_cin_vs_pallas_interpret(B, H, M, D, K):
    xk, x0, w = _inputs(B, H, M, D, K)
    got = ops.cin_layer(torch.from_numpy(xk), torch.from_numpy(x0),
                        torch.from_numpy(w))
    want = pallas_cin_layer(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                            interpret=True)
    assert got.shape == (B, K, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,H,M,D,K", SHAPES)
def test_cin_vs_oracle(B, H, M, D, K):
    xk, x0, w = _inputs(B, H, M, D, K, seed=1)
    got = cin_layer(torch.from_numpy(xk), torch.from_numpy(x0),
                    torch.from_numpy(w))
    want = rref.cin_layer_ref(jnp.asarray(xk), jnp.asarray(x0),
                              jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B", [1, 37])
def test_cin_any_batch_vs_padded_reference(B):
    """The reference pads B to its TPU block of 32; the port takes any B."""
    xk, x0, w = _inputs(B, 12, 7, 10, 9, seed=B)
    got = ops.cin_layer(torch.from_numpy(xk), torch.from_numpy(x0),
                        torch.from_numpy(w))
    want = rops.cin_layer(jnp.asarray(xk), jnp.asarray(x0), jnp.asarray(w),
                          use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cin_input_requiring_grad_raises():
    """An input that requires grad raises no more: the call is
    differentiable (its gradients equal the plain backward's), and under
    no_grad it returns a result without a graph."""
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(4, 3, 2, 5, 6))
    out = cin_layer(xk, x0, w.clone().requires_grad_())
    assert out.requires_grad
    out = ops.cin_layer(xk.clone().requires_grad_(), x0, w.detach())
    assert out.requires_grad
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert not cin_layer(xk, x0, w.requires_grad_()).requires_grad
    xk_, x0_, w_ = (t.detach().clone().requires_grad_() for t in (xk, x0, w))
    grads = torch.autograd.grad(cin_layer(xk_, x0_, w_), (xk_, x0_, w_), g)
    want = ref.cin_layer_bwd_ref(xk, x0, w.detach(), g)
    for got, exp in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), **TOL)


def test_cin_checks_arguments():
    xk, x0, w = (torch.from_numpy(a) for a in _inputs(4, 3, 2, 5, 6))
    with pytest.raises(TypeError):
        cin_layer(xk.double(), x0, w)
    with pytest.raises(ValueError):
        cin_layer(xk, x0[:, :, :4].contiguous(), w)
    with pytest.raises(ValueError):
        cin_layer(xk, x0, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cin_layer(xk.transpose(1, 2).contiguous().transpose(1, 2), x0, w)
    with pytest.raises(ValueError, match="no kernel"):
        cin_layer(xk.to("meta"), x0.to("meta"), w.to("meta"))
    before = _build.launch_counts()
    cin_layer(xk, x0, w)
    assert _build.launch_counts() == before       # the CPU launches nothing
