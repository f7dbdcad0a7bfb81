"""Port parity for xDeepFM training: ``loss_fn``'s value, accuracy and
the gradient of every parameter leaf against ``jax.value_and_grad`` of
the reference's ``loss_fn`` on the same weights (carried across by
``convert``) and batch, at the SMOKE config and at FULL's widths (CIN
200-200-200: layer 2 and 3's dx_0 in one launch each) with its fields
cut to 1,000 rows; and the reference's
``test_training_reduces_loss`` on the port (60 SGD steps, lr 0.1, SMOKE,
CPU).  Tolerance: the reference's xDeepFM tolerance, rtol = atol = 1e-4
(float32 sums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xdeepfm as rxd
from repro_torch import convert
from repro_torch.checkpoint.store import tree_leaves
from repro_torch.data.synthetic import RecsysStream
from repro_torch.kernels import cin
from repro_torch.models import xdeepfm as pxd
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_xdeepfm import REF_SMOKE, REF_WIDE, _port_cfg

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cfg,B", [(REF_SMOKE, 16), (REF_WIDE, 6)])
def test_loss_and_grads_vs_reference(cfg, B, monkeypatch):
    rparams = rxd.init_params(cfg, jax.random.PRNGKey(1))
    pparams = convert.xdeepfm_params_from_arrays(rparams, device="cpu")
    batch = RecsysStream(cfg.sizes(), cfg.offsets, B, seed=2).next_batch()
    leaves = tree_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    wgrads = []
    real = cin.cin_weight_grad
    monkeypatch.setattr(cin, "cin_weight_grad",
                        lambda *a: wgrads.append(1) or real(*a))
    loss, metrics = pxd.loss_fn(pparams, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert len(wgrads) == len(cfg.cin_layers)    # one a CIN layer
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: rxd.loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg),
        has_aux=True)(rparams)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), **TOL)
    np.testing.assert_allclose(float(metrics["acc"]), float(rmetrics["acc"]))
    rleaves = jax.tree.leaves(rgrads)
    assert len(rleaves) == len(grads)
    for g, w in zip(grads, rleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_init_params_requires_grad_on_request():
    cfg = _port_cfg(REF_SMOKE)
    gen = torch.Generator().manual_seed(0)
    assert not any(t.requires_grad for t in tree_leaves(
        pxd.init_params(cfg, gen, "cpu")))
    assert all(t.requires_grad for t in tree_leaves(
        pxd.init_params(cfg, gen, "cpu", requires_grad=True)))
    model = pxd.XDeepFM.init(cfg, gen, "cpu")
    assert not any(p.requires_grad for p in model.parameters())


def test_training_reduces_loss():
    cfg = _port_cfg(REF_SMOKE)
    params = pxd.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             requires_grad=True)
    leaves = tree_leaves(params)
    stream = RecsysStream(cfg.sizes(), cfg.offsets, batch=64, seed=0)
    lr = 0.1
    losses = []
    for _ in range(60):
        batch = {k: torch.from_numpy(v) for k, v in
                 stream.next_batch().items()}
        loss, _ = pxd.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p -= lr * g
        losses.append(float(loss.detach()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.03
