"""Port parity for LM training: ``transformer.loss_fn`` (its loss, its
metrics and the gradient of every parameter leaf) against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
weights (carried across by ``convert``) and the same ``TokenStream``
batch, for all five LM smoke archs (MoE routing and drops, llama4's
chunked-local layers across a chunk boundary), with B6 and its backward
through their plain versions.  The port's gradients go back to the
reference's stacked tree with ``convert.lm_params_to_arrays``.
Tolerance: float32, rtol 1e-3 and atol 1e-5 on the gradients, rtol 1e-4
and atol 1e-6 on the loss and metrics (sums in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rtfm
from repro_torch import convert
from repro_torch.checkpoint.store import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import TokenStream
from repro_torch.kernels import flash_attn
from repro_torch.models import transformer as ptfm
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ARCHS, ref_arch, setup

GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)


def _port_grads(pparams, pcfg, batch):
    leaves = tree_leaves(pparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = ptfm.loss_fn(pparams, batch, pcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, tree_unflatten(pparams, list(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_grads_vs_reference(arch, monkeypatch):
    rcfg = ref_arch(arch).smoke
    if arch == "deepseek-moe-16b":       # drops on: capacity below the load
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=0.5))
    rparams, pcfg, pparams = setup(rcfg, seed=3)
    toks = TokenStream(rcfg.vocab, 33, 2, seed=5).next_batch()["tokens"]
    bwd = []
    real = flash_attn.flash_attention_bwd
    monkeypatch.setattr(flash_attn, "flash_attention_bwd",
                        lambda *a: bwd.append(1) or real(*a))
    loss, metrics, grads = _port_grads(pparams, pcfg,
                                       {"tokens": torch.from_numpy(toks)})
    (rloss, rmetrics), rgrads = jax.value_and_grad(
        lambda p: rtfm.loss_fn(p, {"tokens": jnp.asarray(toks)}, rcfg),
        has_aux=True)(rparams)
    assert len(bwd) == rcfg.n_layers              # one B6 backward a layer
    np.testing.assert_allclose(float(loss.detach()), float(rloss), **LOSS_TOL)
    assert set(metrics) == set(rmetrics) == {"nll", "zloss", "moe_lb",
                                             "moe_z"}
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(rmetrics[key]),
                                   **LOSS_TOL)
    got = convert.lm_params_to_arrays(grads, pcfg)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, rgrads))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(rgrads)):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_params_to_arrays_inverts_from_arrays():
    rcfg = ref_arch("llama4-maverick-400b-a17b").smoke
    rparams, pcfg, pparams = setup(rcfg)
    back = convert.lm_params_to_arrays(pparams, pcfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rparams),
                    strict=True):
        assert np.array_equal(a, np.asarray(b, np.float32))
