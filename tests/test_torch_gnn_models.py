"""Port parity for GAT and PNA (``repro_torch.models.gnn.gat``, ``pna``)
at smoke widths, and for the four GNN configs: the reference's weights
carried across by ``convert.gnn_params_from_arrays``, the same graph
(isolated nodes, empty segments, padding edges) through both packages;
forward and loss within rtol 1e-4 / atol 1e-5, every gradient leaf of
``torch.autograd`` within rtol 1e-3 / atol 1e-5 of ``jax.grad``'s.

PNA's absolute tolerances scale with the largest magnitude (forward:
1e-5 of the largest output; gradients: 1e-4 of the leaf's largest):
on nodes without in-edges the attenuation scaler is 2.5 / 1e-6, so
outputs reach ~4e3 and gradients ~1e3, and std's sqrt(E[m^2] - mean^2)
cancels.  There the reference's own float32 gradients are 2e-5 of the
leaf's largest away from a float64 run of the port's, as far as the
port's are.  Configs: fields, arch specs and the reference's FLOP
formulas equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.cells import GNN_SHAPES as REF_SHAPES
from repro.models.gnn import gat as rgat
from repro.models.gnn import layers as RL
from repro.models.gnn import pna as rpna
from repro_torch import convert
from repro_torch.checkpoint.store import tree_leaves
from repro_torch.configs import get_arch
from repro_torch.configs.cells import GNN_SHAPE_NAMES, GNN_SHAPES
from repro_torch.models.gnn import gat as pgat
from repro_torch.models.gnn import layers as PL
from repro_torch.models.gnn import pna as ppna
from test_torch_gnn_layers import graph_arrays, to_np
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ref_arch

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# atol times the largest magnitude (output, resp. gradient leaf): PNA,
# and the molecular models' gradients (test_torch_gnn_molecular)
PNA_SCALED = dict(fwd=1e-5, grad=1e-4)
GNN_ARCHS = ("gat-cora", "pna", "dimenet", "nequip")


def port_cfg(rcfg, cls):
    return cls(**dataclasses.asdict(rcfg))


def _tol(tol, want, scale):
    """``tol`` with its atol times ``want``'s largest magnitude when a
    ``scale`` is given."""
    if scale is None:
        return tol
    return dict(tol, atol=scale * float(np.abs(want).max()))


def check_model(rmod, pmod, rcfg, pcfg, ref_b, port_b, seed, scaled=None):
    """Forward, loss, metrics and gradients of one model, reference
    against port from the same weights (``scaled``: the absolute
    tolerances' factors of the largest magnitudes).  Returns the gradient
    leaves' count."""
    scaled = scaled or {}
    rparams = rmod.init_params(rcfg, jax.random.PRNGKey(seed))
    pparams = convert.gnn_params_from_arrays(rparams, device="cpu")
    want_out = np.asarray(jax.jit(
        lambda p, b: rmod.forward(p, b, rcfg))(rparams, ref_b))
    got_out = to_np(pmod.forward(pparams, port_b, pcfg))
    np.testing.assert_allclose(
        got_out, want_out, **_tol(FWD_TOL, want_out, scaled.get("fwd")))

    (want_loss, want_met), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: rmod.loss_fn(p, b, rcfg), has_aux=True))(rparams, ref_b)
    leaves = tree_leaves(pparams)
    for t in leaves:
        t.requires_grad_(True)
    got_loss, got_met = pmod.loss_fn(pparams, port_b, pcfg)
    got_g = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad(got_loss, leaves, allow_unused=True), leaves)]
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss),
                               **FWD_TOL)
    assert set(got_met) == set(want_met)
    for k in want_met:
        np.testing.assert_allclose(float(got_met[k].detach()),
                                   float(want_met[k]),
                                   **FWD_TOL)
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(got_g)
    for i, (a, b) in enumerate(zip(got_g, want_leaves, strict=True)):
        assert a.shape == b.shape
        np.testing.assert_allclose(
            to_np(a), np.asarray(b), err_msg=f"gradient leaf {i}",
            **_tol(GRAD_TOL, np.asarray(b), scaled.get("grad")))
    assert any(float(g.abs().max()) > 0 for g in got_g)
    return len(got_g)


def batches(seed, d, classes):
    n, src, dst, x, y = graph_arrays(seed, n=40, e=150, d=d,
                                     classes=classes, sinks=30)
    return (RL.build_batch(n, src, dst, x, y),
            PL.build_batch(n, src, dst, x, y, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
def test_gat_smoke_matches_reference(seed):
    rcfg = ref_arch("gat-cora").smoke
    pcfg = get_arch("gat-cora").smoke
    ref_b, port_b = batches(seed, rcfg.in_dim, rcfg.n_classes)
    assert check_model(rgat, pgat, rcfg, pcfg, ref_b, port_b, seed) == 6


def test_gat_three_layers_and_train_mask():
    """A deeper GAT (two concatenating layers) and an explicit mask."""
    rcfg = rgat.GATConfig(n_layers=3, d_hidden=4, n_heads=3, in_dim=10,
                          n_classes=4)
    pcfg = port_cfg(rcfg, pgat.GATConfig)
    ref_b, port_b = batches(2, 10, 4)
    check_model(rgat, pgat, rcfg, pcfg, ref_b, port_b, 3)
    mask = np.arange(ref_b.n_nodes) % 3 == 0
    rparams = rgat.init_params(rcfg, jax.random.PRNGKey(4))
    pparams = convert.gnn_params_from_arrays(rparams, device="cpu")
    want, _ = rgat.loss_fn(rparams, ref_b, rcfg, train_mask=mask)
    got, _ = pgat.loss_fn(pparams, port_b, pcfg,
                          train_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **FWD_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_pna_smoke_matches_reference(seed):
    rcfg = ref_arch("pna").smoke
    pcfg = get_arch("pna").smoke
    ref_b, port_b = batches(seed, rcfg.in_dim, rcfg.n_classes)
    n = check_model(rpna, ppna, rcfg, pcfg, ref_b, port_b, seed, PNA_SCALED)
    assert n == 2 * (1 + 2 * rcfg.n_layers + 1)


def test_pna_single_in_edges():
    """Nodes with exactly one in-edge: std's clamp and max == min."""
    rcfg = rpna.PNAConfig(n_layers=2, d_hidden=8, in_dim=5, n_classes=3)
    pcfg = port_cfg(rcfg, ppna.PNAConfig)
    n = 12
    src = np.arange(1, n)
    dst = np.arange(0, n - 1)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    y = rng.integers(0, 3, n)
    check_model(rpna, ppna, rcfg, pcfg, RL.build_batch(n, src, dst, x, y),
                PL.build_batch(n, src, dst, x, y, device="cpu"), 6,
                PNA_SCALED)


def test_gnn_params_tree_lines_up():
    """``tree_leaves`` of a converted tree is ``jax.tree.leaves`` of the
    reference's, int keys (NequIP's ``self``/``skip``) sorted alike."""
    from repro.models.gnn import nequip as rnq
    rcfg = ref_arch("nequip").smoke
    rparams = rnq.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = convert.gnn_params_from_arrays(rparams, device="cpu")
    assert list(pparams["layers"][0]["self"]) == [0, 1, 2]
    for a, b in zip(tree_leaves(pparams), jax.tree.leaves(rparams),
                    strict=True):
        assert a.dtype == torch.float32
        assert np.array_equal(to_np(a), np.asarray(b))


def test_shape_table_equal():
    assert GNN_SHAPES == REF_SHAPES
    assert GNN_SHAPE_NAMES == tuple(REF_SHAPES)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_arch_specs_match_reference(arch):
    spec, ref = get_arch(arch), ref_arch(arch)
    assert (spec.name, spec.kind, spec.shapes, spec.notes) == \
        (ref.name, ref.kind, ref.shapes, ref.notes)
    for which in ("full", "smoke"):
        assert dataclasses.asdict(getattr(spec, which)) == \
            dataclasses.asdict(getattr(ref, which))


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape", GNN_SHAPE_NAMES)
def test_cfg_for_and_cell_flops_match_reference(arch, shape):
    """``cfg_for`` is the reference's ``_cfg_for`` and ``cell_flops`` of
    the shape's edges is its ``build_cell``'s ``model_flops``."""
    import importlib
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")
    rmod = importlib.import_module(f"repro.configs.{arch.replace('-', '_')}")
    if hasattr(rmod, "_cfg_for"):
        cfg = mod.cfg_for(shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            rmod._cfg_for(shape))
    else:
        cfg = mod.FULL
    cell = rmod.build_cell(None, shape)
    assert mod.cell_flops(cfg, GNN_SHAPES[shape]["e"]) == cell.model_flops
