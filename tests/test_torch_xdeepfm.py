"""Port parity for xDeepFM scoring: the port's embedding bag, forward,
loss, retrieval scores, configurations and data stream against the
reference on the same numpy inputs, with the reference's weights carried
across by ``convert``.  The CIN runs on the CPU through its plain
version; the reference's runs through its Pallas kernel (interpret mode)
and its einsum oracle.  Tolerances are the reference's own
(tests/test_xdeepfm.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.configs import xdeepfm as rcfg
from repro.data.synthetic import RecsysStream as RefStream
from repro.kernels import ops as rops
from repro.models import xdeepfm as rxd
from repro_torch import convert
from repro_torch.configs import xdeepfm as pcfg
from repro_torch.data.synthetic import RecsysStream
from repro_torch.kernels import ops as kops
from repro_torch.models import xdeepfm as pxd
from test_torch_graph import _one_torch_thread  # noqa: F401

REF_SMOKE = get_arch("xdeepfm").smoke
# FULL's widths (39 fields, embed 10, CIN 200-200-200, MLP 400-400) with
# every field cut to at most 1,000 rows so the table stays small
REF_WIDE = dataclasses.replace(
    rcfg.FULL, field_sizes=tuple(min(s, 1000) for s in rcfg.FULL.sizes()))


def _port_cfg(cfg) -> pxd.XDeepFMConfig:
    return pxd.XDeepFMConfig(
        n_fields=cfg.n_fields, embed_dim=cfg.embed_dim,
        cin_layers=cfg.cin_layers, mlp_dims=cfg.mlp_dims,
        field_sizes=cfg.field_sizes)


def _setup(cfg, B, seed=0):
    params = rxd.init_params(cfg, jax.random.PRNGKey(seed))
    batch = RefStream(cfg.sizes(), cfg.offsets, batch=B,
                      seed=seed).next_batch()
    return (params, {k: jnp.asarray(v) for k, v in batch.items()},
            convert.xdeepfm_params_from_arrays(params, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_embedding_bag_vs_reference():
    rparams, rbatch, pparams, pbatch = _setup(REF_SMOKE, B=16)
    got = pxd.embedding_bag(pparams["table"], pbatch["indices"])
    want = rxd.embedding_bag(rparams["table"], rbatch["indices"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [REF_SMOKE, REF_WIDE],
                         ids=["smoke", "full_widths"])
@pytest.mark.parametrize("use_pallas_cin", [False, True])
def test_cin_layers_of_forward_vs_reference(cfg, use_pallas_cin):
    """Each CIN layer as the forward chains it, on its own x_0, against
    the reference's chain, relative to the layer's largest output.  At the
    init scales a layer-2 or layer-3 output moves a logit by far less than
    the forward test's atol, so the logits alone cannot see these layers."""
    rparams, rbatch, pparams, pbatch = _setup(cfg, B=32)
    x0 = pxd.embedding_bag(pparams["table"], pbatch["indices"])
    rx0 = rxd.embedding_bag(rparams["table"], rbatch["indices"])
    xk, rxk = x0, rx0
    for w, rw in zip(pparams["cin"], rparams["cin"], strict=True):
        xk = kops.cin_layer(xk, x0, w)
        rxk = rops.cin_layer(rxk, rx0, rw, use_pallas=use_pallas_cin)
        want = np.asarray(rxk)
        assert xk.shape == want.shape
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(xk.numpy() - want).max() <= 3e-4 * scale


@pytest.mark.parametrize("cfg", [REF_SMOKE, REF_WIDE],
                         ids=["smoke", "full_widths"])
@pytest.mark.parametrize("use_pallas_cin", [False, True])
def test_forward_vs_reference(cfg, use_pallas_cin):
    cfg = dataclasses.replace(cfg, use_pallas_cin=use_pallas_cin)
    rparams, rbatch, pparams, pbatch = _setup(cfg, B=32)
    want = np.asarray(rxd.forward(rparams, rbatch, cfg))
    got = pxd.forward(pparams, pbatch)
    assert got.shape == (32,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    model = pxd.XDeepFM(_port_cfg(cfg), pparams)
    assert torch.equal(model(pbatch["indices"]), got)


def test_loss_vs_reference():
    rparams, rbatch, pparams, pbatch = _setup(REF_SMOKE, B=64, seed=3)
    want_loss, want_aux = rxd.loss_fn(rparams, rbatch, REF_SMOKE)
    loss, aux = pxd.loss_fn(pparams, pbatch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(aux["acc"]) == float(want_aux["acc"])


def test_retrieval_scores_vs_reference():
    rparams, rbatch, pparams, pbatch = _setup(REF_SMOKE, B=1, seed=4)
    cand = np.random.default_rng(5).normal(
        size=(5000, REF_SMOKE.embed_dim)).astype(np.float32)
    got = pxd.retrieval_scores(pparams, pbatch["indices"],
                               torch.from_numpy(cand))
    want = rxd.retrieval_scores(rparams, rbatch["indices"],
                                jnp.asarray(cand), REF_SMOKE)
    assert got.shape == (5000,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-7)
    model = pxd.XDeepFM(_port_cfg(REF_SMOKE), pparams)
    assert torch.equal(model.retrieval_scores(pbatch["indices"],
                                              torch.from_numpy(cand)), got)


@pytest.mark.parametrize("cfg", [REF_SMOKE, rcfg.FULL],
                         ids=["smoke", "full"])
@pytest.mark.parametrize("seed", [0, 7])
def test_recsys_stream_same_arrays(cfg, seed):
    ref = RefStream(cfg.sizes(), cfg.offsets, batch=64, seed=seed)
    port = RecsysStream(cfg.sizes(), cfg.offsets, batch=64, seed=seed)
    for _ in range(2):
        a, b = ref.next_batch(), port.next_batch()
        for key in ("indices", "labels"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


def test_configs_match_reference():
    for name in ("FULL", "SMOKE"):
        r, p = getattr(rcfg, name), getattr(pcfg, name)
        assert p == _port_cfg(r)
        assert p.sizes() == r.sizes() and p.total_rows == r.total_rows
        assert np.array_equal(p.offsets, r.offsets)
    assert pcfg.FULL.total_rows == 18_916_161
    assert pcfg.SHAPES == rcfg.SHAPES
    assert pcfg.VALUES_PER_FIELD == rcfg.VALUES_PER_FIELD
    for shape in ("serve_p99", "serve_bulk"):
        B = pcfg.SHAPES[shape]["batch"]
        assert pcfg.cell_flops(pcfg.FULL, B) == rcfg._cell_flops(rcfg.FULL, B)
    default = pxd.XDeepFMConfig(n_fields=12)
    assert default.sizes() == rxd.XDeepFMConfig(n_fields=12).sizes()


def test_init_params_tree_and_scales():
    """Same tree, shapes and scales as the reference's init (the numbers
    differ: torch.Generator, not jax.random)."""
    cfg = dataclasses.replace(REF_WIDE, cin_layers=(40, 30))
    ref = rxd.init_params(cfg, jax.random.PRNGKey(0))
    got = pxd.init_params(_port_cfg(cfg), torch.Generator().manual_seed(0),
                          device="cpu")
    assert set(got) == set(ref)
    for key in ("table", "linear", "bias", "cin_out"):
        assert tuple(got[key].shape) == tuple(np.shape(ref[key]))
    for a, b in zip(got["cin"], ref["cin"], strict=True):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(float(a.std()), float(jnp.std(b)),
                                   rtol=0.1)
    for (w, b), (rw, rb) in zip(got["dnn"], ref["dnn"], strict=True):
        assert tuple(w.shape) == rw.shape and tuple(b.shape) == rb.shape
    np.testing.assert_allclose(float(got["table"].std()), 0.01, rtol=0.05)
    again = pxd.init_params(_port_cfg(cfg), torch.Generator().manual_seed(0),
                            device="cpu")
    assert torch.equal(again["table"], got["table"])


def test_model_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pxd.XDeepFM.init(pcfg.SMOKE, torch.Generator())
    model = pxd.XDeepFM.init(pcfg.SMOKE, torch.Generator().manual_seed(1),
                             device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    idx = torch.from_numpy(RecsysStream(
        pcfg.SMOKE.sizes(), pcfg.SMOKE.offsets, batch=5).next_batch()
        ["indices"])
    assert model(idx).shape == (5,)
