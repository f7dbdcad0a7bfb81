"""Port parity for the LM model: configs copied field for field, the
parameter tree carried across by ``convert.lm_params_from_arrays``, the
analytic and actual parameter counts, and teacher-forced ``forward``
(logits and aux losses, MoE drops included) against the reference on the
same tokens, for all five LM archs.  Tolerance: float32, rtol 1e-4 and
atol 1e-5 (products and the attention's softmax sum in another order)."""
import dataclasses
import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rtfm
from repro_torch import convert
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as ptfm
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["command-r-35b", "command-r-plus-104b", "deepseek-moe-16b",
         "llama4-maverick-400b-a17b", "qwen3-32b"]


def ref_arch(name: str):
    """The reference's ``ArchSpec`` of an LM arch, from its config module
    (the reference's registry loads its archs only while it is empty, so
    another test file's partial registration could hide them)."""
    return importlib.import_module(
        "repro.configs." + name.replace("-", "_")).ARCH


def as_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def port_cfg(rcfg) -> ptfm.LMConfig:
    """The port's config with the reference config's fields."""
    fields = as_dict(rcfg)
    if rcfg.moe is not None:
        from repro_torch.models.moe import MoEConfig
        fields["moe"] = MoEConfig(**fields["moe"])
    return ptfm.LMConfig(**fields)


def setup(rcfg, seed=0):
    rparams = rtfm.init_params(rcfg, jax.random.PRNGKey(seed))
    pcfg = port_cfg(rcfg)
    return rparams, pcfg, convert.lm_params_from_arrays(rparams, pcfg,
                                                        device="cpu")


def test_registry_lists_the_five_lm_archs():
    assert [a for a in list_archs() if get_arch(a).kind == "lm"] == ARCHS
    assert list_archs() == sorted(ARCHS + ["xdeepfm", "gat-cora", "pna",
                                           "dimenet", "nequip", "sssp"])
    for a in ARCHS:
        spec, ref = get_arch(a), ref_arch(a)
        assert (spec.name, spec.kind, spec.shapes, spec.notes) == \
            (ref.name, ref.kind, ref.shapes, ref.notes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_and_param_counts(arch, which):
    cfg, rcfg = (getattr(s, which) for s in (get_arch(arch), ref_arch(arch)))
    assert as_dict(cfg) == as_dict(rcfg)
    assert cfg.hd == rcfg.hd and cfg.sub_quadratic == rcfg.sub_quadratic
    assert [cfg.layer_is_global(i) for i in range(cfg.n_layers)] == \
        [rcfg.layer_is_global(i) for i in range(rcfg.n_layers)]
    assert [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] == \
        [rcfg.layer_is_moe(i) for i in range(rcfg.n_layers)]
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    if which == "smoke":
        p = ptfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        leaves = [p["embed"], p["lm_head"], p["final_norm"]] + [
            t for lp in p["layers"] for t in _leaves(lp)]
        assert sum(t.numel() for t in leaves) == cfg.param_count()
    else:
        abs_p = jax.eval_shape(partial(rtfm.init_params, rcfg),
                               jax.random.PRNGKey(0))
        assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(abs_p)) \
            == cfg.param_count()


def _leaves(tree):
    for _, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_tree_matches_init_and_reference(arch):
    """Same structure, shapes and dtypes as the port's own init; every
    leaf is the reference's layer slice, exactly."""
    rcfg = ref_arch(arch).smoke
    rparams, pcfg, pparams = setup(rcfg)
    own = ptfm.init_params(pcfg, torch.Generator().manual_seed(0), "cpu")
    assert len(pparams["layers"]) == len(own["layers"]) == pcfg.n_layers
    for a, b in zip(pparams["layers"], own["layers"], strict=True):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            assert x.shape == y.shape and x.dtype == y.dtype
    i = pcfg.n_layers - 1
    s, sub = divmod(i, pcfg.moe_every)
    want = np.asarray(rparams["layers"]["ab"[sub]]["wq"][s])
    assert np.array_equal(pparams["layers"][i]["wq"].numpy(), want)


def test_bfloat16_leaves_cross_exactly():
    rcfg = dataclasses.replace(ref_arch("llama4-maverick-400b-a17b").smoke,
                               param_dtype="bfloat16")
    rparams, pcfg, pparams = setup(rcfg)
    assert pcfg.dtype == torch.bfloat16
    lp = pparams["layers"][1]
    assert lp["moe"]["we_up"].dtype == torch.bfloat16
    assert lp["moe"]["router"].dtype == torch.float32
    assert lp["attn_norm"].dtype == torch.float32
    want = np.asarray(rparams["layers"]["b"]["moe"]["we_up"][0], np.float32)
    assert np.array_equal(lp["moe"]["we_up"].float().numpy(), want)


def _with_capacity(rcfg, cf):
    return dataclasses.replace(
        rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=cf))


FORWARD_CASES = [(a, "config") for a in ARCHS] + [
    ("deepseek-moe-16b", "drops"), ("llama4-maverick-400b-a17b", "drops")]


@pytest.mark.parametrize("arch,capacity", FORWARD_CASES)
def test_forward_vs_reference(arch, capacity, monkeypatch):
    """Teacher-forced logits and aux losses (llama4's local layers cross
    a chunk boundary), one B6 call a layer."""
    rcfg = ref_arch(arch).smoke
    if capacity == "drops":
        rcfg = _with_capacity(rcfg, 0.5)
    rparams, pcfg, pparams = setup(rcfg)
    toks = np.random.default_rng(1).integers(0, rcfg.vocab, (2, 33),
                                             dtype=np.int32)
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, gaux = ptfm.forward(pparams, torch.from_numpy(toks), pcfg)
    want, waux = rtfm.forward(rparams, jnp.asarray(toks), rcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 33, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]),
                                   rtol=1e-5, atol=1e-9)
    assert len(calls) == rcfg.n_layers
