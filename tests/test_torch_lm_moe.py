"""Port parity for the MoE FFN: the port's ``moe_ffn`` (routing, the
sort-based capacity dispatch with its drops, expert and shared SwiGLU,
the aux losses) against the reference's on the same numpy inputs, with
the reference's weights carried across.  Tolerance: float32, rtol 1e-4
and atol 1e-5 (the products and the combine sum in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.models import moe as pmoe
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _port_cfg(cfg) -> pmoe.MoEConfig:
    return pmoe.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg, d, seed):
    rp = rmoe.init_moe_params(jax.random.PRNGKey(seed), cfg, d, jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rp, pp


def _run(cfg, B, S, d, seed):
    rp, pp = _params(cfg, d, seed)
    x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
    got, gaux = pmoe.moe_ffn(pp, torch.from_numpy(x), _port_cfg(cfg))
    want, waux = rmoe.moe_ffn(rp, jnp.asarray(x), cfg)
    return got, gaux, want, waux


def _dropped(cfg, B, S, d, seed) -> int:
    """Pairs past capacity in the reference's routing of the same input."""
    rp, _ = _params(cfg, d, seed)
    x = np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], axis=-1)
    eidx = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    C = rmoe.capacity(cfg, S)
    return sum(max(0, int(c) - C) for row in eidx
               for c in np.bincount(row.reshape(-1),
                                    minlength=cfg.n_experts))


CASES = {
    # capacity_factor small enough that tokens drop (C = 8 < S*K/E)
    "drops_top2_shared": (rmoe.MoEConfig(n_experts=4, top_k=2,
                                         d_ff_expert=24, n_shared=2,
                                         capacity_factor=0.5), 2, 40, 32),
    "drops_top1": (rmoe.MoEConfig(n_experts=4, top_k=1, d_ff_expert=16,
                                  capacity_factor=0.25), 3, 48, 16),
    "no_drops_smoke": (rmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=44,
                                      n_shared=2, capacity_factor=2.0),
                       2, 21, 64),
    "decode_step": (rmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=44,
                                   n_shared=2), 4, 1, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_vs_reference(case):
    cfg, B, S, d = CASES[case]
    got, gaux, want, waux = _run(cfg, B, S, d, seed=len(case))
    assert got.shape == (B, S, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("moe_lb", "moe_z"):
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]),
                                   rtol=1e-5)
    assert (_dropped(cfg, B, S, d, seed=len(case)) > 0) == \
        case.startswith("drops")


def test_capacity_and_no_drop():
    for cfg, _, S, _ in CASES.values():
        assert pmoe.capacity(_port_cfg(cfg), S) == rmoe.capacity(cfg, S)
        nd = pmoe.no_drop(_port_cfg(cfg))
        assert pmoe.capacity(nd, S) >= S
    for S in (1, 7, 256, 1024):
        cfg = pmoe.MoEConfig(n_experts=64, top_k=6, d_ff_expert=8)
        assert pmoe.capacity(pmoe.no_drop(cfg), S) >= S


def test_dropped_tokens_fall_through():
    """A dropped token gets nothing from the routed experts: with C = 8
    and every token routed to one expert, tokens 8.. get only the shared
    branch (none here), so their output is exactly 0."""
    cfg = pmoe.MoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                         capacity_factor=0.25)
    g = torch.Generator().manual_seed(0)
    p = pmoe.init_moe_params(g, cfg, 16, torch.float32)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 2] = 1.0
    x = torch.ones((1, 20, 16))
    out, _ = pmoe.moe_ffn(p, x, cfg)
    assert out[0, :8].abs().sum() > 0
    assert torch.equal(out[0, 8:], torch.zeros_like(out[0, 8:]))


def test_bfloat16_keeps_activation_dtype():
    cfg = pmoe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, n_shared=1)
    p = pmoe.init_moe_params(torch.Generator().manual_seed(1), cfg, 32,
                             torch.bfloat16)
    assert p["router"].dtype == torch.float32
    x = torch.randn((2, 9, 32), generator=torch.Generator().manual_seed(2))
    out, aux = pmoe.moe_ffn(p, x.bfloat16(), cfg)
    assert out.dtype == torch.bfloat16
    assert aux["moe_lb"].dtype == torch.float32
    ref, _ = pmoe.moe_ffn({k: v.float() for k, v in p.items()},
                          x.bfloat16().float(), cfg)
    assert torch.allclose(out.float(), ref, rtol=5e-2, atol=5e-2)
