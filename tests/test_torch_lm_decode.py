"""Port parity for KV-cache serving: ``decode_step`` sequences and the
batched ``prefill`` (the last position's logits and every cache entry,
local layers' ring slots included) against the reference's decode steps
on the same tokens, for all five LM archs; and decoding on from the
port's prefill.  The reference's ``prefill`` is its decode step run once
a prompt token; here that step is jitted (the same function, compiled
once per arch).  Tolerance: float32, rtol 1e-4 and atol 1e-5."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as rtfm
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as ptfm
from test_torch_graph import _one_torch_thread  # noqa: F401
from test_torch_lm_model import ARCHS, ref_arch, setup

TOL = dict(rtol=1e-4, atol=1e-5)
T = 21            # crosses the llama4 smoke's chunk of 16
MAX_SEQ = 40
SNAP = 12         # a prompt shorter than the local layers' 16 slots


@pytest.fixture(scope="module")
def runs():
    """Per arch: the reference's logits after each of T decode steps and
    its caches after SNAP and T steps, with the weights and tokens."""
    out = {}

    def run(arch):
        if arch not in out:
            rcfg = ref_arch(arch).smoke
            rparams, pcfg, pparams = setup(rcfg)
            toks = np.random.default_rng(2).integers(0, rcfg.vocab, (2, T),
                                                     dtype=np.int32)
            step = jax.jit(partial(rtfm.decode_step, cfg=rcfg))
            cache = rtfm.init_cache(rcfg, 2, MAX_SEQ)
            logits, snaps = [], {}
            for t in range(T):
                lg, cache = step(rparams, cache, jnp.asarray(toks[:, t]))
                logits.append(np.asarray(lg))
                if t + 1 in (SNAP, T):
                    snaps[t + 1] = cache
            out[arch] = dict(pcfg=pcfg, pparams=pparams, toks=toks,
                             logits=logits, caches=snaps)
        return out[arch]
    return run


def _same_cache(got, want, S):
    assert got.pos == S == int(want.pos)
    assert len(got.k) == len(want.k)
    for gk, gv, wk, wv in zip(got.k, got.v, want.k, want.v, strict=True):
        assert gk.shape == wk.shape
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_vs_reference(arch, runs):
    r = runs(arch)
    cache = ptfm.init_cache(r["pcfg"], 2, MAX_SEQ, device="cpu")
    for t in range(T):
        lg, cache = ptfm.decode_step(r["pparams"], cache,
                                     torch.from_numpy(r["toks"][:, t]),
                                     r["pcfg"])
        assert lg.dtype == torch.float32 and lg.shape == (2, r["pcfg"].vocab)
        np.testing.assert_allclose(lg.numpy(), r["logits"][t], **TOL)
    _same_cache(cache, r["caches"][T], T)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [SNAP, T])
def test_prefill_vs_reference(arch, S, runs, monkeypatch):
    """Logits of the last position and every cache entry, from one
    batched pass with one B6 call a layer."""
    r = runs(arch)
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    lg, cache = ptfm.prefill(r["pparams"], torch.from_numpy(r["toks"][:, :S]),
                             r["pcfg"], MAX_SEQ)
    assert len(calls) == r["pcfg"].n_layers
    np.testing.assert_allclose(lg.numpy(), r["logits"][S - 1], **TOL)
    _same_cache(cache, r["caches"][S], S)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b", "qwen3-32b"])
def test_decode_on_from_prefill(arch, runs, monkeypatch):
    """Prefill SNAP tokens, then decode the rest one step at a time: the
    logits of every step are the reference's (local layers cross their
    chunk boundary after the prefill).  Decode steps launch no B6."""
    r = runs(arch)
    _, cache = ptfm.prefill(r["pparams"],
                            torch.from_numpy(r["toks"][:, :SNAP]),
                            r["pcfg"], MAX_SEQ)
    monkeypatch.setattr(kops, "flash_attention", None)
    for t in range(SNAP, T):
        lg, cache = ptfm.decode_step(r["pparams"], cache,
                                     torch.from_numpy(r["toks"][:, t]),
                                     r["pcfg"])
        np.testing.assert_allclose(lg.numpy(), r["logits"][t], **TOL)
    _same_cache(cache, r["caches"][T], T)


def test_prefill_moe_does_not_drop():
    """With a capacity factor that drops tokens in a batched pass, prefill
    still equals the decode steps (which never drop); ``forward`` keeps
    the drops."""
    import dataclasses
    rcfg = ref_arch("deepseek-moe-16b").smoke
    rcfg = dataclasses.replace(
        rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=0.25))
    _, pcfg, pparams = setup(rcfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, rcfg.vocab, (2, 24), dtype=np.int32))
    lg, _ = ptfm.prefill(pparams, toks, pcfg, 32)
    cache = ptfm.init_cache(pcfg, 2, 32, device="cpu")
    for t in range(24):
        step, cache = ptfm.decode_step(pparams, cache, toks[:, t], pcfg)
    np.testing.assert_allclose(lg.numpy(), step.numpy(), **TOL)
    fwd, _ = ptfm.forward(pparams, toks, pcfg)
    assert not np.allclose(fwd[:, -1].numpy(), step.numpy(), **TOL)


def test_cache_limits():
    _, pcfg, pparams = setup(ref_arch("qwen3-32b").smoke)
    toks = torch.zeros((1, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        ptfm.prefill(pparams, toks, pcfg, 8)
    _, cache = ptfm.prefill(pparams, toks[:, :8], pcfg, 8)
    with pytest.raises(ValueError, match="cannot decode position 8"):
        ptfm.decode_step(pparams, cache, toks[:, 0], pcfg)
