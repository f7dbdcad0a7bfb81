"""Port parity for B6's backward: ``ref.flash_attention_bwd_ref`` (the
plain backward, written out from FA2's formulas) and the autograd path
of ``flash_attention`` (the ``torch.autograd.Function`` whose CPU forward
and backward are the plain versions) against ``jax.grad`` of the
reference's oracle ``repro/kernels/ref.py::flash_attention_ref``, causal
and full, in float32; and ragged sequence lengths through
``flash_attention_gqa`` (K/V repeated, S right-padded to 128) against
``jax.grad`` of the reference's ``models/attention.flash_attention_gqa``.
Tolerance: float32, rtol 1e-4 and atol 1e-5 (softmax sums and products
in another order).  The CUDA backward is held against the same plain
version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.models import attention as rattn
from repro_torch.kernels import _build, flash_attn, ref
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models import attention as pattn
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _ref_grads(q, k, v, do, causal):
    def f(q, k, v):
        return jnp.sum(rref.flash_attention_ref(q, k, v, causal=causal) * do)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


CASES = [((1, 2, 128, 32), 128, True), ((2, 3, 256, 64), 256, True),
         ((1, 2, 128, 16), 384, False), ((1, 1, 256, 100), 256, False)]


@pytest.mark.parametrize("shape_q,sk,causal", CASES)
def test_plain_backward_vs_jax_grad(shape_q, sk, causal):
    B, H, Sq, d = shape_q
    q, k, v, do = _arrays([shape_q, (B, H, sk, d), (B, H, sk, d), shape_q],
                          seed=Sq + d)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(
        o.numpy(), ref.flash_attention_ref(tq, tk, tv, causal).numpy(),
        rtol=0, atol=0)
    logits = np.einsum("bhqd,bhkd->bhqk", q / np.sqrt(d), k)
    if causal:
        logits = np.where(np.tril(np.ones((Sq, sk), bool)), logits, -np.inf)
    np.testing.assert_allclose(
        lse.numpy(), np.log(np.exp(logits - logits.max(-1, keepdims=True))
                            .sum(-1)) + logits.max(-1), **TOL)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(got, _ref_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("shape_q,sk,causal", CASES)
def test_autograd_path_vs_jax_grad(shape_q, sk, causal):
    B, H, Sq, d = shape_q
    q, k, v, do = _arrays([shape_q, (B, H, sk, d), (B, H, sk, d), shape_q],
                          seed=7 + Sq)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = _build.launch_counts()
    out = flash_attention(*ts, causal=causal)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(rref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                            causal=causal)), **TOL)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert _build.launch_counts() == before       # the CPU launches nothing
    for g, w in zip(got, _ref_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_no_grad_takes_the_plain_forward():
    q = torch.zeros((1, 1, 128, 8), requires_grad=True)
    with torch.no_grad():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None and not out.requires_grad
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn.flash_attention_bwd(q, q, q, q, torch.zeros((1, 1, 128)),
                                       torch.zeros((1, 1, 8, 128)).mT, True)


@pytest.mark.parametrize("S,G", [(40, 4), (128, 1), (131, 2)])
def test_gqa_ragged_grads_vs_reference(S, G, monkeypatch):
    """Grouped-query attention over a ragged S: the port repeats K/V to
    the query heads and right-pads S to a multiple of 128; autograd sums
    the repeated heads' K/V gradients, and the padded rows' upstream
    gradient is zero, so the gradients equal the reference's."""
    B, Hkv, hd = 2, 2, 16
    q, k, v, do = _arrays([(B, S, Hkv, G, hd), (B, S, Hkv, hd),
                           (B, S, Hkv, hd), (B, S, Hkv, G, hd)], seed=S)

    def f(q, k, v):
        return jnp.sum(rattn.flash_attention_gqa(q, k, v, causal=True) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    seen = []
    real = flash_attn.flash_attention_bwd

    def watching(q_, k_, v_, o_, lse_, do_, causal):
        seen.append(do_)
        return real(q_, k_, v_, o_, lse_, do_, causal)
    monkeypatch.setattr(flash_attn, "flash_attention_bwd", watching)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pattn.flash_attention_gqa(*ts, causal=True)
    got = torch.autograd.grad(out, ts, torch.from_numpy(do))
    assert len(seen) == 1 and seen[0].shape[2] == -(-S // 128) * 128
    assert not seen[0][:, :, S:].any()            # padded rows: dO = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
