"""Port parity for B6, flash attention: the port's ``ops.flash_attention``
on the CPU (its plain version) against the reference's Pallas kernel in
interpret mode and its jnp oracle, on the same numpy inputs, over the
reference's own sweep and tolerances (2e-3 in float32, 2e-2 in
bfloat16).  The CUDA kernel is held against the same plain version on
the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attn import flash_attention as pallas_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attn import flash_attention
from test_torch_graph import _one_torch_thread  # noqa: F401


def _qkv(shape_q, shape_kv, dtype, seed):
    """The same values for both packages: numpy float32, rounded to
    bfloat16 by torch where the sweep asks for it."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = [torch.from_numpy(a).to(tdt) for a in arrs]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = [jnp.asarray(t.float().numpy()).astype(jdt) for t in port]
    return port, ref


@pytest.mark.parametrize("B,H,S,d", [(1, 2, 256, 64), (2, 4, 512, 128),
                                     (1, 1, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_vs_pallas_interpret_and_oracle(B, H, S, d, causal, dtype):
    (q, k, v), (jq, jk, jv) = _qkv((B, H, S, d), (B, H, S, d), dtype,
                                   seed=S + d)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    for want in (pallas_flash(jq, jk, jv, causal=causal, interpret=True),
                 rref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_flash_full_attention_with_sq_ne_sk():
    """Without a mask the reference's kernel and oracle agree for any
    lengths, and so does the port."""
    (q, k, v), (jq, jk, jv) = _qkv((1, 2, 128, 32), (1, 2, 384, 32),
                                   "float32", seed=3)
    got = ops.flash_attention(q, k, v, causal=False)
    for want in (pallas_flash(jq, jk, jv, causal=False, interpret=True),
                 rref.flash_attention_ref(jq, jk, jv, causal=False)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


def test_flash_causal_with_sq_ne_sk_raises():
    """The reference aligns a causal mask top-left in its kernel and
    bottom-right in its oracle; the port refuses the case."""
    (q, k, v), (jq, jk, jv) = _qkv((1, 1, 128, 32), (1, 1, 256, 32),
                                   "float32", seed=4)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q, k, v, causal=True)
    kern = pallas_flash(jq, jk, jv, causal=True, interpret=True)
    oracle = rref.flash_attention_ref(jq, jk, jv, causal=True)
    assert not np.allclose(np.asarray(kern), np.asarray(oracle), atol=1e-2)


def test_flash_checks_arguments():
    q = torch.zeros((1, 2, 128, 16))
    with pytest.raises(ValueError, match="multiples of 128"):
        flash_attention(q[:, :, :64].contiguous(), q[:, :, :64].contiguous(),
                        q[:, :, :64].contiguous())
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    big = torch.zeros((1, 1, 128, 129))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    # an input that requires grad gives a differentiable result
    assert flash_attention(q.clone().requires_grad_(), q, q).requires_grad
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    before = _build.launch_counts()
    flash_attention(q, q, q)
    assert _build.launch_counts() == before       # the CPU launches nothing
