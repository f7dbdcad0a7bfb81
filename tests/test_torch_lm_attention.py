"""Port parity for the LM's attention: ``flash_attention_gqa`` and
``chunked_local_attention`` (through ``ops.flash_attention``, B6, whose
plain version runs on the CPU) and ``decode_attention`` against the
reference's pure-jnp ``repro.models.attention`` on the same numpy
inputs.  Tolerance: float32, rtol 1e-4 and atol 1e-5 (the reference's
online softmax against the plain version's materialised one); bfloat16
inputs at the reference's bf16 attention tolerance, 2e-2, and bfloat16
decode attention (both sides compute in float32 and round the result
once) at two bf16 steps, 8e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as pattn
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _qkv(B, S, Hkv, G, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.normal(size=(B, S, Hkv, G, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32))


@pytest.fixture
def b6_calls(monkeypatch):
    """Counts the calls of ``ops.flash_attention`` and the shapes it
    gets."""
    calls = []
    real = kops.flash_attention

    def counting(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(kops, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("S", [40, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_attention_gqa_vs_reference(S, G, b6_calls):
    B, Hkv, hd = 2, 2, 16
    q, k, v = _qkv(B, S, Hkv, G, hd, seed=S + G)
    got = pattn.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True)
    want = rattn.flash_attention_gqa(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=True)
    assert got.shape == (B, S, Hkv, G, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    S_pad = -(-S // 128) * 128
    assert b6_calls == [((B, Hkv * G, S_pad, hd),) * 2 + (True,)]


def test_flash_attention_gqa_bfloat16():
    q, k, v = _qkv(1, 96, 2, 4, 32, seed=5)
    got = pattn.flash_attention_gqa(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = rattn.flash_attention_gqa(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_gqa_heads_order_and_padding():
    """Head h of B6's input is query group (h // G, h % G) and KV head
    h // G: the reference's order.  Padding is zeros past S."""
    B, S, Hkv, G, hd = 1, 5, 3, 2, 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, S, Hkv, G, hd, seed=1))
    qh, kh, vh = pattn.gqa_heads(q, k, v)
    assert qh.shape == kh.shape == vh.shape == (B, Hkv * G, 128, hd)
    for h in range(Hkv * G):
        assert torch.equal(qh[0, h, :S], q[0, :, h // G, h % G])
        assert torch.equal(kh[0, h, :S], k[0, :, h // G])
        assert torch.equal(vh[0, h, :S], v[0, :, h // G])
    assert not qh[:, :, S:].any() and not kh[:, :, S:].any()


def test_flash_attention_gqa_refuses_what_b6_cannot_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 1, 2, 8, 0, Sk=128))
    with pytest.raises(ValueError, match="Sq == Sk"):
        pattn.flash_attention_gqa(q, k, v, causal=True)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 40, 1, 2, 8, 0))
    with pytest.raises(ValueError, match="multiples of 128"):
        pattn.flash_attention_gqa(q, k, v, causal=False)


def test_non_causal_takes_unpadded_keys():
    q, k, v = _qkv(1, 40, 2, 2, 16, seed=7, Sk=128)
    got = pattn.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=False)
    want = rattn.flash_attention_gqa(*(jnp.asarray(a) for a in (q, k, v)),
                                     causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S,chunk", [(40, 16), (48, 16), (16, 16),
                                     (12, 16), (300, 128)])
def test_chunked_local_vs_reference(S, chunk, b6_calls):
    """Across chunk boundaries (a ragged last chunk too), one B6 call
    with the chunks as batch rows, each padded to 128."""
    B, Hkv, G, hd = 2, 2, 2, 16
    q, k, v = _qkv(B, S, Hkv, G, hd, seed=S)
    got = pattn.chunked_local_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), chunk=chunk)
    want = rattn.chunked_local_attention(
        *(jnp.asarray(a) for a in (q, k, v)), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    rows = B * -(-S // chunk) if S > chunk else B
    width = -(-min(S, chunk) // 128) * 128
    assert b6_calls == [((rows, Hkv * G, width, hd),) * 2 + (True,)]


def test_chunked_local_masks_cross_chunk():
    """Changing V in chunk 0 leaves the later chunks' outputs alone."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 32, 1, 1, 16, seed=0))
    out0 = pattn.chunked_local_attention(q, k, v, chunk=8)
    v1 = v.clone()
    v1[:, :8] += 100.0
    out1 = pattn.chunked_local_attention(q, k, v1, chunk=8)
    assert torch.equal(out0[:, 8:], out1[:, 8:])
    assert not torch.allclose(out0[:, :8], out1[:, :8])


@pytest.mark.parametrize("length", [1, 7, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_vs_reference(length, dtype):
    B, Smax, Hkv, G, hd = 2, 24, 2, 4, 16
    rng = np.random.default_rng(length)
    q = rng.normal(size=(B, 1, Hkv, G, hd)).astype(np.float32)
    kc = rng.normal(size=(B, Smax, Hkv, hd)).astype(np.float32)
    vc = rng.normal(size=(B, Smax, Hkv, hd)).astype(np.float32)
    tdt = getattr(torch, dtype)
    port = [torch.from_numpy(a).to(tdt) for a in (q, kc, vc)]
    ref = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
           for t in port]
    got = pattn.decode_attention(*port, length)
    want = rattn.decode_attention(*ref, jnp.int32(length))
    assert got.dtype == tdt and got.shape == (B, 1, Hkv, G, hd)
    tol = TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
