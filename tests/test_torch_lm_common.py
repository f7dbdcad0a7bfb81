"""Port parity for the LM substrate's shared pieces: the port's norms and
RoPE (``repro_torch.models.common``) against the reference's on the same
numpy inputs.  Tolerance: float32, rtol 1e-4 and atol 1e-5 (both sides
compute in float32; only the order of the reductions differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as rcommon
from repro_torch.models import common as pcommon
from test_torch_graph import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 4, 16)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(shape, eps):
    rng = np.random.default_rng(len(shape))
    x, scale = _normal(rng, *shape, scale=3.0), _normal(rng, shape[-1])
    got = pcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), eps)
    want = rcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_keeps_bfloat16():
    rng = np.random.default_rng(1)
    x, scale = _normal(rng, 4, 32), _normal(rng, 32)
    got = pcommon.rms_norm(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(scale))
    want = rcommon.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    assert got.dtype == torch.bfloat16
    # both round the same f32 value to bf16: one bf16 step apart at most
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-5)


def test_layer_norm():
    rng = np.random.default_rng(2)
    x = _normal(rng, 3, 7, 48, scale=2.0) + 1.5
    scale, bias = _normal(rng, 48), _normal(rng, 48)
    got = pcommon.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    want = rcommon.layer_norm(*(jnp.asarray(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hd,theta", [(16, 5e5), (128, 1e6), (64, 1e4)])
def test_rope_frequencies_and_apply_rope(hd, theta):
    S = 40
    cos, sin = pcommon.rope_frequencies(hd, S, theta)
    rcos, rsin = rcommon.rope_frequencies(hd, S, theta)
    assert cos.shape == (S, hd // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(rsin), **TOL)
    x = _normal(np.random.default_rng(hd), 2, S, 3, hd)
    got = pcommon.apply_rope(torch.from_numpy(x), cos, sin)
    want = rcommon.apply_rope(jnp.asarray(x), rcos, rsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [0, 1, 17, 39, 8191])
def test_apply_rope_at_position(pos):
    """One decode position against the reference's, and against row
    ``pos`` of the prompt tables (what prefill uses)."""
    hd, theta = 16, 1e6
    x = _normal(np.random.default_rng(pos), 2, 1, 4, hd)
    got = pcommon.apply_rope_at(torch.from_numpy(x), pos, hd, theta)
    want = rcommon.apply_rope_at(jnp.asarray(x), jnp.int32(pos), hd, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cos, sin = pcommon.rope_frequencies(hd, pos + 1, theta)
    table = pcommon.apply_rope(torch.from_numpy(x), cos[pos:], sin[pos:])
    np.testing.assert_allclose(got.numpy(), table.numpy(), **TOL)


def test_normal_init_is_the_generators():
    g = torch.Generator().manual_seed(3)
    a = pcommon.normal_init(g, (64, 32), 0.5, torch.bfloat16)
    g.manual_seed(3)
    b = pcommon.normal_init(g, (64, 32), 0.5, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert 0.4 < float(a.float().std()) < 0.6
