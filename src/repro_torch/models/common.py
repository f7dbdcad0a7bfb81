"""Shared model substrate (port of ``repro/models/common.py``): norms,
RoPE and generator-based initialisers.

Norms accumulate in float32 and cast back to the input's dtype, as the
reference does.  RoPE splits the head dimension into halves (not
interleaved pairs).  Initialisers draw from an explicit
``torch.Generator``: the port's random weights are not the reference's
(the two generators differ), so parity tests carry the reference's
weights across with ``convert.lm_params_from_arrays``.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 accumulation, cast back to ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def rope_frequencies(head_dim: int, max_pos: int, theta: float,
                     dtype=torch.float32, device=None):
    """cos and sin tables, each ``[max_pos, head_dim // 2]``."""
    inv = _inv_freq(head_dim, theta, device)
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """``x`` [..., S, H, head_dim]; ``cos``/``sin`` [S, head_dim // 2]."""
    return _rotate(x, cos[..., :, None, :], sin[..., :, None, :])


def apply_rope_at(x: torch.Tensor, pos: int, head_dim: int,
                  theta: float) -> torch.Tensor:
    """Decode-step RoPE at the single position ``pos``; ``x`` [B, 1, H,
    hd].  ``pos`` is a host integer (the cache keeps it on the host)."""
    freqs = float(pos) * _inv_freq(head_dim, theta, x.device)
    return _rotate(x, torch.cos(freqs), torch.sin(freqs))


def normal_init(generator: torch.Generator, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """Normal(0, ``scale``) in ``dtype``, drawn in float32 from
    ``generator`` (which lives on ``device``)."""
    return (torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=device)
            * scale).to(dtype)
