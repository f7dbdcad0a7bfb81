"""MLP layers (port of ``init_mlp`` / ``mlp`` in ``repro/models/gnn/layers.py``).

Parameters are a list of ``(w [d_in, d_out], b [d_out])`` pairs, the
reference's layout, so weights carried across by ``convert`` apply as
they are.  The rest of the GNN substrate is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlp(params: list, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` between layers (not after the
    last)."""
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = act(x)
    return x


def init_mlp(dims: list[int], generator: torch.Generator,
             device: torch.device) -> list:
    """float32 normal weights scaled by ``d_in ** -0.5``, zero biases.
    Draws from ``generator``, which lives on ``device``; the numbers differ
    from the reference's random draws."""
    return [
        (torch.randn((dims[i], dims[i + 1]), generator=generator,
                     device=device) * (dims[i] ** -0.5),
         torch.zeros((dims[i + 1],), device=device))
        for i in range(len(dims) - 1)
    ]
