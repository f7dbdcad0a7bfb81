"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.checkpoint.store import map_leaves, tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed in float32; a 0-d
    tensor on the leaves' device."""
    total = None
    for x in tree_leaves(tree):
        s = x.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return total.sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled by min(1, max_norm / norm), norm)``: each leaf
    scaled in float32 and returned in its own dtype."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return map_leaves(lambda g: (g.float() * scale).to(g.dtype), grads), gn
