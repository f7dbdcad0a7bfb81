"""AdamW over parameter trees (port of ``repro/optim/adamw.py``; not
``torch.optim.AdamW``, whose eps placement and decay order round
differently).

Moments are float32 whatever the parameter dtype, and the update is cast
back to it.  The reference returns new trees; here ``adamw_update``
writes the moments and the parameters in place (at full width the
moments alone are tens of GB) and returns the same trees.  Each
elementwise step is the reference's, in its order, so float32 results
round as the reference's do.  ``step`` is a host int32 tensor: the
schedule and the bias corrections read nothing back from the card.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.store import map_leaves, tree_leaves


def host_scalars():
    """A context in which the host's scalar math (the step count, the
    schedule, the bias corrections) runs on real tensors even inside a
    fake-tensor trace (the dry-run), so its values can still be read."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    return unset_fake_temporarily()


def adamw_init(params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": map_leaves(zeros32, params),
            "v": map_leaves(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(grads, state: dict, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """One AdamW step: returns ``(params, state)``, both updated in place
    (``state["step"]`` is replaced by ``step + 1``).  ``lr`` is a float or
    a 0-d tensor."""
    with host_scalars():
        step = state["step"] + 1
        t = step.to(torch.float32)
        bc1 = float(1.0 - b1 ** t)
        bc2 = float(1.0 - b2 ** t)
        lr = float(lr)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32.square())
        del g32
        p32 = p.float()
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        delta.add_(weight_decay * p32)
        p.copy_(p32 - delta.mul_(lr))
    state["step"] = step
    return params, state
