"""DTensor layout helpers of the port's sharded paths.

The models call these on any tensor: on a plain tensor each is the
identity (or answers False), so one card keeps its bits; on a DTensor
they move or read its layout.  ``torch.distributed.tensor`` is imported
only when a DTensor is met.
"""
from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(t, mesh):
    """The plain tensor ``t`` as a DTensor replicated over ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def local_block(x, dim: int) -> tuple[int, int]:
    """``(offset, width)`` of this rank's block of DTensor ``x`` along
    ``dim``, every shard even (as the rules lay them out); the mesh dims
    that shard ``dim`` count in mesh order, the first the major one."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for md, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(md) + coord[md]
            n *= mesh.size(md)
    width = x.shape[dim] // n
    return idx * width, width


def whole_rows(h):
    """A DTensor ``h`` [B, S, ...] whose sequence is sharded (the
    sequence-parallel residual stream) gathered whole along S before a
    product (Megatron-SP's all-gather); any other tensor as it is."""
    if not is_dtensor(h):
        return h
    from torch.distributed.tensor import Replicate, Shard
    p = tuple(Replicate() if isinstance(x, Shard) and x.dim == 1 else x
              for x in h.placements)
    return h if p == tuple(h.placements) else h.redistribute(
        h.device_mesh, p)


def hold_layout(x):
    """``x`` itself; under DTensor its gradient is laid out as ``x`` is
    (a partial sum's replicated), for a view DTensor cannot take back in
    the layout the gradient arrives in (e.g. heads the model axis does
    not divide)."""
    if not is_dtensor(x):
        return x
    return constrain(x, x.device_mesh, tuple(x.placements))


def constrain(x, mesh, p):
    """DTensor ``x`` in placements ``p``, its gradient laid out as ``x``
    was (see ``_Constrain``)."""
    return _Constrain.apply(x, mesh, tuple(p))


def _relayout(x, mesh, p):
    return x if tuple(x.placements) == p else x.redistribute(mesh, p)


class _Constrain(torch.autograd.Function):
    """A relayout whose gradient goes back in the input's layout, a
    partial sum's replicated (Megatron's adjoints: the backward of an
    all-reduce or a reduce-scatter of the forward is the identity or an
    all-gather); bound the same way at every hook, it never leaves
    DTensor a layout its products cannot take."""

    @staticmethod
    def forward(ctx, x, mesh, p):
        from torch.distributed.tensor import Partial, Replicate
        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if isinstance(q, Partial) else q
                         for q in x.placements)
        return _relayout(x, mesh, p).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _relayout(g, ctx.mesh, ctx.back), None, None


def write_slot(cache, slot: int, val) -> None:
    """``cache[:, slot] = val`` for a DTensor ``cache`` [B, S, ...] whose
    dim 1 may be sharded: the rank holding the slot writes its rows of
    ``val`` [B, ...] (laid out as the cache's batch) into its block, the
    others nothing."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in cache.placements)
    if is_dtensor(val):
        val = val.redistribute(mesh, want).to_local()
    lo, width = local_block(cache, 1)
    if lo <= slot < lo + width:
        cache.to_local()[:, slot - lo] = val
