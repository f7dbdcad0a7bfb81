"""Edge-sharded SSSP over ``torch.distributed`` (port of
``repro/core/sssp/distributed.py``).

Garg's rounds on R ranks, as the reference maps them onto a device mesh:

  * the dst-sorted edge list is cut into R contiguous blocks, one a rank
    (``shard_graph_edges`` pads ``e_pad`` to a multiple of ``R * 128``
    with ``src = dst = n`` and ``w = +inf``; ``local_block`` views rank
    r's block);
  * vertex vectors (D, C, fixed) are replicated: every rank runs the same
    round body (``engine._round``) on the same state, reduces its block
    with the segment primitives, and ``all_reduce(MIN)`` combines the
    partial minima (``backends.distributed_prims``) — the PRAM's
    concurrent-min memory as a collective.  An SP4 round makes
    ``1 + c_prop_iters`` of them (the relax and inWeight_nf stacked into
    one, then each C-propagation), a warm taint sweep one;
  * min is exact and the blocks partition the edges, so every world size
    gives the single-device bits, and every rank holds the same state:
    each takes the same branch at every host read, so the collectives
    stay matched.

The process group takes the place of the reference's ``(mesh, axes)``,
whose axes the reference flattens into one edge axis anyway
(``edge_group`` flattens a mesh's data axes into one group).
``default_group`` is the default process group when one is initialized,
else a world of one in which the combine is the identity (the
reference's default mesh of one device); the solve runs on the caller's
device either way.  ``round_program`` is the counterpart of the
reference's ``lower_distributed``: a rank's program of one SP4 round, for
the dry-run (the round count is data-dependent, so the dry-run prices a
round).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.graph import INF, Graph, round_up
from repro_torch.core.sssp.backends import (CollectiveCounter, Primitives,
                                            distributed_prims)
from repro_torch.core.sssp.engine import SP4_CONFIG, SSSPConfig


def shard_graph_edges(g: Graph, n_shards: int) -> Graph:
    """``g`` with ``e_pad`` a multiple of ``n_shards * 128`` (padding edges
    ``src = dst = n``, ``w = +inf``), the reference's arrays."""
    e_pad = round_up(g.e_pad, n_shards * 128)
    if e_pad == g.e_pad:
        return g
    pad = e_pad - g.e_pad

    def ext(t, fill):
        return torch.cat([t, t.new_full((pad,), fill)])
    return dataclasses.replace(g, e_pad=e_pad, src=ext(g.src, g.n),
                               dst=ext(g.dst, g.n), w=ext(g.w, INF))


def resolve_group(group=None):
    """``(group, rank, world)`` of ``group``, or of ``default_group()``
    when it is None."""
    if group is None:
        return default_group()
    return group, dist.get_rank(group), dist.get_world_size(group)


def default_group():
    """``(group, rank, world)``: the default process group when one is
    initialized, else ``(None, 0, 1)``, a world of one whose combine is
    the identity."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def local_block(g: Graph, rank: int, world: int) -> Graph:
    """Rank ``rank``'s contiguous block of the shard-padded dst-sorted edge
    list, as views; vertex arrays and ``n`` are the whole graph's."""
    if g.e_pad % world:
        raise ValueError(f"e_pad {g.e_pad} is not shard-padded for "
                         f"{world} ranks (shard_graph_edges)")
    per = g.e_pad // world
    blk = slice(rank * per, (rank + 1) * per)
    return dataclasses.replace(g, e_pad=per, src=g.src[blk],
                               dst=g.dst[blk], w=g.w[blk])


def sharded_prims(g: Graph, group, rank: int, world: int,
                  counter: CollectiveCounter) -> Primitives:
    """The distributed primitives over rank ``rank``'s block of ``g``."""
    return distributed_prims(local_block(g, rank, world), group, counter)


def edge_group(mesh):
    """The process group of this rank's data axes of ``mesh`` flattened
    into one edge axis (the ranks that share its model coordinate), and
    its size."""
    from repro_torch.distributed.mesh import data_axes
    from repro_torch.optim.adamw import host_scalars
    axes = data_axes(mesh)
    with host_scalars():        # the mesh's rank tensor stays real
        sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    return sub.get_group(), sub.size()


def round_program(g: Graph, group=None, source: int = 0,
                  cfg: SSSPConfig = SP4_CONFIG):
    """This rank's program of ONE SP4 round on the edge-sharded graph
    (the counterpart of the reference's ``lower_distributed``): ``g``
    padded as ``shard_graph_edges`` pads it for the group's world, the
    rank's block relaxed, the minima combined by all-reduces.  Returns
    ``(run, inputs, counter)``: ``run()`` makes the round from the cold
    state at ``source``, ``inputs`` are the tensors it reads (the block
    and the vertex vectors) and ``counter`` its collectives."""
    from repro_torch.core.sssp import engine
    group, rank, world = resolve_group(group)
    g = shard_graph_edges(g, world)
    counter = CollectiveCounter()
    prims = sharded_prims(g, group, rank, world, counter)
    lg = local_block(g, rank, world)
    sources = torch.full((1,), int(source), dtype=torch.int64,
                         device=g.device)
    state = engine._init_state(g, sources)

    def run():
        return engine._round(g, cfg, state, prims)
    inputs = {"edges": [lg.src, lg.dst, lg.w],
              "vertices": [g.in_deg, g.out_deg, g.in_weight, g.out_weight],
              "state": [state.D, state.C, state.fixed]}
    return run, inputs, counter


def run_sssp_distributed(g: Graph, source: int = 0,
                         cfg: SSSPConfig = SP4_CONFIG, group=None):
    """One source with the edges sharded over ``group`` (default:
    ``default_group()``), on ``g``'s device: ``(D, C, fixed, rounds)``,
    bitwise the single-device engine's.  Compatibility entry point for
    ``Solver(backend="distributed").solve``."""
    from repro_torch.core.sssp.solver import Solver
    res = Solver(g, cfg, "distributed", device=g.device,
                 group=group).solve(source)
    return res.dist, res.C, res.fixed, res.rounds
