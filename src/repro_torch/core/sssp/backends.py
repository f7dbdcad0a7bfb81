"""Backend primitives (port of ``repro/core/sssp/backends.py``).

The round body (engine.py) is written once against these vertex-level
ops; a backend is a concrete choice of them.  Every op is batch-first:

    relax(x, src_mask)      [B, n] x [B, n] -> float32[B, n]
        min over in-edges (u, v, w) with src_mask[u] of x[u] + w at v
        (+inf where none): the relax, and the Eqn-(1) C-propagation.
    in_weight_nf(nf_mask)   [B, n] -> float32[B, n]
        min in-edge weight over sources in nf_mask.
    relax2(x, src_mask, nf_mask) -> (relax(x, src_mask),
                                     in_weight_nf(nf_mask))
        optional fusion hook: both depend only on round-start state, so
        a backend may fuse them (the distributed backend stacks them into
        one all-reduce).  None runs them separately.
    masked_min_pair(x, mask, add)  [B, n] x [B, n] x [n] | None
                            -> float32[B, 2]
        per-lane min over masked vertices of x (the heap minimum of
        SP1-SP3) and of x + add (the out-rule threshold; +inf if add is
        None), both in one call.
    relax_frontier_b(x, f_idx, src_mask) -> float32[B, n]
        (frontier backend) the relax restricted to out-edges of the
        shared compacted buffer f_idx int32[frontier_cap] (padding n).
    out_nbrs(idx) -> int32[len(idx), max_out]; in_min_at(x, tgt,
        mask) -> [B, *tgt.shape]: the incremental-maintenance primitives.
    relax_frontier(x, f_idx, src_mask) -> float32[L, n]
        (legacy frontier round) each lane's relax restricted to the
        out-edges of its own buffer f_idx int32[L, cap], over its own
        graph: one single-lane B1 launch a lane.

``stacked_segment_prims`` and ``lane_frontier_prims`` run over a
``GraphStack``: lane l on member ``l // per``, every op one set of
launches for all lanes.  ``distributed_prims`` reduces one rank's block
of the edge list and combines the ranks' partial minima with an
all-reduce (``core/sssp/distributed.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.analysis.contracts import contract
from repro_torch.core.graph import INF, CsrGraph, EllGraph, Graph, GraphStack
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class Primitives:
    """The ops one SSSP round needs (see module docstring)."""

    relax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    in_weight_nf: Callable[[torch.Tensor], torch.Tensor]
    masked_min_pair: Callable[[torch.Tensor, torch.Tensor,
                               torch.Tensor | None], torch.Tensor]
    relax2: Callable | None = None  # optional fused (relax, in_weight_nf)
    frontier_cap: int = 0           # static frontier-buffer size (0 = dense)
    walk_width: int = 1             # max_out_deg * max_in_deg: cells a
    #   walked source costs each lane in out_nbrs -> in_min_at
    relax_frontier_b: Callable | None = None
    out_nbrs: Callable | None = None
    in_min_at: Callable | None = None
    relax_frontier: Callable | None = None


@contract(
    "backend.segment",
    routes=("segment.*",),
    require=("aten.scatter_reduce.amin",),
    dense_budget=8,
    same_round_ops=True,
    notes="The default backend relaxes by scatter_reduce_ 'amin' over "
          "the dst-sorted edge list: every round must run the segment "
          "min, cost at most 8 full-e_pad sweeps (the relax's two "
          "gathers and scatter, inWeight_nf's gather and scatter, the "
          "C-propagation relax's three; a warm round the same: its "
          "taint sweeps run before the rounds) and issue one op "
          "sequence whatever the source or round.")
def segment_prims(g: Graph) -> Primitives:
    """Scatter-min (``scatter_reduce_`` "amin") over the dst-sorted edge
    list.  The reference used its library segment_min outside Pallas here,
    so this backend has no kernel of its own."""
    g.src_l, g.dst_l    # the int64 index copies: made now, not in a round

    def relax(x, src_mask):
        ok = g.gather_src(src_mask, fill=False)
        cand = torch.where(ok, g.gather_src(x) + g.w, INF)
        return g.seg_min_at_dst(cand)

    def in_weight_nf(nf_mask):
        ok = g.gather_src(nf_mask, fill=False)
        return g.seg_min_at_dst(torch.where(ok, g.w, INF))

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min_pair=ref.masked_min_pair_ref)


@contract(
    "backend.ell",
    routes=("ell.*",),
    require=("ops.relax_ell", "ops.masked_min_pair"),
    dense_budget=3,
    same_round_ops=True,
    notes="The ELL backend is row-form: every reduction is one call of "
          "the fused relax (B3: the relax, inWeight_nf and the "
          "C-propagation, each one sweep of the [n_pad, deg_pad] table) "
          "and both minima one masked-min pair (B4); no scatter at all.")
@contract(
    "backend.pallas",
    routes=("pallas.*",),
    require=("ops.relax_ell", "ops.masked_min_pair"),
    dense_budget=3,
    same_round_ops=True,
    notes="'pallas' must actually route through the hand-written "
          "kernels: its rounds call B3's and B4's entries, and on the "
          "card each call launches its kernel (a plain fallback on a "
          "CUDA tensor fails the launch check).  The port's 'ell' and "
          "'pallas' are one backend; the device picks kernel or plain.")
def ell_prims(g: Graph, ell: EllGraph) -> Primitives:
    """Dense padded in-neighbour (ELL) layout.

    Every reduction is one call of the fused relax (B3), and both minima
    of a round are one call of the masked min pair (B4).  The reference's
    "ell" and "pallas" backends differed only in running these as jnp or
    as Pallas kernels; in the port both names run the same wrappers and
    the tensors' device decides: the CUDA kernels on the card, the plain
    versions on the CPU.
    """

    def relax(x, src_mask):
        return ops.relax_ell(x, ell, src_mask)

    def in_weight_nf(nf_mask):
        return ops.relax_ell(None, ell, nf_mask)

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min_pair=ops.masked_min_pair)


@contract(
    "backend.frontier",
    routes=("frontier.*",),
    require=("aten.cumsum", "ops.frontier_relax_b"),
    dense_budget=3,
    notes="The whole point of this backend is the compacted sparse "
          "relax: every route (batched and warm included, the shared "
          "batch frontier of engine._round_shared) must run the cumsum "
          "compaction and B2's fused relax.  Only a round whose union "
          "frontier overflowed the buffer takes the dense segment relax "
          "(3 sweeps, the largest count a probe round reaches: "
          "frontier.batched); inWeight_nf and the C-propagation are "
          "incremental chunked walks with no dense rebuild.")
def frontier_prims(g: Graph, csr: CsrGraph, cap: int) -> Primitives:
    """Sparse-frontier backend: compacted-buffer relax over the CSR view.

    Step 1 gathers only the out-edges of the (at most ``cap``) buffered
    vertices and scatter-mins them per lane through B2.  The dense
    segment primitives stay as the overflow fallback and the init-region
    seeds; the minima are the plain masked min pair, as in the reference.
    """
    base = segment_prims(g)

    def relax_frontier_b(x, f_idx, src_mask):
        return ops.frontier_relax_b(x, csr, f_idx, src_mask)

    def out_nbrs(idx):
        return ops.out_nbrs(csr, idx)

    def in_min_at(x, tgt, src_mask):
        return ops.in_min_at(g, csr, x, tgt, src_mask)

    return Primitives(relax=base.relax, in_weight_nf=base.in_weight_nf,
                      masked_min_pair=ref.masked_min_pair_ref,
                      frontier_cap=int(cap),
                      walk_width=csr.max_out_deg * csr.max_in_deg,
                      relax_frontier_b=relax_frontier_b,
                      out_nbrs=out_nbrs, in_min_at=in_min_at)


def stacked_segment_prims(s: GraphStack) -> Primitives:
    """The segment backend over a ``GraphStack``: one gather and one
    scatter-min for all ``L`` lanes, each lane on its member's edge
    list.  ``masked_min_pair`` takes the members' ``out_weight`` [M, n]
    as its ``add`` and broadcasts it across each member's lanes; the
    sums are the same single f32 adds as a member's own solve."""
    M, P, n = s.size, s.per, s.n
    w = s.w[:, None]                              # [M, 1, e_pad]

    def relax(x, src_mask):
        ok = s.gather_src(src_mask, fill=False)
        return s.seg_min_at_dst(torch.where(ok, s.gather_src(x) + w, INF))

    def in_weight_nf(nf_mask):
        ok = s.gather_src(nf_mask, fill=False)
        return s.seg_min_at_dst(torch.where(ok, w, INF))

    def masked_min_pair(x, mask, add):
        mins = ref.masked_min_pair_ref(x.view(M, P, n), mask.view(M, P, n),
                                       None if add is None else add[:, None])
        return mins.view(M * P, 2)

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min_pair=masked_min_pair)


def lane_frontier_prims(s: GraphStack, csrs: list[CsrGraph],
                        cap: int) -> Primitives:
    """The legacy round's frontier backend over a one-lane-a-member
    stack (the bidirectional pair): step 1 relaxes each lane's own
    buffer over its own CSR view through B1, one launch a lane; the
    other reductions stay the dense stacked segment ones, as in the
    reference's legacy body."""
    if s.per != 1 or len(csrs) != s.size:
        raise ValueError(f"one CSR view a lane: {len(csrs)} views for "
                         f"{s.size} members x {s.per} lanes")
    base = stacked_segment_prims(s)

    def relax_frontier(x, f_idx, src_mask):
        return torch.stack([ops.frontier_relax(x[i], csr, f_idx[i],
                                               src_mask[i])
                            for i, csr in enumerate(csrs)])

    return dataclasses.replace(base, frontier_cap=int(cap),
                               relax_frontier=relax_frontier)


class CollectiveCounter:
    """The distributed backend's combines: ``calls`` all-reduces and the
    ``bytes`` each rank sent into them.  A world of one without a process
    group counts its combines too, though each is the identity.  Once
    ``timed`` is set, each all-reduce is timed (CUDA events on the current
    stream for card tensors, the host clock for CPU ones, whose
    all-reduce blocks); ``ms()`` waits for the events and sums."""

    def __init__(self):
        self.timed = False
        self.calls = 0
        self.bytes = 0
        self._spans: list = []

    def reset(self) -> None:
        self.calls = self.bytes = 0
        self._spans = []

    def all_reduce_min(self, t: torch.Tensor, group) -> torch.Tensor:
        """``t`` (made contiguous: collectives reject strided views) with
        every rank's elementwise minimum, in place; the identity when
        ``group`` is None."""
        t = t.contiguous()
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        if group is None:
            return t
        if not self.timed:
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        elif t.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            ev[1].record()
            self._spans.append(ev)
        else:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            self._spans.append((time.perf_counter() - t0) * 1e3)
        return t

    def ms(self) -> float:
        """Summed milliseconds of the timed all-reduces."""
        return sum(s if isinstance(s, float) else s[0].elapsed_time(s[1])
                   for s in self._spans)


@contract(
    "backend.distributed",
    routes=("distributed.*",),
    require=("aten.scatter_reduce.amin", "dist.all_reduce_min"),
    dense_budget=8,
    same_round_ops=True,
    notes="Rank-local segment relax + a MIN all-reduce combine "
          "(CollectiveCounter.all_reduce_min, the reference's pmin): "
          "both must run every round (a missing combine means the ranks "
          "silently diverge), the sweeps those of the segment round on "
          "the rank's block.")
def distributed_prims(lg: Graph, group, counter: CollectiveCounter
                      ) -> Primitives:
    """Edge-sharded segment reductions: ``lg`` is this rank's block of the
    dst-sorted edge list (``distributed.local_block``; same ``n``), the
    vertex arrays are replicated on every rank, so each rank reduces its
    block and ``counter.all_reduce_min`` combines the partial minima over
    ``group`` (min is exact and the blocks partition the edges, so any
    world size gives the single-device bits).  ``relax2`` stacks the
    round's two reductions into one all-reduce of ``[2, B, n]``; the
    masked minima need no collective."""
    local = segment_prims(lg)

    def relax(x, src_mask):
        return counter.all_reduce_min(local.relax(x, src_mask), group)

    def in_weight_nf(nf_mask):
        return counter.all_reduce_min(local.in_weight_nf(nf_mask), group)

    def relax2(x, src_mask, nf_mask):
        both = counter.all_reduce_min(torch.stack(
            [local.relax(x, src_mask), local.in_weight_nf(nf_mask)]), group)
        return both[0], both[1]

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min_pair=ref.masked_min_pair_ref,
                      relax2=relax2)
