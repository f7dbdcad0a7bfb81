"""Backend primitives (port of ``repro/core/sssp/backends.py``).

The round body (engine.py) is written once against these vertex-level
ops; a backend is a concrete choice of them.  Every op is batch-first:

    relax(x, src_mask)      [B, n] x [B, n] -> float32[B, n]
        min over in-edges (u, v, w) with src_mask[u] of x[u] + w at v
        (+inf where none): the relax, and the Eqn-(1) C-propagation.
    in_weight_nf(nf_mask)   [B, n] -> float32[B, n]
        min in-edge weight over sources in nf_mask.
    masked_min(x, mask)     [B, n] x [B, n] -> float32[B]
        per-lane min over masked vertices (the heap minimum of SP1-SP3).
    relax_frontier_b(x, f_idx, src_mask) -> float32[B, n]
        (frontier backend) the relax restricted to out-edges of the
        shared compacted buffer f_idx int32[frontier_cap] (padding n).
    out_nbrs(idx) -> int32[len(idx), max_out]; in_min_at(x, tgt,
        mask) -> [B, *tgt.shape]: the incremental-maintenance primitives.

The reference's ``relax2`` fusion hook and single-lane ``relax_frontier``
serve the distributed backend and bidirectional.py (ROADMAP A10, A7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.graph import INF, CsrGraph, EllGraph, Graph
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Primitives:
    """The ops one SSSP round needs (see module docstring)."""

    relax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    in_weight_nf: Callable[[torch.Tensor], torch.Tensor]
    masked_min: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    frontier_cap: int = 0           # static frontier-buffer size (0 = dense)
    walk_width: int = 1             # max_out_deg * max_in_deg: cells a
    #   walked source costs each lane in out_nbrs -> in_min_at
    relax_frontier_b: Callable | None = None
    out_nbrs: Callable | None = None
    in_min_at: Callable | None = None


def _masked_min_local(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, INF).amin(dim=-1)


def segment_prims(g: Graph) -> Primitives:
    """Scatter-min (``scatter_reduce_`` "amin") over the dst-sorted edge
    list.  The reference used ``jax.ops.segment_min`` outside Pallas here,
    so this backend has no kernel of its own."""

    def relax(x, src_mask):
        ok = g.gather_src(src_mask, fill=False)
        cand = torch.where(ok, g.gather_src(x) + g.w, INF)
        return g.seg_min_at_dst(cand)

    def in_weight_nf(nf_mask):
        ok = g.gather_src(nf_mask, fill=False)
        return g.seg_min_at_dst(torch.where(ok, g.w, INF))

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min=_masked_min_local)


def ell_prims(g: Graph, ell: EllGraph) -> Primitives:
    """Dense padded in-neighbour (ELL) layout.

    Every reduction is one call of the fused relax (B3) and every minimum
    one call of the masked min (B4).  The reference's "ell" and "pallas"
    backends differed only in running these as jnp or as Pallas kernels;
    in the port both names run the same wrappers and the tensors' device
    decides: the CUDA kernels on the card, the plain versions on the CPU.
    """

    def relax(x, src_mask):
        return ops.relax_ell(x, ell, src_mask)

    def in_weight_nf(nf_mask):
        zeros = torch.zeros(nf_mask.shape, dtype=torch.float32,
                            device=nf_mask.device)
        return ops.relax_ell(zeros, ell, nf_mask)

    return Primitives(relax=relax, in_weight_nf=in_weight_nf,
                      masked_min=ops.masked_min)


def frontier_prims(g: Graph, csr: CsrGraph, cap: int) -> Primitives:
    """Sparse-frontier backend: compacted-buffer relax over the CSR view.

    Step 1 gathers only the out-edges of the (at most ``cap``) buffered
    vertices and scatter-mins them per lane through B2.  The dense
    segment primitives stay as the overflow fallback and the init-region
    seeds; the minima are the plain masked min, as in the reference.
    """
    base = segment_prims(g)

    def relax_frontier_b(x, f_idx, src_mask):
        return ops.frontier_relax_b(x, csr, f_idx, src_mask)

    def out_nbrs(idx):
        return ops.out_nbrs(csr, idx)

    def in_min_at(x, tgt, src_mask):
        return ops.in_min_at(g, csr, x, tgt, src_mask)

    return Primitives(relax=base.relax, in_weight_nf=base.in_weight_nf,
                      masked_min=_masked_min_local, frontier_cap=int(cap),
                      walk_width=csr.max_out_deg * csr.max_in_deg,
                      relax_frontier_b=relax_frontier_b,
                      out_nbrs=out_nbrs, in_min_at=in_min_at)
