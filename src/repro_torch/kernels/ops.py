"""Vertex-level ops over the graph layouts (port of ``repro/kernels/ops.py``).

Every op takes batch-first ``[B, n]`` vertex tensors (``frontier_relax``
is the single-lane B1 form).  The CSR/CSC gathers are plain PyTorch; the
reductions that were Pallas kernels in the reference go through the
kernel wrappers, which pick the CUDA kernel or the plain version by the
tensors' device.  There is no ``use_pallas`` switch: the device decides.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import INF, CsrGraph, EllGraph, Graph
from repro_torch.kernels import frontier_relax as _fr
from repro_torch.kernels import relax as _relax
from repro_torch.kernels import segment_min as _segmin


def relax_ell(x: torch.Tensor, ell: EllGraph,
              src_mask: torch.Tensor) -> torch.Tensor:
    """float32[B, n]: per vertex, min over ELL in-edges of ``x[src] + w``
    with ``src_mask[src]`` (B3, gather and mask fused)."""
    return _relax.relax_ell(x, src_mask, ell.in_src, ell.in_w, ell.n)


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32[B]: per-lane min of ``x`` over ``mask`` (B4)."""
    return _segmin.masked_min(x, mask)


def _out_cells(csr: CsrGraph, f_idx: torch.Tensor):
    """Clamped buffer ids, live-cell mask and clamped CSR edge positions
    of the ``[cap, max_out_deg]`` out-edge table of ``f_idx``."""
    n = csr.n
    u = f_idx.clamp(max=n - 1).long()
    base = csr.indptr[u]
    deg = csr.indptr[u + 1] - base
    j = torch.arange(csr.max_out_deg, dtype=torch.int32, device=f_idx.device)
    cell = (f_idx < n)[:, None] & (j[None, :] < deg[:, None])
    epos = (base[:, None] + j[None, :]).clamp(max=csr.e_pad - 1).long()
    return u, cell, epos


def frontier_relax(x: torch.Tensor, csr: CsrGraph, f_idx: torch.Tensor,
                   src_mask: torch.Tensor) -> torch.Tensor:
    """Single-lane sparse-frontier relax -> float32[n] (B1).

    ``x`` float32[n], ``f_idx`` int32[cap] (padding ``n``), ``src_mask``
    bool[n].  Used by no engine path of this slice (the single-lane
    frontier round is ROADMAP A7).
    """
    n = csr.n
    u, cell, epos = _out_cells(csr, f_idx)
    cell_ok = cell & src_mask[u][:, None]
    tgt = torch.where(cell_ok, csr.dst[epos], n).to(torch.int32)
    cand = torch.where(cell_ok, x[u][:, None] + csr.w[epos], INF)
    return _fr.frontier_scatter_min(tgt.contiguous(), cand.contiguous(), n)


def frontier_relax_b(x: torch.Tensor, csr: CsrGraph, f_idx: torch.Tensor,
                     src_mask: torch.Tensor) -> torch.Tensor:
    """Batched shared-buffer relax: one union gather, B scatter-mins (B2).

    ``x`` float32[B, n], ``f_idx`` int32[cap] union frontier (padding
    ``n``), ``src_mask`` bool[B, n].  Returns float32[B, n], +inf where
    no live offer.
    """
    n = csr.n
    u, cell, epos = _out_cells(csr, f_idx)
    tgt = torch.where(cell, csr.dst[epos], n).to(torch.int32)  # shared
    w = csr.w[epos]
    lane_ok = cell[None] & src_mask[:, u][:, :, None]
    cand = torch.where(lane_ok, x[:, u][:, :, None] + w[None], INF)
    return _fr.frontier_scatter_min_batch(tgt.contiguous(),
                                          cand.contiguous(), n)


def out_nbrs(csr: CsrGraph, f_idx: torch.Tensor) -> torch.Tensor:
    """int32[cap, max_out_deg] out-neighbours of the buffered vertices
    (padding cells ``n``)."""
    _, cell, epos = _out_cells(csr, f_idx)
    return torch.where(cell, csr.dst[epos], csr.n).to(torch.int32)


def in_min_at(g: Graph, csr: CsrGraph, x: torch.Tensor | None,
              tgt: torch.Tensor, src_mask: torch.Tensor | None
              ) -> torch.Tensor:
    """Masked min over the FULL in-neighbourhood of each target vertex.

    ``x`` float32[B, n] or None (reduce the edge weight alone),
    ``tgt`` int32[...] shared targets (padding ``n``), ``src_mask``
    bool[B, n] or None (all sources).  Returns float32[B, *tgt.shape]
    over the CSC runs ``in_indptr[t]:in_indptr[t+1]`` of the primary
    dst-sorted ``g.src``/``g.w``.
    """
    n = g.n
    tc = tgt.clamp(max=n - 1).long()
    base = csr.in_indptr[tc]
    deg = csr.in_indptr[tc + 1] - base
    j = torch.arange(csr.max_in_deg, dtype=torch.int32, device=tgt.device)
    cell = (tgt < n)[..., None] & (j < deg[..., None])
    epos = (base[..., None] + j).clamp(max=g.e_pad - 1).long()
    u_raw = g.src[epos]
    uc = u_raw.clamp(max=n - 1).long()
    ok = cell & (u_raw < n)
    w = torch.where(ok, g.w[epos], INF)           # [*T, max_in]
    if x is None:
        val = w[None]
    else:
        val = x[:, uc] + w[None]                 # masked cells stay +inf
    if src_mask is not None:
        val = torch.where(src_mask[:, uc] & ok[None], val, INF)
    return val.amin(dim=-1)
