"""Ops over the kernels (port of ``repro/kernels/ops.py``).

The vertex-level ops take batch-first ``[B, n]`` vertex tensors
(``frontier_relax`` is the single-lane B1 form).  The CSR gather of the
frontier relax is fused into its kernel; the other CSR/CSC gathers are
plain PyTorch.  The reductions that were Pallas kernels in the
reference go through the kernel wrappers, which pick the CUDA kernel or
the plain version by the tensors' device.  There is no ``use_pallas``
switch: the device decides.  ``cin_layer`` and ``flash_attention`` are
the model ops (B5, B6), differentiable through their wrappers' backward
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import INF, CsrGraph, EllGraph, Graph
from repro_torch.kernels import cin as _cin
from repro_torch.kernels import flash_attn as _flash
from repro_torch.kernels import frontier_relax as _fr
from repro_torch.kernels import ref
from repro_torch.kernels import relax as _relax
from repro_torch.kernels import segment_min as _segmin


def relax_ell(x: torch.Tensor | None, ell: EllGraph,
              src_mask: torch.Tensor) -> torch.Tensor:
    """float32[B, n]: per vertex, min over ELL in-edges of ``x[src] + w``
    with ``src_mask[src]`` (B3, gather and mask fused); ``x`` None reads
    as zeros (inWeight_nf)."""
    return _relax.relax_ell(x, src_mask, ell.in_src, ell.in_w, ell.n,
                            ell.row_len)


def masked_min_pair(x: torch.Tensor, mask: torch.Tensor,
                    add: torch.Tensor | None) -> torch.Tensor:
    """float32[B, 2]: per-lane min of ``x`` and of ``x + add`` over
    ``mask`` (B4, one launch; column 1 +inf if ``add`` is None)."""
    return _segmin.masked_min_pair(x, mask, add)


def frontier_relax(x: torch.Tensor, csr: CsrGraph, f_idx: torch.Tensor,
                   src_mask: torch.Tensor) -> torch.Tensor:
    """Single-lane sparse-frontier relax -> float32[n] (B1): the fused
    entry at B = 1, launch key ``frontier_relax``.

    ``x`` float32[n], ``f_idx`` int32[cap] (padding ``n``), ``src_mask``
    bool[n].  The legacy round's frontier branch (bidirectional lanes)
    calls it once a lane.
    """
    return _fr.frontier_relax(x, src_mask, f_idx, csr.indptr, csr.dst,
                              csr.w, csr.max_out_deg)


def frontier_relax_b(x: torch.Tensor, csr: CsrGraph, f_idx: torch.Tensor,
                     src_mask: torch.Tensor) -> torch.Tensor:
    """Batched shared-buffer relax: one union gather, B scatter-mins (B2),
    gather and scatter fused into one kernel on the card.

    ``x`` float32[B, n], ``f_idx`` int32[cap] union frontier (padding
    ``n``), ``src_mask`` bool[B, n].  Returns float32[B, n], +inf where
    no live offer.
    """
    return _fr.frontier_relax_csr(x, src_mask, f_idx, csr.indptr, csr.dst,
                                  csr.w, csr.max_out_deg)


def out_nbrs(csr: CsrGraph, f_idx: torch.Tensor) -> torch.Tensor:
    """int32[cap, max_out_deg] out-neighbours of the buffered vertices
    (padding cells ``n``)."""
    _, cell, epos = ref.out_cells(csr.indptr, f_idx, csr.max_out_deg,
                                  csr.e_pad)
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


def cin_layer(x_k: torch.Tensor, x_0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """xDeepFM CIN layer (B5): x_k [B, H, D], x_0 [B, M, D], w [K, H, M]
    -> float32[B, K, D].  Any B: the kernel needs no batch padding."""
    return _cin.cin_layer(x_k.contiguous(), x_0.contiguous(),
                          w.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on ``[B, H, S, d]`` (B6); K/V repeated to H heads by the
    caller (``models/attention.flash_attention_gqa``), ``causal`` only
    with ``Sq == Sk``."""
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal)
