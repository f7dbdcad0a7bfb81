"""Frontier scatter-min wrappers (port of ``repro/kernels/frontier_relax.py``).

``frontier_relax_csr`` is the step-1 relax of the shared batch frontier
with its CSR gather fused in (B2): what ``ops.frontier_relax_b`` runs.
``frontier_relax`` is the single-lane relax of the legacy round (B1), the
same fused entry at B = 1 counted under its own key: what
``ops.frontier_relax`` runs.  ``frontier_scatter_min_batch`` (B2) and
``frontier_scatter_min`` (B1) are the counterparts at the TPU kernels'
own ``tgt``/``cand`` signature and share the fused entry's kernel body.
A CPU tensor goes to the plain versions in ``ref.py``, a CUDA tensor to
``csrc/frontier_relax.cu``; anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(tgt: torch.Tensor, cand: torch.Tensor, n: int,
           lead: int) -> None:
    """``cand`` is ``tgt``'s shape behind ``lead`` lane dimensions."""
    if tgt.dtype != torch.int32:
        raise TypeError(f"tgt must be int32, got {tgt.dtype}")
    if cand.dtype != torch.float32:
        raise TypeError(f"cand must be float32, got {cand.dtype}")
    if tgt.device != cand.device:
        raise ValueError(f"tgt on {tgt.device}, cand on {cand.device}")
    if cand.dim() != tgt.dim() + lead or cand.shape[lead:] != tgt.shape:
        raise ValueError(f"cand {tuple(cand.shape)} must be "
                         f"[{'B, ' * lead}*{tuple(tgt.shape)}]")
    if not (tgt.is_contiguous() and cand.is_contiguous()):
        raise ValueError("tgt and cand must be contiguous")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def _launch(tgt: torch.Tensor, cand: torch.Tensor, n: int, lanes: int,
            out: torch.Tensor) -> torch.Tensor:
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    rc = _build.function("frontier_scatter_min_batch")(
        tgt.data_ptr(), cand.data_ptr(), out.data_ptr(), lanes, tgt.numel(),
        n, dev.index, _build.raw_stream(dev))
    _build.check(rc, "frontier_scatter_min_batch")
    return out


def frontier_scatter_min_batch(tgt: torch.Tensor, cand: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Shared-table batched scatter-min -> float32[B, n] (B2).

    ``tgt`` int32[cap, deg] (cells outside ``[0, n)`` drop), ``cand``
    float32[B, cap, deg], every value ``>= +0.0`` or +inf.
    """
    _check(tgt, cand, n, 1)
    if cand.device.type == "cpu":
        return ref.frontier_scatter_min_batch_ref(tgt, cand, n)
    B = cand.shape[0]
    out = _launch(tgt, cand, n, B, torch.empty(
        (B, n), dtype=torch.float32, device=cand.device))
    _build.count_launch("frontier_scatter_min_batch")
    return out


def frontier_scatter_min(tgt: torch.Tensor, cand: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Single-lane scatter-min -> float32[n] (B1): B2's kernel at B = 1."""
    _check(tgt, cand, n, 0)
    if cand.device.type == "cpu":
        return ref.frontier_scatter_min_ref(tgt, cand, n)
    out = _launch(tgt, cand, n, 1, torch.empty(
        (n,), dtype=torch.float32, device=cand.device))
    _build.count_launch("frontier_scatter_min")
    return out


_CSR_ARGS = (("f_idx", torch.int32, 1), ("indptr", torch.int32, 1),
             ("dst", torch.int32, 1), ("w", torch.float32, 1),
             ("x", torch.float32, 2), ("src_mask", torch.bool, 2))
_CSR_DTYPES = tuple(dt for _, dt, _ in _CSR_ARGS)


def _csr_fault(args: tuple, dev: torch.device) -> None:
    """Raise for the first of ``args`` (in ``_CSR_ARGS`` order) that is
    not a contiguous tensor of its type and rank on ``dev``."""
    for (name, dt, dim), t in zip(_CSR_ARGS, args):
        if t.dtype != dt or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dim}-d {dt} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")


def _fused(x: torch.Tensor, src_mask: torch.Tensor, f_idx: torch.Tensor,
           indptr: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
           max_deg: int, key: str) -> torch.Tensor:
    """The fused CSR relax over ``[B, n]`` lanes, counted under ``key``."""
    dev = x.device
    B, n = x.shape if x.dim() == 2 else (0, -1)
    # one pass over the six tensors; _csr_fault names the one at fault
    if ((f_idx.dtype, indptr.dtype, dst.dtype, w.dtype, x.dtype,
         src_mask.dtype) != _CSR_DTYPES
            or src_mask.shape != x.shape or f_idx.dim() != 1
            or indptr.shape != (n + 1,) or dst.dim() != 1
            or w.shape != dst.shape
            or not (x.is_contiguous() and src_mask.is_contiguous()
                    and f_idx.is_contiguous() and indptr.is_contiguous()
                    and dst.is_contiguous() and w.is_contiguous())
            or not (src_mask.device == dev and f_idx.device == dev
                    and indptr.device == dev and dst.device == dev
                    and w.device == dev)):
        _csr_fault((f_idx, indptr, dst, w, x, src_mask), dev)
        raise ValueError(f"x {tuple(x.shape)}, src_mask "
                         f"{tuple(src_mask.shape)}, indptr "
                         f"{tuple(indptr.shape)}, dst {tuple(dst.shape)}, "
                         f"w {tuple(w.shape)} do not fit")
    if dev.type == "cpu":
        return ref.frontier_relax_ref(x, src_mask, f_idx, indptr, dst, w,
                                      max_deg)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    rc = _build.function("frontier_relax_csr")(
        f_idx.data_ptr(), indptr.data_ptr(), dst.data_ptr(), w.data_ptr(),
        x.data_ptr(), src_mask.data_ptr(), out.data_ptr(), B,
        f_idx.shape[0], max_deg, n, dev.index, _build.raw_stream(dev))
    _build.check(rc, key)
    _build.count_launch(key)
    return out


def frontier_relax_csr(x: torch.Tensor, src_mask: torch.Tensor,
                       f_idx: torch.Tensor, indptr: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor,
                       max_deg: int) -> torch.Tensor:
    """Shared-frontier relax, CSR gather fused -> float32[B, n] (B2).

    ``x`` float32[B, n] and ``src_mask`` bool[B, n] per lane, ``f_idx``
    int32[cap] union frontier (padding ``n``), ``indptr`` int32[n + 1]
    and ``dst``/``w`` [e_pad] the CSR view, ``max_deg`` its largest
    out-degree.  ``out[b, t]`` is the min of ``x[b, u] + w`` over the
    out-edges (u, t, w) of buffered u with ``src_mask[b, u]``, +inf where
    none; every such sum must be ``>= +0.0`` or +inf.
    """
    return _fused(x, src_mask, f_idx, indptr, dst, w, max_deg,
                  "frontier_relax_csr")


def frontier_relax(x: torch.Tensor, src_mask: torch.Tensor,
                   f_idx: torch.Tensor, indptr: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor,
                   max_deg: int) -> torch.Tensor:
    """Single-lane frontier relax, CSR gather fused -> float32[n] (B1).

    ``x`` float32[n] and ``src_mask`` bool[n], the rest as
    ``frontier_relax_csr``; the same kernel at B = 1.
    """
    if x.dim() != 1 or src_mask.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} and src_mask "
                         f"{tuple(src_mask.shape)} must be 1-d")
    return _fused(x[None], src_mask[None], f_idx, indptr, dst, w, max_deg,
                  "frontier_relax")[0]
