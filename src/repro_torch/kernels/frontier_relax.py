"""Frontier scatter-min wrappers (port of ``repro/kernels/frontier_relax.py``).

``frontier_scatter_min_batch`` (B2) is the step-1 relax of the shared
batch frontier; ``frontier_scatter_min`` (B1) is the same CUDA kernel at
B = 1.  A CPU tensor goes to the plain version in ``ref.py``, a CUDA
tensor to ``csrc/frontier_relax.cu``; anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(tgt: torch.Tensor, cand: torch.Tensor, n: int) -> None:
    if tgt.dtype != torch.int32:
        raise TypeError(f"tgt must be int32, got {tgt.dtype}")
    if cand.dtype != torch.float32:
        raise TypeError(f"cand must be float32, got {cand.dtype}")
    if tgt.device != cand.device:
        raise ValueError(f"tgt on {tgt.device}, cand on {cand.device}")
    if cand.shape[1:] != tgt.shape:
        raise ValueError(f"cand {tuple(cand.shape)} must be [B, "
                         f"*{tuple(tgt.shape)}]")
    if not (tgt.is_contiguous() and cand.is_contiguous()):
        raise ValueError("tgt and cand must be contiguous")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")


def _launch(tgt: torch.Tensor, cand: torch.Tensor, n: int) -> torch.Tensor:
    B = cand.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=cand.device)
    fn = _build.function("frontier_scatter_min_batch")
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        rc = fn(tgt.data_ptr(), cand.data_ptr(), out.data_ptr(), B,
                tgt.numel(), n, stream)
    _build.check(rc, "frontier_scatter_min_batch")
    return out


def frontier_scatter_min_batch(tgt: torch.Tensor, cand: torch.Tensor,
                               n: int) -> torch.Tensor:
    """Shared-table batched scatter-min -> float32[B, n] (B2).

    ``tgt`` int32[cap, deg] (cells outside ``[0, n)`` drop), ``cand``
    float32[B, cap, deg], every value ``>= +0.0`` or +inf.
    """
    _check(tgt, cand, n)
    if cand.device.type == "cpu":
        return ref.frontier_scatter_min_batch_ref(tgt, cand, n)
    if cand.device.type != "cuda":
        raise ValueError(f"no kernel for device {cand.device}")
    out = _launch(tgt, cand, n)
    _build.count_launch("frontier_scatter_min_batch")
    return out


def frontier_scatter_min(tgt: torch.Tensor, cand: torch.Tensor,
                         n: int) -> torch.Tensor:
    """Single-lane scatter-min -> float32[n] (B1): B2's kernel at B = 1."""
    _check(tgt, cand[None], n)
    if cand.device.type == "cpu":
        return ref.frontier_scatter_min_ref(tgt, cand, n)
    if cand.device.type != "cuda":
        raise ValueError(f"no kernel for device {cand.device}")
    out = _launch(tgt, cand[None], n)[0]
    _build.count_launch("frontier_scatter_min")
    return out
