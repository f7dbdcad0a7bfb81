"""Masked global min wrapper (port of ``repro/kernels/segment_min.py``, B4).

The minD and out-rule threshold reductions of the ELL/pallas backend,
batched over lanes and left on the device (no host read).  A CPU tensor
goes to ``ref.masked_min_ref``, a CUDA tensor to ``csrc/segment_min.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32[B, n] x, bool[B, n] mask -> float32[B] (+inf if empty)."""
    if x.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"x must be float32 and mask bool, got {x.dtype} "
                        f"and {mask.dtype}")
    if x.dim() != 2 or mask.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and mask {tuple(mask.shape)} "
                         "must both be [B, n]")
    if mask.device != x.device:
        raise ValueError(f"mask on {mask.device}, x on {x.device}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("x and mask must be contiguous")
    if x.device.type == "cpu":
        return ref.masked_min_ref(x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B, n = x.shape
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    fn = _build.function("masked_min")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), mask.data_ptr(), out.data_ptr(), B, n, stream)
    _build.check(rc, "masked_min")
    _build.count_launch("masked_min")
    return out
