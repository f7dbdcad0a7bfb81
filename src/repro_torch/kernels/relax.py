"""Fused ELL relax wrapper (port of ``repro/kernels/relax.py``, B3).

One call is the relax, the inWeight_nf (``x = 0``) or the Eqn-(1)
C-propagation (``x = C``, every source) of the ELL/pallas backend.  The
gather ``x[clamp(in_src)]`` and the mask ``in_src < n & src_mask[...]``
that the reference did in XLA around its Pallas kernel are fused into
``csrc/relax.cu``.  A CPU tensor goes to ``ref.relax_ell_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def relax_ell(x: torch.Tensor, src_mask: torch.Tensor, in_src: torch.Tensor,
              in_w: torch.Tensor, n: int) -> torch.Tensor:
    """float32[B, n] x, bool[B, n] src_mask, int32/float32[n_pad, deg_pad]
    ELL arrays -> float32[B, n] masked row min of ``x[src] + w``."""
    for name, t, dt in (("x", x, torch.float32), ("src_mask", src_mask,
                        torch.bool), ("in_src", in_src, torch.int32),
                        ("in_w", in_w, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or x.shape[1] != n or src_mask.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and src_mask "
                         f"{tuple(src_mask.shape)} must be [B, {n}]")
    if in_src.dim() != 2 or in_w.shape != in_src.shape or in_src.shape[0] < n:
        raise ValueError(f"in_src {tuple(in_src.shape)} / in_w "
                         f"{tuple(in_w.shape)} must be [n_pad >= {n}, deg]")
    if x.device.type == "cpu":
        return ref.relax_ell_ref(x, src_mask, in_src, in_w, n)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    B = x.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=x.device)
    fn = _build.function("relax_ell")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), src_mask.data_ptr(), in_src.data_ptr(),
                in_w.data_ptr(), out.data_ptr(), B, n, in_src.shape[1],
                stream)
    _build.check(rc, "relax_ell")
    _build.count_launch("relax_ell")
    return out
