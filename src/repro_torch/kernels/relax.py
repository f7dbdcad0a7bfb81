"""Fused ELL relax wrapper (port of ``repro/kernels/relax.py``, B3).

One call is the relax, the inWeight_nf (``x = None``, read as zeros) or
the Eqn-(1) C-propagation (``x = C``, every source) of the ELL/pallas
backend.  The gather ``x[clamp(in_src)]`` and the mask ``in_src < n &
src_mask[...]`` that the reference did in XLA around its Pallas kernel
are fused into ``csrc/relax.cu``, which reads each row only to its
``row_len`` and gathers the lanes packed vertex-major (``xm``, scratch
allocated here).  A CPU tensor goes to ``ref.relax_ell_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(x, src_mask, in_src, in_w, row_len, n: int) -> None:
    for name, t, dt in (("x", x, torch.float32), ("src_mask", src_mask,
                        torch.bool), ("in_src", in_src, torch.int32),
                        ("in_w", in_w, torch.float32),
                        ("row_len", row_len, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != src_mask.device:
            raise ValueError(f"{name} on {t.device}, src_mask on "
                             f"{src_mask.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (src_mask.dim() != 2 or src_mask.shape[1] != n
            or (x is not None and x.shape != src_mask.shape)):
        raise ValueError(f"x {None if x is None else tuple(x.shape)} and "
                         f"src_mask {tuple(src_mask.shape)} must be [B, {n}]")
    if in_src.dim() != 2 or in_w.shape != in_src.shape or in_src.shape[0] < n:
        raise ValueError(f"in_src {tuple(in_src.shape)} / in_w "
                         f"{tuple(in_w.shape)} must be [n_pad >= {n}, deg]")
    if row_len is not None and (row_len.dim() != 1
                                or row_len.shape[0] < n):
        raise ValueError(f"row_len {tuple(row_len.shape)} must be "
                         f"[n_pad >= {n}]")


def xm_stride(lanes: int) -> int:
    """Floats a vertex in the kernel's packed lanes: 1 at B = 1, else B
    rounded up to 8 (one 32-byte sector for 8 lanes)."""
    return 1 if lanes == 1 else -(-lanes // 8) * 8


def relax_ell(x: torch.Tensor | None, src_mask: torch.Tensor,
              in_src: torch.Tensor, in_w: torch.Tensor, n: int,
              row_len: torch.Tensor | None = None) -> torch.Tensor:
    """float32[B, n] x (None: zeros, the inWeight_nf form), bool[B, n]
    src_mask, int32/float32[n_pad, deg_pad] ELL arrays -> float32[B, n]
    masked row min of ``x[src] + w``.

    ``row_len`` int32[n_pad] (``EllGraph.row_len``): the kernel reads row
    i only over its first ``row_len[i]`` cells, which must hold every
    cell with ``in_src < n``.  The kernel needs it; the plain version
    needs no extent, so a CPU call may leave it out.
    """
    _check(x, src_mask, in_src, in_w, row_len, n)
    if src_mask.device.type == "cpu":
        if x is None:
            x = torch.zeros(src_mask.shape, dtype=torch.float32)
        if row_len is not None:
            # every cell past the longest row's extent is padding, which
            # the min masks to +inf anyway: reading up to it is exact
            width = max(int(row_len.max()) if row_len.numel() else 0, 1)
            in_src, in_w = in_src[:, :width], in_w[:, :width]
        return ref.relax_ell_ref(x, src_mask, in_src, in_w, n)
    if src_mask.device.type != "cuda":
        raise ValueError(f"no kernel for device {src_mask.device}")
    if row_len is None:
        raise ValueError("the CUDA relax_ell needs row_len (EllGraph."
                         "row_len; a full row is row_len = deg_pad)")
    B = src_mask.shape[0]
    dev = src_mask.device
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    stride = xm_stride(B)
    xm = torch.empty(n * stride, dtype=torch.float32, device=dev)
    fn = _build.function("relax_ell")
    with torch.cuda.device(dev):
        stream = _build.raw_stream(dev)
        rc = fn(None if x is None else x.data_ptr(), src_mask.data_ptr(),
                in_src.data_ptr(), in_w.data_ptr(), row_len.data_ptr(),
                xm.data_ptr(), out.data_ptr(), B, n, in_src.shape[1],
                int(x is None), stride, stream)
    _build.check(rc, "relax_ell")
    _build.count_launch("relax_ell")
    return out
