"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

Each function is the mathematical definition with no tiling.  The kernel
wrappers call these for CPU tensors, and ``chip_smoke.py`` holds every
CUDA kernel against them on the card with tolerance 0: min, mask and a
single f32 add are exact, so the two must agree bit for bit.
"""
from __future__ import annotations

import torch

INF = float("inf")


def frontier_scatter_min_batch_ref(tgt: torch.Tensor, cand: torch.Tensor,
                                   n: int) -> torch.Tensor:
    """Batched scatter-min over ONE shared target table -> float32[B, n].

    ``tgt`` int32[...]: destination vertex of each cell, shared by every
    lane (cells outside ``[0, n)`` are padding and drop); ``cand``
    float32[B, ...]: lane b's candidate per cell (+inf on padding and
    lane-masked cells).  Min is exact and order-free, so any scatter
    order gives the same bits.

    The CUDA kernel folds candidates with an int32 ``atomicMin`` on their
    bit patterns, which equals the float min only for values ``>= +0.0``
    (or +inf).  The engine never makes anything else: weights are > 0 and
    D, C >= 0.  This plain version takes any non-NaN input.
    """
    B = cand.shape[0]
    t = tgt.reshape(-1).long()
    t = torch.where((t >= 0) & (t < n), t, n)
    out = torch.full((B, n + 1), INF, dtype=torch.float32, device=cand.device)
    out.scatter_reduce_(1, t.expand(B, -1), cand.reshape(B, -1), "amin")
    return out[:, :n]


def frontier_scatter_min_ref(tgt: torch.Tensor, cand: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Single-lane scatter-min -> float32[n]; same premise as the batch."""
    return frontier_scatter_min_batch_ref(tgt, cand[None], n)[0]


def relax_ell_ref(x: torch.Tensor, src_mask: torch.Tensor,
                  in_src: torch.Tensor, in_w: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Fused ELL relax -> float32[B, n]: the whole of ``ops.relax_ell``.

    ``out[b, i] = min_j mask ? x[b, s] + in_w[i, j] : +inf`` with
    ``s = in_src[i, j]`` and ``mask = s < n & src_mask[b, s]``, for the
    first ``n`` rows.  The gather index is clamped and padding cells are
    masked out (the reference's concat-free form).  Lanes run one at a
    time so the gathered ``[n, deg_pad]`` operands exist for one lane
    only.
    """
    rows_src = in_src[:n]
    idx = rows_src.clamp(max=max(n - 1, 0)).long()
    in_range = rows_src < n
    w = in_w[:n]
    out = torch.empty((x.shape[0], n), dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        mask = in_range & src_mask[b][idx]
        out[b] = torch.where(mask, x[b][idx] + w, INF).amin(dim=-1)
    return out


def masked_min_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-lane min over masked elements -> float32[B] (+inf if none).

    The CUDA kernel shares the scatter-min's premise: every ``x`` is
    ``>= +0.0`` or +inf (the engine's D and D + outWeight).
    """
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], INF, dtype=torch.float32,
                          device=x.device)
    return torch.where(mask, x, INF).amin(dim=-1)
