"""xDeepFM CIN layer wrapper (port of ``repro/kernels/cin.py``, B5).

``out[b, k, d] = sum_{h, m} w[k, h, m] * x_k[b, h, d] * x_0[b, m, d]``
without building ``z[b, h, m, d]``.  A CPU tensor goes to
``ref.cin_layer_ref``, a CUDA tensor to ``csrc/cin.cu``, which takes any
batch size (the reference padded B to its TPU block of 32).

The kernel runs the layer as one GEMM over the flat reduction index
``j = h * M + m``; ``plan`` splits its chunks into S parts when the batch
gives too few output tiles to fill the card, and the wrapper allocates
its scratch: W split into TF32 hi/lo, and the parts' partial sums.  One
wrapper call is one counted launch, whatever S is.

Scoring only: the reference kernel has no backward, and neither has
this one, so an input that requires grad (with grad mode on) raises
rather than returning a result with no gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

# The kernel's tiles (csrc/cin.cu: kNc, kKt, kJc; a test holds them
# equal): columns b * D + d and rows k a block, values of j a chunk.
COLS = 256
ROWS = 40
CHUNK = 32
SMS = 132           # streaming multiprocessors of an H100 SXM
# fields the kernel's dynamic shared memory holds: x_0 of the block's
# columns and two stages of x_k rows (2 a stage when M >= 32), 1,056
# bytes a row, and two W tiles with their j tables (26,112 bytes), at
# most 232,448 bytes a block on an H100
MAX_FIELDS = 191


class Plan(NamedTuple):
    splits: int                  # S parts of the reduction
    chunks_per_split: int        # chunks of CHUNK values of j a part
    w_prep_shape: tuple          # W split into TF32 hi/lo, fragment order
    partial_shape: tuple | None  # f32 partial sums [S, K, B*D], if S > 1


def plan(B: int, H: int, M: int, D: int, K: int, sms: int = SMS) -> Plan:
    """How the kernel splits a layer's reduction into S parts, and the
    shapes of its float32 scratch.

    A block owns one output tile and one part, and one block fits an SM,
    so the layer takes ceil(tiles * S / sms) waves of ceil(chunks / S)
    chunks each.  S is the one that minimises that product, the smallest
    on ties, among S <= ceil(4 * sms / tiles): at most about four waves,
    so a large batch (whose tiles alone fill the card) keeps S = 1 and
    needs no partial sums."""
    n_chunks = math.ceil(H * M / CHUNK)
    n_ktiles = math.ceil(K / ROWS)
    tiles = max(1, math.ceil(B * D / COLS) * n_ktiles)
    limit = max(1, min(n_chunks, math.ceil(4 * sms / tiles)))
    _, best = min((math.ceil(tiles * s / sms) * math.ceil(n_chunks / s), s)
                  for s in range(1, limit + 1))
    cps = max(1, math.ceil(n_chunks / best))
    splits = max(1, math.ceil(n_chunks / cps))
    return Plan(splits, cps, (n_ktiles * ROWS, n_chunks * 2 * CHUNK),
                (splits, K, B * D) if splits > 1 else None)


def cin_layer(x_k: torch.Tensor, x_0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """float32 x_k [B, H, D], x_0 [B, M, D], w [K, H, M] -> [B, K, D]."""
    for name, t in (("x_k", x_k), ("x_0", x_0), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(t.shape)}")
        if t.device != x_k.device:
            raise ValueError(f"{name} on {t.device}, x_k on {x_k.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, D = x_k.shape
    M = x_0.shape[1]
    K = w.shape[0]
    if x_0.shape != (B, M, D) or w.shape != (K, H, M):
        raise ValueError(f"x_k {tuple(x_k.shape)}, x_0 {tuple(x_0.shape)} "
                         f"and w {tuple(w.shape)} must be [B, H, D], "
                         "[B, M, D] and [K, H, M]")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_k, x_0, w)):
        raise RuntimeError("cin_layer has no backward kernel: score under "
                           "torch.no_grad() or with inputs that do not "
                           "require grad")
    if x_k.device.type == "cpu":
        return ref.cin_layer_ref(x_k, x_0, w)
    if x_k.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_k.device}")
    if M > MAX_FIELDS:
        raise ValueError(f"M = {M} fields exceed the kernel's shared "
                         f"memory ({MAX_FIELDS} at most)")
    dev = x_k.device
    p = plan(B, H, M, D, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((B, K, D), dtype=torch.float32, device=dev)
    w_prep = torch.empty(p.w_prep_shape, dtype=torch.float32, device=dev)
    part = (torch.empty(p.partial_shape, dtype=torch.float32, device=dev)
            if p.partial_shape else None)
    fn = _build.function("cin_layer")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x_k.data_ptr(), x_0.data_ptr(), w.data_ptr(), out.data_ptr(),
                w_prep.data_ptr(), None if part is None else part.data_ptr(),
                B, H, M, D, K, p.splits, p.chunks_per_split, stream)
    _build.check(rc, "cin_layer")
    _build.count_launch("cin_layer")
    return out
