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

Training: with grad mode on and an input that requires grad, the call
is a ``torch.autograd.Function`` whose backward takes the input
gradients from this same kernel with permuted weights (the reference's
CIN has no backward kernel, and these need none of their own):

    dx_k = cin_layer(g, x_0, w^T),   w^T[h, k, m] = w[k, h, m]
    dx_0 = cin_layer(g, x_k, w'),    w'[m, k, h] = w[k, h, m]

where in dx_0 the x_0 role has H fields, which may pass ``MAX_FIELDS``
(CIN 200-200-200): that call splits over ranges of at most
``MAX_FIELDS`` values of h and adds the parts, on every device.  The
weight gradient ``dw[k, h, m] = sum_{b, d} g x_k x_0`` is a kernel of its
own, ``cin_weight_grad`` (``csrc/cin.cu``), with its own split plan
(``wgrad_plan``) and launch key.  On the CPU each call takes its plain
version.
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


# cin_weight_grad's tiles (csrc/cin.cu: kGJt, kGKt, kGCols, kGFlush; a
# test holds them equal): values of j and rows k a block, columns
# b * D + d a stage of the reduction, and k-steps of 8 columns between
# two flushes of the float32 accumulators into their Kahan pairs
WG_ROWS = 64
WG_KROWS = 208
WG_COLS = 32
WG_FLUSH = 32
# floats of g split into TF32 hi and lo a stage and k tile (csrc/cin.cu:
# 2 * kGG / 4): the weight gradient's scratch
WG_PREP = 2 * WG_KROWS * WG_COLS


class Plan(NamedTuple):
    splits: int                  # S parts of the reduction
    chunks_per_split: int        # chunks of CHUNK values of j a part
    w_prep_shape: tuple          # W split into TF32 hi/lo, fragment order
    partial_shape: tuple | None  # f32 partial sums [S, K, B*D], if S > 1


def _split(n_chunks: int, tiles: int, sms: int) -> tuple[int, int]:
    """``(S, chunks a part)`` for a kernel whose blocks each own one
    output tile and one part of a reduction of ``n_chunks`` chunks.

    One block fits an SM, so the call takes ceil(tiles * S / sms) waves
    of ceil(chunks / S) chunks each.  S is the one that minimises that
    product, the smallest on ties, among S <= ceil(4 * sms / tiles): at
    most about four waves, so a call whose tiles alone fill the card
    keeps S = 1 and needs no partial sums."""
    tiles = max(1, tiles)
    limit = max(1, min(n_chunks, math.ceil(4 * sms / tiles)))
    _, best = min((math.ceil(tiles * s / sms) * math.ceil(n_chunks / s), s)
                  for s in range(1, limit + 1))
    cps = max(1, math.ceil(n_chunks / best))
    return max(1, math.ceil(n_chunks / cps)), cps


def plan(B: int, H: int, M: int, D: int, K: int, sms: int = SMS) -> Plan:
    """How the forward kernel splits a layer's reduction (over j = h * M
    + m) into S parts (``_split``), and the shapes of its float32
    scratch."""
    n_chunks = math.ceil(H * M / CHUNK)
    n_ktiles = math.ceil(K / ROWS)
    splits, cps = _split(n_chunks, math.ceil(B * D / COLS) * n_ktiles, sms)
    return Plan(splits, cps, (n_ktiles * ROWS, n_chunks * 2 * CHUNK),
                (splits, K, B * D) if splits > 1 else None)


def wgrad_plan(B: int, H: int, M: int, D: int, K: int,
               sms: int = SMS) -> tuple[int, int, tuple | None]:
    """How ``cin_weight_grad`` splits its reduction over the B * D columns
    (stages of ``WG_COLS``) into S parts (``_split``): ``(S, stages a
    part, the float32 partial sums' shape [S, K, H * M] or None)``."""
    n_chunks = math.ceil(B * D / WG_COLS)
    tiles = math.ceil(H * M / WG_ROWS) * math.ceil(K / WG_KROWS)
    splits, cps = _split(max(1, n_chunks), tiles, sms)
    return splits, cps, (splits, K, H * M) if splits > 1 else None


def wgrad_prep_floats(B: int, D: int, K: int) -> int:
    """Floats of ``cin_weight_grad``'s scratch for g split into TF32 hi
    and lo: ``WG_PREP`` a stage of ``WG_COLS`` columns and k tile of
    ``WG_KROWS`` rows (1.09 GB at B = 65,536, D = 10, K = 200)."""
    return (math.ceil(K / WG_KROWS) * math.ceil(B * D / WG_COLS)
            * WG_PREP)


def backward_launches(H: int, M: int) -> dict:
    """The launches of one layer's backward whose inputs all require
    grad: dx_k (one ``cin_layer``), dx_0 (one ``cin_layer`` a part of at
    most ``MAX_FIELDS`` values of h) and dw (one ``cin_weight_grad``)."""
    return {"cin_layer": 1 + math.ceil(H / MAX_FIELDS),
            "cin_weight_grad": 1}


def _check(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> None:
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
    if x_k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x_k.device}")


def cin_layer(x_k: torch.Tensor, x_0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """float32 x_k [B, H, D], x_0 [B, M, D], w [K, H, M] -> [B, K, D];
    differentiable in all three."""
    _check(x_k, x_0, w)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x_k, x_0, w)):
        return _CinLayer.apply(x_k, x_0, w)
    return _forward(x_k, x_0, w)


class _CinLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_k, x_0, w):
        ctx.save_for_backward(x_k, x_0, w)
        return _forward(x_k, x_0, w)

    @staticmethod
    def backward(ctx, g):
        x_k, x_0, w = ctx.saved_tensors
        g = g.contiguous()
        dx_k = dx_0 = dw = None
        if ctx.needs_input_grad[0]:
            dx_k = _forward(g, x_0, w.permute(1, 0, 2).contiguous())
        if ctx.needs_input_grad[1]:
            dx_0 = input_grad_x0(g, x_k, w)
        if ctx.needs_input_grad[2]:
            dw = cin_weight_grad(g, x_k, x_0)
        return dx_k, dx_0, dw


def input_grad_x0(g: torch.Tensor, x_k: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``dx_0 = cin_layer(g, x_k, w')`` with ``w'[m, k, h] = w[k, h, m]``:
    the sum over h split into ranges of at most ``MAX_FIELDS`` (x_k takes
    the x_0 role here), one forward launch a range."""
    H = x_k.shape[1]
    wt = w.permute(2, 0, 1)                       # [M, K, H]
    parts = math.ceil(H / MAX_FIELDS)
    step = math.ceil(H / parts)
    out = None
    for h0 in range(0, H, step):
        part = _forward(g, x_k[:, h0:h0 + step].contiguous(),
                        wt[:, :, h0:h0 + step].contiguous())
        out = part if out is None else out + part
    return out


def _forward(x_k: torch.Tensor, x_0: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    if x_k.device.type == "cpu":
        return ref.cin_layer_ref(x_k, x_0, w)
    B, H, D = x_k.shape
    M = x_0.shape[1]
    K = w.shape[0]
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


def cin_weight_grad(g: torch.Tensor, x_k: torch.Tensor,
                    x_0: torch.Tensor) -> torch.Tensor:
    """float32 g [B, K, D], x_k [B, H, D], x_0 [B, M, D] -> dw [K, H, M],
    ``dw[k, h, m] = sum_{b, d} g[b, k, d] x_k[b, h, d] x_0[b, m, d]``: the
    CIN layer's weight gradient, one counted launch on the card.  Blocks
    of ``WG_ROWS`` values of j by ``WG_KROWS`` rows k walk the columns in
    stages of ``WG_COLS``; ``wgrad_plan`` splits the stages into parts
    when the blocks alone leave SMs idle.  The wrapper allocates the
    float32 scratch: g split into TF32 hi and lo in the stages' order
    (``wgrad_prep_floats``) and the parts' partial sums."""
    for name, t in (("g", g), ("x_k", x_k), ("x_0", x_0)):
        if t.dtype != torch.float32 or t.dim() != 3 or \
                not t.is_contiguous() or t.device != g.device:
            raise ValueError(f"{name} must be a contiguous 3-d float32 "
                             f"tensor on {g.device}")
    B, K, D = g.shape
    H, M = x_k.shape[1], x_0.shape[1]
    if x_k.shape != (B, H, D) or x_0.shape != (B, M, D):
        raise ValueError(f"g {tuple(g.shape)}, x_k {tuple(x_k.shape)} and "
                         f"x_0 {tuple(x_0.shape)} must be [B, K, D], "
                         "[B, H, D] and [B, M, D]")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {g.device}")
    if g.device.type == "cpu":
        return ref.cin_weight_grad_ref(g, x_k, x_0)
    dev = g.device
    splits, cps, part_shape = wgrad_plan(
        B, H, M, D, K, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    dw = torch.empty((K, H, M), dtype=torch.float32, device=dev)
    gprep = torch.empty(max(1, wgrad_prep_floats(B, D, K)),
                        dtype=torch.float32, device=dev)
    part = (torch.empty(part_shape, dtype=torch.float32, device=dev)
            if part_shape else None)
    fn = _build.function("cin_weight_grad")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(g.data_ptr(), x_k.data_ptr(), x_0.data_ptr(), dw.data_ptr(),
                gprep.data_ptr(), None if part is None else part.data_ptr(),
                B, H, M, D, K, splits, cps, stream)
    _build.check(rc, "cin_weight_grad")
    _build.count_launch("cin_weight_grad")
    return dw
