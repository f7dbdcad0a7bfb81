"""xDeepFM CIN layer wrapper (port of ``repro/kernels/cin.py``, B5).

``out[b, k, d] = sum_{h, m} w[k, h, m] * x_k[b, h, d] * x_0[b, m, d]``
without building ``z[b, h, m, d]``.  A CPU tensor goes to
``ref.cin_layer_ref``, a CUDA tensor to ``csrc/cin.cu``, which takes any
batch size (the reference padded B to its TPU block of 32).

The kernel runs the layer as one GEMM over the flat reduction index
``j = h * M + m``, in stages of ``CHUNK`` values of j, on blocks of
``COLS`` columns ``b * D + d`` by ``rows(K)`` rows k; ``plan`` splits the
stages into S parts when the batch gives too few output tiles to fill
the card, and the wrapper allocates its scratch: W split into TF32 hi/lo
in the stages' order, and the parts' partial sums.  One wrapper call is
one counted launch, whatever S is.

Training: with grad mode on and an input that requires grad, the call
is a ``torch.autograd.Function`` whose backward takes the input
gradients from this same kernel with permuted weights (the reference's
CIN has no backward kernel, and these need none of their own):

    dx_k = cin_layer(g, x_0, w^T),   w^T[h, k, m] = w[k, h, m]
    dx_0 = cin_layer(g, x_k, w'),    w'[m, k, h] = w[k, h, m]

where in dx_0 the x_0 role has H fields, which may pass ``MAX_FIELDS``
(221: CIN 200-200-200 takes one launch): that call splits over ranges of
at most ``MAX_FIELDS`` values of h and adds the parts, on every device.  The
weight gradient ``dw[k, h, m] = sum_{b, d} g x_k x_0`` is a kernel of its
own, ``cin_weight_grad`` (``csrc/cin.cu``), with its own split plan
(``wgrad_plan``) and launch key.  On the CPU each call takes its plain
version.

The forward and the weight gradient are ``torch.library.custom_op``s
(``repro_torch::cin_layer``, ``cin_weight_grad``) with fake
implementations (their output shapes: a fake tensor never builds the
plain version's ``z``), FLOP formulas and DTensor rules (a call on
batch-sharded tensors is local), for the dry-run.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

# The kernel's tiles (csrc/cin.cu: kFCols, kFRowsL, kFRowsS, kFJ,
# kFFlush; a test holds them equal): columns b * D + d a block, rows k a
# block (ROWS_SMALL when K <= ROWS_SMALL), values of j a stage, and k-steps
# of 8 values of j between two flushes of the float32 accumulators into
# their Kahan pairs.
COLS = 128
ROWS = 104
ROWS_SMALL = 40
CHUNK = 32
FLUSH = 16
SMS = 132           # streaming multiprocessors of an H100 SXM
# fields of x_0 the kernel's dynamic shared memory holds beside its two
# stages (csrc/cin.cu: kFMaxFields): 512 bytes a field (the block's 128
# columns), at most 232,448 bytes a block on an H100
MAX_FIELDS = 221


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
    chunks_per_split: int        # stages of CHUNK values of j a part
    w_prep_shape: tuple          # W split into TF32 hi/lo, the stages' order
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


def rows(K: int) -> int:
    """Rows k a block of the forward kernel: the wgmma's N."""
    return ROWS_SMALL if K <= ROWS_SMALL else ROWS


def plan(B: int, H: int, M: int, D: int, K: int, sms: int = SMS) -> Plan:
    """How the forward kernel splits a layer's reduction (over j = h * M
    + m, in stages of ``CHUNK``) into S parts (``_split``), and the shapes
    of its float32 scratch: W^T split into hi and lo, one tile of
    ``rows(K)`` rows by ``CHUNK`` a row tile and stage."""
    n_chunks = math.ceil(H * M / CHUNK)
    n_ktiles = math.ceil(K / rows(K))
    splits, cps = _split(n_chunks, math.ceil(B * D / COLS) * n_ktiles, sms)
    return Plan(splits, cps, (n_ktiles, n_chunks, 2 * rows(K) * CHUNK),
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
    most ``MAX_FIELDS`` values of h: one at H = 200) and dw (one
    ``cin_weight_grad``)."""
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
    return _layer_op(x_k, x_0, w)


def _forward_impl(x_k: torch.Tensor, x_0: torch.Tensor,
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
    return _wgrad_op(g, x_k, x_0)


def _wgrad_impl(g: torch.Tensor, x_k: torch.Tensor,
                x_0: torch.Tensor) -> torch.Tensor:
    B, K, D = g.shape
    H, M = x_k.shape[1], x_0.shape[1]
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


# ---------------------------------------------------------------------------
# custom ops: B5's forward and weight gradient
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::cin_layer", mutates_args=())
def _layer_op(x_k: torch.Tensor, x_0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    return _forward_impl(x_k, x_0, w)


@torch.library.custom_op("repro_torch::cin_weight_grad", mutates_args=())
def _wgrad_op(g: torch.Tensor, x_k: torch.Tensor,
              x_0: torch.Tensor) -> torch.Tensor:
    return _wgrad_impl(g, x_k, x_0)


@_layer_op.register_fake
def _(x_k, x_0, w):
    return x_k.new_empty((x_k.shape[0], w.shape[0], x_k.shape[2]),
                         dtype=torch.float32)


@_wgrad_op.register_fake
def _(g, x_k, x_0):
    return g.new_empty((g.shape[1], x_k.shape[1], x_0.shape[1]),
                       dtype=torch.float32)


def _register_rules() -> None:
    """FLOP formulas (2 a multiply-add of ``sum_{h,m}`` over every
    [b, k, d], the same for the weight gradient's ``sum_{b,d}``) and
    DTensor rules: a batch-sharded call is local (the weights
    replicated; the weight gradient a partial sum over the batch's
    axes)."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.cin_layer)
    def _(x_k, x_0, w, *args, out_shape=None, **kwargs):
        (B, H, D), M, K = x_k, x_0[1], w[0]
        return 2 * B * K * H * M * D

    @register_flop_formula(torch.ops.repro_torch.cin_weight_grad)
    def _(g, x_k, x_0, *args, out_shape=None, **kwargs):
        (B, K, D), H, M = g, x_k[1], x_0[1]
        return 2 * B * K * H * M * D

    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.cin_layer.default)
    def _(x_k, x_0, w):
        return [([Replicate()], [Replicate()] * 3),
                ([Shard(0)], [Shard(0), Shard(0), Replicate()])]

    @register_sharding(torch.ops.repro_torch.cin_weight_grad.default)
    def _(g, x_k, x_0):
        return [([Replicate()], [Replicate()] * 3),
                ([Partial()], [Shard(0)] * 3)]


_register_rules()
