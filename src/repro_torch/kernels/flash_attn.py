"""Flash attention wrapper (port of ``repro/kernels/flash_attn.py``, B6).

Softmax attention on ``[B, H, S, d]`` with an online softmax, causal or
full, in float32 or bfloat16, ``d <= 128`` and both sequence lengths
multiples of 128 (as the reference asserts).  K and V have as many heads
as Q: the grouped-query caller, ``models/attention.flash_attention_gqa``
(every prompt attention of the LM path), repeats each KV head G times
and right-pads the sequence to a multiple of 128, which causal masking
keeps invisible to the real queries.  A CPU tensor goes to
``ref.flash_attention_ref``, a CUDA tensor to ``csrc/flash_attn.cu``.

``causal=True`` needs ``Sq == Sk``.  The reference's two functions
disagree elsewhere: its Pallas kernel aligns the mask top-left
(``q_pos >= k_pos``), its jnp oracle bottom-right
(``tril(k=Sk - Sq)``).  Rather than pick one, the port raises.

Training: with grad mode on and an input that requires grad, the call
is a ``torch.autograd.Function``.  Its forward is the same kernel writing
each row's log-sum-exp too (``csrc/flash_attn.cu``,
``flash_attention_lse``), and its backward the port's own kernels
(``csrc/flash_attn_bwd.cu``: D, then dK/dV, then dQ, one counted launch
``flash_attention_bwd``); the reference's Pallas kernel has no backward.
On the CPU the two take their plain versions,
``ref.flash_attention_fwd_ref`` and ``ref.flash_attention_bwd_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BLOCK = 128     # the sequence lengths' required multiple
MAX_HEAD_DIM = 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or \
                t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share float32 or bfloat16, "
                            f"got {name} {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, d], got "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [{B}, {H}, Sk, {d}]")
    if Sq % BLOCK or Sk % BLOCK:
        raise ValueError(f"Sq = {Sq} and Sk = {Sk} must be multiples of "
                         f"{BLOCK}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and "
                         f"{Sk}: the reference aligns the mask two ways")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, Sq, d], k and v [B, H, Sk, d] -> [B, H, Sq, d] in q.dtype;
    differentiable in q, k and v."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def _forward(q, k, v, causal: bool, with_lse: bool):
    """``(o, lse)``: the kernel's output and, ``with_lse``, each row's
    log-sum-exp float32 [B, H, Sq] (else None)."""
    if q.device.type == "cpu":
        if with_lse:
            return ref.flash_attention_fwd_ref(q, k, v, causal=causal)
        return ref.flash_attention_ref(q, k, v, causal=causal), None
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    name = "flash_attention_lse" if with_lse else "flash_attention"
    fn = _build.function(name)
    lse_ptr = (lse.data_ptr(),) if with_lse else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *lse_ptr, B * H, Sq, Sk, d, int(causal),
                int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, name)
    _build.count_launch(name)
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """``(dq, dk, dv)`` of ``o = flash_attention(q, k, v, causal)`` for the
    upstream gradient ``do`` (contiguous, ``o``'s shape and dtype), from
    the forward's ``o`` and ``lse``.  One counted launch on the card."""
    if do.shape != o.shape or do.dtype != o.dtype or not do.is_contiguous():
        raise ValueError(f"do must be contiguous {tuple(o.shape)} {o.dtype}")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, Sq, Sk,
                d, int(causal), int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, "flash_attention_bwd")
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv
