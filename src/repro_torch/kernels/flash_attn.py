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

Scoring only: like the reference kernel this one has no backward, so an
input that requires grad (with grad mode on) raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BLOCK = 128     # the sequence lengths' required multiple
MAX_HEAD_DIM = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, H, Sq, d], k and v [B, H, Sk, d] -> [B, H, Sq, d] in q.dtype."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B * H, Sq, Sk, d, int(causal),
                int(q.dtype == torch.bfloat16), stream)
    _build.check(rc, "flash_attention")
    _build.count_launch("flash_attention")
    return out
