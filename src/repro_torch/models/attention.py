"""Attention of the LM path (port of ``repro/models/attention.py``).

Prompt attention (``flash_attention_gqa``, ``chunked_local_attention``)
goes through ``kernels.ops.flash_attention`` (B6): one launch for a
layer's whole prompt.  The reference computes it as an online softmax in
jnp; here the CUDA kernel runs on a CUDA tensor (a shape it refuses
raises, nothing falls back) and its plain version on a CPU tensor.

Grouped-query layout: the public functions keep the reference's
``q [B, S, Hkv, G, hd]`` and ``k, v [B, S, Hkv, hd]``.  B6 takes as many
K/V heads as query heads, so ``gqa_heads`` flattens q to ``[B, Hkv*G,
S, hd]`` (head ``h = kv * G + g``, the reference's order) and repeats
each K/V head G times.  B6 needs sequence lengths that are multiples of
128: the sequence is right-padded with zeros, and causal masking keeps
the padded keys invisible to every real query; the padded queries' rows
are cut off the output.

Chunked-local attention (Llama-4's local layers) runs the same kernel
with the chunks as extra batch rows, each chunk padded to 128.

``decode_attention`` (one query against a KV cache) stays plain f32
PyTorch, as it was plain jnp outside any kernel in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attn import BLOCK

NEG_INF = -1e30


def _pad_seq(x: torch.Tensor, length: int) -> torch.Tensor:
    """Right-pad dim 2 of ``[B, H, S, hd]`` with zeros to ``length``."""
    pad = length - x.shape[2]
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def gqa_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True):
    """The tensors B6 takes for grouped-query attention: ``q`` [B, S,
    Hkv, G, hd] -> [B, Hkv*G, S', hd] and ``k``, ``v`` [B, Sk, Hkv, hd]
    -> [B, Hkv*G, Sk', hd], with S' and Sk' the lengths rounded up to
    128.  K/V are padded only under ``causal`` (which has Sq == Sk); a
    non-causal call would let the real queries see padded keys, so it
    takes Sk as it is and the kernel refuses a ragged one."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, Hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [{B}, Sk, {Hkv}, {hd}]")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and "
                         f"{Sk}")
    qh = q.reshape(B, Sq, Hkv * G, hd).transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    qh = _pad_seq(qh, -(-Sq // BLOCK) * BLOCK)
    if causal:
        kh = _pad_seq(kh, qh.shape[2])
        vh = _pad_seq(vh, qh.shape[2])
    return qh.contiguous(), kh.contiguous(), vh.contiguous()


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Softmax attention through B6, one launch.

    q: [B, Sq, Hkv, G, hd]; k, v: [B, Sk, Hkv, hd]; returns [B, Sq, Hkv,
    G, hd] in ``q.dtype``.  The reference's ``block_k`` and ``unroll``
    shape its jnp scan and have no counterpart; its ``q_offset`` (no
    caller) neither: causal attention takes Sq == Sk.
    """
    B, Sq, Hkv, G, hd = q.shape
    qh, kh, vh = gqa_heads(q, k, v, causal)
    o = kops.flash_attention(qh, kh, vh, causal=causal)
    return o[:, :, :Sq].transpose(1, 2).reshape(B, Sq, Hkv, G, hd)


def chunked_local_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Causal attention restricted to fixed chunks (Llama-4 local layers).

    q: [B, S, Hkv, G, hd]; k, v: [B, S, Hkv, hd].  A ragged last chunk is
    right-padded; causal masking keeps its padded keys invisible.  The
    chunks become batch rows of one B6 launch.
    """
    B, S, Hkv, G, hd = q.shape
    if S <= chunk:
        return flash_attention_gqa(q, k, v, causal=True)
    pad = -S % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n = (S + pad) // chunk
    out = flash_attention_gqa(q.reshape(B * n, chunk, Hkv, G, hd),
                              k.reshape(B * n, chunk, Hkv, hd),
                              v.reshape(B * n, chunk, Hkv, hd), causal=True)
    return out.reshape(B, n * chunk, Hkv, G, hd)[:, :S]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """Single-token attention over a KV cache, in float32.

    q: [B, 1, Hkv, G, hd]; k_cache, v_cache: [B, S_max, Hkv, hd];
    ``length``: the number of valid cache slots (a host integer).
    """
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float() * scale,
                     k_cache.float())
    valid = torch.arange(k_cache.shape[1], device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    return out.to(q.dtype)
