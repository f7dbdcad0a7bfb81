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

from repro_torch.distributed.layout import is_dtensor, local_block
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
    Hkv, G, hd] (or [B, S, Hkv*G, hd]) -> [B, Hkv*G, S', hd] and ``k``,
    ``v`` [B, Sk, Hkv, hd] -> [B, Hkv*G, Sk', hd], with S' and Sk' the
    lengths rounded up to 128.  K/V are padded only under ``causal``
    (which has Sq == Sk); a non-causal call would let the real queries
    see padded keys, so it takes Sk as it is and the kernel refuses a
    ragged one."""
    B, Sq = q.shape[:2]
    hd = q.shape[-1]
    Sk, Hkv = k.shape[1], k.shape[2]
    H = q.shape[2] * q.shape[3] if q.dim() == 5 else q.shape[2]
    G = H // Hkv
    if (k.shape != (B, Sk, Hkv, hd) or v.shape != k.shape
            or H != Hkv * G or q.dim() == 5 and q.shape[2] != Hkv):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [{B}, Sk, Hkv, {hd}] for q {tuple(q.shape)}")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq} and "
                         f"{Sk}")
    qh = q.reshape(B, Sq, H, hd).transpose(1, 2)
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

    q: [B, Sq, Hkv, G, hd] (or [B, Sq, H, hd]); k, v: [B, Sk, Hkv, hd];
    returns q's shape in ``q.dtype``.  The reference's ``block_k`` and
    ``unroll`` shape its jnp scan and have no counterpart; its
    ``q_offset`` (no caller) neither: causal attention takes Sq == Sk.
    """
    if is_dtensor(q):
        return _flash_gqa_sharded(q, k, v, causal)
    Sq = q.shape[1]
    qh, kh, vh = gqa_heads(q, k, v, causal)
    o = kops.flash_attention(qh, kh, vh, causal=causal)
    return o[:, :, :Sq].transpose(1, 2).reshape(q.shape)


def _flash_gqa_sharded(q, k, v, causal: bool):
    """``flash_attention_gqa`` of DTensors (``local_map``): q [B, S, H,
    hd] keeps its batch and head sharding (a sequence-sharded q is
    gathered whole: B6 takes no query offset), K/V [B, S, Hkv, hd] are
    gathered whole over the axes that shard q's heads, and each rank runs
    one B6 call on its query heads against the K/V heads they read.  The
    K/V gradients come back as partial sums over those axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if q.dim() != 4:
        raise ValueError(f"a DTensor q must be [B, S, H, hd], got "
                         f"{tuple(q.shape)}")
    mesh = q.device_mesh
    qp = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else
               Replicate() for p in q.placements)
    if qp != tuple(q.placements):
        q = q.redistribute(mesh, qp)
    kp = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in qp)
    gp = tuple(Partial() if isinstance(p, Shard) and p.dim == 2 else r
               for p, r in zip(qp, kp))
    H, Hkv = q.shape[2], k.shape[2]
    G = H // Hkv
    lo, width = local_block(q, 2)

    def local(ql, kl, vl):
        heads = torch.div(lo + torch.arange(width, device=ql.device), G,
                          rounding_mode="floor")
        kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
        return flash_attention_gqa(ql, kl, vl, causal=causal)
    return local_map(local, out_placements=(qp,), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, gp, gp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def chunked_local_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """Causal attention restricted to fixed chunks (Llama-4 local layers).

    q: [B, S, Hkv, G, hd] (or [B, S, H, hd]); k, v: [B, S, Hkv, hd].  A
    ragged last chunk is right-padded; causal masking keeps its padded
    keys invisible.  The chunks become batch rows of one B6 launch.
    """
    B, S = q.shape[:2]
    if S <= chunk:
        return flash_attention_gqa(q, k, v, causal=True)
    pad = -S % chunk
    if pad:
        q = F.pad(q, (0, 0) * (q.dim() - 2) + (0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n = (S + pad) // chunk
    out = flash_attention_gqa(q.reshape((B * n, chunk) + q.shape[2:]),
                              k.reshape((B * n, chunk) + k.shape[2:]),
                              v.reshape((B * n, chunk) + v.shape[2:]),
                              causal=True)
    return out.reshape((B, n * chunk) + q.shape[2:])[:, :S]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """Single-token attention over a KV cache, in float32.

    q: [B, 1, Hkv, G, hd] (or [B, 1, H, hd]: the result then has that
    shape); k_cache, v_cache: [B, S_max, Hkv, hd]; ``length``: the number
    of valid cache slots (a host integer).
    """
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, length)
    if q.dim() == 4:
        B, _, H, hd = q.shape
        Hkv = k_cache.shape[2]
        o = decode_attention(q.reshape(B, 1, Hkv, H // Hkv, hd), k_cache,
                             v_cache, length)
        return o.reshape(q.shape)
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float() * scale,
                     k_cache.float())
    valid = torch.arange(k_cache.shape[1], device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v_cache.float())
    return out.to(q.dtype)


def _decode_attention_sharded(q, k_cache, v_cache, length: int):
    """``decode_attention`` against a DTensor cache whose sequence may be
    sharded (``sharding.lm_cache_spec``), flash-decode style with
    ``local_map``: each rank scores its block of cache slots, a max over
    the model axis and two sums (the softmax's denominator and the
    weighted values) combine the blocks.  The query is gathered whole;
    the result is laid out as the cache's batch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    cp = tuple(k_cache.placements)
    rows = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
                 Replicate() for p in cp)

    def part(op):
        return tuple(Partial(op) if isinstance(p, Shard) and p.dim == 1
                     else r for p, r in zip(cp, rows))
    lo, width = local_block(k_cache, 1)
    hd = q.shape[-1]
    scale = 1.0 / (hd ** 0.5)

    def scores(ql, kl):
        B, _, H, _ = ql.shape
        Hkv = kl.shape[2]
        qg = ql.reshape(B, 1, Hkv, H // Hkv, hd)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg.float() * scale, kl.float())
        valid = lo + torch.arange(width, device=ql.device) < length
        return torch.where(valid, s, NEG_INF)

    def local_max(ql, kl):
        return scores(ql, kl).amax(-1)

    def weighted(ql, kl, vl, m):
        p = torch.exp(scores(ql, kl) - m[..., None])
        o = torch.einsum("bqhgk,bkhd->bqhgd", p, vl.float())
        return o, p.sum(-1)

    m = local_map(local_max, out_placements=(part("max"),),
                  in_placements=(rows, cp), device_mesh=mesh,
                  redistribute_inputs=True)(q, k_cache)
    m = m.redistribute(mesh, rows)
    o, den = local_map(weighted, out_placements=(part("sum"), part("sum")),
                       in_placements=(rows, cp, cp, rows), device_mesh=mesh,
                       redistribute_inputs=True)(q, k_cache, v_cache, m)
    o = o.redistribute(mesh, rows)
    den = den.redistribute(mesh, rows)
    return (o / den[..., None]).reshape(q.shape).to(q.dtype)
