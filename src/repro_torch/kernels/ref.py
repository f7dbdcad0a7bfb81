"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

Each function is the mathematical definition with no tiling.  The kernel
wrappers call these for CPU tensors, and ``chip_smoke.py`` holds every
CUDA kernel against them on the card.  The SSSP kernels (min, mask and a
single f32 add) are exact, so there the two must agree bit for bit; the
CIN and attention kernels sum in another order and are held allclose.
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


def out_cells(indptr: torch.Tensor, f_idx: torch.Tensor, max_deg: int,
              e_pad: int):
    """The ``[cap, max_deg]`` out-edge table of the buffer ``f_idx`` over
    the CSR run table ``indptr`` (n + 1 entries; padding slots carry
    ``n``): clamped buffer ids, the live-cell mask and the clamped edge
    positions into the ``e_pad``-long ``dst``/``w``."""
    n = indptr.shape[0] - 1
    u = f_idx.clamp(max=n - 1).long()
    base = indptr[u]
    deg = indptr[u + 1] - base
    j = torch.arange(max_deg, dtype=torch.int32, device=f_idx.device)
    cell = (f_idx < n)[:, None] & (j[None, :] < deg[:, None])
    epos = (base[:, None] + j[None, :]).clamp(max=e_pad - 1).long()
    return u, cell, epos


def frontier_relax_ref(x: torch.Tensor, src_mask: torch.Tensor,
                       f_idx: torch.Tensor, indptr: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor,
                       max_deg: int) -> torch.Tensor:
    """Shared-frontier relax -> float32[B, n]: the whole of
    ``ops.frontier_relax_b``, the plain version of the fused CUDA entry.

    One gather of the buffered vertices' out-edges, shared by the lanes
    (``tgt``), lane b's candidates ``x[b, u] + w`` where ``src_mask[b,
    u]`` (+inf elsewhere), then the batched scatter-min."""
    n = x.shape[1]
    u, cell, epos = out_cells(indptr, f_idx, max_deg, dst.shape[0])
    tgt = torch.where(cell, dst[epos], n).to(torch.int32)
    lane_ok = cell[None] & src_mask[:, u][:, :, None]
    cand = torch.where(lane_ok, x[:, u][:, :, None] + w[epos][None], INF)
    return frontier_scatter_min_batch_ref(tgt, cand, n)


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

    The CUDA kernel takes no NaN (the engine's D and D + outWeight are
    ``>= +0.0`` or +inf).
    """
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], INF, dtype=torch.float32,
                          device=x.device)
    return torch.where(mask, x, INF).amin(dim=-1)


def masked_min_pair_ref(x: torch.Tensor, mask: torch.Tensor,
                        add: torch.Tensor | None) -> torch.Tensor:
    """Both minima of a round over one mask -> float32[..., 2]: column 0
    ``masked_min_ref(x, mask)``, column 1 ``masked_min_ref(x + add,
    mask)`` (+inf if ``add`` is None).  A min is exact and ``x + add``
    one f32 add, so the kernel, which adds in its loop, is bitwise this.
    The segment and frontier backends take their minima from this on
    any device, as the reference took them in jnp there.
    """
    lo = masked_min_ref(x, mask)
    hi = (torch.full_like(lo, INF) if add is None
          else masked_min_ref(x + add, mask))
    return torch.stack([lo, hi], dim=-1)


def cin_layer_ref(x_k: torch.Tensor, x_0: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """xDeepFM CIN layer -> float32[B, K, D].

    ``out[b, k, d] = sum_{h, m} w[k, h, m] * x_k[b, h, d] * x_0[b, m, d]``
    with x_k [B, H, D], x_0 [B, M, D], w [K, H, M].  Builds the outer
    product ``z[b, h, m, d]`` that the kernel never builds.
    """
    z = torch.einsum("bhd,bmd->bhmd", x_k, x_0)
    return torch.einsum("khm,bhmd->bkd", w, z)


def cin_weight_grad_ref(g: torch.Tensor, x_k: torch.Tensor,
                        x_0: torch.Tensor) -> torch.Tensor:
    """The CIN layer's weight gradient for the upstream gradient ``g``
    [B, K, D] -> [K, H, M]: ``dw[k, h, m] = sum_{b, d} g[b, k, d] *
    x_k[b, h, d] * x_0[b, m, d]``, through the outer product as above."""
    z = torch.einsum("bhd,bmd->bhmd", x_k, x_0)
    return torch.einsum("bkd,bhmd->khm", g, z)


def cin_layer_bwd_ref(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor,
                      g: torch.Tensor):
    """Gradients ``(dx_k, dx_0, dw)`` of ``cin_layer_ref`` for the upstream
    gradient ``g`` [B, K, D], each written out from the definition:
    ``dx_k[b, h, d] = sum_{k, m} g[b, k, d] w[k, h, m] x_0[b, m, d]``,
    ``dx_0[b, m, d] = sum_{k, h} g[b, k, d] w[k, h, m] x_k[b, h, d]``."""
    dx_k = torch.einsum("bkd,khm,bmd->bhd", g, w, x_0)
    dx_0 = torch.einsum("bkd,khm,bhd->bmd", g, w, x_k)
    return dx_k, dx_0, cin_weight_grad_ref(g, x_k, x_0)


def _scaled_logits(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """float32 ``q k^T / sqrt(d)`` with masked scores ``-1e30``, and the
    causal keep mask (``q_pos >= k_pos``; None when not causal)."""
    d = q.shape[-1]
    qf = q.float() * (1.0 / d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    keep = None
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(keep, logits, -1e30)
    return logits, keep


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True):
    """``(flash_attention_ref(q, k, v, causal), lse)``: the output and each
    row's log-sum-exp of its scaled scores, float32 [B, H, Sq], as the
    training forward keeps it for the backward."""
    logits, _ = _scaled_logits(q, k, causal)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain softmax attention on ``[B, H, S, d]``, scores materialized.

    Follows the kernel's numerics: inputs in float32, ``q`` scaled by
    ``1/sqrt(d)`` first, masked scores ``-1e30``, the result cast to
    ``q.dtype``.  The causal mask is ``q_pos >= k_pos``; the wrapper
    admits it only for ``Sq == Sk``, where the reference's kernel and
    its oracle agree.
    """
    return flash_attention_fwd_ref(q, k, v, causal)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of ``o = flash_attention(q, k, v)`` for
    the upstream ``do``, from the forward's ``o`` and ``lse``, written out
    from the formulas the CUDA backward computes (in float32, each cast
    to its input's dtype):

        P = exp(q k^T / sqrt(d) - lse)     (0 where masked)
        dv = P^T do,  dS = P * (do v^T - rowsum(do * o))
        dq = dS k / sqrt(d),  dk = dS^T q / sqrt(d)
    """
    scale = 1.0 / q.shape[-1] ** 0.5
    logits, keep = _scaled_logits(q, k, causal)
    p = torch.exp(logits - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dof, qf, kf = do.float(), q.float(), k.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    delta = (dof * o.float()).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
