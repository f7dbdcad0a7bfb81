"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k
routing and sort-based capacity dispatch with the reference's drop
semantics.

Routing is f32: softmax over the router's logits, ``topk``, renormalise,
then the gates drop to the activation dtype.  Per batch row the (token,
choice) pairs are sorted stably by expert id; a pair's rank within its
expert decides whether it fits the expert's capacity C = ``capacity``.
A pair past capacity goes to the drop slot ``E*C`` and its token falls
through the residual (GShard drop semantics).  The dispatch buffer is
``[B, E*C + 1, d]``, filled by one ``index_add_`` (each kept slot takes
exactly one token) with its last row cut.

The expert SwiGLU and the shared experts are ``einsum``s: plain products
the reference left to XLA outside any kernel.  The combine puts each
expert output back at its (token, choice) position and sums the choices,
so it is deterministic on the card (no atomics).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal_init


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    d_model: int, dtype, device=None) -> dict:
    E, f = cfg.n_experts, cfg.d_ff_expert

    def draw(shape, scale, dt=dtype):
        return normal_init(generator, shape, scale, dt, device)

    p = {
        "router": draw((d_model, E), d_model ** -0.5, torch.float32),
        "we_gate": draw((E, d_model, f), d_model ** -0.5),
        "we_up": draw((E, d_model, f), d_model ** -0.5),
        "we_down": draw((E, f, d_model), f ** -0.5),
    }
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p["ws_gate"] = draw((d_model, fs), d_model ** -0.5)
        p["ws_up"] = draw((d_model, fs), d_model ** -0.5)
        p["ws_down"] = draw((fs, d_model), fs ** -0.5)
    return p


def capacity(cfg: MoEConfig, s: int) -> int:
    c = int(s * cfg.top_k * cfg.capacity_factor / cfg.n_experts + 0.999)
    return max(8, -(-c // 8) * 8)  # round up to 8


def no_drop(cfg: MoEConfig) -> MoEConfig:
    """``cfg`` with ``capacity_factor = E / top_k``: C >= S, so no token
    of an S-token row is dropped (a token picks an expert at most once)."""
    return dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts / cfg.top_k))


def swiglu(x, w_gate, w_up, w_down, up: str = "bsd,df->bsf",
           down: str = "bsf,fd->bsd"):
    """SwiGLU as the reference writes it (silu in f32, cast back), with
    the ``up`` and ``down`` products as einsum specs: by default a dense
    FFN over ``[B, S, d]``."""
    g = torch.einsum(up, x, w_gate)
    u = torch.einsum(up, x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum(down, h, w_down)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: [B, S, d] -> (out [B, S, d], aux losses dict)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    dev = x.device

    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1)              # [B, S, K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    gates = gates.to(x.dtype)

    # aux losses (Switch load balance + z-loss) on the full router state
    me = probs.mean(dim=(0, 1))                             # [E]
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=dev))
    ce = ce / (B * S * K)
    aux_lb = E * torch.sum(me * ce)
    aux_z = torch.logsumexp(logits, dim=-1).square().mean()

    # per-row sort-based dispatch, all rows at once
    fid = eidx.reshape(B, S * K)
    order = torch.argsort(fid, dim=-1, stable=True)
    fid_s = fid.gather(1, order)
    ftok_s = torch.div(order, K, rounding_mode="floor")     # token of a pair
    fgate_s = gates.reshape(B, S * K).gather(1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, fid_s, torch.ones_like(fid_s))
    start = counts.cumsum(1) - counts
    rank = torch.arange(S * K, device=dev) - start.gather(1, fid_s)
    keep = rank < C
    slot = torch.where(keep, fid_s * C + rank, E * C)       # drop slot E*C
    rows = torch.arange(B, device=dev)[:, None] * (E * C + 1)
    tok_rows = x.gather(1, ftok_s[..., None].expand(-1, -1, d))
    tok_rows = tok_rows * keep[..., None].to(x.dtype)
    buf = torch.zeros((B * (E * C + 1), d), dtype=x.dtype, device=dev)
    buf.index_add_(0, (rows + slot).reshape(-1), tok_rows.reshape(-1, d))
    buf = buf.view(B, E * C + 1, d)[:, : E * C].reshape(B, E, C, d)

    # expert SwiGLU
    eo = swiglu(buf, params["we_gate"], params["we_up"], params["we_down"],
                "becd,edf->becf", "becf,efd->becd")

    # combine: each kept pair's expert output, gated, back at its
    # (token, choice) position; the choices summed per token
    vals = eo.reshape(B, E * C, d).gather(
        1, slot.clamp(max=E * C - 1)[..., None].expand(-1, -1, d))
    vals = vals * (keep.to(fgate_s.dtype) * fgate_s)[..., None].to(vals.dtype)
    pairs = torch.empty_like(vals).scatter_(
        1, order[..., None].expand(-1, -1, d), vals)
    out = pairs.view(B, S, K, d).sum(2)

    if "ws_gate" in params:                                 # shared experts
        out = out + swiglu(x, params["ws_gate"], params["ws_up"],
                           params["ws_down"])

    aux = {"moe_lb": aux_lb * cfg.router_aux_weight,
           "moe_z": aux_z * cfg.router_z_weight}
    return out, aux
