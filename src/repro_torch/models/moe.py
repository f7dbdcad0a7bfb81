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

from repro_torch.distributed.layout import is_dtensor, whole_rows
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


def _route(x: torch.Tensor, router: torch.Tensor, K: int):
    """Router logits, probabilities, renormalised top-k gates (in the
    activation dtype) and expert ids of ``x`` [B, S, d]."""
    logits = torch.einsum("bsd,de->bse", x.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1)              # [B, S, K]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return logits, probs, gates.to(x.dtype), eidx


def _dispatch(x: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
              E: int, C: int):
    """Per-row sort-based dispatch, all rows at once: the buffer [B, E, C,
    d] and what the combine needs (order, slot, keep, gate of each sorted
    (token, choice) pair)."""
    B, S, d = x.shape
    K = eidx.shape[-1]
    dev = x.device
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
    return buf, order, slot, keep, fgate_s


def _combine(eo: torch.Tensor, order, slot, keep, fgate_s, S: int, K: int):
    """Each kept pair's expert output, gated, back at its (token, choice)
    position; the choices summed per token: [B, S, d]."""
    B, E, C, d = eo.shape
    vals = eo.reshape(B, E * C, d).gather(
        1, slot.clamp(max=E * C - 1)[..., None].expand(-1, -1, d))
    vals = vals * (keep.to(fgate_s.dtype) * fgate_s)[..., None].to(vals.dtype)
    pairs = torch.empty_like(vals).scatter_(
        1, order[..., None].expand(-1, -1, d), vals)
    return pairs.view(B, S, K, d).sum(2)


def _experts(params: dict, buf: torch.Tensor) -> torch.Tensor:
    return swiglu(buf, params["we_gate"], params["we_up"], params["we_down"],
                  "becd,edf->becf", "becf,efd->becd")


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
            ep_constraint=None):
    """x: [B, S, d] -> (out [B, S, d], aux losses dict).

    ``ep_constraint`` (the sharding hooks' ``moe_buf``) lays out the
    dispatch buffer and the expert outputs [B, E, C, d]; a DTensor ``x``
    takes ``_moe_ffn_sharded``."""
    if is_dtensor(x):
        return _moe_ffn_sharded(params, x, cfg, ep_constraint)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    dev = x.device

    logits, probs, gates, eidx = _route(x, params["router"], K)

    # aux losses (Switch load balance + z-loss) on the full router state
    me = probs.mean(dim=(0, 1))                             # [E]
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), torch.ones(eidx.numel(), device=dev))
    ce = ce / (B * S * K)
    aux_lb = E * torch.sum(me * ce)
    aux_z = torch.logsumexp(logits, dim=-1).square().mean()

    buf, *meta = _dispatch(x, gates, eidx, E, C)
    if ep_constraint is not None:
        buf = ep_constraint(buf)
    eo = _experts(params, buf)
    if ep_constraint is not None:
        eo = ep_constraint(eo)
    out = _combine(eo, *meta, S, K)

    if "ws_gate" in params:                                 # shared experts
        out = out + swiglu(x, params["ws_gate"], params["ws_up"],
                           params["ws_down"])

    aux = {"moe_lb": aux_lb * cfg.router_aux_weight,
           "moe_z": aux_z * cfg.router_z_weight}
    return out, aux


def _moe_ffn_sharded(params: dict, x, cfg: MoEConfig, ep_constraint):
    """``moe_ffn`` of a DTensor ``x``: routing and dispatch run on each
    rank's batch rows (``local_map``: whole rows, replicated over the
    model axis, so a sequence-sharded ``x`` is gathered first), the
    buffer goes to ``ep_constraint``'s layout (a local slice of the
    experts), the expert SwiGLU runs on each rank's experts, and the
    combine gathers the expert outputs of its rows back.  The aux losses'
    sums come out as partial sums over the data axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    mesh = x.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    part = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    rep = (Replicate(),) * mesh.ndim

    def route(xl, router):
        logits, probs, gates, eidx = _route(xl, router, K)
        ce = torch.zeros(E, dtype=torch.float32, device=xl.device)
        ce = ce.index_add_(0, eidx.reshape(-1),
                           torch.ones(eidx.numel(), device=xl.device))
        z2 = torch.logsumexp(logits, dim=-1).square().sum()
        return (*_dispatch(xl, gates, eidx, E, C), probs.sum(dim=(0, 1)),
                ce, z2)

    route = local_map(route, out_placements=(rows,) * 5 + (part,) * 3,
                      in_placements=(rows, rep), device_mesh=mesh,
                      redistribute_inputs=True)
    buf, order, slot, keep, fgate_s, me_sum, ce, z2 = route(
        x, params["router"])
    me = me_sum / (B * S)
    ce = ce / (B * S * K)
    aux_lb = E * torch.sum(me * ce)
    aux_z = z2 / (B * S)

    if ep_constraint is not None:
        buf = ep_constraint(buf)
    eo = _experts(params, buf)
    if ep_constraint is not None:
        eo = ep_constraint(eo)
    combine = local_map(
        lambda e, o, sl, kp, g: _combine(e, o, sl, kp, g, S, K),
        out_placements=(rows,), in_placements=(rows,) * 5, device_mesh=mesh,
        redistribute_inputs=True)
    out = combine(eo, order, slot, keep, fgate_s)

    if "ws_gate" in params:                                 # shared experts
        out = out + swiglu(whole_rows(x), params["ws_gate"],
                           params["ws_up"], params["ws_down"])

    aux = {"moe_lb": aux_lb * cfg.router_aux_weight,
           "moe_z": aux_z * cfg.router_z_weight}
    return out, aux
