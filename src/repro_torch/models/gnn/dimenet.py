"""DimeNet — directional message passing (arXiv:2003.03123), port of
``repro/models/gnn/dimenet.py``.

Messages live on directed edges m_{j->i}; each interaction block
aggregates over triplets (k->j->i), combining a radial Bessel basis of
|r_ji| with an angular basis of angle(k,j,i) through a bilinear tensor.
As in the reference, the radial basis is the paper's spherical Bessel
sqrt(2/c) sin(n pi r / c) / r with the polynomial envelope, and the
angular basis a cosine-Fourier expansion cos(m * angle); the counts (6
blocks, 128 hidden, 8 bilinear, 7 spherical, 6 radial) are the paper's.

Padded triplets carry ``t_ji == n_edges``.  ``jax.ops.segment_sum`` drops
such out-of-range ids; ``index_add`` would raise (CPU) or trip a device
assert (CUDA), so the triplet aggregation reduces into ``n_edges + 1``
rows and slices the last off.  Gathers clamp their indices to the last
row, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16
    envelope_p: int = 6


@dataclasses.dataclass(frozen=True)
class TripletBatch:
    """Edges + triplets of a molecular batch (host-built, padded).
    Index tensors are int64 (the reference's int32 values)."""
    n_nodes: int
    n_edges: int
    n_graphs: int
    species: torch.Tensor    # [N_pad]
    pos: torch.Tensor        # float32[N_pad, 3]
    node_mask: torch.Tensor
    graph_id: torch.Tensor   # [N_pad]
    src: torch.Tensor        # [E_pad]  (edge j->i: src=j, dst=i)
    dst: torch.Tensor
    edge_mask: torch.Tensor
    t_kj: torch.Tensor       # [T_pad] index of edge (k->j)
    t_ji: torch.Tensor       # [T_pad] index of edge (j->i)
    t_mask: torch.Tensor
    y: torch.Tensor          # float32[n_graphs] energies

    def to(self, device) -> "TripletBatch":
        return L._batch_to(self, device)


def build_triplets(n: int, src, dst, pos, species, y, *, n_graphs=1,
                   graph_id=None, e_pad_mult=128, t_pad_mult=256,
                   device=None) -> TripletBatch:
    """Host-side: enumerate (k->j->i) pairs of edges sharing middle j (the
    reference's numpy), then tensors on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    e = len(src)
    in_edges = [[] for _ in range(n)]   # edges arriving at vertex
    for eid, d in enumerate(dst):
        in_edges[d].append(eid)
    t_kj, t_ji = [], []
    for eid in range(e):              # edge j->i
        j, i = src[eid], dst[eid]
        for kid in in_edges[j]:       # edge k->j
            if src[kid] != i:         # exclude back-tracking k == i
                t_kj.append(kid)
                t_ji.append(eid)
    t = len(t_kj)
    e_pad = max(e_pad_mult, -(-e // e_pad_mult) * e_pad_mult)
    t_pad = max(t_pad_mult, -(-max(t, 1) // t_pad_mult) * t_pad_mult)
    n_pad = -(-n // 8) * 8

    def pad(a, size, fill):
        out = np.full(size, fill, np.int32)
        out[: len(a)] = a
        return out

    pos_p = np.zeros((n_pad, 3), np.float32)
    pos_p[:n] = pos
    sp_p = pad(np.asarray(species), n_pad, 0)
    nm = np.zeros(n_pad, bool)
    nm[:n] = True
    gid = pad(np.zeros(n, np.int64) if graph_id is None else graph_id,
              n_pad, 0)
    T = L._tensor
    return TripletBatch(
        n_nodes=n_pad, n_edges=e_pad, n_graphs=n_graphs,
        species=T(sp_p, device), pos=T(pos_p, device),
        node_mask=T(nm, device), graph_id=T(gid, device),
        src=T(pad(src, e_pad, n_pad), device),
        dst=T(pad(dst, e_pad, n_pad), device),
        edge_mask=T(np.arange(e_pad) < e, device),
        t_kj=T(pad(t_kj, t_pad, e_pad), device),
        t_ji=T(pad(t_ji, t_pad, e_pad), device),
        t_mask=T(np.arange(t_pad) < t, device),
        y=T(np.asarray(y, np.float32).reshape(n_graphs), device),
    )


def _envelope(r, cutoff, p):
    """DimeNet polynomial envelope u(d) with u(cutoff)=0 smoothly."""
    d = r / cutoff
    a = -(p + 1) * (p + 2) / 2
    b = p * (p + 2)
    c = -p * (p + 1) / 2
    u = 1 + a * d ** p + b * d ** (p + 1) + c * d ** (p + 2)
    return torch.where(d < 1, u, 0.0)


def radial_basis(r, cfg: DimeNetConfig):
    """[E] -> [E, n_radial] Bessel basis * envelope."""
    n = torch.arange(1, cfg.n_radial + 1, dtype=r.dtype, device=r.device)
    rr = torch.clamp(r[:, None], min=1e-6)
    rbf = math.sqrt(2.0 / cfg.cutoff) * torch.sin(
        n * math.pi * rr / cfg.cutoff) / rr
    return rbf * _envelope(rr, cfg.cutoff, cfg.envelope_p)


def angular_basis(cos_angle, cfg: DimeNetConfig):
    """[T] -> [T, n_spherical] cosine-Fourier basis of the angle."""
    ang = torch.arccos(torch.clamp(cos_angle, -1 + 1e-6, 1 - 1e-6))
    m = torch.arange(cfg.n_spherical, dtype=cos_angle.dtype,
                     device=cos_angle.device)
    return torch.cos(m[None, :] * ang[:, None])


def init_params(cfg: DimeNetConfig, generator: torch.Generator,
                device) -> dict:
    """The reference's tree (``embed_species``, ``embed_rbf``,
    ``embed_msg``, ``blocks[i]``, ``out_head``) and scales; draws from
    ``generator`` on ``device``."""
    d, nb = cfg.d_hidden, cfg.n_bilinear

    def mlp(dims):
        return L.init_mlp(dims, generator, device)

    params = {
        "embed_species": torch.randn((cfg.n_species, d), generator=generator,
                                     device=device) * 0.5,
        "embed_rbf": mlp([cfg.n_radial, d]),
        "embed_msg": mlp([3 * d, d]),
        "blocks": [],
        "out_head": mlp([d, d, 1]),
    }
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "rbf_proj": mlp([cfg.n_radial, d]),
            "sbf_proj": mlp([cfg.n_spherical, nb]),
            "w_bilinear": torch.randn((nb, d, d), generator=generator,
                                      device=device) * (d ** -0.5),
            "msg_mlp": mlp([d, d]),
            "upd_mlp": mlp([d, d]),
            "out_proj": mlp([d, d]),
        })
    return params


def _rows(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``x[min(idx, n - 1)]``: the reference's clamped gather."""
    return L.take(x, torch.clamp(idx, max=n - 1))


def _bilinear(a: torch.Tensor, w: torch.Tensor, m_kj: torch.Tensor):
    """``einsum("tb,bdf,td->tf", a, w, m_kj)`` as one product of m_kj
    with w's [d, nb * f] view, then the weighted sum over b."""
    nb, d, f = w.shape
    mw = (m_kj @ w.permute(1, 0, 2).reshape(d, nb * f)).view(-1, nb, f)
    return (a[:, :, None] * mw).sum(1)


def forward(params, b: TripletBatch, cfg: DimeNetConfig) -> torch.Tensor:
    """Returns per-graph energy [n_graphs]."""
    # geometry
    pos_src = _rows(b.pos, b.src, b.n_nodes)
    pos_dst = _rows(b.pos, b.dst, b.n_nodes)
    vec = pos_dst - pos_src                     # r_ji = x_i - x_j
    dist = torch.where(b.edge_mask,
                       torch.linalg.norm(vec + 1e-9, dim=-1), cfg.cutoff)
    rbf = radial_basis(dist, cfg)               # [E, n_radial]

    # triplet angles: edges (k->j) and (j->i) meet at j
    v_ji = _rows(vec, b.t_ji, b.n_edges)
    v_kj = _rows(vec, b.t_kj, b.n_edges)
    # angle between r_jk (= -v_kj) and r_ji
    num = (-v_kj * v_ji).sum(-1)
    den = torch.clamp(torch.linalg.norm(v_kj, dim=-1)
                      * torch.linalg.norm(v_ji, dim=-1), min=1e-9)
    sbf = angular_basis(num / den, cfg)         # [T, n_spherical]

    # edge message init: h_j, h_i, rbf
    hs = params["embed_species"].index_select(0, b.species)
    h_j = _rows(hs, b.src, b.n_nodes)
    h_i = _rows(hs, b.dst, b.n_nodes)
    e_rbf = L.mlp(params["embed_rbf"], rbf)
    m = L.mlp(params["embed_msg"], torch.cat([h_j, h_i, e_rbf], -1))
    edge_mask = b.edge_mask[:, None]
    m = torch.where(edge_mask, m, 0.0)
    env = _envelope(dist, cfg.cutoff, cfg.envelope_p)[:, None]

    energy = 0.0
    for blk in params["blocks"]:
        # directional aggregation over triplets
        m_kj = _rows(m, b.t_kj, b.n_edges)                     # [T, d]
        a = L.mlp(blk["sbf_proj"], sbf)                        # [T, nb]
        g = L.mlp(blk["rbf_proj"], rbf)                        # [E, d]
        inter = _bilinear(a, blk["w_bilinear"], m_kj)
        inter = torch.where(b.t_mask[:, None], inter, 0.0)
        # padded triplets (t_ji == n_edges) land in the extra row
        agg = L.segment_sum(inter, b.t_ji, b.n_edges + 1)[: b.n_edges]
        m = m + L.mlp(blk["upd_mlp"],
                      F.silu(L.mlp(blk["msg_mlp"], m) * g + agg))
        m = torch.where(edge_mask, m, 0.0)
        # per-block output: scatter edge messages to atoms
        h_out = L.segment_sum(L.mlp(blk["out_proj"], m) * env, b.dst,
                              b.n_nodes + 1)[: b.n_nodes]
        e_atom = L.mlp(params["out_head"], h_out)[:, 0]
        e_atom = torch.where(b.node_mask, e_atom, 0.0)
        energy = energy + L.segment_sum(e_atom, b.graph_id, b.n_graphs)
    return energy


def loss_fn(params, b: TripletBatch, cfg: DimeNetConfig):
    pred = forward(params, b, cfg)
    err = pred - b.y
    loss = (err ** 2).mean()
    return loss, {"mae": err.abs().mean()}
