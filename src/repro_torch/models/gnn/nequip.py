"""NequIP — E(3)-equivariant interatomic potential (arXiv:2101.03164),
port of ``repro/models/gnn/nequip.py``.

Spherical-harmonic evaluation + Clebsch-Gordan tensor product + scatter.
Features are irrep dicts {l: [N, mult, 2l+1]} with l <= l_max = 2;
messages are CG-coupled products of neighbour features with edge
spherical harmonics, weighted by a radial MLP of the Bessel basis,
aggregated with a segment sum.

The real-basis coupling tensors come from the reference's numpy code at
import (complex CG by the Racah formula, then the complex->real unitary
change of basis; odd (l1+l2+l3) paths realified by dropping the global
i), float64 then float32: bit for bit the reference's ``CG``.  Like the
reference, the model tracks rotation order l, not parity (SE(3)- rather
than full E(3)-equivariant).
"""
from __future__ import annotations

import dataclasses
from math import factorial, pi, sqrt

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.dimenet import (DimeNetConfig, _envelope,
                                            radial_basis)

L_MAX = 2


# ---------------------------------------------------------------------------
# Real spherical harmonics (standard convention, m = -l..l)
# ---------------------------------------------------------------------------

def real_sh(unit: torch.Tensor) -> dict[int, torch.Tensor]:
    """unit: [..., 3] unit vectors -> {l: [..., 2l+1]}."""
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    c0 = sqrt(1 / (4 * pi))
    c1 = sqrt(3 / (4 * pi))
    return {
        0: torch.full(unit.shape[:-1] + (1,), c0, dtype=unit.dtype,
                      device=unit.device),
        1: c1 * torch.stack([y, z, x], dim=-1),
        2: torch.stack([
            sqrt(15 / (4 * pi)) * x * y,
            sqrt(15 / (4 * pi)) * y * z,
            sqrt(5 / (16 * pi)) * (3 * z * z - 1.0),
            sqrt(15 / (4 * pi)) * x * z,
            sqrt(15 / (16 * pi)) * (x * x - y * y),
        ], dim=-1),
    }


# ---------------------------------------------------------------------------
# Clebsch-Gordan in the real basis (computed once, numpy float64)
# ---------------------------------------------------------------------------

def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    f = lambda n: float(factorial(n))  # noqa: E731
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pre = sqrt((2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2)
                       * f(l1 + l2 - l3) / f(l1 + l2 + l3 + 1))
            pre *= sqrt(f(l3 + m3) * f(l3 - m3) * f(l1 - m1) * f(l1 + m1)
                        * f(l2 - m2) * f(l2 + m2))
            s = 0.0
            for k in range(0, l1 + l2 + l3 + 1):
                d = (k, l1 + l2 - l3 - k, l1 - m1 - k, l2 + m2 - k,
                     l3 - l2 + m1 + k, l3 - l1 - m2 + k)
                if min(d) < 0:
                    continue
                s += (-1) ** k / np.prod([f(v) for v in d])
            C[m1 + l1, m2 + l2, m3 + l3] = pre * s
    return C


def _real_U(l: int) -> np.ndarray:
    """Unitary mapping complex SH -> real SH (rows m_real, cols m_cplx)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), complex)
    for m in range(-l, l + 1):
        if m == 0:
            U[l, l] = 1.0
        elif m > 0:
            U[m + l, -m + l] = 1 / sqrt(2)
            U[m + l, m + l] = (-1) ** m / sqrt(2)
        else:
            am = -m
            U[m + l, m + l] = 1j / sqrt(2)
            U[m + l, am + l] = -1j * (-1) ** am / sqrt(2)
    return U


def _cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    C = _cg_complex(l1, l2, l3).astype(complex)
    U1, U2, U3 = _real_U(l1), _real_U(l2), _real_U(l3)
    W = np.einsum("cn,abn,xa,yb->xyc", U3, C,
                  U1.conj(), U2.conj())
    if np.abs(W.real).max() >= np.abs(W.imag).max():
        W = W.real
    else:
        W = W.imag  # odd paths: drop the global i (parity flip only)
    return np.ascontiguousarray(W)


PATHS: list[tuple[int, int, int]] = [
    (l1, l2, l3)
    for l1 in range(L_MAX + 1)
    for l2 in range(L_MAX + 1)
    for l3 in range(L_MAX + 1)
    if abs(l1 - l2) <= l3 <= l1 + l2
]
# float32 numpy tables, one a path (the reference's jnp.float32 values)
CG = {p: _cg_real(*p).astype(np.float32) for p in PATHS}
# every table in one flat array, so that a forward moves them in one copy
_CG_FLAT = np.concatenate([CG[p].ravel() for p in PATHS])
_CG_OFFSETS = np.cumsum([0] + [CG[p].size for p in PATHS])


def cg_tensors(device, dtype=torch.float32) -> dict:
    """``CG`` as tensors on ``device`` (one host-to-device copy), float32
    unless ``dtype`` asks for another."""
    flat = torch.from_numpy(_CG_FLAT).to(device, dtype)
    return {p: flat[_CG_OFFSETS[i]:_CG_OFFSETS[i + 1]].view(CG[p].shape)
            for i, p in enumerate(PATHS)}


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    n_layers: int = 5
    mult: int = 32          # d_hidden: channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16

    @property
    def paths(self):
        return [p for p in PATHS if max(p) <= self.l_max]


def init_params(cfg: NequIPConfig, generator: torch.Generator,
                device) -> dict:
    """The reference's tree: ``embed``, ``layers[i]`` (``radial`` MLP,
    ``self`` and ``skip`` keyed by int l, ``gate`` MLP) and ``out``, with
    its scales; draws from ``generator`` on ``device``."""
    m = cfg.mult
    n_paths = len(cfg.paths)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    params = {
        "embed": normal((cfg.n_species, m), 0.5),
        "layers": [],
        "out": L.init_mlp([m, m, 1], generator, device),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            # radial MLP -> per-path per-channel weights
            "radial": L.init_mlp([cfg.n_rbf, m, n_paths * m], generator,
                                 device),
            # self-interaction per output l
            "self": {l: normal((m, m), m ** -0.5)
                     for l in range(cfg.l_max + 1)},
            "skip": {l: normal((m, m), m ** -0.5)
                     for l in range(cfg.l_max + 1)},
            "gate": L.init_mlp([m, cfg.l_max * m], generator, device),
        })
    return params


def _mix(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("nmi,mk->nki", h, w)``: channels mixed per component."""
    return torch.einsum("nmi,mk->nki", h, w)


def forward(params, b, cfg: NequIPConfig) -> torch.Tensor:
    """b: TripletBatch-compatible (species, pos, src, dst, edge_mask,
    node_mask, graph_id) -> per-graph energy [n_graphs]."""
    N = b.n_nodes
    dev = b.pos.device
    src = torch.clamp(b.src, max=N - 1)
    dst = torch.clamp(b.dst, max=N - 1)
    vec = L.take(b.pos, dst) - L.take(b.pos, src)
    dist = torch.linalg.norm(vec + 1e-9, dim=-1)
    dist = torch.where(b.edge_mask, dist, cfg.cutoff)
    unit = vec / torch.clamp(dist, min=1e-9)[:, None]
    rcfg = DimeNetConfig(n_radial=cfg.n_rbf, cutoff=cfg.cutoff)
    rbf = radial_basis(dist, rcfg)                        # [E, n_rbf]
    Y = real_sh(unit)                                     # {l2: [E, 2l2+1]}
    env = _envelope(dist, cfg.cutoff, 6)[:, None]
    dt = b.pos.dtype
    cg = cg_tensors(dev, dt)
    edge_mask = b.edge_mask[:, None, None]

    m = cfg.mult
    h = {0: params["embed"].index_select(0, b.species)[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = torch.zeros((N, m, 2 * l + 1), dtype=dt, device=dev)

    paths = cfg.paths
    for lp in params["layers"]:
        w_all = L.mlp(lp["radial"], rbf).reshape(
            rbf.shape[0], len(paths), m)                  # [E, P, m]
        w_all = w_all * env[..., None]
        agg = {l: torch.zeros((N, m, 2 * l + 1), dtype=dt, device=dev)
               for l in range(cfg.l_max + 1)}
        for p, (l1, l2, l3) in enumerate(paths):
            hj = L.take(h[l1], src)                       # [E, m, 2l1+1]
            # einsum("abc,ema,eb->emc", CG, hj, Y[l2]): CG with Y first
            k = torch.einsum("abc,eb->eac", cg[(l1, l2, l3)], Y[l2])
            msg = torch.bmm(hj, k)                        # [E, m, 2l3+1]
            msg = msg * w_all[:, p, :, None]
            msg = torch.where(edge_mask, msg, 0.0)
            agg[l3] = agg[l3] + L.segment_sum(msg, dst, N)
        # self-interaction + gated nonlinearity
        scal = F.silu(_mix(agg[0], lp["self"][0])[:, :, 0])
        gates = torch.sigmoid(
            L.mlp(lp["gate"], scal).reshape(N, cfg.l_max, m))
        h_new = {0: (scal + _mix(h[0], lp["skip"][0])[:, :, 0])[:, :, None]}
        for l in range(1, cfg.l_max + 1):
            mixed = _mix(agg[l], lp["self"][l]) * gates[:, l - 1, :, None]
            h_new[l] = mixed + _mix(h[l], lp["skip"][l])
        h = h_new

    e_atom = L.mlp(params["out"], h[0][:, :, 0])[:, 0]
    e_atom = torch.where(b.node_mask, e_atom, 0.0)
    return L.segment_sum(e_atom, b.graph_id, b.n_graphs)


def loss_fn(params, b, cfg: NequIPConfig):
    pred = forward(params, b, cfg)
    err = pred - b.y
    return (err ** 2).mean(), {"mae": err.abs().mean()}
