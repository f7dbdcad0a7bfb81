"""PNA — Principal Neighbourhood Aggregation (arXiv:2004.05718), port of
``repro/models/gnn/pna.py``.

Per layer: message MLP over [h_src, h_dst] -> 4 parallel segment
aggregators (mean/max/min/std) x 3 degree scalers (identity,
amplification log(d+1)/delta, attenuation delta/log(d+1)) -> update MLP.
Config: 4 layers, d_hidden=75.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.gat import node_nll


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    n_layers: int = 4
    d_hidden: int = 75
    in_dim: int = 100
    n_classes: int = 47
    delta: float = 2.5   # mean log-degree of the training graphs


def init_params(cfg: PNAConfig, generator: torch.Generator, device) -> dict:
    """``encode``, ``layers[i]`` (``msg``, ``upd``) and ``head`` MLPs, the
    reference's layout; draws from ``generator`` on ``device``."""
    d = cfg.d_hidden
    params = {"encode": L.init_mlp([cfg.in_dim, d], generator, device)}
    params["layers"] = [
        {"msg": L.init_mlp([2 * d, d], generator, device),
         "upd": L.init_mlp([d + 12 * d, d], generator, device)}
        for _ in range(cfg.n_layers)]
    params["head"] = L.init_mlp([d, cfg.n_classes], generator, device)
    return params


def forward(params, batch: L.GraphBatch, cfg: PNAConfig) -> torch.Tensor:
    x = L.mlp(params["encode"], batch.x)
    deg = L.in_degrees(batch)
    logd = torch.log1p(deg)[:, None]
    amp = logd / cfg.delta
    att = cfg.delta / torch.clamp(logd, min=1e-6)
    valid = (batch.dst < batch.n_nodes)[:, None]

    for lp in params["layers"]:
        h_src = L.gather_nodes(batch, x, batch.src)
        h_dst = L.gather_nodes(batch, x, batch.dst)
        m = L.mlp(lp["msg"], torch.cat([h_src, h_dst], -1))
        mean = L.seg_mean(batch, m)
        # padded edges masked to -inf / +inf before the max / min
        mx = L.seg_max(batch, torch.where(valid, m, -L.INF))
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        mn = L.seg_min(batch, torch.where(valid, m, L.INF))
        mn = torch.where(torch.isfinite(mn), mn, 0.0)
        sq = L.seg_mean(batch, m * m)
        std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-6))
        aggs = torch.cat([mean, mx, mn, std], -1)             # [N, 4d]
        scaled = torch.cat([aggs, aggs * amp, aggs * att], -1)
        x = x + L.mlp(lp["upd"], torch.cat([x, scaled], -1))
    return L.mlp(params["head"], x)


def loss_fn(params, batch: L.GraphBatch, cfg: PNAConfig, train_mask=None):
    return node_nll(forward(params, batch, cfg), batch, train_mask)
