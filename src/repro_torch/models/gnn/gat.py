"""GAT (Veličković et al., arXiv:1710.10903), port of
``repro/models/gnn/gat.py``: the gat-cora config.

SDDMM (per-edge attention logits) -> segment softmax -> SpMM, all through
the segment-op substrate.  Hidden layers concatenate heads (ELU); the
output layer averages them (the paper's Cora setup: 2 layers, 8 hidden x
8 heads).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.gnn import layers as L


@dataclasses.dataclass(frozen=True)
class GATConfig:
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    in_dim: int = 1433
    n_classes: int = 7
    dropout: float = 0.0   # inference/dry-run default; train pass sets >0


def init_params(cfg: GATConfig, generator: torch.Generator, device) -> list:
    """A list of ``{"w" [d_in, H, d_out], "a_l" [H, d_out], "a_r"}`` a
    layer, the reference's layout and scales; the draws come from
    ``generator`` (on ``device``) and differ from the reference's."""
    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    params = []
    d_in = cfg.in_dim
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        H = cfg.n_heads
        params.append({"w": normal((d_in, H, d_out), d_in ** -0.5),
                       "a_l": normal((H, d_out), d_out ** -0.5),
                       "a_r": normal((H, d_out), d_out ** -0.5)})
        d_in = d_out if last else d_out * H
    return params


def forward(params, batch: L.GraphBatch, cfg: GATConfig) -> torch.Tensor:
    """Class logits ``[N_pad, n_classes]``."""
    x = batch.x
    for i, lp in enumerate(params):
        last = i == len(params) - 1
        f, H, d = lp["w"].shape
        h = (x @ lp["w"].reshape(f, H * d)).view(-1, H, d)   # [N, H, d]
        el = (h * lp["a_l"]).sum(-1)                          # [N, H]
        er = (h * lp["a_r"]).sum(-1)
        # logits on edge (src -> dst): a_l . h_dst + a_r . h_src
        logit = (L.gather_nodes(batch, el, batch.dst)
                 + L.gather_nodes(batch, er, batch.src))
        logit = F.leaky_relu(logit, 0.2)
        alpha = L.seg_softmax(batch, logit)                   # [E, H]
        msg = L.gather_nodes(batch, h, batch.src) * alpha[..., None]
        agg = L.seg_sum(batch, msg)                           # [N, H, d]
        if last:
            x = agg.mean(dim=1)                               # head average
        else:
            x = F.elu(agg.reshape(agg.shape[0], -1))          # head concat
    return x


def node_nll(logits: torch.Tensor, batch, train_mask=None):
    """Masked mean negative log-likelihood and accuracy of node labels
    ``batch.y`` (the reference's GAT and PNA ``loss_fn``)."""
    mask = (batch.node_mask if train_mask is None else train_mask).to(
        logits.dtype)
    labels = batch.y.long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    count = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / count
    acc = ((logits.argmax(-1) == labels).to(logits.dtype) * mask).sum() \
        / count
    return loss, {"acc": acc}


def loss_fn(params, batch: L.GraphBatch, cfg: GATConfig, train_mask=None):
    return node_nll(forward(params, batch, cfg), batch, train_mask)
