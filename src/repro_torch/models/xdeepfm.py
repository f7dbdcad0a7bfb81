"""xDeepFM (port of ``repro/models/xdeepfm.py``; arXiv:1803.05170).

Embedding bag + CIN + DNN + linear term: ``forward`` scores a batch of
multi-hot rows, ``retrieval_scores`` one query against many candidates,
``loss_fn`` is the training loss.  The CIN layers go through
``kernels.ops.cin_layer`` (the CUDA kernel B5 on the card, its plain
version on the CPU; its backward is B5 again for the input gradients and
``cin_weight_grad`` for the weights); the embedding bag, the DNN and the
output products are plain PyTorch, as they were plain XLA in the
reference.

Parameters keep the reference's tree (``table``, ``linear``, ``cin``,
``dnn``, ``bias``, ``cin_out``), so ``convert.xdeepfm_params_from_arrays``
carries its weights across unchanged.  ``init_params(...,
requires_grad=True)`` gives a tree to train; ``XDeepFM`` holds its
parameters frozen, for scoring.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint.store import tree_leaves
from repro_torch.core.graph import resolve_device
from repro_torch.distributed.layout import (is_dtensor, local_block,
                                            replicated_like)
from repro_torch.kernels import ops as kops
from repro_torch.models.gnn.layers import init_mlp, mlp


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    n_fields: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_dims: tuple[int, ...] = (400, 400)
    # Criteo-like vocabulary sizes: a few huge fields + many small ones
    field_sizes: tuple[int, ...] = ()

    def sizes(self) -> tuple[int, ...]:
        if self.field_sizes:
            return self.field_sizes
        base = [1_000_000, 500_000, 250_000, 100_000, 50_000]
        rest = [int(10_000 / (1 + i)) + 100
                for i in range(self.n_fields - len(base))]
        return tuple((base + rest)[: self.n_fields])

    @property
    def total_rows(self) -> int:
        return int(sum(self.sizes()))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes())[:-1]])


def init_params(cfg: XDeepFMConfig, generator: torch.Generator,
                device=None, requires_grad: bool = False) -> dict:
    """Random parameters drawn from ``generator`` (which lives on
    ``device``), scaled as the reference scales them; every leaf
    requires grad if ``requires_grad``."""
    device = resolve_device(device)
    d, m = cfg.embed_dim, cfg.n_fields

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    params = {
        "table": normal(cfg.total_rows, d) * 0.01,
        "linear": normal(cfg.total_rows) * 0.01,
        "cin": [],
        "dnn": init_mlp([m * d, *cfg.mlp_dims, 1], generator, device),
        "bias": torch.zeros((), device=device),
    }
    h_prev = m
    for h in cfg.cin_layers:
        params["cin"].append(normal(h, h_prev, m) * ((h_prev * m) ** -0.5))
        h_prev = h
    params["cin_out"] = normal(sum(cfg.cin_layers)) * 0.1
    if requires_grad:
        for t in tree_leaves(params):
            t.requires_grad_(True)
    return params


def embedding_bag(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """EmbeddingBag(sum): ``indices`` int[B, F, V] global row ids (V values
    per multi-hot field, -1 padding) -> [B, F, d]."""
    B, F_, V = indices.shape
    flat = indices.reshape(-1)
    rows = _take_rows(table, flat)
    return rows.reshape(B, F_, V, table.shape[1]).sum(2)


def _take_rows(table: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``table[flat]`` with 0 where ``flat`` is negative (padding).  A
    DTensor table row-sharded over model (table parallelism) takes
    ``_take_rows_sharded``."""
    if is_dtensor(table):
        return _take_rows_sharded(table, flat)
    valid = flat >= 0
    rows = table.index_select(0, flat.clamp(min=0))
    return torch.where(valid.view((-1,) + (1,) * (rows.dim() - 1)), rows,
                       0.0)


def _take_rows_sharded(table, flat):
    """Table-parallel lookup (``local_map``): each rank reads the ids that
    fall in its block of rows, zeros elsewhere, a partial sum over the
    axes that shard the table."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_dtensor(flat):
        flat = replicated_like(flat, mesh)
    tp = tuple(table.placements)
    ip = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 else
               Replicate() for p in flat.placements)
    out = tuple(Partial() if isinstance(t, Shard) and t.dim == 0 else i
                for t, i in zip(tp, ip))
    lo, width = local_block(table, 0)

    def local(tab, ids):
        t = ids.long() - lo
        inside = (ids >= 0) & (t >= 0) & (t < width)
        rows = tab.index_select(0, t.clamp(0, width - 1))
        return torch.where(inside.view((-1,) + (1,) * (rows.dim() - 1)),
                           rows, torch.zeros((), dtype=rows.dtype))
    return local_map(local, out_placements=(out,), in_placements=(tp, ip),
                     device_mesh=mesh, redistribute_inputs=True)(table, flat)


def forward(params: dict, batch: dict) -> torch.Tensor:
    """``batch["indices"]`` int32[B, F, V] -> logits float32[B]."""
    idx = batch["indices"]
    B = idx.shape[0]
    x0 = embedding_bag(params["table"], idx)        # [B, F, d]

    # linear term: sum of per-row weights
    flat = idx.reshape(-1)
    linear = _take_rows(params["linear"], flat).reshape(B, -1).sum(-1)

    # CIN branch
    xk = x0
    cin_feats = []
    for w in params["cin"]:
        xk = kops.cin_layer(xk, x0, w)
        cin_feats.append(xk.sum(-1))                # sum-pool over d
    cin_logit = torch.cat(cin_feats, dim=-1) @ params["cin_out"]

    # DNN branch
    dnn_logit = mlp(params["dnn"], x0.reshape(B, -1), act=F.relu)[:, 0]

    return linear + cin_logit + dnn_logit + params["bias"]


def loss_fn(params: dict, batch: dict):
    """Mean stable BCE of ``forward`` against ``batch["labels"]``, and the
    accuracy as its metric."""
    logits = forward(params, batch)
    y = batch["labels"].float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    acc = ((logits > 0) == (y > 0.5)).float().mean()
    return loss, {"acc": acc}


def retrieval_scores(params: dict, query_idx: torch.Tensor,
                     cand_table: torch.Tensor) -> torch.Tensor:
    """Score 1 query (``query_idx`` int32[1, F, V]) against N candidate
    embeddings ``cand_table`` [N, d] with one [N, d] @ [d] product -> [N]."""
    q = embedding_bag(params["table"], query_idx)   # [1, F, d]
    qv = q.mean(dim=1)[0]                           # [d]
    return cand_table @ qv


class XDeepFM(torch.nn.Module):
    """The parameters of one xDeepFM on one device, for scoring.

    ``XDeepFM.init(cfg, generator, device)`` draws them;
    ``XDeepFM(cfg, params)`` takes a tree (``init_params``, or the
    reference's weights through ``convert``).  ``.to(device)`` moves them.
    """

    def __init__(self, cfg: XDeepFMConfig, params: dict):
        super().__init__()
        self.cfg = cfg

        def frozen(t):
            return torch.nn.Parameter(t, requires_grad=False)

        self.table = frozen(params["table"])
        self.linear = frozen(params["linear"])
        self.bias = frozen(params["bias"])
        self.cin_out = frozen(params["cin_out"])
        self.cin = torch.nn.ParameterList(
            [frozen(w) for w in params["cin"]])
        self.dnn = torch.nn.ParameterList(
            [frozen(t) for wb in params["dnn"] for t in wb])

    @classmethod
    def init(cls, cfg: XDeepFMConfig, generator: torch.Generator,
             device=None) -> "XDeepFM":
        return cls(cfg, init_params(cfg, generator, device))

    def params(self) -> dict:
        """The parameter tree that ``forward``/``retrieval_scores`` take."""
        dnn = list(self.dnn)
        return {"table": self.table, "linear": self.linear,
                "cin": list(self.cin),
                "dnn": list(zip(dnn[0::2], dnn[1::2])),
                "bias": self.bias, "cin_out": self.cin_out}

    def forward(self, indices: torch.Tensor) -> torch.Tensor:
        """int32[B, F, V] on the parameters' device -> logits [B]."""
        return forward(self.params(), {"indices": indices})

    def retrieval_scores(self, query_idx: torch.Tensor,
                         cand_table: torch.Tensor) -> torch.Tensor:
        return retrieval_scores(self.params(), query_idx, cand_table)
