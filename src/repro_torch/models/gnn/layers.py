"""GNN substrate of the port (``repro/models/gnn/layers.py``): padded
graph batches and segment-op message passing.

Message passing is explicit ``gather(src) -> per-edge compute ->
segment_{sum,max,min}(dst)`` over a padded edge list, computed with
``index_select``, ``index_add`` and ``scatter_reduce`` (the reference
computes these outside any kernel too).  Padding convention as the
reference's: the sentinel node index is ``n_nodes``, segment ops run over
``n_nodes + 1`` segments and slice the sentinel off, and ``gather_nodes``
appends one fill row.  An empty segment's max is ``-inf`` and its min
``+inf``, as ``jax.ops.segment_max``/``segment_min`` give.

Index tensors are int64 (torch's index dtype; the reference's int32
values).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import resolve_device
from repro_torch.distributed.layout import is_dtensor, replicated_like

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A (possibly block-diagonal) padded graph.

    node features x: [N_pad, F]; edges (src, dst): int64[E_pad] with
    sentinel N for padding; node_mask: [N_pad] valid nodes; graph_id:
    [N_pad] segment id for graph-level readout (0 for single graphs);
    pos: [N_pad, 3] coordinates (molecular archs) or zeros; y: labels,
    [N_pad] (node tasks) or [n_graphs] (graph tasks).
    """
    n_nodes: int
    n_graphs: int
    x: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    node_mask: torch.Tensor
    graph_id: torch.Tensor
    pos: torch.Tensor
    y: torch.Tensor

    @property
    def n_seg(self) -> int:
        return self.n_nodes + 1

    def to(self, device) -> "GraphBatch":
        return _batch_to(self, device)


def _batch_to(batch, device):
    """``batch`` (a frozen dataclass of ints and tensors) with every
    tensor on ``device``."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(device)
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)})


def gather_nodes(batch: GraphBatch, vals: torch.Tensor, idx: torch.Tensor,
                 fill=0.0) -> torch.Tensor:
    """``vals[idx]`` with one ``fill`` row appended at index ``n_nodes``
    (the sentinel)."""
    ext = torch.cat([vals, vals.new_full((1,) + vals.shape[1:], fill)])
    return take(ext, idx)


def take(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals.index_select(0, idx)``; DTensors take ``_take_sharded``."""
    if _sharded(vals, idx):
        return _take_sharded(vals, idx)
    return vals.index_select(0, idx)


def _take_sharded(vals, idx):
    """A gather of DTensors (``local_map``): ``vals`` whole along dim 0
    (gathered first where it is sharded, as edge values read by triplet
    indices are), each rank reads the rows its block of ``idx`` names;
    the gradient of ``vals`` comes back as a partial sum over the axes
    that shard ``idx``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (vals if _sharded(vals) else idx).device_mesh
    if not _sharded(idx):
        idx = replicated_like(idx, mesh)
    if not _sharded(vals):
        vals = replicated_like(vals, mesh)
    edge = tuple(isinstance(p, Shard) and p.dim == 0 for p in idx.placements)
    vp = tuple(Replicate() if e or isinstance(p, Shard) and p.dim == 0
               else p for e, p in zip(edge, vals.placements))
    ip = tuple(Shard(0) if e else Replicate() for e in edge)
    out = tuple(Shard(0) if e else p for e, p in zip(edge, vp))
    grad = tuple(Partial() if e else p for e, p in zip(edge, vp))
    return local_map(lambda v, i: v.index_select(0, i),
                     out_placements=(out,), in_placements=(vp, ip),
                     in_grad_placements=(grad, ip), device_mesh=mesh,
                     redistribute_inputs=True)(vals, idx)


def _ids(batch: GraphBatch, at: str) -> torch.Tensor:
    return batch.dst if at == "dst" else batch.src


def segment_sum(vals: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for in-range ids: ``[num_segments, ...]``,
    0 where no id lands."""
    if _sharded(vals, ids):
        return _segment_sharded(vals, ids, num_segments, "sum", 0.0)
    return _segment_plain(vals, ids, num_segments, "sum", 0.0)


def _segment_reduce(vals, ids, num_segments, how: str, fill: float):
    if _sharded(vals, ids):
        return _segment_sharded(vals, ids, num_segments, how, fill)
    return _segment_plain(vals, ids, num_segments, how, fill)


def _sharded(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def _segment_sharded(vals, ids, num_segments: int, how: str, fill: float):
    """A segment reduction of DTensors (``local_map``): each rank reduces
    its block of the edges (the edge arrays sharded over the data axes,
    the distributed SSSP layout) into a full ``[num_segments, ...]``, a
    partial sum, max or min over those axes that the next use combines.
    A max or min of a partial sum takes the sum first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (vals if _sharded(vals) else ids).device_mesh
    if not _sharded(ids):
        ids = replicated_like(ids, mesh)
    if not _sharded(vals):
        vals = replicated_like(vals, mesh)
    edge = tuple(isinstance(p, Shard) and p.dim == 0 for p in ids.placements)
    vp = tuple(Shard(0) if e else
               (Replicate() if isinstance(p, Shard) and p.dim == 0 or
                how != "sum" and isinstance(p, Partial) else p)
               for e, p in zip(edge, vals.placements))
    ip = tuple(Shard(0) if e else Replicate() for e in edge)
    op = {"sum": "sum", "amax": "max", "amin": "min"}[how]
    out = tuple(Partial(op) if e else p for e, p in zip(edge, vp))

    def local(v, i):
        return _segment_plain(v, i, num_segments, how, fill)
    return local_map(local, out_placements=(out,), in_placements=(vp, ip),
                     device_mesh=mesh, redistribute_inputs=True)(vals, ids)


def _segment_plain(vals, ids, num_segments, how: str, fill: float):
    if how == "sum":
        out = vals.new_zeros((num_segments,) + vals.shape[1:])
        return out.index_add(0, ids, vals)
    out = vals.new_full((num_segments,) + vals.shape[1:], fill)
    idx = ids.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return out.scatter_reduce(0, idx, vals, how, include_self=False)


def seg_sum(batch: GraphBatch, edge_vals, at="dst"):
    return segment_sum(edge_vals, _ids(batch, at),
                       batch.n_seg)[: batch.n_nodes]


def seg_max(batch: GraphBatch, edge_vals, at="dst"):
    """Max at each node; ``-inf`` where no edge lands."""
    return _segment_reduce(edge_vals, _ids(batch, at), batch.n_seg, "amax",
                           -INF)[: batch.n_nodes]


def seg_min(batch: GraphBatch, edge_vals, at="dst"):
    """Min at each node; ``+inf`` where no edge lands."""
    return _segment_reduce(edge_vals, _ids(batch, at), batch.n_seg, "amin",
                           INF)[: batch.n_nodes]


def seg_mean(batch: GraphBatch, edge_vals, at="dst"):
    ids = _ids(batch, at)
    s = seg_sum(batch, edge_vals, at)
    ones = (ids < batch.n_nodes).to(edge_vals.dtype)
    cnt = segment_sum(ones, ids, batch.n_seg)[: batch.n_nodes]
    return s / torch.clamp(cnt, min=1.0)[..., None]


def seg_softmax(batch: GraphBatch, edge_logits: torch.Tensor) -> torch.Tensor:
    """Edge softmax normalized over each destination's in-edges.

    edge_logits: [E_pad, H]; padding edges get weight 0.
    """
    mx = _segment_reduce(edge_logits, batch.dst, batch.n_seg, "amax", -INF)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(edge_logits - take(mx, batch.dst))
    ex = torch.where((batch.dst < batch.n_nodes)[:, None], ex, 0.0)
    den = segment_sum(ex, batch.dst, batch.n_seg)
    return ex / torch.clamp(take(den, batch.dst), min=1e-9)


def in_degrees(batch: GraphBatch) -> torch.Tensor:
    ones = (batch.dst < batch.n_nodes).to(torch.float32)
    return segment_sum(ones, batch.dst, batch.n_seg)[: batch.n_nodes]


def graph_readout(batch: GraphBatch, node_vals: torch.Tensor,
                  op: str = "sum") -> torch.Tensor:
    vals = torch.where(batch.node_mask[:, None], node_vals, 0.0)
    out = segment_sum(vals, batch.graph_id, batch.n_graphs)
    if op == "mean":
        cnt = segment_sum(batch.node_mask.to(torch.float32), batch.graph_id,
                          batch.n_graphs)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def mlp(params: list, x: torch.Tensor, act=F.silu) -> torch.Tensor:
    """``x @ w + b`` per layer, ``act`` between layers (not after the
    last).  Parameters are a list of ``(w [d_in, d_out], b [d_out])``
    pairs, the reference's layout."""
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = act(x)
    return x


def init_mlp(dims: list[int], generator: torch.Generator,
             device: torch.device) -> list:
    """float32 normal weights scaled by ``d_in ** -0.5``, zero biases.
    Draws from ``generator``, which lives on ``device``; the numbers differ
    from the reference's random draws."""
    return [
        (torch.randn((dims[i], dims[i + 1]), generator=generator,
                     device=device) * (dims[i] ** -0.5),
         torch.zeros((dims[i + 1],), device=device))
        for i in range(len(dims) - 1)
    ]


# ---------------------------------------------------------------------------
# Host-side batch builder
# ---------------------------------------------------------------------------

def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def build_batch(n: int, src, dst, x, y, *, pos=None, graph_id=None,
                n_graphs: int = 1, e_pad_multiple: int = 128,
                n_pad_multiple: int = 8, device=None) -> GraphBatch:
    """The reference's ``build_batch`` (the same numpy arrays), as tensors
    on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    e = len(src)
    e_pad = max(e_pad_multiple,
                (e + e_pad_multiple - 1) // e_pad_multiple * e_pad_multiple)
    n_pad = max(n_pad_multiple,
                (n + n_pad_multiple - 1) // n_pad_multiple * n_pad_multiple)

    def pad_e(a, fill):
        out = np.full((e_pad,) + a.shape[1:], fill, a.dtype)
        out[:e] = a
        return out

    def pad_n(a, fill=0):
        out = np.full((n_pad,) + np.asarray(a).shape[1:], fill,
                      np.asarray(a).dtype)
        out[:n] = a
        return out

    x = np.asarray(x, np.float32)
    mask = np.zeros(n_pad, bool)
    mask[:n] = True
    gid = (np.zeros(n, np.int32) if graph_id is None
           else np.asarray(graph_id, np.int32))
    pos = np.zeros((n, 3), np.float32) if pos is None else np.asarray(
        pos, np.float32)
    y = np.asarray(y)
    if graph_id is not None and y.shape[0] == n_graphs:
        y_arr = y                      # graph-level labels
    else:
        y_arr = pad_n(y, 0)            # node-level labels
    return GraphBatch(
        n_nodes=n_pad, n_graphs=n_graphs,
        x=_tensor(pad_n(x), device),
        src=_tensor(pad_e(src, n_pad), device),
        dst=_tensor(pad_e(dst, n_pad), device),
        node_mask=_tensor(mask, device),
        graph_id=_tensor(pad_n(gid, 0), device),
        pos=_tensor(pad_n(pos), device),
        y=_tensor(y_arr, device),
    )
