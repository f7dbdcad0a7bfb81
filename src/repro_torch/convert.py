"""Carry the reference's graph containers and weights across to the port.

Each graph function reads the fields of a reference ``Graph``/
``CsrGraph``/``EllGraph`` (duck-typed: anything with those attributes,
read through ``np.asarray``) and builds the port's container from the
same arrays; ``delta_from_arrays`` does the same for a ``GraphDelta``,
``landmark_tables_from_arrays`` for a ``LandmarkIndex``'s two distance
tables, ``fleet_from_arrays``, ``stacked_delta_from_arrays`` and
``fleet_state_from_arrays`` for a ``GraphFleet``, a stacked delta and a
``FleetSolver.state_dict()``, ``graph_batch_from_arrays`` and
``triplet_batch_from_arrays`` for a GNN batch, and
``xdeepfm_params_from_arrays``, ``lm_params_from_arrays`` and
``gnn_params_from_arrays`` for a parameter tree.  So both packages can be
run on identical inputs.  ``lm_params_to_arrays`` goes back, so that an
LM tree's gradients compare with the reference's leaf by leaf (the
xDeepFM and GNN trees have one structure in both packages).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (CsrGraph, EllGraph, Graph, GraphStack,
                                    ell_row_len, resolve_device)
from repro_torch.core.sssp.dynamic import GraphDelta, _delta_from_host
from repro_torch.core.sssp.fleet import GraphFleet, StackedDelta
from repro_torch.models.gnn.dimenet import TripletBatch
from repro_torch.models.gnn.layers import GraphBatch


def _arr(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x), dtype=dtype)).to(device)


def graph_from_arrays(g, device=None) -> Graph:
    device = resolve_device(device)
    return Graph(
        n=int(g.n), e=int(g.e), e_pad=int(g.e_pad),
        src=_arr(g.src, np.int32, device), dst=_arr(g.dst, np.int32, device),
        w=_arr(g.w, np.float32, device),
        in_deg=_arr(g.in_deg, np.int32, device),
        out_deg=_arr(g.out_deg, np.int32, device),
        in_weight=_arr(g.in_weight, np.float32, device),
        out_weight=_arr(g.out_weight, np.float32, device))


def csr_from_arrays(c, device=None) -> CsrGraph:
    device = resolve_device(device)
    return CsrGraph(
        n=int(c.n), e=int(c.e), e_pad=int(c.e_pad),
        max_out_deg=int(c.max_out_deg), max_in_deg=int(c.max_in_deg),
        indptr=_arr(c.indptr, np.int32, device),
        dst=_arr(c.dst, np.int32, device), w=_arr(c.w, np.float32, device),
        in_indptr=_arr(c.in_indptr, np.int32, device))


def ell_from_arrays(ell, device=None) -> EllGraph:
    """The reference's ELL arrays, plus the port's ``row_len`` worked out
    from ``in_src`` (the reference has none)."""
    device = resolve_device(device)
    in_src = np.asarray(ell.in_src, np.int32)
    return EllGraph(
        n=int(ell.n), n_pad=int(ell.n_pad), deg_pad=int(ell.deg_pad),
        in_src=_arr(in_src, np.int32, device),
        in_w=_arr(ell.in_w, np.float32, device),
        row_len=_arr(ell_row_len(in_src, int(ell.n)), np.int32, device))


def delta_from_arrays(d, device=None) -> GraphDelta:
    """The reference's ``GraphDelta`` (``k``, ``edge_idx``, ``new_w``,
    ``ell_row``, ``ell_col``, ``csr_pos`` or None) as the port's,
    padding rows included; its weights are validated here, on the host
    (every row positive and finite)."""
    csr_pos = getattr(d, "csr_pos", None)
    return _delta_from_host(
        int(d.k), resolve_device(device), edge_idx=np.asarray(d.edge_idx),
        new_w=np.asarray(d.new_w, np.float32),
        ell_row=np.asarray(d.ell_row), ell_col=np.asarray(d.ell_col),
        csr_pos=None if csr_pos is None else np.asarray(csr_pos))


def fleet_from_arrays(fleet, device=None) -> GraphFleet:
    """A reference ``GraphFleet`` (its stacked graph ``g`` with ``[F,
    ...]`` leaves and the true edge counts ``es``) as the port's."""
    device = resolve_device(device)
    g = fleet.g
    return GraphFleet(GraphStack(
        n=int(g.n), e_pad=int(g.e_pad), es=tuple(int(e) for e in fleet.es),
        src=_arr(g.src, np.int32, device), dst=_arr(g.dst, np.int32, device),
        w=_arr(g.w, np.float32, device),
        in_deg=_arr(g.in_deg, np.int32, device),
        out_deg=_arr(g.out_deg, np.int32, device),
        in_weight=_arr(g.in_weight, np.float32, device),
        out_weight=_arr(g.out_weight, np.float32, device)))


def stacked_delta_from_arrays(d, device=None) -> StackedDelta:
    """A reference stacked delta (``stack_deltas``: ``k`` int[F], the
    rest ``[F, k_pad]``) as the port's; weights validated on the host."""
    device = resolve_device(device)
    rows = [_delta_from_host(
        int(k), device, edge_idx=np.asarray(d.edge_idx)[f],
        new_w=np.asarray(d.new_w, np.float32)[f],
        ell_row=np.asarray(d.ell_row)[f], ell_col=np.asarray(d.ell_col)[f],
        csr_pos=None if getattr(d, "csr_pos", None) is None
        else np.asarray(d.csr_pos)[f])
        for f, k in enumerate(np.asarray(d.k).ravel())]

    def st(name):
        return torch.stack([getattr(r, name) for r in rows])
    return StackedDelta(
        ks=tuple(r.k for r in rows), edge_idx=st("edge_idx"),
        new_w=st("new_w"), ell_row=st("ell_row"), ell_col=st("ell_col"),
        csr_pos=None if rows[0].csr_pos is None else st("csr_pos"))


_FLEET_STATE = dict(w=np.float32, in_weight=np.float32,
                    out_weight=np.float32, sources=np.int32, D=np.float32,
                    C=np.float32, fixed=np.bool_, rounds=np.int32,
                    fb=np.int32, version=np.int32)


def fleet_state_from_arrays(state, device=None) -> dict:
    """A reference ``FleetSolver.state_dict()`` as tensors on ``device``
    for the port's ``load_state_dict``."""
    device = resolve_device(device)
    return {k: _arr(state[k], dt, device) for k, dt in _FLEET_STATE.items()}


def landmark_tables_from_arrays(d_from, d_to, device=None):
    """A landmark index's ``d_from``/``d_to`` [k, n] tables as float32
    tensors on ``device``, for ``landmarks.seed_lower_bounds``."""
    device = resolve_device(device)
    return (_arr(d_from, np.float32, device), _arr(d_to, np.float32, device))


def xdeepfm_params_from_arrays(params, device=None) -> dict:
    """The reference's xDeepFM parameter tree (``table``, ``linear``,
    ``cin[i]``, ``dnn[(w, b)]``, ``bias``, ``cin_out``; arrays read
    through ``np.asarray``) as the port's float32 tree on ``device``."""
    device = resolve_device(device)

    def f32(x):
        return _arr(x, np.float32, device)

    return {
        "table": f32(params["table"]), "linear": f32(params["linear"]),
        "cin": [f32(w) for w in params["cin"]],
        "dnn": [(f32(w), f32(b)) for w, b in params["dnn"]],
        "bias": f32(params["bias"]), "cin_out": f32(params["cin_out"]),
    }


_SUB_NAMES = ("a", "b", "c", "d")


def lm_params_from_arrays(params, cfg, device=None) -> dict:
    """The reference's LM parameter tree (``embed``, ``lm_head``,
    ``final_norm`` and ``layers``, stacked per super-block: ``layers[
    name][leaf]`` with a leading dim of ``n_layers // moe_every``,
    ``name`` "a", "b", ... for the layers of a super-block) as the port's
    tree, whose ``layers`` is a list of per-layer dicts.  ``cfg`` is the
    port's ``LMConfig``.  bfloat16 leaves go through float32 and back,
    which is exact; every other leaf is float32."""
    device = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        t = _arr(a, np.float32, device)
        return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t

    def tree(x, pick):
        if isinstance(x, dict):
            return {k: tree(v, pick) for k, v in x.items()}
        return leaf(pick(x))

    layers = []
    for i in range(cfg.n_layers):
        s, sub = divmod(i, cfg.moe_every)
        layers.append(tree(params["layers"][_SUB_NAMES[sub]],
                           lambda a, s=s: np.asarray(a)[s]))
    return {"embed": leaf(params["embed"]),
            "lm_head": leaf(params["lm_head"]),
            "final_norm": leaf(params["final_norm"]), "layers": layers}


def lm_params_to_arrays(params, cfg) -> dict:
    """The inverse of ``lm_params_from_arrays``: the port's LM tree (or a
    tree of its shape, such as its gradients) as the reference's, with
    ``layers[name][leaf]`` stacked per super-block, every leaf a float32
    numpy array (bfloat16 widens exactly; numpy has no bfloat16)."""
    def leaf(t):
        return t.detach().float().cpu().numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([leaf(t) for t in trees])

    layers = {}
    for sub in range(cfg.moe_every):
        layers[_SUB_NAMES[sub]] = stack(
            params["layers"][sub::cfg.moe_every])
    return {"embed": leaf(params["embed"]),
            "lm_head": leaf(params["lm_head"]),
            "final_norm": leaf(params["final_norm"]), "layers": layers}


def gnn_params_from_arrays(params, device=None):
    """A reference GNN parameter tree (nested dicts, lists and tuples of
    arrays; NequIP's ``self``/``skip`` keyed by int l) as the port's:
    the same structure and keys, every leaf a float32 tensor on
    ``device``, so ``tree_leaves`` of both trees line up."""
    device = resolve_device(device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(tree(v) for v in x)
        return _arr(x, np.float32, device)
    return tree(params)


def _index(x, device) -> torch.Tensor:
    return _arr(x, np.int64, device)


def graph_batch_from_arrays(b, device=None):
    """A reference ``GraphBatch`` as the port's (indices int64, the same
    values; ``y`` keeps its kind: int64 labels or float32 targets)."""
    device = resolve_device(device)
    y = np.asarray(b.y)
    return GraphBatch(
        n_nodes=int(b.n_nodes), n_graphs=int(b.n_graphs),
        x=_arr(b.x, np.float32, device), src=_index(b.src, device),
        dst=_index(b.dst, device),
        node_mask=_arr(b.node_mask, np.bool_, device),
        graph_id=_index(b.graph_id, device),
        pos=_arr(b.pos, np.float32, device),
        y=(_index(y, device) if y.dtype.kind in "iu"
           else _arr(y, np.float32, device)))


def triplet_batch_from_arrays(b, device=None):
    """A reference ``TripletBatch`` as the port's (indices int64, the
    same values, padded triplets' ``t_ji == n_edges`` included)."""
    device = resolve_device(device)
    return TripletBatch(
        n_nodes=int(b.n_nodes), n_edges=int(b.n_edges),
        n_graphs=int(b.n_graphs), species=_index(b.species, device),
        pos=_arr(b.pos, np.float32, device),
        node_mask=_arr(b.node_mask, np.bool_, device),
        graph_id=_index(b.graph_id, device), src=_index(b.src, device),
        dst=_index(b.dst, device),
        edge_mask=_arr(b.edge_mask, np.bool_, device),
        t_kj=_index(b.t_kj, device), t_ji=_index(b.t_ji, device),
        t_mask=_arr(b.t_mask, np.bool_, device),
        y=_arr(b.y, np.float32, device))
