"""Carry the reference's graph containers and weights across to the port.

Each graph function reads the fields of a reference ``Graph``/
``CsrGraph``/``EllGraph`` (duck-typed: anything with those attributes,
read through ``np.asarray``) and builds the port's container from the
same arrays; ``delta_from_arrays`` does the same for a ``GraphDelta``,
``landmark_tables_from_arrays`` for a ``LandmarkIndex``'s two distance
tables and ``xdeepfm_params_from_arrays`` for a parameter tree.  So both
packages can be run on identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (CsrGraph, EllGraph, Graph,
                                    ell_row_len, resolve_device)
from repro_torch.core.sssp.dynamic import GraphDelta, _delta_from_host


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
