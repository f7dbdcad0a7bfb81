"""Carry the reference's graph containers across to the port.

Each function reads the fields of a reference ``Graph``/``CsrGraph``/
``EllGraph`` (duck-typed: anything with those attributes, read through
``np.asarray``) and builds the port's container from the same arrays, so
both packages can be run on identical inputs.  This is the counterpart
of carrying weights across.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (CsrGraph, EllGraph, Graph,
                                    resolve_device)


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
    device = resolve_device(device)
    return EllGraph(
        n=int(ell.n), n_pad=int(ell.n_pad), deg_pad=int(ell.deg_pad),
        in_src=_arr(ell.in_src, np.int32, device),
        in_w=_arr(ell.in_w, np.float32, device))
