"""Graph containers for the SSSP engine (port of ``repro/core/graph.py``).

Layout is the reference's, array for array:

  * ``Graph``: the edge list sorted by **destination** (CSC order), padded
    to ``e_pad`` with ``src = dst = n`` and ``w = +inf``; vertex-segment
    reductions use ``n + 1`` segments and drop the sentinel row.
  * ``CsrGraph``: the src-sorted out-edge view of the frontier backend,
    with the ``in_indptr`` run table into the primary dst-sorted arrays.
  * ``EllGraph``: the dense padded in-neighbour form ``[n_pad, deg_pad]``
    of the ELL/pallas backend (padding ``in_src = n``, ``in_w = +inf``).
  * ``HostGraph``: numpy adjacency lists for the sequential oracles.

Indices are stored as int32 for parity with the reference arrays; torch's
scatter/gather ops want int64, so each container caches an int64 copy of
the index arrays it reduces over (``src_l``/``dst_l``) at first use.

Everything here is host-side preprocessing except the two segment
primitives the dense rounds use (``seg_min_at_dst``, ``gather_src``),
which take ``[..., n]`` / ``[..., e_pad]`` tensors with any leading batch
shape.  ``apply_delta``/``reverse`` are ROADMAP A5/A6.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

INF = float("inf")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA where there is none raises — nothing here
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static, padded, dst-sorted edge-list graph (tensors on one device)."""

    n: int
    e: int
    e_pad: int
    src: torch.Tensor         # int32[e_pad], padding n
    dst: torch.Tensor         # int32[e_pad], padding n
    w: torch.Tensor           # float32[e_pad], padding +inf
    in_deg: torch.Tensor      # int32[n]
    out_deg: torch.Tensor     # int32[n]
    in_weight: torch.Tensor   # float32[n] min incoming weight (inf if none)
    out_weight: torch.Tensor  # float32[n] min outgoing weight (inf if none)

    @property
    def device(self) -> torch.device:
        return self.w.device

    @property
    def num_segments(self) -> int:
        return self.n + 1  # one sentinel row for padding edges

    @functools.cached_property
    def src_l(self) -> torch.Tensor:
        return self.src.long()

    @functools.cached_property
    def dst_l(self) -> torch.Tensor:
        return self.dst.long()

    def to(self, device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def seg_min_at_dst(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """min-reduce ``[..., e_pad]`` edge values at their destination
        -> ``[..., n]`` (+inf where no edge lands)."""
        lead = edge_vals.shape[:-1]
        out = torch.full(lead + (self.num_segments,), INF,
                         dtype=edge_vals.dtype, device=edge_vals.device)
        out.scatter_reduce_(-1, self.dst_l.expand_as(edge_vals), edge_vals,
                            "amin")
        return out[..., : self.n]

    def gather_src(self, vertex_vals: torch.Tensor, fill=INF) -> torch.Tensor:
        """Gather ``[..., n]`` vertex values at edge sources -> ``[...,
        e_pad]``; padding edges get ``fill``."""
        ext = torch.cat([vertex_vals, vertex_vals.new_full(
            vertex_vals.shape[:-1] + (1,), fill)], dim=-1)
        return ext.index_select(-1, self.src_l)

    def to_host(self) -> "HostGraph":
        """Host adjacency view of the real (non-padding) edges."""
        e = self.e
        return HostGraph(self.n, self.src[:e].cpu().numpy(),
                         self.dst[:e].cpu().numpy(),
                         self.w[:e].cpu().numpy())

    def csr(self) -> "CsrGraph":
        """Src-sorted (CSR) out-edge view for the frontier backend."""
        return build_csr(self)


def build_graph(n: int, src, dst, w, *, edge_pad_multiple: int = 128,
                device=None) -> Graph:
    """Build a Graph from numpy COO arrays (sorted and padded on the host)."""
    device = resolve_device(device)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w, np.float32)
    e = int(src.shape[0])
    if e:
        if src.min() < 0 or src.max() >= n:
            raise ValueError("src out of range")
        if dst.min() < 0 or dst.max() >= n:
            raise ValueError("dst out of range")
        if not (w > 0).all():
            raise ValueError("paper assumes strictly positive weights")
        if not (src != dst).all():
            raise ValueError("paper assumes loop-free graphs")
    # dst-sorted (CSC order); stable so parallel edges keep input order.
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]

    e_pad = max(edge_pad_multiple, round_up(max(e, 1), edge_pad_multiple))
    in_deg = np.bincount(dst, minlength=n).astype(np.int32)
    out_deg = np.bincount(src, minlength=n).astype(np.int32)
    in_weight = np.full(n, np.inf, np.float32)
    np.minimum.at(in_weight, dst, w)
    out_weight = np.full(n, np.inf, np.float32)
    np.minimum.at(out_weight, src, w)
    return Graph(
        n=n, e=e, e_pad=e_pad,
        src=_t(_pad_to(src, e_pad, n), device),
        dst=_t(_pad_to(dst, e_pad, n), device),
        w=_t(_pad_to(w, e_pad, np.inf), device),
        in_deg=_t(in_deg, device), out_deg=_t(out_deg, device),
        in_weight=_t(in_weight, device), out_weight=_t(out_weight, device))


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Src-sorted out-edge (CSR) view for the sparse-frontier backend.

    ``indptr[u] : indptr[u+1]`` is vertex u's run of out-edges in the
    src-sorted ``dst``/``w`` (padding ``dst = n``, ``w = +inf``).
    ``in_indptr`` is the CSC run table into the primary ``Graph``'s
    dst-sorted ``src``/``w``.  ``max_out_deg``/``max_in_deg`` bound the
    per-vertex gather widths.
    """

    n: int
    e: int
    e_pad: int
    max_out_deg: int
    max_in_deg: int
    indptr: torch.Tensor     # int32[n + 1]
    dst: torch.Tensor        # int32[e_pad]
    w: torch.Tensor          # float32[e_pad]
    in_indptr: torch.Tensor  # int32[n + 1]

    @property
    def device(self) -> torch.device:
        return self.w.device


def build_csr(g: Graph) -> CsrGraph:
    """Host-side CSR (out-edge) view of a Graph, on the Graph's device."""
    e = g.e
    src = g.src[:e].cpu().numpy()
    dst = g.dst[:e].cpu().numpy()
    w = g.w[:e].cpu().numpy()
    order = np.argsort(src, kind="stable")  # dst-sorted -> CSR
    out_deg = np.bincount(src, minlength=g.n).astype(np.int64)
    indptr = np.zeros(g.n + 1, np.int32)
    np.cumsum(out_deg, out=indptr[1:])
    in_deg = np.bincount(dst, minlength=g.n).astype(np.int64)
    in_indptr = np.zeros(g.n + 1, np.int32)
    np.cumsum(in_deg, out=in_indptr[1:])
    dev = g.device
    return CsrGraph(
        n=g.n, e=e, e_pad=g.e_pad,
        max_out_deg=max(int(out_deg.max()) if e else 0, 1),
        max_in_deg=max(int(in_deg.max()) if e else 0, 1),
        indptr=_t(indptr, dev),
        dst=_t(_pad_to(dst[order].astype(np.int32), g.e_pad, g.n), dev),
        w=_t(_pad_to(w[order].astype(np.float32), g.e_pad, np.inf), dev),
        in_indptr=_t(in_indptr, dev))


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """Dense padded in-neighbour (ELL) form for the relax kernel.

    ``in_src[i, j]`` is the j-th in-neighbour of vertex i (``n`` padding)
    and ``in_w[i, j]`` its weight (+inf padding).  Rows are padded to
    ``deg_pad`` (a multiple of ``lane``) and vertices to ``n_pad`` (a
    multiple of ``sublane``): the reference's TPU tiling, kept so the two
    packages build the same arrays.
    """

    n: int
    n_pad: int
    deg_pad: int
    in_src: torch.Tensor  # int32[n_pad, deg_pad]
    in_w: torch.Tensor    # float32[n_pad, deg_pad]

    @property
    def device(self) -> torch.device:
        return self.in_w.device


def build_ell(n: int, src, dst, w, *, lane: int = 128, sublane: int = 8,
              max_deg_cap: int | None = None, device=None) -> EllGraph:
    """Vectorised ELL build: edges fill each row's slots in stable
    dst-sorted order, exactly the slots the reference's per-edge loop
    assigns."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    in_deg = np.bincount(dst, minlength=n)
    max_deg = int(in_deg.max()) if len(dst) else 0
    if max_deg_cap is not None and max_deg > max_deg_cap:
        raise ValueError(
            f"max in-degree {max_deg} exceeds ELL cap {max_deg_cap}; "
            "use the edge-list (segment-op) path for power-law graphs")
    deg_pad = max(lane, round_up(max(max_deg, 1), lane))
    n_pad = max(sublane, round_up(n, sublane))
    in_src = np.full((n_pad, deg_pad), n, np.int32)
    in_w = np.full((n_pad, deg_pad), np.inf, np.float32)
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    row_start = np.zeros(n + 1, np.int64)
    np.cumsum(in_deg, out=row_start[1:])
    slot = np.arange(len(d), dtype=np.int64) - row_start[d]
    in_src[d, slot] = src[order]
    in_w[d, slot] = w[order]
    return EllGraph(n=n, n_pad=n_pad, deg_pad=deg_pad,
                    in_src=_t(in_src, device), in_w=_t(in_w, device))


class HostGraph:
    """Plain-python adjacency view (out- and in-lists) for reference algos."""

    def __init__(self, n: int, src, dst, w):
        self.n = int(n)
        self.src = np.asarray(src, np.int64)
        self.dst = np.asarray(dst, np.int64)
        self.w = np.asarray(w, np.float64)
        self.e = len(self.src)
        if not (self.w > 0).all():
            raise ValueError("strictly positive weights required")
        self.out: list[list[tuple[int, float]]] = [[] for _ in range(self.n)]
        self.inn: list[list[tuple[int, float]]] = [[] for _ in range(self.n)]
        for s, d, ww in zip(self.src, self.dst, self.w):
            self.out[s].append((int(d), float(ww)))
            self.inn[d].append((int(s), float(ww)))

    def to_device(self, device=None, **kw) -> Graph:
        return build_graph(self.n, self.src, self.dst, self.w, device=device,
                           **kw)

    def to_ell(self, device=None, **kw) -> EllGraph:
        return build_ell(self.n, self.src, self.dst, self.w, device=device,
                         **kw)

    def reverse(self) -> "HostGraph":
        """The transpose graph (edges flipped, weights kept)."""
        return HostGraph(self.n, self.dst, self.src, self.w)
