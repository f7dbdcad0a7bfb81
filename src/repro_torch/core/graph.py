"""Graph containers for the SSSP engine (port of ``repro/core/graph.py``).

Layout is the reference's, array for array:

  * ``Graph``: the edge list sorted by **destination** (CSC order), padded
    to ``e_pad`` with ``src = dst = n`` and ``w = +inf``; vertex-segment
    reductions use ``n + 1`` segments and drop the sentinel row.
  * ``CsrGraph``: the src-sorted out-edge view of the frontier backend,
    with the ``in_indptr`` run table into the primary dst-sorted arrays.
  * ``EllGraph``: the dense padded in-neighbour form ``[n_pad, deg_pad]``
    of the ELL/pallas backend (padding ``in_src = n``, ``in_w = +inf``),
    plus the port's ``row_len``: each row's live extent, so the relax
    kernel reads no padding past a row's last live cell.
  * ``HostGraph``: numpy adjacency lists for the sequential oracles.

Indices are stored as int32 for parity with the reference arrays; torch's
scatter/gather ops want int64, so each container caches an int64 copy of
the index arrays it reduces over (``src_l``/``dst_l``) at first use.

Everything here is host-side preprocessing except the segment
primitives of the rounds (``seg_min_at_dst``, ``gather_src``,
``gather_dst``), which take ``[..., n]`` / ``[..., e_pad]`` tensors with
any leading batch shape, and ``apply_delta``: a weight delta
(``core/sssp/dynamic.GraphDelta``) scattered into every layout on the
device, topology unchanged.  ``Graph.reverse()`` builds the transpose on
the host.

``GraphStack`` (port only) holds M member graphs that share ``(n,
e_pad)`` as ``[M, e_pad]`` edge and ``[M, n]`` vertex tensors and runs
them as ``L = M * per`` lanes, lane l on member ``l // per``: the
reference's stacked pytrees (``bidirectional._stack2``, the fleet's
``_stack_trees``) without vmap.  Its gathers and scatters take each
member's index row as an ``expand`` view across that member's lanes.
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

    def gather_dst(self, vertex_vals: torch.Tensor, fill=INF) -> torch.Tensor:
        """Gather ``[..., n]`` vertex values at edge destinations."""
        ext = torch.cat([vertex_vals, vertex_vals.new_full(
            vertex_vals.shape[:-1] + (1,), fill)], dim=-1)
        return ext.index_select(-1, self.dst_l)

    def apply_delta(self, delta) -> "Graph":
        """New Graph with a ``GraphDelta``'s weights scattered in at
        ``delta.edge_idx`` (padding rows, ``edge_idx >= e_pad``, land in
        a spare slot and drop) and ``in_weight``/``out_weight``
        recomputed as segment minima.  Topology tensors are shared with
        ``self``, so topology caches keyed by them stay valid."""
        w = _scatter_rows(self.w, delta.edge_idx, delta.new_w)
        return dataclasses.replace(
            self, w=w, in_weight=self._seg_min(w, self.dst_l),
            out_weight=self._seg_min(w, self.src_l))

    def _seg_min(self, w: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        out = torch.full((self.num_segments,), INF, dtype=w.dtype,
                         device=w.device)
        return out.scatter_reduce_(0, seg, w, "amin")[: self.n]

    def reverse(self, **kw) -> "Graph":
        """The transpose graph (every edge (u, v, w) becomes (v, u, w)),
        built on the host and placed on this graph's device.  Forward
        edge i lands at ``argsort(src, stable)^-1[i]`` of the reverse
        edge list."""
        e = self.e
        return build_graph(self.n, self.dst[:e].cpu().numpy(),
                           self.src[:e].cpu().numpy(),
                           self.w[:e].cpu().numpy(), device=self.device,
                           **kw)

    def to_host(self) -> "HostGraph":
        """Host adjacency view of the real (non-padding) edges."""
        e = self.e
        return HostGraph(self.n, self.src[:e].cpu().numpy(),
                         self.dst[:e].cpu().numpy(),
                         self.w[:e].cpu().numpy())

    def csr(self) -> "CsrGraph":
        """Src-sorted (CSR) out-edge view for the frontier backend."""
        return build_csr(self)


@dataclasses.dataclass(frozen=True)
class GraphStack:
    """M member graphs sharing ``(n, e_pad)``, run as ``L = M * per`` lanes.

    Lane l runs member ``l // per``: the bidirectional pair is the stack
    ``[graph, reverse]`` at ``per = 1``, a fleet's ``solve`` its members
    at ``per = 1`` and its ``solve_batch`` at ``per = B``.  ``es`` keeps
    each member's true edge count; the rows past it are the inert
    padding every ``Graph`` carries (``src = dst = n``, ``w = +inf``), so
    members with different ``e`` stack unchanged.  ``src_ix``/``dst_ix``
    are the int64 index rows ``[M, 1, e_pad]`` that every lane of a
    member reads through an ``expand`` view (never an ``[L, e_pad]``
    copy).  Lane tensors are ``[L, n]`` / ``[L, e_pad]``.
    """

    n: int
    e_pad: int
    es: tuple[int, ...]
    src: torch.Tensor         # int32[M, e_pad]
    dst: torch.Tensor         # int32[M, e_pad]
    w: torch.Tensor           # float32[M, e_pad]
    in_deg: torch.Tensor      # int32[M, n]
    out_deg: torch.Tensor     # int32[M, n]
    in_weight: torch.Tensor   # float32[M, n]
    out_weight: torch.Tensor  # float32[M, n]
    per: int = 1
    src_ix: torch.Tensor | None = None   # int64[M, 1, e_pad]
    dst_ix: torch.Tensor | None = None   # int64[M, 1, e_pad]

    def __post_init__(self):
        if self.src_ix is None:
            object.__setattr__(self, "src_ix", self.src.long()[:, None])
        if self.dst_ix is None:
            object.__setattr__(self, "dst_ix", self.dst.long()[:, None])

    @property
    def size(self) -> int:
        return len(self.es)

    @property
    def lanes(self) -> int:
        return self.size * self.per

    @property
    def device(self) -> torch.device:
        return self.w.device

    def with_lanes(self, per: int) -> "GraphStack":
        """The same members run as ``per`` lanes each (tensors shared)."""
        return dataclasses.replace(self, per=int(per))

    def _lane_ix(self, ix: torch.Tensor) -> torch.Tensor:
        return ix.expand(self.size, self.per, self.e_pad)

    def gather_src(self, vertex_vals: torch.Tensor, fill=INF) -> torch.Tensor:
        """``[L, n]`` lane values at each lane's member's edge sources ->
        ``[M, per, e_pad]``; padding edges get ``fill``."""
        ext = torch.cat([vertex_vals, vertex_vals.new_full(
            (vertex_vals.shape[0], 1), fill)], dim=1)
        return ext.view(self.size, self.per, self.n + 1).gather(
            2, self._lane_ix(self.src_ix))

    def seg_min_at_dst(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """min-reduce ``[M, per, e_pad]`` edge values at their member's
        destinations -> ``[L, n]`` (+inf where no edge lands)."""
        out = torch.full((self.size, self.per, self.n + 1), INF,
                         dtype=edge_vals.dtype, device=edge_vals.device)
        out.scatter_reduce_(2, self._lane_ix(self.dst_ix), edge_vals, "amin")
        return out[..., : self.n].reshape(self.lanes, self.n)

    def member(self, i: int) -> Graph:
        """Member ``i`` as a ``Graph`` with its true ``e`` (tensors are
        views of the stack's rows, its int64 index copies too)."""
        i = int(i)
        if not 0 <= i < self.size:
            raise IndexError(f"member {i} out of range [0, {self.size})")
        g = Graph(n=self.n, e=self.es[i], e_pad=self.e_pad, src=self.src[i],
                  dst=self.dst[i], w=self.w[i], in_deg=self.in_deg[i],
                  out_deg=self.out_deg[i], in_weight=self.in_weight[i],
                  out_weight=self.out_weight[i])
        object.__setattr__(g, "src_l", self.src_ix[i, 0])
        object.__setattr__(g, "dst_l", self.dst_ix[i, 0])
        return g

    def members(self) -> list[Graph]:
        return [self.member(i) for i in range(self.size)]

    def apply_deltas(self, delta) -> "GraphStack":
        """New stack with row m of a stacked delta (``edge_idx``/``new_w``
        ``[M, k_pad]``) scattered into member m's weights; rows outside
        ``[0, e_pad)`` drop.  ``in_weight``/``out_weight`` are recomputed
        as segment minima, topology tensors shared."""
        M, E = self.size, self.e_pad
        idx = delta.edge_idx.long()
        base = torch.arange(M, device=idx.device)[:, None] * E
        flat = torch.where((idx >= 0) & (idx < E), base + idx, M * E)
        w = _scatter_rows(self.w.reshape(-1), flat.reshape(-1),
                          delta.new_w.reshape(-1)).view(M, E)
        return dataclasses.replace(
            self, w=w, in_weight=self._seg_min(w, self.dst_ix[:, 0]),
            out_weight=self._seg_min(w, self.src_ix[:, 0]))

    def _seg_min(self, w: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        out = torch.full((self.size, self.n + 1), INF, dtype=w.dtype,
                         device=w.device)
        return out.scatter_reduce_(1, seg, w, "amin")[:, : self.n]


def stack_graphs(graphs, per: int = 1) -> GraphStack:
    """Stack ``Graph`` members that share ``(n, e_pad)`` and a device."""
    graphs = list(graphs)
    if not graphs:
        raise ValueError("empty fleet")
    for i, g in enumerate(graphs):
        if not isinstance(g, Graph):
            raise TypeError(f"fleet member {i} must be a Graph, got "
                            f"{type(g)!r} (see build_fleet)")
    shapes = {(g.n, g.e_pad) for g in graphs}
    if len(shapes) > 1:
        raise ValueError(
            f"fleet members must share (n, e_pad); got {sorted(shapes)} "
            "— build them with a common edge_pad_multiple (build_fleet "
            "does this)")

    def st(name):
        return torch.stack([getattr(g, name) for g in graphs])
    return GraphStack(
        n=graphs[0].n, e_pad=graphs[0].e_pad,
        es=tuple(int(g.e) for g in graphs), src=st("src"), dst=st("dst"),
        w=st("w"), in_deg=st("in_deg"), out_deg=st("out_deg"),
        in_weight=st("in_weight"), out_weight=st("out_weight"), per=per)


def _scatter_rows(vals: torch.Tensor, idx: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """A copy of the flat ``vals`` with ``new`` written at ``idx``; rows
    whose index is outside ``[0, len(vals))`` (padding) go to a spare
    slot past the end and are dropped.  Indices are never clipped: a
    clipped padding row would overwrite a real entry."""
    size = vals.shape[0]
    idx = idx.long()
    at = torch.where((idx >= 0) & (idx < size), idx, size)
    ext = torch.cat([vals, vals.new_full((1,), INF)])
    ext.index_put_((at,), new.to(vals.dtype))
    return ext[:size]


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

    def apply_delta(self, delta) -> "CsrGraph":
        """The same weight updates ``Graph.apply_delta`` applies, landed at
        the src-sorted positions ``delta.csr_pos`` (padding rows drop)."""
        if getattr(delta, "csr_pos", None) is None:
            raise ValueError(
                "delta carries no csr_pos permutation; build it with "
                "make_delta/make_delta_from_endpoints against the current "
                "graph to update a CsrGraph")
        return dataclasses.replace(
            self, w=_scatter_rows(self.w, delta.csr_pos, delta.new_w))


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
    packages build the same arrays.  ``row_len[i]`` (port only) is one
    past the last cell of row i with ``in_src < n``, 0 for a row with no
    live cell: every cell at or beyond it is padding.
    """

    n: int
    n_pad: int
    deg_pad: int
    in_src: torch.Tensor   # int32[n_pad, deg_pad]
    in_w: torch.Tensor     # float32[n_pad, deg_pad]
    row_len: torch.Tensor  # int32[n_pad]

    @property
    def device(self) -> torch.device:
        return self.in_w.device

    def apply_delta(self, delta) -> "EllGraph":
        """The same weight updates at the cells ``(delta.ell_row,
        delta.ell_col)`` (padding rows, ``2^30``, drop).  ``row_len``
        is kept: a delta changes weights, never which cells are live."""
        row, col = delta.ell_row.long(), delta.ell_col.long()
        ok = (row >= 0) & (row < self.n_pad) & (col >= 0) & (col
                                                             < self.deg_pad)
        flat = torch.where(ok, row * self.deg_pad + col, -1)
        in_w = _scatter_rows(self.in_w.reshape(-1), flat, delta.new_w)
        return dataclasses.replace(
            self, in_w=in_w.view(self.n_pad, self.deg_pad))


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
    row_len = _pad_to(in_deg.astype(np.int32), n_pad, 0)  # left-packed
    return EllGraph(n=n, n_pad=n_pad, deg_pad=deg_pad,
                    in_src=_t(in_src, device), in_w=_t(in_w, device),
                    row_len=_t(row_len, device))


def ell_row_len(in_src: np.ndarray, n: int) -> np.ndarray:
    """int32[n_pad]: one past the last cell of each row with ``in_src <
    n`` (0 for a row with none), for an ELL table in any cell order."""
    live = np.asarray(in_src) < n
    last = live.shape[1] - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0).astype(np.int32)


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
