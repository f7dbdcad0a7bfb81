"""Bidirectional point-to-point queries (port of
``repro/core/sssp/bidirectional.py``).

A forward search from ``s`` on the graph and a backward search from ``t``
on its transpose run as the two lanes of one ``GraphStack`` through the
engine's ``_round`` (the reference vmaps the round over a stacked
``[2, ...]`` pytree).  Termination, read once a round:

    stop when  bound_f + bound_b  >=  mu,
    where  bound_lane = min D over (active | fixed-but-unexplored)
    and    mu         = min_v (D_f[v] + D_b[v]),

or when no lane has a frontier, or at the round cap.  At the stop ``mu``
is d(s, t) and the meeting vertex ``argmin(D_f + D_b)`` (the first
minimum) is exact in both lanes, so ``BidiResult.path`` stitches a path
across it from parent pointers.  ``distance`` is that path's weights
folded left to right in f32: a forward solve's ``dist[t]`` bits when the
path is a shortest one.  As in the reference, a parent may be within
``atol = 1e-5 * (1 + D)`` of tight (the smallest-index such one), so on
a near-tie the path can be near-shortest and its fold a few ulps above
``dist[t]`` (seen on the grid at n = 2^20).

Seeds: both lanes take landmark lower bounds from one ``LandmarkIndex``
(``seed_pair``: the forward lane from the tables, the backward lane from
the tables swapped).

Backends: "segment" runs the dense stacked segment round; "frontier" the
legacy frontier branch, each lane relaxing its own buffer over its own
CSR view through B1 (two launches a round), the other reductions dense.
"auto" takes frontier when both graphs pass ``_frontier_fits``.  The
buffer defaults to ``next_pow2(n)``, which cannot overflow.

``update(delta, warm=[(s, t, D, fixed), ...])`` applies a forward-graph
delta to both lanes (the reverse one through the forward->reverse edge
permutation) and re-solves cached pairs warm: the taint cone against the
old graphs, then both lanes to their full fixpoints with the stacked
segment round on the new ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.graph import (INF, Graph, HostGraph, resolve_device,
                                    stack_graphs)
from repro_torch.core.sssp import backends
from repro_torch.core.sssp.dynamic import make_delta
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter,
                                          _fixed_by_dict, _init_state,
                                          _round, _solve_warm,
                                          stack_taint_seeds)
from repro_torch.core.sssp.fleet import stack_deltas
from repro_torch.core.sssp.parents import extract_path, parent_pointers
from repro_torch.core.sssp.solver import _frontier_fits, _next_pow2

BIDI_BACKENDS = ("auto", "segment", "frontier")


@dataclasses.dataclass
class BidiResult:
    """One bidirectional answer and both lanes' state (lane 0 forward,
    lane 1 backward: distances on the reverse graph, i.e. TO the target).

    ``distance`` is the f32 fold of ``path()`` (+inf: unreachable; see
    the module docstring for near-ties); ``mu`` keeps the raw two-lane
    minimum.  ``meeting`` is
    ``argmin(D_f + D_b)``, exact in both lanes (None when unreachable).
    ``host_syncs`` counts the device->host reads of the solve.
    """

    source: int
    target: int
    distance: float
    meeting: int | None
    rounds: int
    D: torch.Tensor            # float32[2, n]
    C: torch.Tensor            # float32[2, n]
    fixed: torch.Tensor        # bool[2, n]
    fixed_by: dict[str, int]
    graph: Graph
    rgraph: Graph
    mu: float = INF
    edges_relaxed: int | None = None
    host_syncs: int | None = None
    _path: list[int] | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def forward_result(self) -> SSSPResult:
        """The forward lane as a partial ``SSSPResult``: its ``fixed``
        mask says which entries are exact."""
        return SSSPResult(
            dist=self.D[0], C=self.C[0], fixed=self.fixed[0],
            rounds=self.rounds, fixed_by=self.fixed_by,
            source=self.source, graph=self.graph, target=self.target,
            partial=True)

    def path(self) -> list[int] | None:
        """The s->t vertex list: parent pointers on ``D_f`` walked back
        from the meeting vertex to s, then on ``D_b`` over the reverse
        graph from it to t."""
        if self._path is not None:
            return self._path
        if not np.isfinite(self.distance):
            return None
        parents = torch.stack([parent_pointers(self.graph, self.D[0]),
                               parent_pointers(self.rgraph, self.D[1])])
        self._path = _stitch(parents.cpu().numpy(), int(self.meeting),
                             self.source, self.target)
        return self._path


def _stitch(parents: np.ndarray, m: int, s: int, t: int):
    fwd = extract_path(parents[0], m, s)
    bwd = extract_path(parents[1], m, t)
    if fwd is None or bwd is None:
        return None
    return fwd + bwd[::-1][1:]


class _EdgeMins:
    """Min weight of every (u, v) pair over parallel edges, for the f32
    refold: keys ``u * n + v`` sorted once (lexsort on the pair; the
    topology never changes), a min per run of the current weights
    (``reweigh``), ``searchsorted`` to look a path's edges up.  The fold
    adds the path's weights left to right, one f32 add each: the
    engine's own sums from the source (the raw ``D_f[m] + D_b[m]``
    associates differently)."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray):
        self.n = n
        self.order = np.lexsort((dst, src))
        key = src.astype(np.int64)[self.order] * n + dst[self.order]
        self.starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        self.keys = key[self.starts]
        self.wmin = None

    def reweigh(self, w: np.ndarray) -> None:
        """The per-pair minima of the weights ``w`` (dst-sorted order)."""
        ws = w[self.order]
        self.wmin = (np.minimum.reduceat(ws, self.starts) if len(ws)
                     else ws)

    def fold(self, path) -> np.float32:
        """The path's weights added left to right, one f32 add each."""
        p = np.asarray(path, np.int64)
        want = p[:-1] * self.n + p[1:]
        pos = np.searchsorted(self.keys, want)
        if len(want) and (pos.max() >= len(self.keys)
                          or not np.array_equal(self.keys[pos], want)):
            raise ValueError("path uses a pair that is not an edge")
        d = np.float32(0.0)
        for ww in self.wmin[pos]:
            d = np.float32(d + ww)
        return d


@contract(
    "bidi.pair_lanes",
    routes=("bidi.*",),
    require=("aten.scatter_reduce.amin",),
    dense_budget=8,
    same_round_ops=True,
    notes="Forward and reverse searches run as TWO LANES of one stacked "
          "segment round (one set of launches a round pair, not two); "
          "the lanes share the round body, so the segment scatter-min "
          "relax and the segment dense budget hold for the pair.")
class BidirectionalSolver:
    """Bidirectional point-to-point solver over one graph.

    graph:   ``Graph`` (moved to ``device``) or ``HostGraph``.
    cfg:     engine configuration (shared by both lanes).
    backend: "auto" | "segment" | "frontier" (see the module docstring).
    rgraph:  pre-built transpose (``graph.reverse()`` when omitted); must
             share n / e / e_pad with ``graph``.
    landmarks: optional ``LandmarkIndex``; ``solve`` then seeds both
             lanes from ``seed_pair``.
    frontier_cap: the frontier buffer (default ``next_pow2(n)``); below n
             a lane whose frontier outgrows it relaxes densely that round.
    device:  where the solves run; CUDA unless given.

    ``host_reads`` (a ``SyncCounter``) counts the solver's own reads
    outside a solve: the refold's weights at every restack and a derived
    reverse delta's rows.
    """

    def __init__(self, graph, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "auto", *, rgraph: Graph | None = None,
                 landmarks=None, frontier_cap: int | None = None,
                 device=None):
        if backend not in BIDI_BACKENDS:
            raise ValueError(f"unknown bidirectional backend {backend!r}; "
                             f"expected one of {BIDI_BACKENDS}")
        device = resolve_device(device)
        if isinstance(graph, HostGraph):
            graph = graph.to_device(device)
        if not isinstance(graph, Graph):
            raise TypeError(f"graph must be Graph/HostGraph, "
                            f"got {type(graph)!r}")
        graph = graph.to(device)
        rgraph = graph.reverse() if rgraph is None else rgraph.to(device)
        if (rgraph.n, rgraph.e, rgraph.e_pad) != (graph.n, graph.e,
                                                  graph.e_pad):
            raise ValueError(
                f"reverse graph shape {(rgraph.n, rgraph.e, rgraph.e_pad)} "
                f"must match forward {(graph.n, graph.e, graph.e_pad)} "
                "(build it via graph.reverse())")
        if backend == "auto":
            backend = ("frontier" if _frontier_fits(graph)
                       and _frontier_fits(rgraph) else "segment")
        if backend != "frontier" and cfg.use_pallas:
            cfg = dataclasses.replace(cfg, use_pallas=False)
        self.graph, self.rgraph = graph, rgraph
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.landmarks = landmarks
        self.solves = 0
        self.warm_solves = 0

        e = graph.e
        src = graph.src[:e].cpu().numpy()
        self._wmap = _EdgeMins(graph.n, src, graph.dst[:e].cpu().numpy())
        # forward edge i (dst-sorted) sits at row rev_perm[i] of the
        # reverse graph's dst-sorted list (reverse() sorts stably)
        order = np.argsort(src, kind="stable")
        self._rev_perm = np.empty(e, np.int64)
        self._rev_perm[order] = np.arange(e)

        # the solver's own device reads outside a solve (the refold's
        # weights at every restack, a derived reverse delta's rows)
        self.host_reads = SyncCounter()
        self.frontier_cap = 0
        self._csrs = None
        if backend == "frontier":
            self.frontier_cap = _next_pow2(
                graph.n if frontier_cap is None else max(1, int(frontier_cap)))
            self._csrs = [graph.csr(), rgraph.csr()]
        self._restack()

    # ------------------------------------------------------------------
    def _restack(self) -> None:
        """The lanes' stack and prims, and the refold's edge map, for the
        current graphs (read here, so a solve reads only its own state)."""
        self._wmap.reweigh(self.host_reads.read_numpy(
            self.graph.w[: self.graph.e]))
        self._stack = stack_graphs([self.graph, self.rgraph])
        self._prims = (
            backends.lane_frontier_prims(self._stack, self._csrs,
                                         self.frontier_cap)
            if self._csrs is not None
            else backends.stacked_segment_prims(self._stack))

    def _to_device(self, host) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(host, np.int64))
        if self.device.type == "cuda":    # an async copy: no host sync
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _finish(self, state, source: int, target: int, sync: SyncCounter,
                edges: bool) -> BidiResult:
        """The result of a finished two-lane state: one read of the
        stats (mu's f32 bits among them), then, when t is reachable, one
        read of both lanes' parent pointers for the path and its refold."""
        score = state.D[0] + state.D[1]
        mu = score.min()
        meta = [torch.argmin(score).reshape(1).long(),
                state.round[:1].long(), state.fixed_by.sum(dim=0).long(),
                mu.reshape(1).view(torch.int32).long()]
        if edges:
            meta.append(state.edges.sum().reshape(1))
        meta = sync.read(torch.cat(meta))
        dist = float(np.array(meta[7], np.int32).view(np.float32))
        res = BidiResult(
            source=int(source), target=int(target), distance=dist,
            meeting=int(meta[0]) if np.isfinite(dist) else None,
            rounds=int(meta[1]), D=state.D, C=state.C, fixed=state.fixed,
            fixed_by=_fixed_by_dict(meta[2:7]), graph=self.graph,
            rgraph=self.rgraph, mu=dist,
            edges_relaxed=int(meta[8]) if edges else None)
        if np.isfinite(dist):
            parents = torch.stack([parent_pointers(self.graph, state.D[0]),
                                   parent_pointers(self.rgraph, state.D[1])])
            res._path = _stitch(sync.read_numpy(parents),
                                res.meeting, res.source, res.target)
            if res._path is not None:
                res.distance = float(self._wmap.fold(res._path))
        res.host_syncs = sync.count
        return res

    # ------------------------------------------------------------------
    def solve(self, source: int, target: int, C0=None) -> BidiResult:
        """d(source, target) and a stitched path, two lanes.

        ``C0`` float32[2, n] seeds both lanes' lower bounds (default: the
        landmark index's ``seed_pair`` when it can vouch, else none).
        Host reads: one a round plus the final reads (``host_syncs``).
        """
        n = self.graph.n
        for name, v in (("source", source), ("target", target)):
            if not 0 <= int(v) < n:
                raise ValueError(f"{name} {v} out of range [0, {n})")
        if C0 is None and self.landmarks is not None:
            C0 = self.landmarks.seed_pair(int(source), int(target))
        if C0 is not None:
            C0 = torch.as_tensor(C0, dtype=torch.float32, device=self.device)
            if C0.shape != (2, n):
                raise ValueError(f"C0 shape {tuple(C0.shape)} != (2, {n})")
        sync = SyncCounter()
        ends = self._to_device([int(source), int(target)])
        state = _init_state(self._stack, ends, C0, self._prims)
        max_rounds = self.cfg.max_rounds or n + 2
        while sync.read(_bidi_go(state, max_rounds)):
            state = _round(self._stack, self.cfg, state, self._prims)
        self.solves += 1
        return self._finish(state, source, target, sync,
                            edges=state.edges is not None)

    # ------------------------------------------------------------------
    def apply_delta(self, delta, rdelta=None) -> None:
        """Mutate both lanes with a forward-graph delta (``rdelta``, the
        same updates on the transpose, derived when omitted)."""
        self.update(delta, rdelta)

    def reverse_delta(self, delta):
        """A forward-graph delta's updates as a delta on the transpose."""
        k = delta.k
        idx = self.host_reads.read_numpy(delta.edge_idx[:k]).astype(np.int64)
        return make_delta(self.rgraph, self._rev_perm[idx],
                          self.host_reads.read_numpy(delta.new_w[:k]))

    def update(self, delta, rdelta=None, *,
               warm=None) -> dict[tuple[int, int], BidiResult]:
        """Apply a delta and warm re-solve cached pairs.

        ``warm`` lists ``(source, target, D, fixed)``, each pair's
        ``[2, n]`` lanes as a pre-delta ``BidiResult`` carried them.  The
        taint cone is judged on the old graphs, then both lanes run to
        their full fixpoints on the new ones (the standard termination,
        not the bidirectional cut), so the forward lane is a complete
        distance vector.  Returns ``{(s, t): BidiResult}``.
        """
        if rdelta is None:
            rdelta = self.reverse_delta(delta)
        old = self._stack
        self.graph = self.graph.apply_delta(delta)
        self.rgraph = self.rgraph.apply_delta(rdelta)
        if self._csrs is not None:
            self._csrs = [self._csrs[0].apply_delta(delta),
                          self._csrs[1].apply_delta(rdelta)]
        self._restack()
        out: dict[tuple[int, int], BidiResult] = {}
        if not warm:
            return out
        pair_delta = stack_deltas([delta, rdelta])
        new = self._stack
        prims = backends.stacked_segment_prims(new)
        for source, target, D0, F0 in warm:
            sync = SyncCounter()
            D0 = torch.as_tensor(D0, dtype=torch.float32, device=self.device)
            F0 = torch.as_tensor(F0, dtype=torch.bool, device=self.device)
            seeds, pure = stack_taint_seeds(old, pair_delta, D0)
            state, _, _ = _solve_warm(new, self.cfg, D0, F0, seeds, pure,
                                      prims, sync)
            self.warm_solves += 1
            out[(int(source), int(target))] = self._finish(
                state, source, target, sync, edges=False)
        return out


def _bidi_go(state, max_rounds: int) -> torch.Tensor:
    """bool scalar: the bidirectional loop's keep-going predicate, one
    f32 add a vertex for ``mu`` and one for the bounds, as written."""
    frontier = ((state.D < INF) & ~state.fixed) | (state.fixed
                                                   & ~state.explored)
    bound = torch.where(frontier, state.D, INF).amin(dim=1)
    mu = (state.D[0] + state.D[1]).min()
    go = frontier.any() & (state.round[0] < max_rounds)
    return go & (bound[0] + bound[1] < mu)
