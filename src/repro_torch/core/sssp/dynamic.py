"""Dynamic graphs: weight deltas and warm re-solves (port of
``repro/core/sssp/dynamic.py``).

A routing service's weights drift while its topology stays put, so a
weight change is an event on the device, not a rebuild:

  * ``GraphDelta``: a batch of ``(edge_idx, new_w)`` updates, padded to a
    power of two, with each edge's ELL cell and CSR position, so one delta
    updates every layout (``Graph``/``CsrGraph``/``EllGraph.apply_delta``).
    Padding rows carry out-of-range indices (``edge_idx = csr_pos =
    e_pad``, ``ell_row = ell_col = 2^30``) and drop in every scatter.
  * ``DynamicSolver``: a ``Solver`` whose ``solve``/``solve_batch`` track
    their full results; ``update(delta)`` mutates the layouts and
    warm-repairs the tracked distance fields (``engine._solve_warm``:
    the increased-and-tight cone is un-fixed, decreases heal in the warm
    rounds), and ``resolve(sources)`` serves post-update distances, warm
    rows first.

Deltas are validated once on the host, where they are built
(``make_delta``, ``convert.delta_from_arrays``) or, for a hand-built
``GraphDelta``, when it is constructed, so ``apply_delta`` and
``update`` read nothing back for it.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.graph import Graph
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter,
                                          _fixed_by_dict, _solve_warm,
                                          delta_decrease_sources,
                                          delta_taint_seeds)
from repro_torch.core.sssp.solver import (SSSPBatchResult, Solver,
                                          _next_pow2)

_ELL_PAD = 1 << 30   # ELL padding coordinate: out of range for any table

# dst-sorted -> CSR inverse permutations, keyed by id(g.src).  It depends
# only on topology, and ``apply_delta`` keeps the src tensor object, so
# every version of a graph shares one entry; the finalizer drops it with
# the tensor (which also makes id reuse harmless).
_CSR_INV_CACHE: dict[int, np.ndarray] = {}


def _csr_inverse_perm(g: Graph) -> np.ndarray:
    key = id(g.src)
    inv = _CSR_INV_CACHE.get(key)
    if inv is None:
        order = np.argsort(g.src[: g.e].cpu().numpy(), kind="stable")
        inv = np.empty(g.e, np.int64)
        inv[order] = np.arange(g.e)
        _CSR_INV_CACHE[key] = inv
        weakref.finalize(g.src, _CSR_INV_CACHE.pop, key, None)
    return inv


def _check_weights(new_w: np.ndarray) -> None:
    if new_w.size and not (np.isfinite(new_w).all() and (new_w > 0).all()):
        raise ValueError(
            "update weights must be strictly positive and finite (got "
            f"min={new_w.min()!r}, padding rows included); the engine's "
            "fixing rules assume w > 0")


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A padded batch of edge-weight updates on one device.

    ``edge_idx`` int32[k_pad] indexes the graph's dst-sorted edge arrays,
    ``new_w`` float32[k_pad] the new weights, ``ell_row``/``ell_col``
    int32[k_pad] the same edges' ELL cells and ``csr_pos`` int32[k_pad]
    (or None: such a delta cannot update a ``CsrGraph``) their CSR
    positions; ``k`` rows are real.  Constructing one validates every
    row's weight (> 0 and finite) on the host, unless ``checked`` says
    the builder already did from its host arrays.
    """

    k: int
    edge_idx: torch.Tensor
    new_w: torch.Tensor
    ell_row: torch.Tensor
    ell_col: torch.Tensor
    csr_pos: torch.Tensor | None = None
    checked: bool = dataclasses.field(default=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        if not self.checked:
            _check_weights(self.new_w.cpu().numpy())
            object.__setattr__(self, "checked", True)

    @property
    def k_pad(self) -> int:
        return int(self.edge_idx.shape[0])


def _delta_from_host(k: int, device, **rows: np.ndarray | None
                     ) -> GraphDelta:
    """A GraphDelta of host rows already padded and validated."""
    _check_weights(rows["new_w"])
    dtypes = dict(edge_idx=np.int32, new_w=np.float32, ell_row=np.int32,
                  ell_col=np.int32, csr_pos=np.int32)
    return GraphDelta(k=k, checked=True, **{
        name: None if a is None else torch.from_numpy(
            np.array(a, dtypes[name])).to(device)
        for name, a in rows.items()})


def make_delta(g: Graph, edge_idx, new_w, *, min_pad: int = 8) -> GraphDelta:
    """GraphDelta of updates to edges ``edge_idx`` of ``g`` (indices into
    its dst-sorted edge arrays), on ``g``'s device.

    Validates on the host: indices must name real edges, weights must be
    positive and finite.  Duplicate indices keep the last update.  Pads to
    ``max(min_pad, next power of two)`` rows.
    """
    edge_idx = np.asarray(edge_idx, np.int64).ravel()
    new_w = np.asarray(new_w, np.float32).ravel()
    if edge_idx.shape != new_w.shape:
        raise ValueError(f"edge_idx {edge_idx.shape} and new_w "
                         f"{new_w.shape} must match")
    if edge_idx.size == 0:
        raise ValueError("empty delta")
    if edge_idx.min() < 0 or edge_idx.max() >= g.e:
        bad = edge_idx[(edge_idx < 0) | (edge_idx >= g.e)]
        raise ValueError(f"edge indices {bad.tolist()} outside the real "
                         f"edge range [0, {g.e}) (padding edges are not "
                         "updatable: topology is fixed)")
    _check_weights(new_w)
    _, last = np.unique(edge_idx[::-1], return_index=True)
    keep = np.sort(edge_idx.size - 1 - last)        # last write wins
    edge_idx, new_w = edge_idx[keep], new_w[keep]

    # ELL cell: row = dst, col = rank within the dst run (the edge list
    # is dst-sorted stably and build_ell fills rows in that order)
    dst_sorted = g.dst[: g.e].cpu().numpy()
    dst = dst_sorted[edge_idx]
    col = edge_idx - np.searchsorted(dst_sorted, dst, side="left")
    csr_pos = _csr_inverse_perm(g)[edge_idx]

    k = int(edge_idx.size)
    pad = max(min_pad, _next_pow2(k)) - k

    def _p(x, fill):
        return np.concatenate([x, np.full(pad, fill, x.dtype)])

    return _delta_from_host(
        k, g.device, edge_idx=_p(edge_idx, g.e_pad),
        new_w=_p(new_w, np.float32(1.0)), ell_row=_p(dst, _ELL_PAD),
        ell_col=_p(col, _ELL_PAD), csr_pos=_p(csr_pos, g.e_pad))


def make_delta_from_endpoints(g: Graph, src, dst, new_w, **kw) -> GraphDelta:
    """GraphDelta from ``(u, v, w_new)`` triples; each (u, v) must be an
    edge of ``g`` (of parallel edges the lowest-index one is updated)."""
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    key = (g.src[: g.e].cpu().numpy().astype(np.int64) * g.n
           + g.dst[: g.e].cpu().numpy())
    order = np.argsort(key, kind="stable")
    want = src * g.n + dst
    pos = np.searchsorted(key[order], want)
    pos_ok = pos < g.e
    found = np.zeros(len(want), bool)
    found[pos_ok] = key[order][pos[pos_ok]] == want[pos_ok]
    if not found.all():
        missing = [(int(s), int(d))
                   for s, d in zip(src[~found], dst[~found])]
        raise ValueError(f"edges {missing} not present in the graph; "
                         "GraphDelta updates weights of existing edges only")
    return make_delta(g, order[pos], new_w, **kw)


def random_delta(g: Graph, k: int, *, seed: int = 0, lo: float = 0.5,
                 hi: float = 2.0) -> GraphDelta:
    """k random edges rescaled by uniform[lo, hi] (tests, benchmarks)."""
    rng = np.random.default_rng(seed)
    k = min(int(k), g.e)
    idx = rng.choice(g.e, size=k, replace=False)
    old = g.w[: g.e].cpu().numpy()[idx]
    return make_delta(g, idx, old * rng.uniform(lo, hi, k).astype(np.float32))


@contract(
    "warm.incremental_repair",
    routes=("*.warm",),
    require=("aten.index_select|aten.gather|ops.relax_ell"
             "|ops.frontier_relax_b", "aten.amin|ops.masked_min_pair"),
    notes="Every warm path taints the increased-and-tight cone, then "
          "re-runs the round body for the tracked lanes.  Its rounds "
          "must still run a relax gather and the masked "
          "min-reduction: a warm path that lost them is returning stale "
          "distances, not repairing them.")
class DynamicSolver(Solver):
    """A Solver whose graph can change between solves.

    ``solve``/``solve_batch`` also track their full results (never
    partial ones: their unfixed entries are only upper bounds) in an LRU
    of ``track_sources`` entries.  ``update(delta)`` applies a weight
    delta to every layout and warm-refreshes the tracked sources in one
    batch-first run; ``graph``/``ell``/``csr``/``prims`` always hold the
    newest version and ``version`` counts the deltas applied.  On the
    distributed backend every rank keeps the whole graph: the taint seeds
    come from the whole old graph, and the taint sweeps (one all-reduce
    each) and warm rounds run on this rank's block of the new one.
    """

    def __init__(self, graph, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "auto", *, track_sources: int = 128, **kw):
        super().__init__(graph, cfg, backend, **kw)
        self.version = 0
        self.track_sources = max(1, int(track_sources))
        # source -> dict(version, D, C, fixed, rounds, fixed_by)
        self._states: OrderedDict[int, dict] = OrderedDict()

    # ------------------------------------------------------------------
    def _track(self, source: int, *, D, C, fixed, rounds, fixed_by) -> None:
        self._states[source] = dict(version=self.version, D=D, C=C,
                                    fixed=fixed, rounds=int(rounds),
                                    fixed_by=fixed_by)
        self._states.move_to_end(source)
        while len(self._states) > self.track_sources:
            self._states.popitem(last=False)

    def _fresh(self, source: int) -> dict | None:
        st = self._states.get(source)
        if st is not None and st["version"] == self.version:
            self._states.move_to_end(source)
            return st
        return None

    def solve(self, source: int, target: int | None = None,
              C0=None) -> SSSPResult:
        res = super().solve(source, target=target, C0=C0)
        if not res.partial:
            self._track(int(source), D=res.dist, C=res.C, fixed=res.fixed,
                        rounds=res.rounds, fixed_by=res.fixed_by)
        return res

    def solve_batch(self, sources, targets=None, C0=None) -> SSSPBatchResult:
        batch = super().solve_batch(sources, targets=targets, C0=C0)
        if not batch.partial:
            for i, s in enumerate(batch.sources):
                self._track(int(s), D=batch.dist[i], C=batch.C[i],
                            fixed=batch.fixed[i], rounds=batch.rounds[i],
                            fixed_by=batch.fixed_by[i])
        return batch

    # ------------------------------------------------------------------
    def _apply(self, delta: GraphDelta) -> None:
        self.graph = self.graph.apply_delta(delta)
        if self.ell is not None:
            self.ell = self.ell.apply_delta(delta)
        if self.csr is not None:
            self.csr = self.csr.apply_delta(delta)
        self.prims = self._make_prims(self.graph, self.ell, self.csr)
        self.version += 1

    def update(self, delta: GraphDelta, *, refresh=None) -> dict:
        """Apply a weight delta; warm-refresh tracked sources; stats.

        ``refresh`` names the sources to re-solve now (default: every
        current tracked source).  Those with a current tracked state are
        warm-refreshed in one run; the others are cold-solved on the
        mutated graph.  Tracked states not refreshed go stale and
        ``resolve`` re-solves them.  Returns ``edges_changed``,
        ``increased``/``decreased`` (against the old weights),
        ``warm_refreshed``/``cold_refreshed``, ``sweeps`` (the most taint
        sweeps of a lane), per-lane ``warm_rounds`` and ``tainted``, and
        ``host_syncs``, the device->host reads of the warm run and of the
        stats (the warm run's own, then one read for all stats).
        """
        if not isinstance(delta, GraphDelta):
            raise TypeError(f"update() wants a GraphDelta (see make_delta); "
                            f"got {type(delta)!r}")
        g_old = self.graph
        k = delta.k
        # the k old weights' comparisons, read with the other stats
        old_w = g_old.w[delta.edge_idx[:k].long()]
        new_w = delta.new_w[:k]
        moved = torch.stack([(new_w > old_w).sum(), (new_w < old_w).sum()])

        tracked = [s for s in self._states
                   if self._states[s]["version"] == self.version]
        want = tracked if refresh is None else [int(s) for s in refresh]
        warm_src = [s for s in dict.fromkeys(want) if s in self._states
                    and self._states[s]["version"] == self.version]
        cold_src = [s for s in dict.fromkeys(want) if s not in warm_src]
        stats = dict(edges_changed=k, increased=0, decreased=0,
                     warm_refreshed=len(warm_src),
                     cold_refreshed=len(cold_src), sweeps=0,
                     warm_rounds=[], tainted=[], host_syncs=0)
        sync = SyncCounter()
        if warm_src:
            b = len(warm_src)
            padded = warm_src + [warm_src[-1]] * (_next_pow2(b) - b)
            prev_D = torch.stack([self._states[s]["D"] for s in padded])
            prev_F = torch.stack([self._states[s]["fixed"] for s in padded])
            seeds, pure = delta_taint_seeds(g_old, delta, prev_D)
            dec = (delta_decrease_sources(g_old, delta)
                   if self.csr is not None else None)
            self._apply(delta)
            state, sweeps, taint = _solve_warm(
                self.graph, self.cfg, prev_D, prev_F, seeds, pure,
                self.prims, sync, dec)
            meta = torch.cat([
                state.round[:b, None].long(), state.fixed_by[:b].long(),
                sweeps[:b, None].long(),
                taint[:b].sum(dim=1, keepdim=True),
                moved[None].expand(b, 2)], dim=1)
            meta = np.asarray(sync.read(meta), np.int64)
            for i, s in enumerate(warm_src):
                self._track(s, D=state.D[i], C=state.C[i],
                            fixed=state.fixed[i], rounds=meta[i, 0],
                            fixed_by=_fixed_by_dict(meta[i, 1:6]))
            stats["sweeps"] = int(meta[:, 6].max())
            stats["warm_rounds"] = [int(r) for r in meta[:, 0]]
            stats["tainted"] = [int(t) for t in meta[:, 7]]
            inc, dec_n = meta[0, 8], meta[0, 9]
        else:
            self._apply(delta)
            inc, dec_n = sync.read(moved)
        stats["increased"], stats["decreased"] = int(inc), int(dec_n)
        stats["host_syncs"] = sync.count
        if cold_src:
            self.solve_batch(cold_src)
        return stats

    def resolve(self, sources) -> SSSPBatchResult:
        """Distances from ``sources`` on the current graph: current tracked
        rows as they are (snapshotted before anything is solved, since the
        misses' solve may evict them from the LRU), the rest cold-solved
        in one batch."""
        sources = np.asarray(sources, np.int32).ravel()
        if sources.size == 0:
            raise ValueError("resolve needs at least one source")
        self._check_sources(sources)
        rows = {}
        for s in dict.fromkeys(sources.tolist()):
            st = self._fresh(int(s))
            if st is not None:
                rows[int(s)] = (st["D"], st["C"], st["fixed"], st["rounds"],
                                st["fixed_by"])
        missing = [int(s) for s in dict.fromkeys(sources.tolist())
                   if int(s) not in rows]
        if missing:
            mb = self.solve_batch(missing)
            for i, s in enumerate(mb.sources):
                rows[int(s)] = (mb.dist[i], mb.C[i], mb.fixed[i],
                                int(mb.rounds[i]), mb.fixed_by[i])
        picked = [rows[int(s)] for s in sources]
        return SSSPBatchResult(
            sources=sources,
            dist=torch.stack([r[0] for r in picked]),
            C=torch.stack([r[1] for r in picked]),
            fixed=torch.stack([r[2] for r in picked]),
            rounds=np.asarray([r[3] for r in picked], np.int32),
            fixed_by=[r[4] for r in picked], graph=self.graph)
