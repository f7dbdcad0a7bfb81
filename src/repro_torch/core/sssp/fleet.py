"""Graph fleets: many same-shape graphs solved together (port of
``repro/core/sssp/fleet.py``).

A ``GraphFleet`` is F graphs sharing ``(n, e_pad)`` as one
``GraphStack`` (``[F, e_pad]`` edge and ``[F, n]`` vertex tensors); the
reference stacks them into one pytree with a leading fleet axis and
vmaps the round over it.  ``build_fleet`` pads members whose edge counts
differ to one ``e_pad`` (padding edges are inert: ``src = dst = n``,
``w = +inf``) and ``es`` keeps each member's true ``e``.

``FleetSolver`` backends:

  * "segment": all ``F * B`` lanes of a ``solve``/``solve_batch`` run one
    loop of the stacked segment round (one set of launches and one host
    read a round, whatever F is); a finished lane is frozen by
    ``_select``, as vmap of a ``while_loop`` freezes it, so every member
    is bitwise a per-graph ``Solver(backend="segment")`` solve.
  * "frontier": each member runs the shared-batch-frontier solve
    (``_solve_frontier``/``_solve_warm_frontier``) over its own CSR view,
    one member after another (the reference unrolls them inside one
    program); "auto" takes it when every member passes
    ``_frontier_fits``.

``stack_deltas`` stacks F per-member ``GraphDelta`` batches into one
``StackedDelta`` (padding rows carry ``edge_idx = 2^30``);
``FleetSolver.update`` applies each member's own row and warm re-solves
every member's tracked state in one run.  ``state_dict``/
``load_state_dict`` carry the weights and the tracked solve for a
bitwise restore.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.graph import (Graph, GraphStack, HostGraph,
                                    build_graph, resolve_device, round_up,
                                    stack_graphs)
from repro_torch.core.sssp import backends
from repro_torch.core.sssp.dynamic import _ELL_PAD, GraphDelta
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter,
                                          _fixed_by_dict, _solve,
                                          _solve_frontier, _solve_warm,
                                          _solve_warm_frontier,
                                          delta_decrease_sources,
                                          delta_taint_seeds,
                                          stack_taint_seeds)
from repro_torch.core.sssp.solver import (_default_frontier_cap,
                                          _frontier_fits, _next_pow2)

# out-of-range index of stacked-delta padding rows: every consumer drops
# indices >= e_pad, and 2^30 clears any member's e_pad
_IDX_PAD = 1 << 30


@dataclasses.dataclass(frozen=True)
class StackedDelta:
    """F per-member ``GraphDelta`` batches as ``[F, k_pad]`` tensors; row
    f holds ``ks[f]`` real updates of member f."""

    ks: tuple[int, ...]
    edge_idx: torch.Tensor           # int32[F, k_pad]
    new_w: torch.Tensor              # float32[F, k_pad]
    ell_row: torch.Tensor            # int32[F, k_pad]
    ell_col: torch.Tensor            # int32[F, k_pad]
    csr_pos: torch.Tensor | None = None

    @property
    def k(self) -> int:
        return sum(self.ks)

    def row(self, f: int) -> GraphDelta:
        """Member f's delta (weights were checked where it was built)."""
        return GraphDelta(  # astlint: ignore[raw-graphdelta]
            k=self.ks[f], edge_idx=self.edge_idx[f], new_w=self.new_w[f],
            ell_row=self.ell_row[f], ell_col=self.ell_col[f],
            csr_pos=None if self.csr_pos is None else self.csr_pos[f],
            checked=True)


def stack_deltas(deltas) -> StackedDelta:
    """Stack per-member deltas, padded to a common ``k_pad`` (the next
    power of two of the largest), on the device: no host read."""
    deltas = list(deltas)
    if not deltas:
        raise ValueError("stack_deltas needs at least one delta")
    kp = _next_pow2(max(d.k_pad for d in deltas))

    def pad(name, fill):
        return torch.stack([torch.cat([
            getattr(d, name), getattr(d, name).new_full(
                (kp - d.k_pad,), fill)]) for d in deltas])

    has_csr = all(d.csr_pos is not None for d in deltas)
    return StackedDelta(
        ks=tuple(int(d.k) for d in deltas), edge_idx=pad("edge_idx", _IDX_PAD),
        new_w=pad("new_w", 1.0), ell_row=pad("ell_row", _ELL_PAD),
        ell_col=pad("ell_col", _ELL_PAD),
        csr_pos=pad("csr_pos", _IDX_PAD) if has_csr else None)


def _check_stacked(deltas, F: int) -> None:
    if not isinstance(deltas, StackedDelta) or deltas.edge_idx.dim() != 2 \
            or deltas.edge_idx.shape[0] != F:
        shape = tuple(getattr(deltas, "edge_idx", torch.empty(0)).shape)
        raise ValueError(f"stacked delta shape {shape} must be "
                         f"[{F}, k_pad] (see stack_deltas)")


class GraphFleet:
    """F same-shape graphs as one ``GraphStack`` (``g``, one lane a
    member); ``es`` their true edge counts.  Build with ``stack`` or
    ``build_fleet``."""

    def __init__(self, g: GraphStack):
        self.g = g

    @property
    def es(self) -> tuple[int, ...]:
        return self.g.es

    @property
    def size(self) -> int:
        return self.g.size

    @property
    def n(self) -> int:
        return self.g.n

    @property
    def e_pad(self) -> int:
        return self.g.e_pad

    @property
    def device(self) -> torch.device:
        return self.g.device

    @classmethod
    def stack(cls, graphs) -> "GraphFleet":
        """Stack ``Graph`` members sharing ``(n, e_pad)``; their true
        ``e`` may differ."""
        return cls(stack_graphs(graphs))

    def member(self, i: int) -> Graph:
        """Member ``i`` as a ``Graph`` with its true ``e``."""
        return self.g.member(i)

    def members(self) -> list[Graph]:
        return self.g.members()

    def apply_deltas(self, deltas: StackedDelta) -> "GraphFleet":
        """New fleet with each member's own delta row applied."""
        _check_stacked(deltas, self.size)
        return GraphFleet(self.g.apply_deltas(deltas))

    def with_arrays(self, **leaves) -> "GraphFleet":
        """New fleet with stacked tensors replaced (a restore lands
        ``w``/``in_weight``/``out_weight`` verbatim)."""
        return GraphFleet(dataclasses.replace(self.g, **leaves))


def build_fleet(members, *, edge_pad_multiple: int = 128,
                device=None) -> GraphFleet:
    """Pad members to one ``e_pad`` and stack them on ``device`` (CUDA
    unless given).  ``members``: ``HostGraph``s, ``(n, src, dst, w)``
    tuples or ``Graph``s, all with the same ``n``."""
    device = resolve_device(device)
    hosts = []
    for i, m in enumerate(members):
        if isinstance(m, Graph):
            m = m.to_host()
        if isinstance(m, HostGraph):
            hosts.append((m.n, m.src, m.dst, m.w))
        elif isinstance(m, tuple) and len(m) == 4:
            hosts.append(m)
        else:
            raise TypeError(f"fleet member {i}: expected HostGraph, Graph, "
                            f"or (n, src, dst, w), got {type(m)!r}")
    if not hosts:
        raise ValueError("empty fleet")
    ns = {int(h[0]) for h in hosts}
    if len(ns) > 1:
        raise ValueError(f"fleet members must share n; got {sorted(ns)}")
    pad = max(round_up(max(len(h[1]), 1), edge_pad_multiple) for h in hosts)
    return GraphFleet.stack([build_graph(*h, edge_pad_multiple=pad,
                                         device=device) for h in hosts])


@dataclasses.dataclass
class FleetResult:
    """One source per member; ``result(i)`` is member i's ``SSSPResult``
    on its own graph."""

    sources: np.ndarray        # int32[F]
    dist: torch.Tensor         # float32[F, n]
    C: torch.Tensor            # float32[F, n]
    fixed: torch.Tensor        # bool[F, n]
    rounds: np.ndarray         # int32[F]
    fixed_by: list[dict[str, int]]
    fleet: GraphFleet
    edges_relaxed: np.ndarray | None = None  # int64[F] (frontier backend)
    host_syncs: int | None = None

    def __len__(self) -> int:
        return len(self.sources)

    def result(self, i: int) -> SSSPResult:
        return SSSPResult(
            dist=self.dist[i], C=self.C[i], fixed=self.fixed[i],
            rounds=int(self.rounds[i]), fixed_by=self.fixed_by[i],
            source=int(self.sources[i]), graph=self.fleet.member(i),
            edges_relaxed=None if self.edges_relaxed is None
            else int(self.edges_relaxed[i]))

    __getitem__ = result


@dataclasses.dataclass
class FleetBatchResult:
    """B sources per member (``[F, B]`` lanes)."""

    sources: np.ndarray        # int32[F, B]
    dist: torch.Tensor         # float32[F, B, n]
    C: torch.Tensor            # float32[F, B, n]
    fixed: torch.Tensor        # bool[F, B, n]
    rounds: np.ndarray         # int32[F, B]
    fixed_by: list[list[dict[str, int]]]
    fleet: GraphFleet
    edges_relaxed: np.ndarray | None = None  # int64[F, B] (frontier)
    host_syncs: int | None = None

    def result(self, f: int, i: int) -> SSSPResult:
        return SSSPResult(
            dist=self.dist[f, i], C=self.C[f, i], fixed=self.fixed[f, i],
            rounds=int(self.rounds[f, i]), fixed_by=self.fixed_by[f][i],
            source=int(self.sources[f, i]), graph=self.fleet.member(f),
            edges_relaxed=None if self.edges_relaxed is None
            else int(self.edges_relaxed[f, i]))


def _stack_states(states) -> dict:
    """Member states ``[B, ...]`` stacked as ``[F, B, ...]``."""
    return {name: torch.stack([getattr(st, name) for st in states])
            for name in ("D", "C", "fixed", "round", "fixed_by", "edges")}


@contract(
    "fleet.lockstep",
    routes=("fleet.*",),
    require=("aten.scatter_reduce.amin",),
    dense_budget=8,
    same_round_ops=True,
    notes="F graphs solve in ONE loop: every [F * B] lane runs the "
          "stacked segment round on the shape-unified edge layout, so "
          "the segment scatter-min relax and dense budget hold for the "
          "whole fleet: a budget regression here costs F-fold.")
@contract(
    "fleet.frontier",
    routes=("fleet_frontier.*",),
    require=("aten.cumsum", "ops.frontier_relax_b"),
    dense_budget=3,
    notes="backend='frontier' runs the members one after another through "
          "the shared-batch-frontier round: each member's rounds must run "
          "their cumsum union compaction and B2's fused relax, and only "
          "an overflowed round may sweep e_pad (the budget is a "
          "member's round, not F of them: the rounds are not fused).")
class FleetSolver:
    """SSSP over a whole ``GraphFleet`` (see the module docstring).

    ``solve(sources[F])`` and ``solve_batch(sources[F, B])`` (B padded to
    a power of two by repeating each member's last source); ``update``
    consumes a ``StackedDelta`` and warm re-solves the tracked ``solve``;
    ``resolve`` serves it; ``state_dict``/``load_state_dict`` restore.
    Runs on the fleet's device.
    """

    def __init__(self, fleet, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "segment", *,
                 frontier_cap: int | None = None):
        if isinstance(fleet, (list, tuple)):
            fleet = GraphFleet.stack(fleet)
        if not isinstance(fleet, GraphFleet):
            raise TypeError(f"fleet must be a GraphFleet or a list of "
                            f"Graphs, got {type(fleet)!r}")
        if backend not in ("segment", "frontier", "auto"):
            raise ValueError(f"unknown fleet backend {backend!r}; "
                             "expected 'segment', 'frontier', or 'auto'")
        if cfg.use_pallas:
            cfg = dataclasses.replace(cfg, use_pallas=False)
        if backend == "auto":
            backend = ("frontier"
                       if all(_frontier_fits(m) for m in fleet.members())
                       else "segment")
        self.fleet = fleet
        self.cfg = cfg
        self.backend = backend
        self.device = fleet.device
        self.version = 0
        self.solves = 0
        self._tracked: dict | None = None  # last untargeted solve()
        self.frontier_cap = 0
        self.csrs: list | None = None
        if backend == "frontier":
            self.csrs = [m.csr() for m in fleet.members()]
            self.frontier_cap = _next_pow2(
                _default_frontier_cap(fleet.n) if frontier_cap is None
                else max(1, int(frontier_cap)))

    @property
    def size(self) -> int:
        return self.fleet.size

    def _check_sources(self, sources: np.ndarray, what="source") -> None:
        bad = sources[(sources < 0) | (sources >= self.fleet.n)]
        if bad.size:
            raise ValueError(f"{what} vertices {bad.tolist()} out of range "
                             f"[0, {self.fleet.n})")

    def _dev(self, host: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(host, np.int64))
        if self.device.type == "cuda":    # an async copy: no host sync
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fprims(self, g: Graph, csr):
        return backends.frontier_prims(g, csr, self.frontier_cap)

    def _run(self, sources: np.ndarray, targets: np.ndarray | None,
             C0: torch.Tensor | None):
        """All ``[F, B]`` lanes to their fixpoints (or targets); returns
        the ``[F, B, ...]`` tensors, the host copies of rounds, fixed_by
        and edges (one read) and the count of host reads."""
        F, B = sources.shape
        sync = SyncCounter()
        src = self._dev(sources)
        tgt = None if targets is None else self._dev(targets)
        if self.csrs is None:
            stack = self.fleet.g.with_lanes(B)
            st = _solve(stack, self.cfg, src.reshape(-1),
                        backends.stacked_segment_prims(stack), sync,
                        None if C0 is None else C0.reshape(F * B, -1),
                        None if tgt is None else tgt.reshape(-1))
            out = {k: v.view((F, B) + v.shape[1:]) for k, v in (
                ("D", st.D), ("C", st.C), ("fixed", st.fixed),
                ("round", st.round), ("fixed_by", st.fixed_by))}
            out["edges"] = None
        else:
            states = [_solve_frontier(
                g, self.cfg, src[f], self._fprims(g, self.csrs[f]), sync,
                None if C0 is None else C0[f],
                None if tgt is None else tgt[f])
                for f, g in enumerate(self.fleet.members())]
            out = _stack_states(states)
        meta = [out["round"][..., None].long(), out["fixed_by"].long()]
        if out["edges"] is not None:
            meta.append(out["edges"][..., None])
        meta = np.asarray(sync.read(torch.cat(meta, dim=-1)), np.int64)
        edges = meta[..., 6] if out["edges"] is not None else None
        return out, meta[..., 0].astype(np.int32), meta[..., 1:6], edges, \
            sync.count

    # ------------------------------------------------------------------
    def solve(self, sources, targets=None, C0=None) -> FleetResult:
        """One source per member.  Untargeted solves are tracked for the
        next ``update``; ``targets`` int[F] makes each member's lane
        goal-directed (partial, not tracked), ``C0`` float32[F, n] seeds
        lower bounds."""
        F, n = self.size, self.fleet.n
        sources = np.asarray(sources, np.int32).ravel()
        if sources.shape != (F,):
            raise ValueError(f"sources shape {sources.shape} != ({F},) "
                             "(one source per fleet member)")
        self._check_sources(sources)
        tgts = None
        if targets is not None:
            tgts = np.asarray(targets, np.int32).ravel()
            if tgts.shape != (F,):
                raise ValueError(f"targets shape {tgts.shape} != ({F},)")
            self._check_sources(tgts, "target")
        c0 = None
        if C0 is not None:
            c0 = torch.as_tensor(C0, dtype=torch.float32, device=self.device)
            if c0.shape != (F, n):
                raise ValueError(f"C0 shape {tuple(c0.shape)} != ({F}, {n})")
            c0 = c0[:, None]
        out, rounds, fb, edges, syncs = self._run(
            sources[:, None], None if tgts is None else tgts[:, None], c0)
        self.solves += F
        res = FleetResult(
            sources=sources, dist=out["D"][:, 0], C=out["C"][:, 0],
            fixed=out["fixed"][:, 0], rounds=rounds[:, 0],
            fixed_by=[_fixed_by_dict(fb[i, 0]) for i in range(F)],
            fleet=self.fleet,
            edges_relaxed=None if edges is None else edges[:, 0],
            host_syncs=syncs)
        if not (targets is not None and self.cfg.early_exit):
            self._tracked = dict(version=self.version, sources=sources,
                                 D=res.dist, C=res.C, fixed=res.fixed,
                                 rounds=res.rounds, fb=fb[:, 0])
        return res

    def solve_batch(self, sources, targets=None, C0=None) -> FleetBatchResult:
        """``[F, B]`` sources, all lanes in one run; B is right-padded
        (repeating each member's last source) to a power of two."""
        F, n = self.size, self.fleet.n
        sources = np.asarray(sources, np.int32)
        if sources.ndim != 2 or sources.shape[0] != F:
            raise ValueError(f"sources shape {sources.shape} must be "
                             f"[{F}, B]")
        self._check_sources(sources.ravel())
        b = sources.shape[1]
        if b == 0:
            raise ValueError("solve_batch needs at least one source")
        b_pad = _next_pow2(b)

        def padded(a):
            return np.concatenate(
                [a, np.repeat(a[:, -1:], b_pad - b, axis=1)], axis=1)
        tpad = None
        if targets is not None:
            targets = np.asarray(targets, np.int32)
            if targets.shape != (F, b):
                raise ValueError(f"targets shape {targets.shape} != "
                                 f"({F}, {b})")
            self._check_sources(targets.ravel(), "target")
            tpad = padded(targets)
        c0 = None
        if C0 is not None:
            c0 = torch.as_tensor(C0, dtype=torch.float32, device=self.device)
            if c0.shape != (F, b, n):
                raise ValueError(f"C0 shape {tuple(c0.shape)} != "
                                 f"({F}, {b}, {n})")
            if b_pad > b:
                c0 = torch.cat([c0, c0[:, -1:].expand(F, b_pad - b, n)], 1)
        out, rounds, fb, edges, syncs = self._run(padded(sources), tpad, c0)
        self.solves += F * b
        return FleetBatchResult(
            sources=sources, dist=out["D"][:, :b], C=out["C"][:, :b],
            fixed=out["fixed"][:, :b], rounds=rounds[:, :b],
            fixed_by=[[_fixed_by_dict(fb[f, i]) for i in range(b)]
                      for f in range(F)],
            fleet=self.fleet,
            edges_relaxed=None if edges is None else edges[:, :b],
            host_syncs=syncs)

    # ------------------------------------------------------------------
    def update(self, deltas: StackedDelta, *, refresh: bool = True) -> dict:
        """Apply each member's delta row; with a current tracked state and
        ``refresh``, warm re-solve every member's tracked lane in one run
        (else the tracker goes stale and ``resolve`` re-solves cold).
        Stats: ``edges_changed``, ``warm_refreshed``, ``sweeps`` (the most
        of a lane), per-member ``warm_rounds`` and ``tainted``, and
        ``host_syncs``."""
        F = self.size
        _check_stacked(deltas, F)
        if self.csrs is not None and deltas.csr_pos is None:
            raise ValueError(
                "frontier fleet updates need the csr_pos permutation on "
                "every member delta (build them via make_delta against "
                "the member graphs before stack_deltas)")
        tracked = (self._tracked is not None
                   and self._tracked["version"] == self.version)
        stats = dict(edges_changed=deltas.k, warm_refreshed=0, sweeps=0,
                     warm_rounds=[], tainted=[], host_syncs=0)
        old = self.fleet
        self.fleet = old.apply_deltas(deltas)
        if self.csrs is not None:
            self.csrs = [csr.apply_delta(deltas.row(f))
                         for f, csr in enumerate(self.csrs)]
        self.version += 1
        if not (refresh and tracked):
            return stats
        sync = SyncCounter()
        D0, F0 = self._tracked["D"], self._tracked["fixed"]
        if self.csrs is None:
            seeds, pure = stack_taint_seeds(old.g, deltas, D0)
            st, sweeps, taint = _solve_warm(
                self.fleet.g, self.cfg, D0, F0, seeds, pure,
                backends.stacked_segment_prims(self.fleet.g), sync)
            D, C, fixed, rnd, fbt = st.D, st.C, st.fixed, st.round, \
                st.fixed_by
            tainted = taint.sum(dim=1)
        else:
            outs = []
            for f, (g_old, g_new) in enumerate(zip(old.members(),
                                                   self.fleet.members())):
                d = deltas.row(f)
                seeds, pure = delta_taint_seeds(g_old, d, D0[f:f + 1])
                outs.append(_solve_warm_frontier(
                    g_new, self.cfg, D0[f:f + 1], F0[f:f + 1], seeds, pure,
                    self._fprims(g_new, self.csrs[f]), sync,
                    delta_decrease_sources(g_old, d)))
            D, C, fixed, rnd, fbt = (torch.cat([getattr(o[0], k)
                                                for o in outs])
                                     for k in ("D", "C", "fixed", "round",
                                               "fixed_by"))
            sweeps = torch.cat([o[1] for o in outs])
            tainted = torch.cat([o[2].sum(dim=1) for o in outs])
        meta = np.asarray(sync.read(torch.cat([
            rnd[:, None].long(), fbt.long(), sweeps[:, None].long(),
            tainted[:, None].long()], dim=1)), np.int64)
        rounds = meta[:, 0].astype(np.int32)
        self._tracked = dict(version=self.version,
                             sources=self._tracked["sources"], D=D, C=C,
                             fixed=fixed, rounds=rounds, fb=meta[:, 1:6])
        stats.update(warm_refreshed=F, sweeps=int(meta[:, 6].max()),
                     warm_rounds=[int(r) for r in rounds],
                     tainted=[int(t) for t in meta[:, 7]],
                     host_syncs=sync.count)
        return stats

    def resolve(self) -> FleetResult:
        """The tracked per-member results on the current graphs (warm
        after ``update``; re-solved cold when stale)."""
        if self._tracked is None:
            raise ValueError("nothing tracked yet — call solve() first")
        if self._tracked["version"] != self.version:
            return self.solve(self._tracked["sources"])
        t = self._tracked
        return FleetResult(
            sources=t["sources"], dist=t["D"], C=t["C"], fixed=t["fixed"],
            rounds=t["rounds"],
            fixed_by=[_fixed_by_dict(t["fb"][i]) for i in range(self.size)],
            fleet=self.fleet)

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The fleet's weights and tracked solve as tensors on its device:
        everything ``load_state_dict`` needs to resume bitwise."""
        if self._tracked is None:
            raise ValueError("nothing tracked yet — call solve() first")
        t, dev = self._tracked, self.device
        return dict(
            w=self.fleet.g.w, in_weight=self.fleet.g.in_weight,
            out_weight=self.fleet.g.out_weight,
            sources=torch.as_tensor(t["sources"], dtype=torch.int32,
                                    device=dev),
            D=t["D"], C=t["C"], fixed=t["fixed"],
            rounds=torch.as_tensor(t["rounds"], dtype=torch.int32,
                                   device=dev),
            fb=torch.as_tensor(np.asarray(t["fb"]), dtype=torch.int32,
                               device=dev),
            version=torch.tensor(self.version, dtype=torch.int32,
                                 device=dev))

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict`` output verbatim (bitwise resume)."""
        dev = self.device

        def t(name, dtype):
            return torch.as_tensor(state[name], dtype=dtype, device=dev)
        self.fleet = self.fleet.with_arrays(
            w=t("w", torch.float32), in_weight=t("in_weight", torch.float32),
            out_weight=t("out_weight", torch.float32))
        if self.csrs is not None:
            # CSR weights are a src-sorted permutation of the restored w
            self.csrs = [m.csr() for m in self.fleet.members()]
        self.version = int(t("version", torch.int32))
        self._tracked = dict(
            version=self.version,
            sources=t("sources", torch.int32).cpu().numpy(),
            D=t("D", torch.float32), C=t("C", torch.float32),
            fixed=t("fixed", torch.bool),
            rounds=t("rounds", torch.int32).cpu().numpy(),
            fb=t("fb", torch.int32).cpu().numpy())
