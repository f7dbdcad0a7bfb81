"""The SSSP solver facade (port of ``repro/core/sssp/solver.py``).

``Solver`` does everything per-graph once — layout build (ELL, CSR) and
the move to the device — so answering a source is one engine run:

  * ``solve(s)`` runs the batch-first engine at B = 1;
  * ``solve_batch`` pads the batch to the next power of two (repeating
    the last source, as the reference does for its compiled shapes) and
    runs all lanes in one loop;
  * ``target=``/``targets=`` make a solve goal-directed (each lane stops
    once its target is certified; the result is stamped ``partial``),
    and ``C0=`` seeds the lower bounds, e.g. from a ``LandmarkIndex``;
  * backends are instances of the primitives protocol (backends.py), so
    "segment", "ell"/"pallas", "frontier" and "distributed" share the
    round body.

The solver runs on CUDA unless ``device="cpu"`` is passed; without a card
it raises rather than falling back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.contracts import contract
from repro_torch.core.graph import (CsrGraph, EllGraph, Graph, HostGraph,
                                    build_ell, build_graph, resolve_device)
from repro_torch.core.sssp import backends, distributed
from repro_torch.core.sssp.engine import (SP4_CONFIG, SSSPConfig,
                                          SSSPResult, SyncCounter,
                                          _fixed_by_dict, _solve)

BACKENDS = ("auto", "segment", "ell", "pallas", "frontier", "distributed")


@dataclasses.dataclass
class SSSPBatchResult:
    """Distances for B sources on one graph; indexable into SSSPResults."""

    sources: np.ndarray       # int32[B]
    dist: torch.Tensor        # float32[B, n]
    C: torch.Tensor           # float32[B, n]
    fixed: torch.Tensor       # bool[B, n]
    rounds: np.ndarray        # int32[B]
    fixed_by: list[dict[str, int]]
    graph: Graph | None = None
    targets: np.ndarray | None = None        # int32[B] (-1: untargeted)
    partial: bool = False                    # lanes may have early-exited
    edges_relaxed: np.ndarray | None = None  # int64[B] (frontier backend)
    host_syncs: int | None = None            # device->host reads of the run

    def __len__(self) -> int:
        return len(self.sources)

    def result(self, i: int) -> SSSPResult:
        t = None
        if self.targets is not None and int(self.targets[i]) >= 0:
            t = int(self.targets[i])
        return SSSPResult(
            dist=self.dist[i], C=self.C[i], fixed=self.fixed[i],
            rounds=int(self.rounds[i]), fixed_by=self.fixed_by[i],
            source=int(self.sources[i]), graph=self.graph, target=t,
            partial=self.partial and t is not None,
            edges_relaxed=None if self.edges_relaxed is None
            else int(self.edges_relaxed[i]))

    __getitem__ = result


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _frontier_fits(g: Graph) -> bool:
    """``backend="auto"`` proxy for thin wavefronts: low average degree
    (chain, grid) or bounded out-degree (geometric), and no hub whose
    out-degree would bloat the ``cap * max_out_deg`` gather."""
    if g.e == 0:
        return False
    max_out = int(g.out_deg.max()) if g.n else 0
    return (g.e <= 4 * g.n or max_out <= 8) and max_out <= 64


def _default_frontier_cap(n: int) -> int:
    return _next_pow2(min(max(n // 4, 32), 4096))


@contract(
    "solver.targeted_early_exit",
    routes=("*.targeted",),
    require_cond=("aten.gather",),
    notes="A targeted solve's keep-going predicate (engine._cond) must "
          "read fixed[target] and explored[target] (a gather): if it "
          "disappears, targeted solves quietly run to full convergence "
          "and the p2p speedup is gone with no output change to catch "
          "it.  Untargeted solves pass no targets, so the port checks "
          "the targeted routes only.")
class Solver:
    """Multi-source SSSP over one graph.

    graph:    a ``Graph`` (moved to ``device``), a ``HostGraph``, or an
              ``(n, src, dst, w)`` tuple of host arrays.
    cfg:      engine configuration (rules / label-correcting / c-prop).
    backend:  "auto" | "segment" | "ell" | "pallas" | "frontier" |
              "distributed".  "auto" picks "pallas" when
              ``cfg.use_pallas``, else "frontier" for thin-wavefront
              graphs, else "segment".  "ell" and "pallas" are one backend
              here: the ELL kernels on CUDA, their plain versions on the
              CPU.  "distributed" shards the edge list over the ranks of
              ``group`` (``core/sssp/distributed.py``): every rank builds
              the same Solver and makes the same calls; ``graph`` is then
              the shard-padded whole graph, which every rank keeps.
    ell:      pre-built ``EllGraph`` for ell/pallas (else built here).
    frontier_cap: compacted-buffer size of the frontier backend (rounded
              up to a power of two; a round whose union frontier outgrows
              it runs the dense relax, bitwise the same).
    device:   where the solve runs; CUDA unless given.
    group:    the distributed backend's process group (default: the
              default group if initialized, else a world of one);
              ``rank``/``world`` report it and ``collectives`` counts its
              all-reduces.

    ``solves`` counts the sources answered (the reference's facade
    counts its traces instead).
    """

    def __init__(self, graph, cfg: SSSPConfig = SP4_CONFIG,
                 backend: str = "auto", *, ell: EllGraph | None = None,
                 max_deg_cap: int | None = None,
                 frontier_cap: int | None = None, device=None, group=None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        if group is not None and backend != "distributed":
            raise ValueError(f"group= is the distributed backend's; "
                             f"backend is {backend!r}")
        device = resolve_device(device)
        if isinstance(graph, HostGraph):
            graph = graph.to_device(device)
        elif isinstance(graph, tuple):
            graph = build_graph(*graph, device=device)
        if not isinstance(graph, Graph):
            raise TypeError(f"graph must be Graph/HostGraph/tuple, "
                            f"got {type(graph)!r}")
        graph = graph.to(device)
        if backend == "auto":
            if cfg.use_pallas:
                backend = "pallas"
            elif _frontier_fits(graph):
                backend = "frontier"
            else:
                backend = "segment"
        # normalize cfg.use_pallas as the reference does: "pallas" forces
        # it on, every other backend but "frontier" forces it off.
        if backend == "pallas":
            cfg = dataclasses.replace(cfg, use_pallas=True)
        elif cfg.use_pallas and backend != "frontier":
            cfg = dataclasses.replace(cfg, use_pallas=False)
        self.graph = graph
        self.cfg = cfg
        self.backend = backend
        self.device = device
        self.ell: EllGraph | None = None
        self.csr: CsrGraph | None = None
        self.frontier_cap = 0
        self.group, self.rank, self.world = None, 0, 1
        self.collectives = backends.CollectiveCounter()
        self.solves = 0     # sources answered (padding lanes not counted)

        if backend == "distributed":
            self.group, self.rank, self.world = distributed.resolve_group(
                group)
            self.graph = distributed.shard_graph_edges(graph, self.world)
        elif backend in ("ell", "pallas"):
            if ell is None:
                e = graph.e
                ell = build_ell(graph.n, graph.src[:e].cpu().numpy(),
                                graph.dst[:e].cpu().numpy(),
                                graph.w[:e].cpu().numpy(),
                                max_deg_cap=max_deg_cap, device=device)
            self.ell = ell
        elif backend == "frontier":
            self.csr = graph.csr()
            self.frontier_cap = _next_pow2(
                _default_frontier_cap(graph.n) if frontier_cap is None
                else max(1, int(frontier_cap)))
        self.prims = self._make_prims(self.graph, self.ell, self.csr)

    def _make_prims(self, g: Graph, ell: EllGraph | None,
                    csr: CsrGraph | None) -> backends.Primitives:
        """The backend's primitives over these layouts (a DynamicSolver
        rebuilds them on each mutated graph; the distributed backend
        then takes this rank's block of the mutated graph)."""
        if self.backend == "distributed":
            return distributed.sharded_prims(g, self.group, self.rank,
                                             self.world, self.collectives)
        if csr is not None:
            return backends.frontier_prims(g, csr, self.frontier_cap)
        if ell is not None:
            return backends.ell_prims(g, ell)
        return backends.segment_prims(g)

    # ------------------------------------------------------------------
    def _check_sources(self, sources, what: str = "source") -> None:
        sources = np.asarray(sources, np.int64)
        bad = sources[(sources < 0) | (sources >= self.graph.n)]
        if bad.size:
            raise ValueError(f"{what} vertices {bad.tolist()} out of range "
                             f"[0, {self.graph.n})")

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(host, dtype=torch.int64)
        if self.device.type == "cuda":    # an async copy: no host sync
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _seeds(self, C0, b: int, b_pad: int) -> torch.Tensor | None:
        """float32[b_pad, n] lower-bound seeds on the solver's device from
        ``C0`` [b, n], padded by repeating its last row."""
        if C0 is None:
            return None
        c0 = torch.as_tensor(C0, dtype=torch.float32, device=self.device)
        n = self.graph.n
        if c0.shape != (b, n):
            raise ValueError(f"C0 shape {tuple(c0.shape)} != ({b}, {n})")
        if b_pad > b:
            c0 = torch.cat([c0, c0[-1:].expand(b_pad - b, n)])
        return c0

    def _run(self, sources: np.ndarray, b: int,
             targets: np.ndarray | None = None,
             C0: torch.Tensor | None = None):
        """Engine run of the (padded) ``sources`` (and ``targets``, seeds
        ``C0``); returns the state, the host copies of
        ``rounds``/``fixed_by``/``edges`` of the first ``b`` lanes (one
        read) and the run's count of host reads."""
        sync = SyncCounter()
        src = self._to_device(sources)
        tgt = None if targets is None else self._to_device(targets)
        state = _solve(self.graph, self.cfg, src, self.prims, sync, C0, tgt)
        self.solves += b
        meta = [state.round[:b, None], state.fixed_by[:b]]
        if state.edges is not None:
            meta.append(state.edges[:b, None])
        meta = np.asarray(sync.read(torch.cat(meta, dim=1)), np.int64)
        edges = meta[:, 6] if state.edges is not None else None
        return (state, meta[:, 0].astype(np.int32), meta[:, 1:6], edges,
                sync.count)

    def solve(self, source: int, target: int | None = None,
              C0=None) -> SSSPResult:
        """Distances from one source (the engine at B = 1).

        ``target`` makes the solve stop once ``dist[target]`` is
        certified (``partial=True``: only fixed vertices are exact, and
        ``path_to(target)`` is).  ``C0`` float32[n] seeds the lower
        bounds, e.g. ``LandmarkIndex.seed(source)``.
        """
        self._check_sources([source])
        if target is not None:
            self._check_sources([target], what="target")
        tgt = None if target is None else np.array([target], np.int64)
        c0 = None if C0 is None else torch.as_tensor(
            C0, dtype=torch.float32, device=self.device).reshape(1, -1)
        state, rounds, fb, edges, syncs = self._run(
            np.array([source], np.int64), 1, tgt, self._seeds(c0, 1, 1))
        return SSSPResult(
            dist=state.D[0], C=state.C[0], fixed=state.fixed[0],
            rounds=int(rounds[0]), fixed_by=_fixed_by_dict(fb[0]),
            source=int(source), graph=self.graph, target=target,
            partial=target is not None and self.cfg.early_exit,
            edges_relaxed=None if edges is None else int(edges[0]),
            host_syncs=syncs)

    def solve_batch(self, sources, targets=None, C0=None) -> SSSPBatchResult:
        """Distances from B sources in one batch-first run.

        The batch is right-padded (repeating the last source) to the next
        power of two, as the reference pads its compiled batch shapes;
        padding lanes are sliced off the result.  ``targets`` int[B]
        makes every lane goal-directed (see ``solve``); padding lanes
        repeat the last target, so they never outrun the real ones.
        ``C0`` float32[B, n] seeds the lanes' lower bounds (on the
        solver's device, no host copy; padding repeats the last row).
        """
        sources = np.asarray(sources, np.int32).ravel()
        if sources.size == 0:
            raise ValueError("solve_batch needs at least one source")
        self._check_sources(sources)
        b = len(sources)
        b_pad = _next_pow2(b)
        padded = np.concatenate(
            [sources, np.full(b_pad - b, sources[-1], np.int32)])
        tpad = None
        if targets is not None:
            targets = np.asarray(targets, np.int32).ravel()
            if targets.size != b:
                raise ValueError(f"targets {targets.shape} must match "
                                 f"sources ({b},)")
            self._check_sources(targets, what="target")
            tpad = np.concatenate(
                [targets, np.full(b_pad - b, targets[-1], np.int32)])
        state, rounds, fb, edges, syncs = self._run(
            padded, b, tpad, self._seeds(C0, b, b_pad))
        return SSSPBatchResult(
            sources=sources,
            dist=state.D[:b], C=state.C[:b], fixed=state.fixed[:b],
            rounds=rounds, fixed_by=[_fixed_by_dict(f) for f in fb],
            graph=self.graph, targets=targets,
            partial=targets is not None and self.cfg.early_exit,
            edges_relaxed=edges, host_syncs=syncs)
